"""The ADMM corr mode's accuracy A/B over several epochs (port of
tools/corr_mode_ab.py): the same W4A4 ADMM ResNet-20 QAT run, one seed,
the synthetic set, three ways:

- `single`: one process;
- `gather`: 2 data-parallel ranks, the corr matrices over the global batch
  (the reference's exact math: the flattened features all-gathered at
  every site);
- `local`: 2 ranks, per-rank B_local x B_local matrices and duals (no
  corr-path traffic; a block-diagonal approximation of the reference's).

The JAX tool ran its mesh as 8 virtual CPU devices in one process; the
port's mesh is the torch.distributed world: 2 gloo ranks, one process each
(subprocesses of this module, `--rank`), sharing the card as chip_smoke.py
phase 24(b) runs them (NCCL refuses two ranks on one card).

Prints, per mode, {"mode", "mesh", "final_top1", "best_top1",
"epochs_to_100", "curve" (test top-1 per epoch), "mean_gamma_mag" (the
mean |gamma| of rank 0's duals at the end)}, then a summary with the
recommendation: `gather` unless `local` reaches gather's best top-1
within 0.5 pts in no more epochs to 100% (the synthetic set saturates,
so the speed of convergence is what tells the modes apart), then `local`.

    python -m alignq_tpu_torch.tools.corr_mode_ab [--epochs 20] [--batch 128] [--smoke] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

RANKS = 2
MODES = ("single", "gather", "local")
RANK_TIMEOUT_S = 3000.0  # what a rank may take: its process group's timeout and the wait for it
SMOKE_TEST_IMAGES = 16


def head(loader, n: int):
    """The loader's first n images, as a loader of the same settings."""
    from alignq_tpu_torch.data.loader import ArrayLoader

    return ArrayLoader(loader.x[:n], loader.y[:n], loader.batch_size, shuffle=loader.shuffle,
                       drop_remainder=loader.drop_remainder, augment_fn=loader.augment_fn,
                       transform_fn=loader.transform_fn, seed=loader.seed, prefetch=loader.prefetch)


def run(mode: str, n: int, a, job: str) -> dict:
    """One training run in this process (rank r of n where n > 1); its
    record (rank 0's is the run's)."""
    from alignq_tpu_torch.data.registry import get_data
    from alignq_tpu_torch.train import TrainConfig
    from alignq_tpu_torch.train.loop import fit

    cfg = TrainConfig(
        target_model="resnet20_quant", method="ours", bitW=a.bits, abitW=a.bits, admm=True, lr=a.lr,
        num_epochs=a.epochs, train_batch_size=a.batch, eval_batch_size=a.batch,
        lr_decay_steps=(int(a.epochs * 0.5), int(a.epochs * 0.75)), job_dir=job, print_freq=10**6, seed=a.seed,
        mesh_shape=(n,), mesh_axes=("data",), corr_mode="gather" if mode == "single" else mode,
    )
    data = get_data("synthetic", job, a.batch, a.batch, a.seed)
    if a.smoke:
        data.loader_test = head(data.loader_test, SMOKE_TEST_IMAGES)
    result = fit(cfg, data, max_steps=2 if a.smoke else None, device=a.device)
    curve = []
    test = Path(job) / "run" / "test.jsonl"
    if test.exists():  # rank 0 writes the metrics
        curve = [json.loads(line)["top1"] for line in test.read_text().splitlines()]
    duals = result["state"].admm_duals
    gamma = sum(float(d.gamma.abs().mean()) for d in duals.values()) / max(len(duals), 1)
    return {"mode": mode, "mesh": [n], "final_top1": curve[-1] if curve else None, "best_top1": result["best_top1"],
            "epochs_to_100": next((i + 1 for i, c in enumerate(curve) if c >= 100.0), None), "curve": curve,
            "mean_gamma_mag": gamma}


def _args(a) -> list:
    out = ["--epochs", str(a.epochs), "--batch", str(a.batch), "--bits", str(a.bits), "--lr", str(a.lr),
           "--seed", str(a.seed)]
    return out + (["--smoke"] if a.smoke else []) + (["--device", a.device] if a.device else [])


def ranks(mode: str, a, job: str) -> dict:
    """The run over RANKS gloo ranks, each a subprocess; rank 0's record."""
    from alignq_tpu_torch.entry import free_port

    port, out = str(free_port()), os.path.join(job, "rank0.json")
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parents[2]), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-m", "alignq_tpu_torch.tools.corr_mode_ab", "--rank", str(r),
                               "--port", port, "--mode", mode, "--job", job, "--out", out, *_args(a)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]
    try:
        for r, p in enumerate(procs):
            log, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            if p.returncode:
                raise RuntimeError(f"{mode} rank {r} exited {p.returncode}:\n{log[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    with open(out) as f:
        return json.load(f)


def parse_args(argv=None):
    """The tool's arguments, --smoke applied (1 epoch at batch 8)."""
    p = argparse.ArgumentParser(description="accuracy A/B of the ADMM corr modes over several epochs")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch", type=int, default=128, help="the global batch")
    p.add_argument("--bits", type=int, default=4)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke", action="store_true", help="1 epoch of 2 steps at batch 8, 16 test images")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", default=None, help=argparse.SUPPRESS)
    p.add_argument("--mode", default=None, help=argparse.SUPPRESS)
    p.add_argument("--job", default=None, help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.smoke:
        a.epochs, a.batch = 1, 8
    return a


def main(argv=None) -> list:
    a = parse_args(argv)

    from alignq_tpu_torch.device import resolve_device
    from alignq_tpu_torch.dist import multihost

    if a.rank is not None:  # one rank of a 2-rank run
        dev = multihost.initialize(f"127.0.0.1:{a.port}", RANKS, a.rank, device=a.device, backend="gloo",
                                   timeout_s=RANK_TIMEOUT_S)
        a.device = str(dev)
        rec = run(a.mode, RANKS, a, a.job)
        if a.rank == 0:
            with open(a.out, "w") as f:
                json.dump(rec, f)
        multihost.shutdown()
        return [rec]

    from alignq_tpu_torch.utils.launches import device_line

    dev = resolve_device(a.device)
    print(json.dumps({"card": device_line(dev), "mesh": f"{RANKS} gloo ranks, one process each"}), flush=True)
    rows = {}
    for mode in MODES:
        with tempfile.TemporaryDirectory(prefix=f"corr_ab_{mode}_") as job:
            rows[mode] = run(mode, 1, a, job) if mode == "single" else ranks(mode, a, job)
        print(json.dumps(rows[mode]), flush=True)
    g, loc = rows["gather"], rows["local"]
    slower = (loc["epochs_to_100"] or a.epochs + 1) > (g["epochs_to_100"] or a.epochs + 1)
    summary = {"summary": True, "epochs": a.epochs, "batch": a.batch, "bits": a.bits,
               **{f"{m}_best": r["best_top1"] for m, r in rows.items()},
               "local_minus_gather_final_pts": loc["final_top1"] - g["final_top1"],
               "local_minus_gather_best_pts": loc["best_top1"] - g["best_top1"],
               "recommendation": "gather" if slower or loc["best_top1"] < g["best_top1"] - 0.5 else "local"}
    print(json.dumps(summary), flush=True)
    return list(rows.values()) + [summary]


if __name__ == "__main__":
    main()
