"""Entry points of the port (the JAX package's __graft_entry__.py):
`entry` gives a forward and its arguments; `dryrun_multichip` runs one
ADMM QAT step over a ('data', 'model') mesh of n ranks, then one
data-parallel step in local mode.

    python -m alignq_tpu_torch.entry --dryrun 2 --device cpu
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from pathlib import Path

import torch


def entry(device=None):
    """(fn, example_args): the W8A8 eval forward of the port's
    resnet20_quant (ResNet-20 CIFAR-10, CDF alignment; random weights from
    seed 0) on 8 zero images, on `device` (default the CUDA card).
    fn(model, x) -> logits (8, 10)."""
    from alignq_tpu_torch.device import resolve_device
    from alignq_tpu_torch.models.resnet_cifar import resnet20_quant

    dev = resolve_device(device)
    model = resnet20_quant(bitW=8, abitW=8, method="ours", generator=torch.Generator().manual_seed(0)).to(dev)
    x = torch.zeros((8, 32, 32, 3), device=dev)

    def forward(model, x):
        with torch.no_grad():
            return model(x, train=False)

    return forward, (model, x)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device=None, backend=None, timeout_s: float = 600.0) -> None:
    """One full ADMM W4A4 QAT train step of ResNet-20 on 16x16 images in
    each corr mode, as the JAX package's: 'gather' over a (n/2, 2)
    ('data', 'model') mesh where n_devices is even and above 1 (the
    kernels column-parallel over the model axis; else (n, 1)), then
    'local' with per-rank duals over an (n,) data mesh (local mode takes
    no model axis). n_devices ranks, each a subprocess of this
    interpreter joined over torch.distributed. On the cards (device None)
    NCCL, one card a rank, unless backend='gloo'; device='cpu' runs gloo
    on the CPU. Raises if a rank fails or outlasts timeout_s."""
    port = free_port()
    root = str(Path(__file__).resolve().parents[1])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep)}
    cmd = [sys.executable, "-m", "alignq_tpu_torch.entry", "--rank", None, "--dryrun", str(n_devices),
           "--port", str(port), "--device", device or "", "--backend", backend or ""]
    procs = []
    for r in range(n_devices):
        cmd[4] = str(r)
        procs.append(subprocess.Popen(list(cmd), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs, failed = [], []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout_s)
            outs.append(out)
            if p.returncode != 0:
                failed.append(f"rank {r} exited {p.returncode}:\n{out}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError("dryrun_multichip failed: " + "\n".join(failed))
    print("".join(line + "\n" for line in outs[0].splitlines() if line.startswith("dryrun_multichip")), end="")


def _dryrun_rank(rank: int, n: int, port: int, device, backend) -> None:
    """One rank of dryrun_multichip."""
    from alignq_tpu_torch.dist import make_mesh, multihost
    from alignq_tpu_torch.dist.corr import create_local_duals, make_local_corr_train_step
    from alignq_tpu_torch.dist.sharding import shard_model
    from alignq_tpu_torch.models.resnet_cifar import resnet20_quant
    from alignq_tpu_torch.train import TrainConfig, create_train_state, make_train_step

    dev = multihost.initialize(f"127.0.0.1:{port}", n, rank, device=device, backend=backend, timeout_s=300)
    model_par = 2 if n % 2 == 0 and n > 1 else 1
    data_par = n // model_par
    batch = max(data_par * 4, 8)
    g = torch.Generator().manual_seed(1)
    # random, not zeros: the corr standardization divides by per-feature std
    x = torch.randn((batch, 16, 16, 3), generator=g)
    y = torch.randint(0, 10, (batch,), generator=g)
    for mode, seed, shape in (("gather", 0, (data_par, model_par)), ("local", 3, (n, 1))):
        mesh = make_mesh(shape, ("data", "model"))
        cfg = TrainConfig(train_batch_size=batch, eval_batch_size=batch, bitW=4, abitW=4, admm=True, num_epochs=1,
                          mesh_shape=shape, mesh_axes=("data", "model"), corr_mode=mode)
        gen = torch.Generator().manual_seed(seed)
        model = resnet20_quant(bitW=4, abitW=4, method="ours", admm=True, generator=gen).to(dev)
        state = create_train_state(gen, model, cfg, input_shape=(1, 16, 16, 3), steps_per_epoch=10)
        if mode == "local":
            state.admm_duals = create_local_duals(torch.Generator().manual_seed(seed + 1), list(state.admm_duals),
                                                  cfg, n, mesh.rank, device=dev)
            step = make_local_corr_train_step(model, cfg, mesh)
        else:
            state.tx.shards = {k: (v.axis, v.dim) for k, v in shard_model(model, mesh).items()}
            step = make_train_step(model, cfg, mesh)
        b = batch // shape[0]
        rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
        _, metrics = step(state, x[rows].to(dev), y[rows].to(dev))
        loss = float(metrics["loss"])
        if not torch.isfinite(torch.tensor(loss)):
            raise RuntimeError(f"dryrun_multichip: non-finite loss in {mode} mode")
        if rank == 0:
            print(f"dryrun_multichip ok ({mode} corr): mesh=({shape[0]}x{shape[1]}) loss={loss:.4f}", flush=True)
    multihost.shutdown()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="the port's entry points")
    ap.add_argument("--dryrun", type=int, default=None, metavar="N", help="dryrun_multichip(N)")
    ap.add_argument("--rank", type=int, default=None, help="(internal) run one rank of the dry run")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--device", default="")
    ap.add_argument("--backend", default="")
    a = ap.parse_args()
    if a.rank is not None:
        _dryrun_rank(a.rank, a.dryrun, a.port, a.device or None, a.backend or None)
    elif a.dryrun is not None:
        dryrun_multichip(a.dryrun, a.device or None, a.backend or None)
    else:
        fn, args = entry()
        print("entry forward:", tuple(fn(*args).shape))
