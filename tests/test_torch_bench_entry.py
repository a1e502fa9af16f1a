"""The port's entry points: alignq_tpu_torch/bench.py's one-line output
(the contract tests/test_bench_smoke.py holds bench.py to, on the CPU at
its smoke size) and alignq_tpu_torch/entry.py."""

import json
import os
import subprocess
import sys

import pytest
import torch

from alignq_tpu_torch import bench
from alignq_tpu_torch.entry import dryrun_multichip, entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_smoke_prints_one_json_line():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2")  # the suite runs several test processes at once
    proc = subprocess.run([sys.executable, "-m", "alignq_tpu_torch.bench", "--smoke", "--device", "cpu"], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, f"expected ONE JSON line, got: {lines!r}"
    row = json.loads(lines[0])
    ceiling = {"frac_of_achievable", "frac_of_nominal", "conv_ceiling_ms", "epilogue_isolated_ms",
               "residual_vs_mandatory"}
    assert set(row) == {"metric", "value", "unit", "batch", "vs_baseline", "device"} | ceiling
    assert all(row[k] is None for k in ceiling)  # measured on a card only
    assert row["unit"] == "images/sec" and row["batch"] == 64 and row["device"] == "cpu"
    assert row["value"] > 0 and row["vs_baseline"] >= 0


def test_bench_analytic_ops():
    """bench.py's count: ~40.6 M int8 multiply-adds an image, doubled."""
    assert bench.resnet20_analytic_ops(1) == 2 * 64 * 10 + sum(
        c * 2 * k * k * ci * co * (hw // s) ** 2 for c, ci, co, hw, k, s in bench.RESNET20_CONVS)
    assert 81e6 < bench.resnet20_analytic_ops(1) < 82e6
    assert bench.resnet20_analytic_ops(2048) == 2048 * bench.resnet20_analytic_ops(1)


def test_bench_defaults_to_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.main(["--smoke"])


def test_entry_runs_on_the_cpu():
    fn, args = entry(device="cpu")
    logits = fn(*args)
    assert logits.shape == (8, 10) and torch.isfinite(logits).all()
    assert args[1].shape == (8, 32, 32, 3) and float(args[1].abs().sum()) == 0.0


def test_dryrun_multichip_waits_for_distribution():
    """The dry run is data-parallel on the cards by default: without CUDA
    its ranks raise, and so does the call (the CPU run, device='cpu', is
    tests/test_torch_dist_train.py's)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dryrun_multichip(2)
