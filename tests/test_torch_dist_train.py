"""The port's data-parallel trainer (alignq_tpu_torch/train/loop.py fit,
train/steps.py, train/checkpoint.py, train/cli.py, entry.py) over
torch.distributed, on the CPU: ranks are gloo subprocesses (torch only),
as tests/test_multihost.py runs JAX's.

- gather mode: a 2-rank fit of 4 steps of a depth-8 PreActResNet (W8A8,
  ADMM on and off, float64, 8x8 images, global batch 8) equals the
  1-process fit over the same global batches within 1e-9: every logged
  loss, every parameter, statistic and dual, the eval top-1; the LSQ and
  LLSQ methods (W4A4) likewise. Rank 0 alone writes the metrics, the log
  file and the config; rank 1 its warnings file;
- JAX's refusals: a train batch the data axis does not divide, 'local'
  with a model axis; a 'model' axis in gather mode builds its step;
- the CLI's mesh flags (tests/test_train_dist.py's cases);
- a local-mode checkpoint (int8_gather) written collectively restores on
  both ranks to the state each trained, its duals in JAX's (N, B/N, B/N)
  layout;
- dryrun_multichip(2) on the CPU: a (1, 2) gather step, a (2,) local one.
"""

import json

import numpy as np
import pytest
import torch
from torch_port_helpers import run_ranks

from alignq_tpu_torch.dist.mesh import Mesh
from alignq_tpu_torch.entry import dryrun_multichip
from alignq_tpu_torch.train.cli import parse_args
from alignq_tpu_torch.train.config import TrainConfig
from alignq_tpu_torch.train.loop import fit
from alignq_tpu_torch.train.steps import make_train_step

TOL = dict(rtol=1e-9, atol=1e-9)


def _fit(tmp_path, n, **spec):
    job = tmp_path / f"job{n}"
    spec = dict(kind="fit", job=str(job), out=str(tmp_path / f"out{n}_{{rank}}.npz"), **spec)
    run_ranks(n, spec, tmp_path)
    losses = [json.loads(line)["loss"] for line in (job / "run" / "train.jsonl").read_text().splitlines()]
    return job, [dict(np.load(tmp_path / f"out{n}_{r}.npz")) for r in range(n)], losses


def _assert_same(a, b, keys=None):
    for k in keys or a:
        np.testing.assert_allclose(a[k], b[k], **TOL, err_msg=k)


@pytest.mark.parametrize("admm", [True, False], ids=["admm", "no_admm"])
def test_gather_fit_equals_one_process(tmp_path, admm):
    spec = dict(bits=8, admm=admm, mode="gather", steps=4)
    job2, (r0, r1), losses2 = _fit(tmp_path, 2, **spec)
    _, (one,), losses1 = _fit(tmp_path, 1, **spec)
    assert len(losses1) == len(losses2) == 4
    np.testing.assert_allclose(losses2, losses1, **TOL)
    assert set(r0) == set(one) and int(r0["step"]) == 4
    assert sum(k.startswith("a:") for k in one) == (9 if admm else 0)
    _assert_same(r0, one)
    _assert_same(r1, r0)
    # rank 0 alone writes the metrics, the log file and the config
    assert (job2 / "config.json").is_file() and (job2 / "logger.log").is_file()
    assert (job2 / "logger.p1.log").is_file() and "Epoch" not in (job2 / "logger.p1.log").read_text()
    assert len((job2 / "run" / "test.jsonl").read_text().splitlines()) == 1


@pytest.mark.parametrize("method", ["lsq", "llsq"])
def test_baseline_gather_fits_equal_one_process(tmp_path, method):
    """LSQ's activation step takes its gradient scale from the global
    batch's size, LLSQ's octave search sums over the global batch."""
    spec = dict(bits=4, admm=False, mode="gather", steps=3, method=method)
    _, (r0, r1), losses2 = _fit(tmp_path, 2, **spec)
    _, (one,), losses1 = _fit(tmp_path, 1, **spec)
    np.testing.assert_allclose(losses2, losses1, **TOL)
    _assert_same(r0, one)
    _assert_same(r1, r0)
    assert any(k.endswith(("lsq_step_a", "alpha")) for k in one)


def test_jax_refusals_and_the_model_axis(tmp_path):
    from alignq_tpu_torch.data.loader import ArrayLoader, Data
    from alignq_tpu_torch.models.resnet_cifar import PreActResNet

    x, y = np.zeros((24, 8, 8, 3), np.float32), np.zeros(24, np.int64)
    data = Data(ArrayLoader(x, y, 12, prefetch=0), ArrayLoader(x, y, 12, prefetch=0))
    cfg = TrainConfig(train_batch_size=12, job_dir=str(tmp_path), mesh_shape=(8,), mesh_axes=("data",))
    with pytest.raises(ValueError, match="not divisible"):
        fit(cfg, data, device="cpu")
    cfg = TrainConfig(train_batch_size=16, job_dir=str(tmp_path), mesh_shape=(2, 4), mesh_axes=("data", "model"),
                      corr_mode="local")
    with pytest.raises(ValueError, match="tensor-parallel"):
        fit(cfg, data, device="cpu")
    # a 'model' axis in gather mode trains (tests/test_torch_tp_train.py): the step builds
    assert callable(make_train_step(PreActResNet(num_units=(1, 1, 1)), TrainConfig(),
                                    Mesh(("data", "model"), (2, 4), None, 0)))
    with pytest.raises(ValueError, match="corr_mode"):
        make_train_step(PreActResNet(num_units=(1, 1, 1)), TrainConfig(corr_mode="ring"),
                        Mesh(("data",), (2,), None, 0))


def test_cli_mesh_flags():
    cfg, *_ = parse_args(["--mesh", "8", "--corr_mode", "local", "--grad_compression", "bf16", "--mxu_bf16"])
    assert tuple(cfg.mesh_shape) == (8,) and cfg.mesh_axes == ("data",)
    assert cfg.corr_mode == "local" and cfg.grad_compression == "bf16" and cfg.mxu_bf16 is True
    cfg, *_ = parse_args(["--mesh", "4", "2"])
    assert tuple(cfg.mesh_shape) == (4, 2) and cfg.mesh_axes == ("data", "model")
    with pytest.raises(SystemExit):
        parse_args(["--dist_backend", "mpi"])


def test_local_checkpoint_restores_on_both_ranks(tmp_path):
    """Each rank trains its own (4, 4) duals; the checkpoint holds them as
    (2, 4, 4), and a fresh state restores, on each rank, to what that
    rank trained."""
    job, outs, _ = _fit(tmp_path, 2, bits=4, admm=True, mode="local", compression="int8_gather", steps=2,
                        restore=True)
    for r, got in enumerate(outs):
        assert int(got["epoch"]) == 1 and int(got["rstep"]) == 2
        trained = {k: v for k, v in got.items() if k[:2] in ("p:", "b:", "a:", "g:", "t:")}
        for k, v in trained.items():
            np.testing.assert_array_equal(got["r" + k], v, err_msg=f"rank {r} {k}")
    duals = [k for k in outs[0] if k.startswith("a:")]
    assert len(duals) == 9 and outs[0][duals[0]].shape == (4, 4)
    assert not np.array_equal(outs[0][duals[0]], outs[1][duals[0]])
    _assert_same(outs[1], outs[0], [k for k in outs[0] if k[:2] in ("p:", "b:", "t:")])
    saved = torch.load(job / "checkpoint" / "epoch_1.pt", weights_only=True)["admm_duals"]
    for k in duals:
        a = saved[k[2:]]["alter_d"].numpy()
        assert a.shape == (2, 4, 4)
        np.testing.assert_array_equal(a[1], outs[1][k])


def test_dryrun_multichip_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert "ok (gather corr): mesh=(1x2)" in out and "ok (local corr): mesh=(2x1)" in out
