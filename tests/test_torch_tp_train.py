"""The port's tensor-parallel trainer (alignq_tpu_torch/train/loop.py fit
over a ('data', 'model') mesh, train/steps.py, train/checkpoint.py) on the
CPU: ranks are gloo subprocesses (torch_port_helpers.run_ranks).

- fits of 4 steps of a depth-8 PreActResNet (W8A8 AlignQ with ADMM, and
  LSQ W4A4 for the baseline quantizers' reductions; float64, 8x8 images,
  global batch 8, gather mode) on meshes (1, 2) and (2, 2) equal the
  one-process fit within 1e-9: every logged loss, the whole network's
  parameters (gathered over the model axis), the statistics, duals and
  the replicated tensors' momentum traces;
- each rank's split kernels hold Cout / n_model output channels, and the
  replicated tensors are bit-identical across the model ranks;
- the checkpoint of the (1, 2) fit holds whole tensors: it restores into
  one process, and into a fresh (1, 2) state as its slices;
- JAX's refusals: 'local' with a model axis ("tensor-parallel"), domain
  adaptation with a model axis ("data axis").
"""

import json

import numpy as np
import pytest
from torch_port_helpers import run_ranks

from alignq_tpu_torch.train.config import TrainConfig

TOL = dict(rtol=1e-9, atol=1e-9)
STEPS = 4
CASES = {"ours": dict(bits=8, admm=True, method="ours"), "lsq": dict(bits=4, admm=False, method="lsq")}


def _cases(tmp_path, mesh, **extra):
    return [dict(CASES[m], tag=m, mesh=list(mesh), steps=STEPS, mode="gather",
                 job=str(tmp_path / f"job_{m}_{mesh[0]}x{mesh[1]}"), **extra) for m in CASES]


def _losses(job):
    return [json.loads(line)["loss"] for line in (job / "run" / "train.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """The (1, 2) and (2, 2) fits (the (1, 2) one then restored on its own
    mesh), and the one-process fits, which then restore the (1, 2) fits'
    checkpoints."""
    tmp = tmp_path_factory.mktemp("tp_fits")
    out = {}
    for n, mesh in ((2, (1, 2)), (4, (2, 2))):
        cases = _cases(tmp, mesh)
        if mesh == (1, 2):
            cases = [dict(c, restore=[1, 2], restore_job=c["job"]) for c in cases]
        run_ranks(n, dict(kind="tp_fit", cases=cases, out=str(tmp / f"tp{n}_{{rank}}.npz")), tmp, timeout=400)
        out[mesh] = [dict(np.load(tmp / f"tp{n}_{r}.npz")) for r in range(n)]
    one = [dict(c, restore=[1, 1], restore_job=str(tmp / f"job_{c['tag']}_1x2")) for c in _cases(tmp, (1, 1))]
    run_ranks(1, dict(kind="tp_fit", cases=one, out=str(tmp / "one_{rank}.npz")), tmp, timeout=400)
    out[(1, 1)] = [dict(np.load(tmp / "one_0.npz"))]
    return tmp, out


def _sub(arrays, tag):
    return {k[len(tag) + 1:]: v for k, v in arrays.items() if k.startswith(tag + "/")}


@pytest.mark.parametrize("method", list(CASES))
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_tp_fit_equals_one_process(fits, mesh, method):
    tmp, out = fits
    one = _sub(out[(1, 1)][0], method)
    ranks = [_sub(r, method) for r in out[mesh]]
    np.testing.assert_allclose(_losses(tmp / f"job_{method}_{mesh[0]}x{mesh[1]}"),
                               _losses(tmp / f"job_{method}_1x1"), **TOL)
    sharded = set(ranks[0]["sharded"].tolist())
    assert len(sharded) == 10  # every conv kernel (7 at depth 8, 2 skips) and the head's (64, 10)
    for r, got in enumerate(ranks):
        assert int(got["step"]) == STEPS
        # the whole network, gathered over the model axis, equals one process's
        for k in [k for k in one if k.startswith("p:")]:
            np.testing.assert_allclose(got["w:" + k[2:]], one[k], **TOL, err_msg=f"rank {r} {k}")
        for k in [k for k in one if k[:2] in ("b:", "a:", "g:")]:
            np.testing.assert_allclose(got[k], one[k], **TOL, err_msg=f"rank {r} {k}")
        for k in [k for k in one if k[:2] == "t:" and k[2:] not in sharded]:
            np.testing.assert_allclose(got[k], one[k], **TOL, err_msg=f"rank {r} {k}")
        # each split kernel holds its Cout / n_model output channels
        for name in sharded:
            dim = 0 if one["p:" + name].ndim == 4 else 1
            assert got["p:" + name].shape[dim] * mesh[1] == one["p:" + name].shape[dim], name
            assert got["t:" + name].shape == got["p:" + name].shape
    # the replicated tensors are bit-identical across the model ranks
    for d in range(mesh[0]):
        first = ranks[d * mesh[1]]
        for m in range(1, mesh[1]):
            other = ranks[d * mesh[1] + m]
            for k, v in first.items():
                if k[2:] in sharded or k in ("sharded",):
                    continue
                np.testing.assert_array_equal(other[k], v, err_msg=f"data rank {d}, model rank {m}: {k}")


@pytest.mark.parametrize("method", list(CASES))
def test_tp_checkpoint_restores_whole_and_sliced(fits, method):
    """The (1, 2) fit's checkpoint: into one process, and re-sliced into a
    fresh (1, 2) state, the whole parameters the fit ended with."""
    _, out = fits
    tp = [_sub(r, method) for r in out[(1, 2)]]
    one = _sub(out[(1, 1)][0], method)
    for got in [one] + tp:
        assert int(got["r:step"]) == STEPS
        for k in [k for k in tp[0] if k.startswith("w:")]:
            np.testing.assert_array_equal(got["r:" + k[2:]], tp[0][k], err_msg=k)


def test_jax_refusals_of_a_model_axis(tmp_path):
    from alignq_tpu_torch.data.loader import ArrayLoader, Data
    from alignq_tpu_torch.train.da import DAConfig, fit_dann
    from alignq_tpu_torch.train.loop import fit

    x, y = np.zeros((16, 8, 8, 3), np.float32), np.zeros(16, np.int64)
    data = Data(ArrayLoader(x, y, 16, prefetch=0), ArrayLoader(x, y, 16, prefetch=0))
    cfg = TrainConfig(train_batch_size=16, job_dir=str(tmp_path), mesh_shape=(2, 4), mesh_axes=("data", "model"),
                      corr_mode="local")
    with pytest.raises(ValueError, match="tensor-parallel"):
        fit(cfg, data, device="cpu")
    da = DAConfig(train_batch_size=8, job_dir=str(tmp_path), mesh_shape=(1, 2), mesh_axes=("data", "model"))
    with pytest.raises(ValueError, match="data axis"):
        fit_dann(da, {}, None, device="cpu")
