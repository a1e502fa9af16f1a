"""Data-parallel domain adaptation (alignq_tpu_torch/train/da.py), gather
mode, on the CPU: 2 gloo ranks (subprocesses, torch only) against 1
process over the same global batches, in float64 within 1e-9:
- the digit DANN (W8A8, ADMM on and off; its channel dropout's masks
  drawn for the global batch, each rank keeping its rows), 3 steps: every
  parameter, statistic and dual, and the target top-1;
- DSAN on a ResNet-18 trunk (W4A4), 2 steps: LMMD's kernel matrices over
  both domains' gathered features;
and JAX's refusals (tests/test_train_dist.py:187-253): 'local', a
compressed gradient mean, a 'model' axis.
"""

import numpy as np
import pytest
from torch_port_helpers import run_ranks

from alignq_tpu_torch.models import MNISTModelQuant
from alignq_tpu_torch.train.da import DAConfig, fit_dann

TOL = dict(rtol=1e-9, atol=1e-9)


def _da(tmp_path, n, **spec):
    spec = dict(kind="da", job=str(tmp_path / f"job{n}"), out=str(tmp_path / f"out{n}_{{rank}}.npz"), **spec)
    run_ranks(n, spec, tmp_path)
    return [dict(np.load(tmp_path / f"out{n}_{r}.npz")) for r in range(n)]


def _assert_equal_runs(two, one):
    assert set(two[0]) == set(one[0])
    for k, v in one[0].items():
        np.testing.assert_allclose(two[0][k], v, **TOL, err_msg=k)
        np.testing.assert_allclose(two[1][k], v, **TOL, err_msg=k)


@pytest.mark.parametrize("admm", [True, False], ids=["admm", "no_admm"])
def test_digit_dann_gather_fit_equals_one_process(tmp_path, admm):
    spec = dict(task="digit", bits=8, admm=admm, steps=3)
    one = _da(tmp_path, 1, **spec)
    _assert_equal_runs(_da(tmp_path, 2, **spec), one)
    assert int(one[0]["step"]) == 3 and sum(k.startswith("a:") for k in one[0]) == (2 if admm else 0)


def test_dsan_gather_steps_equal_one_process(tmp_path):
    spec = dict(task="dsan", bits=4, admm=False, steps=2)
    one = _da(tmp_path, 1, **spec)
    _assert_equal_runs(_da(tmp_path, 2, **spec), one)


@pytest.mark.parametrize("kw, error, match", [
    (dict(corr_mode="local"), ValueError, "gather"),
    (dict(grad_compression="bf16"), ValueError, "grad_compression"),
    (dict(mesh_shape=(4, 2), mesh_axes=("data", "model")), ValueError, "data axis"),
])
def test_refusals(tmp_path, kw, error, match):
    base = dict(train_batch_size=8, eval_batch_size=8, bitW=4, abitW=4, num_classes=10, job_dir=str(tmp_path),
                mesh_shape=(8,), mesh_axes=("data",))
    with pytest.raises(error, match=match):
        fit_dann(DAConfig(**{**base, **kw}), {}, MNISTModelQuant(w_bit=4, a_bit=4), max_steps=1, device="cpu")
