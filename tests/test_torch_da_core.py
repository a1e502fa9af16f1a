"""The domain-adaptation building blocks of alignq_tpu_torch on the CPU,
against the JAX package: the gradient reversal, LMMD, the MDD loss and its
annealed coefficient, the DANN ramps and schedule, Adam, the dropout, and
the DA data loaders.

- GRL: the identity forward and -alpha * g backward, identical to JAX's;
  LMMD (the cases of tests/test_da.py, and a batch with no class common
  to both domains): values and gradients at f32 (within 1e-6) and f64
  (within 1e-10);
- mdd_loss at f64 within 1e-10, value and gradients;
- dann_lr and dann_schedule equal JAX's values exactly; grl_alpha and
  mdd_grl_coeff, which take an exp, within 4 epsilons of the dtype (XLA's
  exp and torch's differ in the last place);
- adam's steps equal optax.adam's within 1e-12 at f64;
- the dropout keeps x / keep where the mask is set, 0 elsewhere, shares
  its mask over broadcast_dims, and draws the same masks on any device;
- the digit and Office loaders (synthetic domains, MNIST idx files) give
  JAX's batches array for array.
"""

import gzip
import struct

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from alignq_tpu.admm import lmmd as JL
from alignq_tpu.data import datasets as Jds
from alignq_tpu.data import digits as Jdig
from alignq_tpu.data import office as Joff
from alignq_tpu.models import mdd as JM
from alignq_tpu.nn.grl import gradient_reversal as j_grl
from alignq_tpu.optim.schedules import dann_schedule as j_dann_schedule
from alignq_tpu.train import da as JDA
from alignq_tpu_torch.admm.lmmd import gaussian_kernel, lmmd
from alignq_tpu_torch.data import datasets as Tds
from alignq_tpu_torch.data import digits as Tdig
from alignq_tpu_torch.data import office as Toff
from alignq_tpu_torch.models.mdd import mdd_grl_coeff, mdd_loss
from alignq_tpu_torch.nn.dropout import Dropout, fold_in
from alignq_tpu_torch.nn.grl import gradient_reversal
from alignq_tpu_torch.optim import adam, dann_lr, dann_schedule
from alignq_tpu_torch.train.da import grl_alpha

TOLS = {np.float32: dict(rtol=1e-6, atol=1e-6), np.float64: dict(rtol=1e-10, atol=1e-10)}
DTYPES = [np.float32, np.float64]


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


@pytest.mark.parametrize("dtype", DTYPES)
def test_grl_forward_identity_backward_negated(dtype):
    rng = np.random.RandomState(0)
    x, g = rng.randn(4, 6).astype(dtype), rng.randn(4, 6).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        y, vjp = jax.vjp(lambda a: j_grl(a, 0.7), jnp.asarray(x))
        want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = _t(x, True)
    yt = gradient_reversal(xt, 0.7)
    yt.backward(_t(g))
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(y))
    np.testing.assert_array_equal(xt.grad.numpy(), want)  # one rounding of -alpha * g in both


def _lmmd_inputs(case, dtype):
    rng = np.random.RandomState({"identical": 1, "shifted": 2, "grad": 3, "empty": 4}[case])
    b = 6 if case == "grad" else 8
    s = rng.randn(b, 16).astype(dtype)
    t = s.copy() if case == "identical" else (s + 3.0 if case == "shifted" else rng.randn(b, 16).astype(dtype))
    y = np.arange(b, dtype=np.int32) % (3 if case == "grad" else 4)
    if case == "empty":  # no class of the target's argmax among the source labels
        soft = np.eye(31, dtype=dtype)[(y + 10) % 31]
    elif case == "grad":
        soft = rng.dirichlet(np.ones(31), b).astype(dtype)
    else:
        soft = np.eye(31, dtype=dtype)[y]
    return s, t, y, soft


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["identical", "shifted", "grad", "empty"])
def test_lmmd_value_and_grads_match_jax(dtype, case):
    s, t, y, soft = _lmmd_inputs(case, dtype)
    with jax.enable_x64(dtype == np.float64):
        (val, (gs, gt)) = jax.value_and_grad(lambda a, b: JL.lmmd(a, b, jnp.asarray(y), jnp.asarray(soft)),
                                             argnums=(0, 1))(jnp.asarray(s), jnp.asarray(t))
        kern = np.asarray(JL.gaussian_kernel(jnp.asarray(s), jnp.asarray(t)))
    st, tt = _t(s, True), _t(t, True)
    v = lmmd(st, tt, torch.tensor(y), torch.tensor(soft))
    v.backward()
    v = v.detach()
    tol = TOLS[dtype]
    np.testing.assert_allclose(gaussian_kernel(_t(s), _t(t)).numpy(), kern, **tol)
    np.testing.assert_allclose(float(v.detach()), float(val), **tol)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gs), **tol)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt), **tol)
    if case == "identical":
        assert abs(float(v)) < 1e-3
    elif case == "shifted":
        assert float(v) > 0
    elif case == "empty":
        assert float(v) == 0.0  # no common class: every weight 0


def test_mdd_loss_and_grads_match_jax_at_f64():
    rng = np.random.RandomState(0)
    out, adv = rng.randn(8, 5), rng.randn(8, 5)
    adv[6, np.argmax(out[6])] = 40.0  # a target softmax at 1: log(1 - p) clipped at 1e-6
    labels = np.arange(4, dtype=np.int32) % 5
    with jax.enable_x64(True):
        val, grads = jax.value_and_grad(lambda a, b: JM.mdd_loss(a, b, jnp.asarray(labels), 3.0), argnums=(0, 1))(
            jnp.asarray(out), jnp.asarray(adv))
    ot, at = _t(out, True), _t(adv, True)
    v = mdd_loss(ot, at, torch.tensor(labels), 3.0)
    v.backward()
    tol = TOLS[np.float64]
    np.testing.assert_allclose(float(v.detach()), float(val), **tol)
    np.testing.assert_allclose(ot.grad.numpy(), np.asarray(grads[0]), **tol)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(grads[1]), **tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ramps_match_jax(dtype):
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    with jax.enable_x64(dtype == np.float64):
        sched, tsched = j_dann_schedule(0.01 / 10, 37), dann_schedule(0.01 / 10, 37)
        for i in range(60):
            p = i / 41
            assert float(JDA.dann_lr(1e-3, p)) == dann_lr(1e-3, p)  # host math in both
            assert float(sched(jnp.asarray(i, jnp.int32))) == tsched(i)  # f32 in both, even under x64
            # the exp's last place, through the ramps' cancellations
            atol = 4 * np.finfo(dtype).eps
            assert abs(float(JDA.grl_alpha(p)) - grl_alpha(p, tdt)) <= atol
            assert abs(float(JM.mdd_grl_coeff(i, max_iter=41)) - mdd_grl_coeff(i, max_iter=41, dtype=tdt)) <= atol
    assert grl_alpha(0.0) == pytest.approx(0.0, abs=1e-6) and grl_alpha(1.0) > 0.998
    assert mdd_grl_coeff(0) == 0.0 and mdd_grl_coeff(1e9) == pytest.approx(0.1)


def test_adam_matches_optax_at_f64():
    rng = np.random.RandomState(0)
    p0 = {"a": rng.randn(5, 3), "b": rng.randn(7)}
    with jax.enable_x64(True):
        tx = optax.adam(lambda c: 1e-2 / (1.0 + c))
        jp = jax.tree.map(jnp.asarray, p0)
        st = tx.init(jp)
        tp = {k: torch.tensor(v) for k, v in p0.items()}
        ta = adam(lambda c: 1e-2 / (1.0 + c))
        for _ in range(5):
            g = {k: rng.randn(*v.shape) for k, v in p0.items()}
            u, st = tx.update(jax.tree.map(jnp.asarray, g), st, jp)
            jp = optax.apply_updates(jp, u)
            ta.step(tp, {k: torch.tensor(v) for k, v in g.items()})
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-12, atol=1e-12)
    assert ta.count == 5


def test_dropout_masks_scale_and_devices():
    x = torch.randn(6, 5, 3, 3, dtype=torch.float64)
    d = Dropout(0.5, broadcast_dims=(2, 3))
    y = d(x, train=True, rng=fold_in(0, 3))
    kept = (y != 0).any(-1).any(-1)
    assert 0 < kept.float().mean() < 1
    torch.testing.assert_close(y[kept], (x * 2)[kept], rtol=0, atol=0)  # x / 0.5, whole channels
    assert (y[~kept] == 0).all()
    assert torch.equal(y, d(x, train=True, rng=fold_in(0, 3)))  # one (seed, step), one mask
    assert not torch.equal(y, d(x, train=True, rng=fold_in(0, 4)))
    assert torch.equal(d(x, train=False), x) and torch.equal(Dropout(0.0)(x, train=True), x)
    mask = torch.zeros(6, 5, 1, 1, dtype=torch.bool)
    mask[0, 1] = True
    z = d(x, train=True, rng=iter([mask]))
    assert torch.equal(z[0, 1], x[0, 1] * 2) and int((z != 0).sum()) == 9
    with pytest.raises(ValueError, match="rng"):
        d(x, train=True)
    with pytest.raises(ValueError, match="shape"):
        d(x, train=True, rng=iter([torch.ones(6, 5, dtype=torch.bool)]))


def _batches(loader, n=2):
    out = []
    for i, b in enumerate(loader):
        out.append(b)
        if i + 1 == n:
            break
    return out


def _same_batches(a, b):
    ba, bb = _batches(a), _batches(b)
    assert len(a) == len(b) and len(ba) == len(bb) == 2
    for (xa, ya), (xb, yb) in zip(ba, bb):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name,img", [("mnist", 28), ("mnistm", 32), ("svhn", 28)])
def test_digit_loaders_equal_jax(tmp_path, name, img, train):
    _same_batches(Jdig.get_digit_domain(name, str(tmp_path), 16, train=train, img_size=img, seed=3),
                  Tdig.get_digit_domain(name, str(tmp_path), 16, train=train, img_size=img, seed=3))


@pytest.mark.parametrize("train", [True, False])
def test_office_loaders_equal_jax(tmp_path, train):
    j = Joff.get_office_pair(str(tmp_path), "dslr", "webcam", 8, 8, image_size=48)
    t = Toff.get_office_pair(str(tmp_path), "dslr", "webcam", 8, 8, image_size=48)
    for key in ("src_train", "tgt_train") if train else ("src_test", "tgt_test"):
        _same_batches(j[key], t[key])
    for a, b in (Joff.split_train_test(101), Toff.split_train_test(101)), (
            Joff.synthetic_domain("amazon", 20, 31, 16), Toff.synthetic_domain("amazon", 20, 31, 16)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def _write_idx(path, arr):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


def test_mnist_idx_files_read_as_jax(tmp_path):
    rng = np.random.RandomState(0)
    raw = tmp_path / "MNIST" / "raw"
    raw.mkdir(parents=True)
    for name, shape in (("train-images-idx3-ubyte", (40, 28, 28)), ("train-labels-idx1-ubyte", (40,)),
                        ("t10k-images-idx3-ubyte", (20, 28, 28)), ("t10k-labels-idx1-ubyte", (20,))):
        _write_idx(str(raw / (name + ".gz")), rng.randint(0, 10 if "labels" in name else 256, shape))
    want, got = Jds.load_mnist(str(tmp_path)), Tds.load_mnist(str(tmp_path))
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (40, 28, 28, 1) and Tds.load_mnist(str(tmp_path / "none")) is None
    _same_batches(Jdig.get_digit_domain("mnist", str(tmp_path), 8, train=True, img_size=32),
                  Tdig.get_digit_domain("mnist", str(tmp_path), 8, train=True, img_size=32))
