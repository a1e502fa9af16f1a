"""The baseline quantizers of alignq_tpu_torch (quant/baselines.py, the
method dispatch of nn/layers.py and the orderings of
models/resnet_cifar.py) against the JAX package's.

- Every baseline function's value and gradients (its STE or custom
  backward, through jax.vjp and torch.autograd on one numpy cotangent)
  against jitted JAX: at f64 within 1e-12; at f32 within F32_TOL (a mean
  or std summed in another order, tanh's last bit; no code moved on these
  inputs), the gradients' sums within F32_TOL of their largest element.
  Bits 1, 2, 4 and 8 where the function takes them; APoT's power and
  non-power paths; LLSQ's per-channel and per-tensor paths.
- Ties: inputs on APoT's level midpoints go to the lower level in both;
  LLSQ's octave search on exact ties (every scale reconstructs alike) and
  on near-ties at f64 (identical) and f32 (flips counted, at most
  LLSQ_F32_FLIPS of the channels within 1e-6 of a tie: the three summed
  errors reduce in another order; none flipped on the random inputs of
  the function tests).
- ResNet-20 at W4A4 for each of the ten methods (ADMM where it has
  sites): the port's parameter and statistic names are flax's paths, and
  three f64 SGD steps from JAX's init equal JAX's within 1e-9 (params,
  statistics, duals); the training CLI runs each method on the CPU.
"""

import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)
from torch_port_helpers import affine_bn_tree, f64_tree, flat_names, to_port_layout

from alignq_tpu.models.resnet_cifar import PreActResNet as JNet
from alignq_tpu.quant import baselines as JB
from alignq_tpu.train import state as jstate
from alignq_tpu.train import steps as jsteps
from alignq_tpu.train.config import TrainConfig as JConfig
from alignq_tpu_torch.interop import duals_from_jax, load_flax_tree
from alignq_tpu_torch.models.resnet_cifar import ORDERING
from alignq_tpu_torch.models.resnet_cifar import PreActResNet as TNet
from alignq_tpu_torch.nn.layers import QConv, QuantAct
from alignq_tpu_torch.quant import baselines as TB
from alignq_tpu_torch.train import state as tstate
from alignq_tpu_torch.train import steps as tsteps
from alignq_tpu_torch.train.config import TrainConfig as TConfig

F64_TOL = dict(rtol=1e-12, atol=1e-12)
F32_TOL = dict(rtol=2e-6, atol=2e-7)
LLSQ_F32_FLIPS = 0.1  # measured: 10 of the 150 engineered near-tie channels
METHODS = ("ours", "uniform", "uniform_admm", "dorefa", "bwn", "bwnf", "lsq", "apot", "llsq", "fp")

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _hwio(rng, shape=(3, 3, 8, 16)):
    return rng.uniform(-1, 1, shape) / np.sqrt(np.prod(shape[:-1]))


# (id, kind, make, fns): kind 'w' (x a conv kernel, HWIO in JAX, OIHW in
# the port) or 'a' (an activation, NHWC / NCHW); make(rng) gives the numpy
# inputs (x, *params); fns(module) the function of them in that module
def _w(rng):
    return (_hwio(rng),)


def _a(rng):
    return (rng.uniform(-0.5, 1.5, (2, 5, 5, 8)),)


def _lsq_w(rng, bits):
    w = _hwio(rng)
    return w, np.asarray(np.abs(w).mean() * 2.0 / np.sqrt(2 ** (bits - 1) - 1))


def _lsq_a(rng, bits):
    return rng.randn(2, 5, 5, 8), np.asarray(0.9 * 2 / np.sqrt(2**bits - 1))


def _llsq_w(rng, per_channel):
    w = _hwio(rng)
    alpha = rng.uniform(0.03, 0.3, (1, 1, 1, 16)) if per_channel else np.asarray(0.11)
    return w, alpha


def _llsq_a(rng):
    return rng.randn(2, 5, 5, 8) * 0.6, np.asarray(0.173)


def _apot_w(rng):
    return _hwio(rng), np.asarray(1.7)


def _apot_a(rng):
    return np.abs(rng.randn(2, 5, 5, 8)) * 4, np.asarray(3.1)


CASES = []
for b in (1, 2, 4, 8, 32):
    for name in ("uniform_weight", "dorefa_weight", "bwn_weight", "bwnf_weight"):
        CASES.append((f"{name}-{b}", "w", _w, lambda m, n=name, b=b: (lambda w: getattr(m, n)(w, b))))
    CASES.append((f"uniform_act-{b}", "a", _a, lambda m, b=b: (lambda a: m.uniform_act(a, b))))
for b in (2, 4, 8):
    CASES.append((f"lsq_weight-{b}", "w", functools.partial(_lsq_w, bits=b),
                  lambda m, b=b: (lambda w, s: m.lsq_quantize(w, s, b, is_activation=False))))
for b in (1, 2, 4, 8):
    CASES.append((f"lsq_act-{b}", "a", functools.partial(_lsq_a, bits=b),
                  lambda m, b=b: (lambda a, s: m.lsq_quantize(a, s, b, is_activation=True))))
for b in (2, 3, 4, 5):  # APoT's weight path: w_bit - 1 bits, power levels from w_bit 3
    CASES.append((f"apot_weight-{b}", "w", _apot_w, lambda m, b=b: (lambda w, al: m.apot_weight(w, al, b))))
for b, power in ((1, False), (2, False), (4, False), (2, True), (3, True), (4, True)):
    CASES.append((f"apot_act-{b}-{'power' if power else 'uniform'}", "a", _apot_a,
                  lambda m, b=b, p=power: (lambda a, al: m.apot_act_quant(a, al, b, p))))
for b in (2, 4, 8):
    for pc in (True, False):
        CASES.append((f"llsq_weight-{b}-{'channel' if pc else 'tensor'}", "w",
                      functools.partial(_llsq_w, per_channel=pc),
                      lambda m, b=b, pc=pc: (lambda w, al: m.llsq_weight_quant(w, al, b, pc))))
    for signed in (True, False):
        CASES.append((f"llsq_act-{b}-{'signed' if signed else 'unsigned'}", "a", _llsq_a,
                      lambda m, b=b, s=signed: (lambda a, al: m.llsq_act_quant(a, al, b, s))))
for b in (8, 16, 32):
    CASES.append((f"quan_alpha-{b}", "p", lambda r: (r.uniform(0.01, 0.7, (1, 1, 1, 16)),),
                  lambda m, b=b: (lambda al: m.quan_alpha(al, b))))


def _to_port(a, kind):
    """A JAX-layout array in the port's layout: a conv kernel or a 4-D
    per-channel parameter HWIO -> OIHW, an activation NHWC -> NCHW."""
    a = np.asarray(a)
    if a.ndim != 4:
        return a
    return np.ascontiguousarray(a.transpose(0, 3, 1, 2) if kind == "a" else a.transpose(3, 2, 0, 1))


def _from_port(a, kind):
    if a.ndim != 4:
        return a
    return a.transpose(0, 2, 3, 1) if kind == "a" else a.transpose(2, 3, 1, 0)


def _jax_value_and_grads(fn, args, g, f64):
    """Jitted JAX: the value and the vjp of the cotangent g."""
    with jax.enable_x64(f64):
        dt = jnp.float64 if f64 else jnp.float32
        out, vjp = jax.vjp(jax.jit(fn), *[jnp.asarray(a, dt) for a in args])
        grads = vjp(jnp.asarray(g, dt))
        return np.asarray(out), [np.asarray(x) for x in grads]


def _port_value_and_grads(fn, kind, args, g, f64):
    """The port on the same inputs in its layouts, results back in JAX's."""
    dtype = torch.float64 if f64 else torch.float32
    kinds = [kind] + ["p"] * (len(args) - 1)
    targs = [torch.tensor(_to_port(a, k), dtype=dtype, requires_grad=True) for a, k in zip(args, kinds)]
    out = fn(*targs)
    grads = torch.autograd.grad(out, targs, torch.tensor(_to_port(g, kind), dtype=dtype))
    return _from_port(out.detach().numpy(), kind), [_from_port(t.numpy(), k) for t, k in zip(grads, kinds)]


def _run(case, dtype):
    name, kind, make, fns = case
    f64 = dtype == "f64"
    npd = np.float64 if f64 else np.float32
    rng = np.random.RandomState(sum(map(ord, name)))
    args = [np.asarray(a, npd) for a in make(rng)]
    with jax.enable_x64(f64):
        shape = jax.eval_shape(fns(JB), *[jnp.asarray(a) for a in args]).shape
    g = rng.randn(*shape).astype(npd)
    return _jax_value_and_grads(fns(JB), args, g, f64), _port_value_and_grads(fns(TB), kind, args, g, f64)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_baseline_function_matches_jax(case, dtype):
    (jout, jgrads), (tout, tgrads) = _run(case, dtype)
    assert tout.shape == jout.shape and tout.dtype == jout.dtype
    if dtype == "f64":
        np.testing.assert_allclose(tout, jout, **F64_TOL)
        for i, (t, j) in enumerate(zip(tgrads, jgrads)):
            np.testing.assert_allclose(t, j, **F64_TOL, err_msg=f"grad {i}")
        return
    # f32: no code moved on these inputs; the gradients' sums within F32_TOL
    # of their largest element
    np.testing.assert_allclose(tout, jout, **F32_TOL)
    for i, (t, j) in enumerate(zip(tgrads, jgrads)):
        np.testing.assert_allclose(t, j, rtol=F32_TOL["rtol"], atol=F32_TOL["rtol"] * max(np.abs(j).max(), 1.0),
                                   err_msg=f"grad {i}")


def test_build_power_value_equals_jax():
    for b in (2, 3, 4, 5, 6):
        np.testing.assert_array_equal(TB.build_power_value(b, True), JB.build_power_value(b, True))
    for b in (1, 2, 3, 4):
        np.testing.assert_array_equal(TB.build_power_value(b, False), JB.build_power_value(b, False))


def _midpoints(b, dtype):
    """Inputs that tie between APoT's neighbouring levels of b bits in
    dtype's arithmetic (|x - lo| == |hi - x| as dtype rounds them: every
    midpoint at f64; at f32 the midpoint's nearest values that do), and the
    lower level of each."""
    lv = JB.build_power_value(b, True).astype(dtype)
    mids, lows = [], []
    for lo, hi in zip(lv[:-1], lv[1:]):
        m = np.asarray((np.float64(lo) + np.float64(hi)) / 2, dtype)
        for x in (m, np.nextafter(m, dtype(2)), np.nextafter(m, dtype(-2))):
            if dtype(x - lo) == dtype(hi - x):
                mids.append(x)
                lows.append(lo)
                break
    return np.asarray(mids, dtype), np.asarray(lows, dtype)


@pytest.mark.parametrize("b", [2, 3, 4, 5])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_apot_ties_on_level_midpoints_go_to_the_lower_level(b, dtype):
    npd = np.float64 if dtype == "f64" else np.float32
    mid, lower = _midpoints(b, npd)
    assert len(mid) >= (1 if dtype == "f32" else len(JB.build_power_value(b, True)) - 1)
    w = np.concatenate([mid, -mid])
    with jax.enable_x64(dtype == "f64"):
        jw = np.asarray(jax.jit(lambda x: JB.apot_weight_quant(x, jnp.asarray(1.0, x.dtype), b, True))(w))
        ja = np.asarray(jax.jit(lambda x: JB.apot_act_quant(x, jnp.asarray(1.0, x.dtype), b, True))(mid))
    tw = TB.apot_weight_quant(torch.tensor(w), torch.tensor(1.0, dtype=torch.tensor(w).dtype), b, True).numpy()
    ta = TB.apot_act_quant(torch.tensor(mid), torch.tensor(1.0, dtype=torch.tensor(mid).dtype), b, True).numpy()
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(ta, lower)
    np.testing.assert_array_equal(tw, np.concatenate([lower, -lower]))


def _octaves_jax(w, a, bit, f64):
    """JAX's LLSQ octave offsets, -grad_alpha / a^2, per channel."""
    with jax.enable_x64(f64):
        _, vjp = jax.vjp(jax.jit(lambda x, al: JB.llsq_weight_quant(x, al, bit, True)), jnp.asarray(w), jnp.asarray(a))
        ga = np.asarray(vjp(jnp.ones(w.shape, w.dtype))[1])
        qa = np.asarray(jax.jit(lambda al: JB.quan_alpha(al, 16))(jnp.asarray(a)))
    return np.rint(-ga / qa**2).reshape(-1)


def _octaves_port(w, a, bit):
    tw, ta = torch.tensor(_to_port(w, "w"), requires_grad=True), torch.tensor(_to_port(a, "p"), requires_grad=True)
    out = TB.llsq_weight_quant(tw, ta, bit, True)
    ga = torch.autograd.grad(out, [tw, ta], torch.ones_like(out))[1].numpy().reshape(-1)
    qa = TB.quan_alpha(ta.detach(), 16).numpy().reshape(-1)
    return np.rint(-ga / qa**2)


def test_llsq_octave_search_on_exact_ties():
    """Channels that every scale reconstructs exactly (all zero, or
    multiples of 2a within range): three equal errors, the first (a/2, an
    offset of -1) wins in both."""
    c = 8
    a = np.full((1, 1, 1, c), 2.0**-3)
    rng = np.random.RandomState(3)
    w = rng.randint(-31, 32, (3, 3, 4, c)) * 2 * a
    w[..., :2] = 0
    for dtype in (np.float64, np.float32):
        wd, ad = w.astype(dtype), a.astype(dtype)
        want = _octaves_jax(wd, ad, 8, dtype == np.float64)
        np.testing.assert_array_equal(want, -np.ones(c))
        np.testing.assert_array_equal(_octaves_port(wd, ad, 8), want)


def _octave_errors(w, a, bit):
    """LLSQ's three summed squared errors (at a/2, a, 2a) of each channel
    of w (..., 9, n) at f64."""
    pwr = 2 ** (bit - 1)
    return np.stack([np.sum((w - np.clip(np.round(w / s), -pwr, pwr - 1) * s) ** 2, axis=-2)
                     for s in (a / 2, a, 2 * a)])


def _near_tie_channels(n=1024, bit=4, rel=1e-9):
    """Channels of 9 weights (3x3x1) whose two lowest octave errors differ
    by ~rel of their size at f64: one weight of each channel is moved, by
    bisection, to where the errors at a/2 and a are equal (each error is
    continuous in it), then off that point by ~rel, to either side."""
    rng = np.random.RandomState(11)
    w = rng.uniform(-1, 1, (9, n))
    a = np.asarray(JB.quan_alpha(jnp.asarray(rng.uniform(0.1, 0.4, n).astype(np.float32)), 16), np.float64)

    def f(t):
        v = w.copy()
        v[0] = t
        e = _octave_errors(v, a, bit)
        return e[0] - e[1], e

    grid = np.linspace(-1, 1, 401)
    vals = np.stack([f(np.full(n, t))[0] for t in grid])
    cross = np.argmax(np.sign(vals[:-1]) != np.sign(vals[1:]), axis=0)
    ok = np.sign(vals[cross, np.arange(n)]) != np.sign(vals[cross + 1, np.arange(n)])
    lo, hi = grid[cross], grid[cross + 1]
    flo = np.sign(vals[cross, np.arange(n)])
    for _ in range(80):
        mid = (lo + hi) / 2
        fm = np.sign(f(mid)[0])
        lo, hi = np.where(fm == flo, mid, lo), np.where(fm == flo, hi, mid)
    t = (lo + hi) / 2 + rng.choice([-1, 1], n) * rel * np.abs(lo) * rng.uniform(1, 10, n)
    d, e = f(t)
    third_above = e[2] > np.maximum(e[0], e[1])
    keep = ok & third_above & (np.abs(d) > 0)
    w[0] = t
    return w[:, keep].reshape(3, 3, 1, -1), a[keep].reshape(1, 1, 1, -1), np.abs(d[keep]) / e[1][keep]


def test_llsq_octave_search_on_near_ties():
    """Channels engineered so that the errors at a/2 and a differ by 1e-9 to
    1e-6 of their size: at f64 (sums exact to ~1e-16) the search equals JAX's on
    every one; at f32 the three sums reduce in another order than XLA's and
    a near-tie can flip: at most LLSQ_F32_FLIPS of the channels."""
    w, a, gap = _near_tie_channels()
    assert w.shape[-1] >= 100 and gap.max() < 1e-6
    want = _octaves_jax(w, a, 4, True)
    assert set(np.unique(want)) <= {-1.0, 0.0} and len(np.unique(want)) == 2  # the tie of a/2 and a, both ways
    np.testing.assert_array_equal(_octaves_port(w, a, 4), want)
    w32, a32 = w.astype(np.float32), a.astype(np.float32)
    flips = (_octaves_port(w32, a32, 4) != _octaves_jax(w32, a32, 4, False)).mean()
    print(f"LLSQ f32 octave flips on {w.shape[-1]} near-tie channels: {flips:.4f}")
    assert flips <= LLSQ_F32_FLIPS


# ------------------------------------------------------- the modules, ResNet-20


def test_qconv_and_quantact_parameters_carry_flax_names_and_inits():
    gen = torch.Generator().manual_seed(0)
    conv = {m: QConv(8, 16, 3, 1, 1, w_bit=4, a_bit=4, method=m, generator=gen) for m in METHODS}
    names = {m: sorted(n for n, _ in c.named_parameters()) for m, c in conv.items()}
    assert names["lsq"] == ["kernel", "lsq_step_a", "lsq_step_w"]
    assert names["apot"] == ["act_alpha", "kernel", "wgt_alpha"]
    assert names["llsq"] == ["alpha_w", "kernel"]
    assert all(names[m] == ["kernel"] for m in METHODS if m not in ("lsq", "apot", "llsq"))
    assert conv["apot"].wgt_alpha.item() == 3.0 and conv["apot"].act_alpha.item() == 8.0
    assert conv["lsq"].lsq_step_a.item() == 1.0
    k = conv["lsq"].kernel.detach()
    assert conv["lsq"].lsq_step_w.item() == TB.lsq_init_step(k, 4, is_activation=False).item()
    alpha = conv["llsq"].alpha_w.detach()
    std = np.sqrt(2.0 / 16) / 0.87962566103423978
    assert alpha.shape == (16, 1, 1, 1) and float(alpha.abs().max()) <= 2 * std
    assert sorted(n for n, _ in QuantAct(4, method="llsq", generator=gen).named_parameters()) == ["alpha"]
    assert 0 <= QuantAct(4, method="llsq", generator=gen).alpha.item() < 1
    with pytest.raises(ValueError, match="unknown quant method"):
        QConv(8, 16, method="lsq2")
    with pytest.raises(ValueError, match="unknown act quant method"):
        QuantAct(4, method="apot")(torch.zeros(2, 3))
    assert QuantAct(32, method="apot")(torch.ones(2)).tolist() == [1.0, 1.0]  # JAX's 32-bit short cut


HW, BATCH, STEPS = 8, 4, 3


def _cfgs(method):
    # ADMM where the method has sites (the 'ours' topology): the JAX
    # package's create_train_state takes admm only with a site to sow
    kw = dict(method=method, train_batch_size=BATCH, bitW=4, abitW=4, admm=ORDERING[method] == "ours", lr=0.02,
              momentum=0.9,
              weight_decay=1e-4, lam=1.0, lam2=4.0, admm_mu=0.2, admm_rho=0.3, lr_decay_steps=(1000,),
              correction_exclude=("conv0",))
    return JConfig(**kw), TConfig(**kw)


def _flat_state(params, stats):
    return {**flat_names(params), **flat_names(stats)}


@pytest.mark.parametrize("method", METHODS)
def test_resnet20_w4a4_three_f64_steps_match_jax(method):
    """ResNet-20 (3 x 3 blocks) at W4A4 (ADMM on the 21 sites of the 'ours'
    topology; the correction, which only 'ours' takes) on 8x8 images,
    batch 4: the port's names are flax's
    paths with flax's shapes; three f64 SGD steps from JAX's init (its
    BatchNorm affine drawn: affine_bn_tree), data and duals carried across,
    equal JAX's within 1e-9. JAX's step runs
    eagerly for the 'ours' topology (an exact-zero residual tie takes the
    other relu branch under jit's contracted adds), jitted for the others."""
    jcfg, tcfg = _cfgs(method)
    jm = JNet(num_units=(3, 3, 3), w_bit=4, a_bit=4, method=method, admm=jcfg.admm)
    with jax.enable_x64(True):
        js = jax.jit(lambda r: jstate.create_train_state(r, jm, jcfg, input_shape=(1, HW, HW, 3),
                                                          steps_per_epoch=10_000))(jax.random.PRNGKey(1))
        params = jax.tree.map(jnp.asarray, affine_bn_tree(f64_tree(jax.device_get(js.params))))
        js = js.replace(params=params, batch_stats=jax.tree.map(jnp.asarray, f64_tree(jax.device_get(js.batch_stats))),
                        admm_duals=jax.tree.map(lambda a: a.astype(jnp.float64), js.admm_duals),
                        opt_state=js.tx.init(params))
    tm = TNet(num_units=(3, 3, 3), w_bit=4, a_bit=4, method=method, admm=tcfg.admm).double()
    want = _flat_state(jax.device_get(js.params), jax.device_get(js.batch_stats))
    own = {**dict(tm.named_parameters()), **dict(tm.named_buffers())}
    assert sorted(own) == sorted(want)
    for n, t in own.items():
        assert tuple(t.shape) == to_port_layout(n, want[n]).shape, n
    load_flax_tree(tm, jax.device_get(js.params), jax.device_get(js.batch_stats))
    ts = tstate.create_train_state(torch.Generator().manual_seed(0), tm, tcfg, input_shape=(1, HW, HW, 3),
                                   steps_per_epoch=10_000)
    assert sorted(ts.admm_duals) == sorted(js.admm_duals)
    assert len(ts.admm_duals) == (21 if ORDERING[method] == "ours" else 0)
    ts.admm_duals = duals_from_jax({k: (np.asarray(s.alter_d), np.asarray(s.gamma))
                                    for k, s in js.admm_duals.items()}, "cpu")
    rng = np.random.RandomState(0)
    jstep, tstep = jsteps.make_train_step(jm, jcfg), tsteps.make_train_step(tm, tcfg)
    if ORDERING[method] != "ours":
        jstep = jax.jit(jstep)
    with jax.enable_x64(True):
        for _ in range(STEPS):
            x, y = rng.randn(BATCH, HW, HW, 3), rng.randint(0, 10, BATCH)
            js, jmet = jstep(js, jnp.asarray(x), jnp.asarray(y))
            ts, tmet = tstep(ts, torch.tensor(x), torch.tensor(y))
            np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-9, atol=1e-9)
    assert ts.step == STEPS
    want = _flat_state(jax.device_get(js.params), jax.device_get(js.batch_stats))
    for n, t in own.items():
        np.testing.assert_allclose(t.detach().numpy(), to_port_layout(n, want[n]), rtol=1e-9, atol=1e-9, err_msg=n)
    for n, s in js.admm_duals.items():
        np.testing.assert_allclose(ts.admm_duals[n].alter_d.numpy(), np.asarray(s.alter_d), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(ts.admm_duals[n].gamma.numpy(), np.asarray(s.gamma), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("method", METHODS)
def test_cli_trains_each_method_on_the_cpu(tmp_path, method):
    """python -m alignq_tpu_torch.train.cli --method <m> on the synthetic
    set, on the CPU: two finite steps of ResNet-20 W4A4 (ADMM where the
    method has sites), then the eval."""
    from alignq_tpu_torch.train import cli

    job = tmp_path / "job"
    args = ["--device", "cpu", "--dataset", "synthetic", "--method", method, "--bitW", "4", "--abitW", "4",
            "--max_steps", "2", "--num_epochs", "1", "--train_batch_size", "8", "--eval_batch_size", "128",
            "--job_dir", str(job), "--print_freq", "1"]
    result = cli.main(args + (["--admm"] if ORDERING[method] == "ours" else []))
    assert result["state"].step == 2 and len(result["state"].admm_duals) == (21 if ORDERING[method] == "ours" else 0)
    losses = [json.loads(line)["loss"] for line in (job / "run" / "train.jsonl").read_text().splitlines()]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert 0 <= result["best_top1"] <= 100
