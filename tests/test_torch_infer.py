"""alignq_tpu_torch/kernels/infer.py (on the CPU, where the kernels run
their plain versions) against alignq_tpu/kernels/infer.py under jax.jit,
on the same numpy inputs.

The whole-forward cases run a small PreAct net (2 blocks a stage, 16x16
images, batch 4) with numpy-drawn weights and non-trivial BN statistics,
converted by the JAX package and carried across with `interop`. JAX runs
its XLA formulation (its Pallas routes are not run here); the port runs
every knob, the slice's K1 + K3 route included. Tolerances: integer codes,
streams and pooled features are bit-identical for every act_impl; logits
agree within atol 1e-5 (the port evaluates the head in float64, JAX in
f32).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignq_tpu.kernels import infer as J
from alignq_tpu.kernels.convert import QConvInt8 as JQConv
from alignq_tpu_torch import interop
from alignq_tpu_torch.kernels import infer as T
from alignq_tpu_torch.kernels.convert import QConvInt8 as TQConv
from torch_port_helpers import random_preact_tree

BATCH, HW = 4, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _qconv(rng, k, cin, cout):
    return (
        rng.randint(-127, 128, (k, k, cin, cout)).astype(np.int8),
        (rng.rand(cout) * 2e-3 - 5e-4).astype(np.float32),
        (rng.randn(cout) * 0.5).astype(np.float32),
    )


def _both(q):
    return JQConv(*(jnp.asarray(a) for a in q)), TQConv(*(_t(a) for a in q))


def _h(seed, n=1 << 14):
    return (np.random.RandomState(seed).randn(n) * 2).astype(np.float32)


# ---------------------------------------------------------------- helpers


@pytest.mark.parametrize("has_skip", [[False] * 3 + [True, False, False] * 2, [False, True, True, False]])
def test_residual_multipliers(has_skip):
    assert T.residual_multipliers(has_skip) == J.residual_multipliers(has_skip)
    assert T.residual_bounds(has_skip) == J.residual_bounds(has_skip)


def test_constants():
    for name in ("ACT_SCALE", "S_IMG", "ACT_RANGE"):
        assert getattr(T, name) == getattr(J, name)


@pytest.mark.parametrize(
    "act_bits,impl", [(8, "erf"), (4, "erf"), (8, "poly"), (4, "poly"), (4, "bins"), (2, "bins")]
)
def test_erfq_codes_exact(act_bits, impl):
    h = _h(act_bits)
    want = jax.jit(lambda v: J._erfq_codes(v, act_bits, impl))(h)
    got = T._erfq_codes(_t(h), act_bits, impl)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bins_rejects_a8():
    with pytest.raises(ValueError):
        T._erfq_codes(torch.zeros(4), 8, "bins")


def test_linear_q_exact():
    x = _h(3)
    want = jax.jit(lambda v: J._linear_q(v, J.S_IMG))(x)
    np.testing.assert_array_equal(T._linear_q(_t(x), T.S_IMG).numpy(), np.asarray(want))


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("g,signed", [(127, False), (127, True), (7, False)])
def test_requant_codes_exact(m, g, signed):
    k = np.arange(-600 if signed else 0, 601).astype(np.int16)
    want = jax.jit(lambda v: J._requant_codes(v, m, float(g), signed))(k)
    got = T._requant_codes(_t(k), m, float(g), signed)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_requant_needs_int_m():
    with pytest.raises(TypeError):
        T._requant_codes(torch.zeros(3, dtype=torch.int16), 2.0, 127.0)


@pytest.mark.parametrize("stride,padding,cin", [(1, 1, 3), (2, 1, 16), (1, 0, 32)])
def test_int8_conv_exact(stride, padding, cin):
    rng = np.random.RandomState(cin + stride)
    x = rng.randint(-127, 128, (2, 8, 8, cin)).astype(np.int8)
    jq, tq = _both(_qconv(rng, 3, cin, 32))
    acc = jax.jit(lambda a: J._int8_conv_acc(a, jq, stride, padding))(x)
    np.testing.assert_array_equal(T._int8_conv_acc(_t(x), tq, stride, padding).numpy(), np.asarray(acc))
    h = jax.jit(lambda a: J._int8_conv(a, jq, stride, padding))(x)
    np.testing.assert_array_equal(T._int8_conv(_t(x), tq, stride, padding).numpy(), np.asarray(h))


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_1x1_route_exact(stride):
    """The K1 1x1 route computes what XLA's 1x1 pad-0 conv does."""
    rng = np.random.RandomState(7 + stride)
    x = rng.randint(0, 128, (2, 8, 8, 16)).astype(np.int8)
    jq, tq = _both(_qconv(rng, 1, 16, 32))
    want = jax.jit(lambda a: J._int8_conv(a, jq, stride, 0))(x)
    got = T._int8_conv_1x1_pallas(_t(x), tq, stride)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_merged_skip_exact():
    rng = np.random.RandomState(11)
    x = rng.randint(0, 128, (2, 8, 8, 16)).astype(np.int8)
    (j0, t0), (js, ts) = _both(_qconv(rng, 3, 16, 32)), _both(_qconv(rng, 1, 16, 32))
    want = jax.jit(lambda a: J._int8_conv_merged_skip(a, j0, js, 2))(x)
    got = T._int8_conv_merged_skip(_t(x), t0, ts, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("act_bits", [4, 2])
def test_int_cutpoints_and_bin_codes_exact(act_bits):
    rng = np.random.RandomState(act_bits)
    q = _qconv(rng, 3, 16, 32)
    q[1][:3] = [0.0, -1e-3, 1e-3]  # a degenerate channel and a negative scale
    jq, tq = _both(q)
    jcut, tcut = J.act_int_cutpoints(jq, act_bits), T.act_int_cutpoints(tq, act_bits)
    for k in ("sgn", "t1", "t2"):
        np.testing.assert_array_equal(tcut[k].numpy(), np.asarray(jcut[k]))
    acc = rng.randint(-40000, 40000, (2, 4, 4, 32)).astype(np.int32)
    want = jax.jit(J._int_bin_codes)(acc, jcut)
    np.testing.assert_array_equal(T._int_bin_codes(_t(acc), tcut).numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "has_skip,runs",
    [([False] * 3 + [True, False, False] * 2, [(0, 3), (4, 6), (7, 9)]),
     ([True, False, True, True], [(1, 2)]), ([False, False], [(0, 2)])],
)
def test_identity_runs(has_skip, runs):
    layers = [{"skip": 0} if s else {} for s in has_skip]
    assert T._identity_runs(layers) == runs


def test_stage_kernel_chunk_divides_batch():
    for c, h, batch in ((16, 32, 2048), (32, 16, 7), (64, 8, 1)):
        chunk = T._stage_kernel_chunk_imgs(c, h, h, batch)
        assert chunk >= 1 and batch % chunk == 0


# ---------------------------------------------------------- whole forward


@functools.lru_cache(maxsize=None)
def _net(bits):
    """(JAX qparams, port qparams) of one small net, and the images."""
    params, stats = random_preact_tree(14, seed=20 + bits)
    jq = J.convert_preact_resnet(params, stats, weight_bits=bits, act_bits=bits)
    if bits <= 4:
        jq = J.augment_int_cutpoints(jq, bits)
    tq = interop.qparams_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    x = np.random.RandomState(bits).randn(BATCH, HW, HW, 3).astype(np.float32)
    return jq, tq, x


def _identity_head(q, eye):
    return {**q, "logit": {"kernel": eye, "bias": eye[0] * 0}}


@functools.lru_cache(maxsize=None)
def _jax_forward(bits, act_impl, stream, fuse_skip):
    """JAX's XLA formulation: (logits, pooled features * act_scale)."""
    jq, _, x = _net(bits)
    fwd = functools.partial(
        J.resnet20_int8_forward, act_bits=bits, act_impl=act_impl, stream=stream, fuse_skip=fuse_skip
    )
    eye = jnp.eye(64, dtype=jnp.float32)
    run = jax.jit(lambda q, x: (fwd(q, x), fwd(_identity_head(q, eye), x)))
    return tuple(np.asarray(a) for a in run(jq, x))


CASES = [
    # act_bits, act_impl, stream, knobs
    (8, "erf", "int16", {}),
    (8, "erf", "int8", {}),
    (8, "erf", "int16", {"use_pallas_1x1": True}),
    (8, "erf", "int16", {"fuse_skip": True}),
    (8, "poly", "int16", {}),
    (8, "poly", "int8", {}),
    (8, "poly", "int16", {"fuse_skip": True}),
    (8, "poly", "int16", {"use_pallas_1x1": True}),
    (8, "poly", "int16", {"use_stage_kernel": True}),
    (8, "poly", "int16", {"use_stage_kernel": True, "use_pallas_1x1": True}),  # the slice's route
    (4, "poly", "int16", {"use_stage_kernel": True}),
    (4, "bins", "int16", {}),
    (4, "bins", "int8", {}),
    (4, "bins_int", "int16", {}),
    (4, "bins_int", "int8", {}),
]


@pytest.mark.parametrize("bits,act_impl,stream,knobs", CASES)
def test_forward_matches_jax(bits, act_impl, stream, knobs):
    jq, tq, x = _net(bits)
    want_logits, want_feat = _jax_forward(bits, act_impl, stream, knobs.get("fuse_skip", False))
    kw = dict(act_bits=bits, act_impl=act_impl, stream=stream, **knobs)
    logits = T.resnet20_int8_forward(tq, _t(x), **kw)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0, atol=1e-5)

    out_c = T.resnet20_int8_stream(tq, _t(x), **kw)
    assert out_c.dtype == torch.int16 and tuple(out_c.shape) == (BATCH, HW // 4, HW // 4, 64)
    feat = T.resnet20_int8_head(_identity_head(tq, torch.eye(64)), out_c, bits).numpy()
    np.testing.assert_array_equal(feat, want_feat)

    # each route of the port gives the plain route's stream exactly
    plain = T.resnet20_int8_stream(tq, _t(x), act_bits=bits, act_impl=act_impl, stream=stream)
    assert torch.equal(out_c, plain)
    # and so do the weights laid out once, as an engine serves them
    packed = T.resnet20_int8_stream(tq, _t(x), operands=T.pack_int8_operands(tq), **kw)
    assert torch.equal(out_c, packed)


def _to_jax(tree):
    if isinstance(tree, TQConv):
        return JQConv(*(jnp.asarray(t.numpy()) for t in tree))
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(tree.numpy()) if torch.is_tensor(tree) else tree


def test_jax_serves_port_conversion():
    """The port's own conversion is a qparams tree the JAX forward takes,
    and both forwards give the same logits on it. (Its weight codes may
    differ from the JAX converter's at CDF rounding ties: test_torch_convert.)"""
    params, stats = random_preact_tree(14, seed=28)
    pt, st = interop.params_from_numpy(params, stats, "cpu")
    tq = T.convert_preact_resnet(pt, st)
    x = np.random.RandomState(8).randn(BATCH, HW, HW, 3).astype(np.float32)
    got = T.resnet20_int8_forward(tq, _t(x), act_impl="poly")
    want = jax.jit(functools.partial(J.resnet20_int8_forward, act_impl="poly"))(_to_jax(tq), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_augment_int_cutpoints_equal():
    jq, tq, _ = _net(4)
    plain = {k: v for k, v in tq.items() if k != "conv0_cut"}
    plain["layers"] = [{k: v for k, v in b.items() if not k.startswith("cut")} for b in tq["layers"]]
    got = T.augment_int_cutpoints(plain, 4)
    for gb, wb in zip(got["layers"], tq["layers"]):
        for k in ("cut0", "cut1", "cut_skip"):
            assert (k in gb) == (k in wb)
            if k in wb:
                for f in ("sgn", "t1", "t2"):
                    assert torch.equal(gb[k][f], wb[k][f])


def test_bins_int_guards():
    _, tq, x = _net(4)
    with pytest.raises(ValueError, match="act_bits"):  # cutpoints built for A4, forward at A2
        T.resnet20_int8_forward(tq, _t(x), act_bits=2, act_impl="bins_int")
    _, tq8, _ = _net(8)
    with pytest.raises(ValueError, match="augment_int_cutpoints"):
        T.resnet20_int8_forward(tq8, _t(x), act_bits=4, act_impl="bins_int")
    with pytest.raises(ValueError):
        T.resnet20_int8_forward(tq, _t(x), act_bits=4, act_impl="bins_int", use_pallas_1x1=True)


@pytest.mark.parametrize(
    "kw", [{"use_stage_kernel": True, "act_impl": "erf"}, {"use_stage_kernel": True, "act_impl": "poly", "stream": "int8"},
           {"stream": "int4"}]
)
def test_knob_guards(kw):
    _, tq, x = _net(8)
    with pytest.raises(ValueError):
        T.resnet20_int8_forward(tq, _t(x), **kw)


def test_build_resnet20_int8_cpu():
    fwd, (qp, x) = T.build_resnet20_int8(2, device="cpu")
    out = fwd(qp, x, act_impl="poly", use_stage_kernel=True, use_pallas_1x1=True)
    assert out.shape == (2, 10) and torch.isfinite(out).all()


def test_operands_carry_bins_int_cutpoints():
    """pack_int8_operands lays out each site's bins_int cutpoints once, at
    K1's padded width; operands packed without them are refused."""
    _, tq, x = _net(4)
    ops = T.pack_int8_operands(tq)
    assert ops["conv0_cut"].impl == "bins_int" and ops["conv0_cut"].t1.shape[1] == ops["conv0"].wt.shape[0]
    for blk, bops in zip(tq["layers"], ops["layers"]):
        for key, conv in (("cut0", "conv0"), ("cut1", "conv1"), ("cut_skip", "skip")):
            assert (key in bops) == (key in blk)
            if key in blk:
                assert bops[key].sgn.shape == (bops[conv].wt.shape[0],)
                assert torch.equal(bops[key].t1[:, : blk[key]["t1"].shape[1]], blk[key]["t1"])
    plain = {k: v for k, v in tq.items() if k != "conv0_cut"}
    plain["layers"] = [{k: v for k, v in b.items() if not k.startswith("cut")} for b in tq["layers"]]
    with pytest.raises(ValueError, match="operands lack"):
        T.resnet20_int8_forward(tq, _t(x), act_bits=4, act_impl="bins_int", operands=T.pack_int8_operands(plain))
