"""DenseNet-40 and MobileNet-V2 serving graphs of alignq_tpu_torch on the
CPU, against the JAX package (qparams carried across), and the K1 forms
and kernels those graphs add, through their plain versions."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignq_tpu.kernels import infer as JI
from alignq_tpu.kernels import infer_densenet as JD
from alignq_tpu.kernels import infer_mobilenet as JM
from alignq_tpu_torch import interop
from alignq_tpu_torch.kernels import dwconv as DW
from alignq_tpu_torch.kernels import infer_densenet as TD
from alignq_tpu_torch.kernels import infer_mobilenet as TM
from alignq_tpu_torch.kernels import qmatmul as K1
from alignq_tpu_torch.kernels import quantize as K2
from torch_port_helpers import emulate_k1 as _emulate_k1
from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)


def _i8(rng, shape, lo=-127, hi=128):
    return torch.from_numpy(rng.randint(lo, hi, shape).astype(np.int8))


# ------------------------------------------------------------ K1's new forms


# (B, H, W, Cin, ksize, stride, N): the forms the two graphs add to K1 --
# 3x3 convs over 200 and more channels (streamed K, DenseNet's stage 2 and
# 3, the last chunk narrower), N above 256 (DenseNet's transition 2,
# MobileNet's expansions and head), deep 1x1 convs (streamed K)
NEW_FORMS = [
    (1, 8, 8, 448, 3, 1, 12),
    (2, 16, 16, 304, 3, 1, 12),
    (1, 8, 8, 336, 3, 1, 12),
    (1, 16, 16, 224, 3, 1, 12),
    (1, 16, 16, 320, 1, 1, 312),
    (2, 4, 4, 320, 1, 1, 1280),
    (1, 4, 4, 160, 1, 1, 960),
    (1, 4, 4, 960, 1, 1, 160),
    (1, 8, 8, 576, 1, 1, 96),
    (1, 32, 32, 176, 1, 1, 168),
    (1, 32, 32, 160, 3, 1, 12),
]


@pytest.mark.parametrize("form", NEW_FORMS)
def test_k1_index_math_emulated(form):
    """The plan of each new form, run through the kernel's index math in
    numpy, computes the conv (int32) and covers every output once."""
    b, h, w, cin, ksize, stride, n = form
    rng = np.random.RandomState(cin + n)
    x = _i8(rng, (b, h, w, cin))
    op = K1.pack_conv_weights(_i8(rng, (ksize, ksize, cin, n)))
    plan = K1.conv_plan(b, h, w, op.cin, ksize, stride, ksize // 2, *op.wt.shape)
    if cin >= 200 and ksize == 3 and h <= 16:
        assert plan.n_chunks > 1  # K streams
    if n > K1.N_MAX:
        assert plan.n_blocks > 1
    got = _emulate_k1(x, op, plan)
    want = K1.int8_conv_reference(x, op, stride, ksize // 2, "int32").reshape(-1, n)
    np.testing.assert_array_equal(got[:, :n], want.numpy())


# ------------------------------------------------------------- MobileNet-V2


def _images(n, seed):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


def _port_qparams(jq):
    return interop.qparams_from_numpy(jax.tree.map(np.asarray, jq), "cpu")


@functools.lru_cache(maxsize=None)
def _jax_mobilenet(act_bits, seed=5):
    from torch_port_helpers import random_mobilenet_tree

    params, stats = random_mobilenet_tree(seed)
    # jitted: JAX's converter dispatches op by op eagerly (~40 s here)
    return jax.jit(functools.partial(JM.convert_mobilenetv2, weight_bits=8, act_bits=act_bits))(params, stats)


def _jax_mobilenet_streams(jq, x, act_bits, act_impl):
    """The stem's codes and every block's int8 stream of
    mobilenetv2_int8_forward, each stage jitted as the forward's code."""
    g = JI._act_g(act_bits)

    @jax.jit
    def stem(q, x):
        h = JM._conv(JI._linear_q(x, JI.S_IMG), q, 1, 1)
        return jnp.maximum(JI._erfq_codes(h, act_bits, act_impl), 0)

    @functools.partial(jax.jit, static_argnums=2)
    def block(blk, x8, s):
        planes = blk["conv2"].kernel_int8.shape[-1]
        r = jnp.maximum(JI._erfq_codes(JM._conv(x8, blk["conv1"], 1, 0), act_bits, act_impl), 0)
        r = jnp.maximum(JI._erfq_codes(JM._conv(r.astype(jnp.int8), blk["conv2"], s, 1, groups=planes),
                                       act_bits, act_impl), 0)
        a3 = JI._erfq_codes(JM._conv(r.astype(jnp.int8), blk["conv3"], 1, 0), act_bits, act_impl).astype(jnp.int16)
        if "shortcut" in blk:
            sc = jnp.maximum(JI._erfq_codes(JM._conv(x8, blk["shortcut"], 1, 0), act_bits, act_impl)
                             .astype(jnp.int16), 0)
            return JI._requant_codes(a3 + sc, 2, g, signed=True)
        return JI._requant_codes(a3, 1, g, signed=True)

    x8 = stem(jq["conv1"], x)
    out = [np.asarray(x8)]
    for blk in jq["blocks"]:
        x8 = block(blk, x8, 1 if "shortcut" in blk else 2)
        out.append(np.asarray(x8))
    return out


@pytest.mark.parametrize("act_bits,act_impl", [(8, "erf"), (4, "bins")])
def test_mobilenetv2_matches_jax(one_torch_thread, act_bits, act_impl):
    """Full-CFG MobileNet-V2 at batch 2, JAX's converted qparams carried
    across: the stem's codes and every block's int8 stream identical to
    jitted JAX, the logits within 1e-5 of the jitted forward (the port's
    head is float64, rounded once)."""
    jq = _jax_mobilenet(act_bits)
    x = _images(2, 21)
    want = _jax_mobilenet_streams(jq, x, act_bits, act_impl)
    tq = _port_qparams(jq)
    got = list(TM.mobilenetv2_int8_streams(tq, torch.from_numpy(x), act_bits, act_impl))
    assert len(got) == len(want) == 18
    for i, (g_, w_) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g_.numpy(), w_, err_msg=f"stream after block {i - 1}")
    assert len(np.unique(want[-1])) > 4  # the codes spread over the grid
    logits = TM.mobilenetv2_int8_forward(tq, torch.from_numpy(x), act_bits, act_impl).numpy()
    ref = jax.jit(functools.partial(JM.mobilenetv2_int8_forward, act_bits=act_bits, act_impl=act_impl))(jq, x)
    np.testing.assert_allclose(logits, np.asarray(ref), rtol=0, atol=1e-5)


def test_mobilenetv2_convert_matches_jax(one_torch_thread):
    """The port's converter on the same flax tree: weight codes within one
    code on under 1e-3 of them (the CDF's mean and std reduce in another
    order), scales and biases within an f32 rounding (BN's bias
    beta - mean * inv cancels, and jitted XLA contracts it, so its ulp is
    absolute)."""
    from torch_port_helpers import random_mobilenet_tree

    params, stats = random_mobilenet_tree(7)
    jq = jax.jit(JM.convert_mobilenetv2)(params, stats)
    tq = TM.convert_mobilenetv2(*interop.params_from_numpy(params, stats, "cpu"))
    jl_all, tl_all = jax.tree.leaves(jq), _leaves_in_jax_order(tq)
    assert len(jl_all) == len(tl_all)
    for jl, tl in zip(jl_all, tl_all):
        jl, tl = np.asarray(jl), tl.numpy()
        assert jl.shape == tl.shape and jl.dtype == tl.dtype
        if jl.dtype == np.int8:
            assert np.abs(jl.astype(int) - tl.astype(int)).max() <= 1
            assert (jl != tl).mean() < 1e-3
        else:
            np.testing.assert_allclose(tl, jl, rtol=2e-6, atol=1e-7)


def _leaves_in_jax_order(tree):
    from alignq_tpu_torch.kernels.artifact import _leaves

    return [leaf for _, leaf in _leaves(tree)]


# -------------------------------------------------------------- DenseNet-40


@functools.lru_cache(maxsize=None)
def _jax_densenet(stage_int8, act_bits=8, depth=10, seed=9):
    from torch_port_helpers import random_densenet_tree

    params, stats = random_densenet_tree(depth, seed, stage_int8=stage_int8)
    return jax.jit(functools.partial(JD.convert_densenet40, weight_bits=8, act_bits=act_bits,
                                     stage_int8=stage_int8))(params, stats)


def _jax_densenet_buffers(jq, x, act_bits, act_impl, stage_int8, prealloc=True):
    """Each stage's final buffer of densenet40_int8_forward, the graph
    jitted whole as the forward's code (the stage buffers returned)."""

    def run(q, x):
        acc = jax.lax.conv_general_dilated(
            JI._linear_q(x, JI.S_IMG), q["conv1"].kernel_int8, (1, 1), [(1, 1)] * 2,
            dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
        out = acc.astype(jnp.float32) * q["conv1"].scale
        bufs = []
        if stage_int8:
            c8 = JD._requant_write(out, q["stem_scale"])
            for entry in q["stages"]:
                c8 = JD._stage_prealloc_int8(c8, entry["svec"], entry["blocks"], act_bits, act_impl)
                bufs.append(c8)
                if "trans" in entry:
                    t = entry["trans"]
                    v = JD._pre_act_conv_int8buf(c8, entry["svec"], t["bn"], t["conv"], act_bits, 0, act_impl)
                    v = jax.lax.reduce_window(v, 0.0, jax.lax.add, (1, 2, 2, 1), (1, 2, 2, 1), "VALID") / 4.0
                    c8 = JD._requant_write(v, t["out_scale"])
            return bufs
        for entry in q["stages"]:
            if prealloc:
                out = JD._stage_prealloc(out, entry["blocks"], act_bits, act_impl)
            else:
                for blk in entry["blocks"]:
                    new = JD._pre_act_conv(out, blk["bn"], blk["conv"], act_bits, 1, act_impl)
                    out = jnp.concatenate([out, new], axis=-1)
            bufs.append(out)
            if "trans" in entry:
                t = entry["trans"]
                out = JD._pre_act_conv(out, t["bn"], t["conv"], act_bits, 0, act_impl)
                out = jax.lax.reduce_window(out, 0.0, jax.lax.add, (1, 2, 2, 1), (1, 2, 2, 1), "VALID") / 4.0
        return bufs

    return [np.asarray(b) for b in jax.jit(run)(jq, x)]


def _port_densenet_buffers(tq, x, act_bits, act_impl, stage_int8, prealloc=True):
    return [b.numpy() for b in TD.densenet40_int8_buffers(tq, torch.from_numpy(x), act_bits, act_impl, prealloc,
                                                           stage_int8)]


@pytest.mark.parametrize("act_impl", ["erf", "poly"])
def test_densenet_stage_int8_matches_jax(one_torch_thread, act_impl):
    """DenseNet at depth 10 (two blocks a stage), the int8 stage buffer,
    W8A8, JAX's qparams carried across: every stage's buffer codes
    identical to jitted JAX, the logits within 1e-5."""
    jq = _jax_densenet(True)
    x = _images(2, 31)
    want = _jax_densenet_buffers(jq, x, 8, act_impl, True)
    tq = _port_qparams(jq)
    got = _port_densenet_buffers(tq, x, 8, act_impl, True)
    for i, (g_, w_) in enumerate(zip(got, want)):
        assert g_.dtype == np.int8
        np.testing.assert_array_equal(g_, w_, err_msg=f"stage {i + 1} buffer")
        assert len(np.unique(w_)) > 20  # codes spread over the buffer grid
    logits = TD.densenet40_int8_forward(tq, torch.from_numpy(x), 8, act_impl, stage_int8=True).numpy()
    ref = jax.jit(functools.partial(JD.densenet40_int8_forward, act_impl=act_impl, stage_int8=True))(jq, x)
    np.testing.assert_allclose(logits, np.asarray(ref), rtol=0, atol=1e-5)


# The f32 stage buffer: the port holds jitted JAX to this relative
# tolerance on every buffer value and 1e-5 on the logits. Every f32 step of
# the port is one rounding where XLA's is (pre-act multiply-add, conv
# epilogue, the pool's (a + b) + (c + d)), so the buffers agree bit for bit
# on this input; the tolerance covers a code that flips where XLA's fusion
# of a larger graph contracts an op differently (tests/test_kernels.py:
# JAX's own fused and unfused graphs differ by an ulp).
F32_BUFFER_RTOL = 1e-6


@pytest.mark.parametrize("prealloc", [True, False])
@pytest.mark.parametrize("act_impl", ["erf", "poly"])
def test_densenet_f32_buffer_matches_jax(one_torch_thread, act_impl, prealloc):
    jq = _jax_densenet(False)
    x = _images(2, 37)
    want = _jax_densenet_buffers(jq, x, 8, act_impl, False, prealloc)
    tq = _port_qparams(jq)
    got = _port_densenet_buffers(tq, x, 8, act_impl, False, prealloc)
    for i, (g_, w_) in enumerate(zip(got, want)):
        assert g_.dtype == np.float32 and g_.shape == w_.shape
        np.testing.assert_allclose(g_, w_, rtol=F32_BUFFER_RTOL, atol=0, err_msg=f"stage {i + 1} buffer")
    logits = TD.densenet40_int8_forward(tq, torch.from_numpy(x), 8, act_impl, prealloc=prealloc).numpy()
    ref = jax.jit(functools.partial(JD.densenet40_int8_forward, act_impl=act_impl, prealloc=prealloc))(jq, x)
    np.testing.assert_allclose(logits, np.asarray(ref), rtol=0, atol=1e-5)


def _family_k1_shapes(batch):
    """(conv_plan args) of every K1 launch of DenseNet-40 (C padded to 16
    at the pre-act sites) and MobileNet-V2 at `batch`."""
    shapes = [(batch, 32, 32, 4, 3, 1, 1, 24), (batch, 32, 32, 4, 3, 1, 1, 32)]  # the stems
    for stage, hw in enumerate((32, 16, 8)):
        for i in range(12):
            shapes.append((batch, hw, hw, -(-(24 + 144 * stage + 12 * i) // 16) * 16, 3, 1, 1, 16))
        if stage < 2:
            c = 24 + 144 * (stage + 1)
            shapes.append((batch, hw, hw, -(-c // 16) * 16, 1, 1, 0, c))
    cin, hw = 32, 32
    for expansion, out, n, stride in TM.CFG:
        for s in [stride] + [1] * (n - 1):
            planes = expansion * cin
            shapes.append((batch, hw, hw, cin, 1, 1, 0, planes))
            hw = (hw - 1) // s + 1
            shapes.append((batch, hw, hw, planes, 1, 1, 0, out))
            if s == 1:
                shapes.append((batch, hw, hw, cin, 1, 1, 0, out))
            cin = out
    shapes.append((batch, 4, 4, 320, 1, 1, 0, 1280))
    return [(b, h, w, c, k, st, p, -(-n // 8) * 8, -(-(k * k * c) // 32) * 32) for b, h, w, c, k, st, p, n in shapes]


@pytest.mark.parametrize("batch", [3, 256, 1024])
def test_family_plans_cover_every_output_once(batch):
    """Every K1 launch plan of both graphs: its tiles over every N block
    write each output once, its bands stay in their shared memory and the
    CTA within its budget: 89 launches (DenseNet-40's 39, MobileNet-V2's
    50), 59 distinct shapes."""
    shapes = _family_k1_shapes(batch)
    assert len(shapes) == 89 and len(set(shapes)) == 59
    for args in set(shapes):
        p = K1.conv_plan(*args)
        assert p.smem <= K1.SMEM_BUDGET and 32 * p.warps_m * p.warps_n <= 256 and p.NB <= K1.N_MAX
        assert p.n_blocks * p.NB >= p.N8 > (p.n_blocks - 1) * p.NB
        assert p.n_chunks == 1 or p.warps_m == p.TR * p.TW // 32  # a streamed warp holds one m group
        tiles = np.arange(p.n_tiles)
        tx, rest = tiles % p.tiles_x, tiles // p.tiles_x
        b, ty = rest // p.tiles_y, rest % p.tiles_y
        i = np.arange(p.TR * p.TW)
        oy = (ty * p.TR)[:, None] + i // p.TW
        ox = (tx * p.TW)[:, None] + i % p.TW
        valid = (oy < p.Ho) & (ox < p.Wo)
        m = ((b[:, None] * p.Ho + oy) * p.Wo + ox)[valid]
        assert np.array_equal(np.bincount(m, minlength=p.B * p.Ho * p.Wo), np.ones(p.B * p.Ho * p.Wo)), args


def test_cpu_forwards_launch_nothing():
    """On CPU tensors every wrapper runs its plain version: no launch."""
    from alignq_tpu_torch.kernels import _build

    before = dict(_build.launches)
    fn, (qp, x) = TD.build_densenet40_int8(1, device="cpu", depth=10, stage_int8=True)
    fn(qp, x, stage_int8=True)
    fn, (qp, x) = TM.build_mobilenetv2_int8(1, device="cpu")
    fn(qp, x)
    assert dict(_build.launches) == before


# ------------------------------------- the depthwise and BN-act plain versions


@pytest.mark.parametrize("c,hw,stride", [(32, 8, 1), (96, 8, 2), (144, 5, 2), (960, 4, 1)])
@pytest.mark.parametrize("impl", ["f32", "erf", "poly"])
def test_dw_conv_plain_matches_jax(c, hw, stride, impl):
    """The depthwise conv's plain version against JAX's grouped int8 conv
    (infer_mobilenet.py _conv) under jit: f32 epilogue bit for bit, and
    the relu'd codes."""
    rng = np.random.RandomState(c + hw + stride)
    x = rng.randint(0, 128, (2, hw, hw, c)).astype(np.int8)
    k = rng.randint(-127, 128, (3, 3, 1, c)).astype(np.int8)
    s = (rng.rand(c) * 2e-4).astype(np.float32)
    b = (rng.randn(c) * 0.5).astype(np.float32)
    q = jconv_qconv(k, s, b)
    h = jax.jit(functools.partial(JM._conv, stride=stride, padding=1, groups=c))(x, q)
    op = DW.pack_dw_weights(torch.from_numpy(k), torch.from_numpy(s), torch.from_numpy(b))
    if impl == "f32":
        np.testing.assert_array_equal(DW.dw_conv(torch.from_numpy(x), op, stride).numpy(), np.asarray(h))
        return
    want = jax.jit(lambda h: jnp.maximum(JI._erfq_codes(h, 8, impl), 0))(h)
    got = DW.dw_conv(torch.from_numpy(x), op, stride, act=K1.act_map(impl, 127, torch.device("cpu"), relu=True))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def jconv_qconv(k, s, b):
    from alignq_tpu.kernels.convert import QConvInt8

    return QConvInt8(jnp.asarray(k), jnp.asarray(s), jnp.asarray(b))


@pytest.mark.parametrize("buffer", ["f32", "int8"])
@pytest.mark.parametrize("impl", ["erf", "poly"])
def test_bn_act_plain_matches_jax(buffer, impl):
    """The BN-act pass's plain version over a live prefix of a wider
    buffer against JAX's pre-activation under jit (infer_densenet.py:
    x * s + b, act_q, relu): identical codes, zero past c_live."""
    rng = np.random.RandomState(len(buffer) + len(impl))
    ld, c_live, c_out = 72, 36, 48
    if buffer == "f32":
        x = (rng.randn(2, 4, 4, ld) * 2).astype(np.float32)
    else:
        x = rng.randint(-127, 128, (2, 4, 4, ld)).astype(np.int8)
    s = (rng.rand(c_live) * (0.05 if buffer == "int8" else 1.5) + 0.01).astype(np.float32)
    b = (rng.randn(c_live) * 0.3).astype(np.float32)
    want = jax.jit(lambda x, s, b: jnp.maximum(JI._erfq_codes(x[..., :c_live].astype(jnp.float32) * s + b, 8, impl),
                                               0))(x, s, b)
    act = K1.act_map(impl, 127, torch.device("cpu"), relu=True)
    got = K2.bn_act_codes(torch.from_numpy(x), c_live, torch.from_numpy(s), torch.from_numpy(b), act, c_out)
    np.testing.assert_array_equal(got[..., :c_live].numpy(), np.asarray(want))
    assert not got[..., c_live:].any()
