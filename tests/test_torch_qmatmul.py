"""Kernel K1's plain version (alignq_tpu_torch/kernels/qmatmul.py, which
the CPU runs) against the JAX reference under jax.jit, on the same numpy
inputs. Raw int32 accumulators are exact; the f32 epilogue
`acc * scale + bias` is one rounding on both sides, so it is bit-identical.
So are the act codes of the codes epilogue (int8_matmul_codes), against
the JAX graph's act-site maps `_erfq_codes` of that epilogue and
`_int_bin_codes` of the accumulator.

The conv entry points (int8_conv_packed / int8_conv_codes) on NHWC codes
give jitted JAX's _int8_conv_acc / _int8_conv and the act codes of its
epilogue exactly at every conv geometry of the serving path; conv_plan,
K1's launch plan, covers every output pixel once.
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignq_tpu.kernels import infer as J
from alignq_tpu.kernels.convert import QConvInt8 as JQConv
from alignq_tpu.kernels.qmatmul import int8_matmul_dequant_reference as jref
from alignq_tpu_torch.kernels import _build
from alignq_tpu_torch.kernels import infer as T
from alignq_tpu_torch.kernels.convert import QConvInt8 as TQConv
from alignq_tpu_torch.kernels.qmatmul import (
    K_MULT,
    SMEM_BUDGET,
    TAP_GATHERS,
    act_map,
    conv_plan,
    gather_taps,
    int8_conv_codes,
    int8_conv_packed,
    int8_matmul_codes,
    int8_matmul_dequant,
    int8_matmul_int32,
    int8_matmul_packed,
    kernel_matrix,
    pack_act_cutpoints,
    pack_conv_weights,
    pack_k1_weights,
)

SHAPES = [(100, 70, 50), (1000, 27, 16), (333, 144, 32), (64, 16, 32), (128, 576, 64), (40, 288, 128)]


def _operands(m, k, n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(-127, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    s = (rng.rand(n) * 1e-3).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    return x, w, s, b


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int32_exact(m, k, n):
    x, w, _, _ = _operands(m, k, n)
    want = jax.jit(
        lambda a, b: jax.lax.dot_general(a, b, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    )(x, w)
    got = int8_matmul_int32(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_dequant_bit_identical(m, k, n, relu):
    x, w, s, b = _operands(m, k, n, seed=1)
    want = jax.jit(lambda *a: jref(*a, relu=relu))(x, w, s, b)
    got = int8_matmul_dequant(*(torch.from_numpy(a) for a in (x, w, s, b)), relu=relu)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dequant_no_bias():
    x, w, s, _ = _operands(50, 32, 24, seed=2)
    want = jax.jit(jref)(x, w, s)
    got = int8_matmul_dequant(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k,n", [(100, 70, 50), (64, 16, 32), (40, 288, 128)])
@pytest.mark.parametrize("mode", ["int32", "f32", "relu"])
def test_packed_matches_jax(m, k, n, mode):
    """A weight packed once (K and N zero-padded, W^T) gives JAX's result;
    x may keep its unpadded K."""
    x, w, s, b = _operands(m, k, n, seed=3)
    op = pack_k1_weights(*(torch.from_numpy(a) for a in (w, s, b)))
    assert op.wt.shape == ((n + 7) // 8 * 8, (k + K_MULT - 1) // K_MULT * K_MULT)
    got = int8_matmul_packed(torch.from_numpy(x), op, mode)
    if mode == "int32":
        want = jax.jit(lambda a, c: jnp.matmul(a, c, preferred_element_type=jnp.int32))(x, w)
    else:
        want = jax.jit(lambda *a: jref(*a, relu=mode == "relu"))(x, w, s, b)
    assert got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_packed_rejects_deeper_x():
    op = pack_k1_weights(torch.zeros((16, 8), dtype=torch.int8))
    with pytest.raises(ValueError):
        int8_matmul_packed(torch.zeros((4, 40), dtype=torch.int8), op)


def test_cpu_runs_no_kernel():
    x, w, s, b = _operands(8, 8, 8)
    before = dict(_build.launches)
    int8_matmul_dequant(*(torch.from_numpy(a) for a in (x, w, s, b)))
    assert dict(_build.launches) == before


@pytest.mark.parametrize(
    "ksize,stride,padding,cin", [(3, 1, 1, 3), (3, 2, 1, 16), (1, 2, 0, 16), (1, 1, 0, 32), (3, 1, 1, 64)]
)
def test_gathered_taps_conv_exact(ksize, stride, padding, cin):
    """The conv as K1 over gathered taps (K zero-padded to the MMA depth)
    gives XLA's int8 conv accumulators exactly."""
    rng = np.random.RandomState(ksize + stride + cin)
    x = rng.randint(-127, 128, (2, 8, 8, cin)).astype(np.int8)
    kern = rng.randint(-127, 128, (ksize, ksize, cin, 16)).astype(np.int8)
    want = jax.jit(
        lambda a, k: jax.lax.conv_general_dilated(
            a, k, (stride, stride), [(padding, padding)] * 2,
            dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32,
        )
    )(x, kern)
    cols = gather_taps(torch.from_numpy(x), ksize, stride, padding, K_MULT)
    kmat = kernel_matrix(torch.from_numpy(kern), K_MULT)
    assert cols.shape[1] % K_MULT == 0 and kmat.shape[0] == cols.shape[1]
    got = int8_matmul_int32(cols, kmat).reshape(np.shape(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


CODE_SHAPES = [(100, 70, 50), (333, 144, 32), (64, 16, 20), (40, 288, 128)]


def _code_operands(m, k, n, seed):
    """Operands whose epilogue h spreads over the act grid (|h| up to ~4),
    with some negative scales, as folded BN gives."""
    x, w, _, _ = _operands(m, k, n, seed)
    rng = np.random.RandomState(seed + 100)
    s = (rng.rand(n) * 2 - 0.4) * 2 / (np.sqrt(k) * 73.3**2)
    b = rng.randn(n) * 0.5
    return x, w, s.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("m,k,n", CODE_SHAPES)
@pytest.mark.parametrize("impl,bits", [("poly", 8), ("erf", 8), ("bins", 4)])
def test_codes_match_jax(m, k, n, impl, bits):
    x, w, s, b = _code_operands(m, k, n, seed=5)
    want = jax.jit(lambda *a: J._erfq_codes(jref(*a), bits, impl))(x, w, s, b)
    op = pack_k1_weights(*(torch.from_numpy(a) for a in (w, s, b)))
    got = int8_matmul_codes(torch.from_numpy(x), op, act_map(impl, 2 ** (bits - 1) - 1, torch.device("cpu")))
    assert got.dtype == torch.int8 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k,n", CODE_SHAPES)
def test_bins_int_codes_match_jax(m, k, n):
    x, w, s, b = _code_operands(m, k, n, seed=6)
    s[:2] = [0.0, -abs(s[2])]  # a degenerate channel and a negative scale
    cut = T.act_int_cutpoints(TQConv(torch.zeros((1, 1, k, n), dtype=torch.int8), *map(torch.from_numpy, (s, b))), 4)
    acc = jax.jit(lambda a, c: jnp.matmul(a, c, preferred_element_type=jnp.int32))(x, w)
    want = jax.jit(J._int_bin_codes)(acc, {key: jnp.asarray(v.numpy()) for key, v in cut.items()})
    op = pack_k1_weights(*(torch.from_numpy(a) for a in (w, s, b)))
    act = pack_act_cutpoints(cut, op.wt.shape[0])
    assert act.g == 7 and act.t1.shape == (7, op.wt.shape[0])
    got = int8_matmul_codes(torch.from_numpy(x), op, act)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_act_map_guards():
    with pytest.raises(ValueError):
        act_map("bins", 127, torch.device("cpu"))
    with pytest.raises(ValueError):
        act_map("bins_int", 7, torch.device("cpu"))  # per site: pack_act_cutpoints
    bins = act_map("bins", 7, torch.device("cpu"))
    assert bins.bnd.dtype == torch.float32 and bins.bnd.shape == (7,)
    assert act_map("bins", 7, torch.device("cpu")) is bins  # laid out once


def test_codes_cpu_runs_no_kernel():
    x, w, s, b = _code_operands(8, 8, 8, seed=7)
    before = dict(_build.launches)
    op = pack_k1_weights(*(torch.from_numpy(a) for a in (w, s, b)))
    int8_matmul_codes(torch.from_numpy(x), op, act_map("erf", 127, torch.device("cpu")))
    assert dict(_build.launches) == before


# ------------------------------------------------- the conv form of K1

# Every conv geometry of the ResNet-20 serving path: (name, H, W, Cin,
# ksize, stride, Cout); "merged" are fuse_skip's conv0 + skip, one 3x3 conv
# whose skip half is its centre tap only.
CONV_GEOMS = [
    ("stem", 32, 32, 3, 3, 1, 16),
    ("stage1 conv", 32, 32, 16, 3, 1, 16),
    ("block3 conv0", 32, 32, 16, 3, 2, 32),
    ("block3 skip", 32, 32, 16, 1, 2, 32),
    ("block3 conv1", 16, 16, 32, 3, 1, 32),
    ("block6 conv0", 16, 16, 32, 3, 2, 64),
    ("block6 skip", 16, 16, 32, 1, 2, 64),
    ("block6 conv1", 8, 8, 64, 3, 1, 64),
    ("block3 merged", 32, 32, 16, 3, 2, 64),
    ("block6 merged", 16, 16, 32, 3, 2, 128),
]
CONV_MODES = ["int32", "f32", "poly", "erf", "bins", "bins_int"]


@functools.lru_cache(maxsize=None)
def _conv_case(name, batch):
    """Inputs of one path conv, and JAX's int32 accumulators and f32
    epilogue of it under jit, at `batch`."""
    _, h, w, cin, ksize, stride, cout = next(g for g in CONV_GEOMS if g[0] == name)
    rng = np.random.RandomState(zlib.crc32(f"{name} {batch}".encode()))
    x = rng.randint(-127, 128, (batch, h, w, cin)).astype(np.int8)
    if name.endswith("merged"):
        k0 = rng.randint(-127, 128, (3, 3, cin, cout // 2)).astype(np.int8)
        ks = np.zeros((3, 3, cin, cout // 2), np.int8)
        ks[1, 1] = rng.randint(-127, 128, (cin, cout // 2))
        kern = np.concatenate([k0, ks], axis=3)
    else:
        kern = rng.randint(-127, 128, (ksize, ksize, cin, cout)).astype(np.int8)
    s = ((rng.rand(cout) * 2 - 0.4) * 2 / (np.sqrt(ksize * ksize * cin) * 73.3**2)).astype(np.float32)
    b = (rng.randn(cout) * 0.5).astype(np.float32)
    pad = 1 if ksize == 3 else 0
    q = JQConv(jnp.asarray(kern), jnp.asarray(s), jnp.asarray(b))
    acc = np.asarray(jax.jit(J._int8_conv_acc, static_argnums=(2, 3))(x, q, stride, pad))
    h32 = np.asarray(jax.jit(J._int8_conv, static_argnums=(2, 3))(x, q, stride, pad))
    return x, kern, s, b, stride, pad, acc, h32


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("mode", CONV_MODES)
@pytest.mark.parametrize("name", [g[0] for g in CONV_GEOMS])
def test_conv_form_matches_jax(name, mode, batch):
    """The conv entry point's plain version (what the CPU runs) on NHWC
    codes gives jitted JAX's int32 accumulators, f32 epilogue and act
    codes exactly, the stem's 3 input channels included."""
    x, kern, s, b, stride, pad, acc, h32 = _conv_case(name, batch)
    op = pack_conv_weights(*(torch.from_numpy(a) for a in (kern, s, b)))
    xt = torch.from_numpy(x)
    if mode == "int32":
        got, want = int8_conv_packed(xt, op, stride, pad, "int32"), acc
    elif mode == "f32":
        got, want = int8_conv_packed(xt, op, stride, pad, "f32"), h32
    elif mode == "bins_int":
        cut = T.act_int_cutpoints(TQConv(torch.from_numpy(kern), torch.from_numpy(s), torch.from_numpy(b)), 4)
        want = jax.jit(J._int_bin_codes)(acc, {k: jnp.asarray(v.numpy()) for k, v in cut.items()})
        got = int8_conv_codes(xt, op, stride, pad, pack_act_cutpoints(cut, op.wt.shape[0]))
    else:
        bits = 4 if mode == "bins" else 8
        want = jax.jit(lambda h: J._erfq_codes(h, bits, mode))(h32)
        got = int8_conv_codes(xt, op, stride, pad, act_map(mode, 2 ** (bits - 1) - 1, torch.device("cpu")))
    assert got.shape == np.shape(want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_merged_skip_halves_match_jax():
    """fuse_skip's merged conv (kernels/infer.py) gives the halves of JAX's
    _int8_conv_merged_skip bit for bit."""
    rng = np.random.RandomState(11)
    x = rng.randint(0, 128, (2, 16, 16, 32)).astype(np.int8)
    convs = []
    for ksize in (3, 1):
        kern = rng.randint(-127, 128, (ksize, ksize, 32, 64)).astype(np.int8)
        convs.append((kern, (rng.rand(64) * 1e-3).astype(np.float32), rng.randn(64).astype(np.float32)))
    want = jax.jit(J._int8_conv_merged_skip, static_argnums=3)(
        x, *(JQConv(*map(jnp.asarray, c)) for c in convs), 2)
    got = T._int8_conv_merged_skip(torch.from_numpy(x), *(TQConv(*map(torch.from_numpy, c)) for c in convs), 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("cin,ksize", [(3, 3), (16, 3), (32, 1), (12, 3)])
def test_packed_conv_weight_is_kernel_matrix(cin, ksize):
    """pack_conv_weights' W^T holds kernel_matrix's columns: each tap's Cin
    channels, then zeros up to a multiple of 4 (the stem's 4th), in (dy, dx)
    order; K zero-padded to the MMA depth, N to 8."""
    rng = np.random.RandomState(cin)
    kern = torch.from_numpy(rng.randint(-127, 128, (ksize, ksize, cin, 20)).astype(np.int8))
    op = pack_conv_weights(kern)
    cp = (cin + 3) // 4 * 4
    assert (op.ksize, op.cin, op.n) == (ksize, cp, 20)
    assert op.wt.shape == (24, (ksize * ksize * cp + K_MULT - 1) // K_MULT * K_MULT)
    mat = kernel_matrix(kern)  # (ksize*ksize*cin, 20)
    for tap in range(ksize * ksize):
        cols = op.wt[:20, tap * cp : (tap + 1) * cp]
        assert torch.equal(cols[:, :cin], mat[tap * cin : (tap + 1) * cin].t())
        assert not cols[:, cin:].any()
    assert not op.wt[:, ksize * ksize * cp :].any() and not op.wt[20:].any()


def _path_plans(batch):
    """(conv_plan args) of every K1 launch shape of the path at `batch`,
    and of the GEMM form at its test shapes."""
    convs = [(batch, h, w, (cin + 3) // 4 * 4, ks, st, 1 if ks == 3 else 0, (n + 7) // 8 * 8)
             for _, h, w, cin, ks, st, n in CONV_GEOMS]
    gemms = [(1, 1, m, kp, 1, 1, 0, n8) for m, kp, n8 in ((batch * 1024, 32, 16), (1000003, 32, 16),
                                                           (4099, 576, 64), (130, 288, 128), (64, 32, 200))]
    return [(b, h, w, c, ks, st, p, n8, (ks * ks * c + 31) // 32 * 32) for b, h, w, c, ks, st, p, n8 in convs + gemms]


@pytest.mark.parametrize("batch", [256, 2048])
def test_conv_plan_covers_every_pixel_once(batch):
    """Each launch plan's tiles, walked as csrc/qmatmul.cu walks them, write
    every output pixel exactly once; the band reads stay in the band's
    shared memory and the CTA within its budget."""
    for args in _path_plans(batch):
        p = conv_plan(*args)
        assert p.TR * p.TW % 32 == 0 and p.TW % 8 == 0 and 32 * p.warps_m * p.warps_n <= 256
        assert p.smem <= SMEM_BUDGET and p.P % p.vec == 0 and p.RP % p.vec == 0
        tiles = np.arange(p.n_tiles)
        tx, rest = tiles % p.tiles_x, tiles // p.tiles_x
        b, ty = rest // p.tiles_y, rest % p.tiles_y
        i = np.arange(p.TR * p.TW)
        oy = (ty * p.TR)[:, None] + i // p.TW
        ox = (tx * p.TW)[:, None] + i % p.TW
        valid = (oy < p.Ho) & (ox < p.Wo)
        m = ((b[:, None] * p.Ho + oy) * p.Wo + ox)[valid]
        assert np.array_equal(np.bincount(m, minlength=p.B * p.Ho * p.Wo), np.ones(p.B * p.Ho * p.Wo)), args
        ps = p.stride if p.ksize == 3 else 1
        last = ((p.TR - 1) * ps + p.ksize - 1) * p.RP + ((p.TW - 1) * ps + p.ksize - 1) * p.P
        assert last + min(p.C if p.ksize == 3 else p.KC, p.P) <= p.a_bytes, args
        assert p.n_chunks * p.KC >= p.Kp and (p.n_chunks == 1) == (p.w_bytes > 0)


def test_conv_plan_rejects():
    with pytest.raises(ValueError):
        conv_plan(1, 8, 8, 16, 3, 1, 0, 16, 160)  # 3x3 takes pad 1 only
    with pytest.raises(ValueError):
        conv_plan(1, 8, 8, 16, 3, 1, 1, 16, 128)  # a depth that is not 9 x 16 padded
    with pytest.raises(ValueError):
        conv_plan(1, 8, 8, 6, 3, 1, 1, 16, 64)  # channels not a multiple of 4
    with pytest.raises(ValueError):
        conv_plan(1, 224, 224, 3, 7, 2, 3, 64, 160)  # an image's 3 channels: the wrapper pads them to 4


def test_gather_counter_ignores_cpu():
    before = _build.launches[TAP_GATHERS]
    gather_taps(torch.zeros((1, 4, 4, 4), dtype=torch.int8), 3, 1, 1)
    assert _build.launches[TAP_GATHERS] == before
