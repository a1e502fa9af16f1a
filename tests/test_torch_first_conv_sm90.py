"""The first-conv kernel (csrc/first_conv_sm90.cu, kernels/first_conv.py)
on the CPU: its plans and rule, the K = 27 re-pack, a numpy model of the
kernel (the stage's rows, the quantized band, each lane's byte gathers,
wgmma's A fragments and B by descriptor, the tiles' walk) that rebuilds the
conv's int32 sums, and the plain first conv (f32 image in) against jitted
JAX's `_linear_q`, `_int8_conv` and act codes and the DenseNet-40 and
MobileNet-V2 stems. The kernel itself runs on the card alone
(tests/test_torch_cuda_kernels.py, chip_smoke.py)."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignq_tpu.kernels import infer as JI
from alignq_tpu.kernels import infer_mobilenet as JM
from alignq_tpu.kernels.convert import QConvInt8 as JQConv
from alignq_tpu_torch.kernels import first_conv as FC
from alignq_tpu_torch.kernels import infer as TI
from alignq_tpu_torch.kernels import qmatmul as K1
from alignq_tpu_torch.kernels.infer import act_int_cutpoints
from alignq_tpu_torch.kernels.convert import QConvInt8

S_IMG = TI.S_IMG
RP, ROW = 192, 32 * 3  # the band's row pitch, an image row's codes


def _images(b, h=32, seed=0):
    return np.random.RandomState(seed).randn(b, h, 32, 3).astype(np.float32) * 1.2


def _weights(n, seed):
    rng = np.random.RandomState(seed)
    kern = rng.randint(-127, 128, (3, 3, 3, n)).astype(np.int8)
    scale = ((rng.rand(n) * 2 - 0.4) * 2 / (27**0.5 * 73.3**2) * 3).astype(np.float32)
    bias = (rng.randn(n) * 0.5).astype(np.float32)
    return kern, scale, bias


def _op(kern, scale, bias):
    return K1.pack_conv_weights(torch.from_numpy(kern), torch.from_numpy(scale), torch.from_numpy(bias))


# ------------------------------------------------------------ plans and rule


@pytest.mark.parametrize("batch, mg", [(2048, 4), (256, 2), (8, 1), (3, 1)])
@pytest.mark.parametrize("n", FC.N_TAKES)
def test_plan_at_the_main_path_batches(batch, mg, n):
    """The rule's tiles (32 or 16 rows where they number TALL_TILES, else
    8), every
    image row in one tile, the regions in order within a CTA's shared
    memory."""
    p = FC.first_plan(batch, 32, n)
    assert (p.MG, p.n_wg, p.R) == (mg, FC.FIRST_WG, 2 * mg * FC.FIRST_WG)
    assert p.TY * p.R == 32 and p.n_tiles == batch * p.TY
    assert p.stage_bytes >= (p.R + 2) * ROW * 4 and p.band_bytes >= (p.R + 2) * RP
    assert p.stage_off >= 32 * n and p.band_off == p.stage_off + p.S * p.stage_bytes
    assert p.obuf_off == p.band_off + 2 * p.band_bytes and p.obuf_bytes >= 16 * n * 4
    assert p.tab_off >= p.obuf_off + 4 * p.n_wg * p.obuf_bytes and p.sb_off >= p.tab_off + 8 * 1024
    assert p.bar_off >= p.sb_off + 8 * n and p.smem <= FC.SMEM_MAX
    assert all(v % 16 == 0 for v in (p.stage_off, p.band_off, p.obuf_off, p.tab_off, p.sb_off))


@pytest.mark.parametrize("args", [(2, 32, 8), (2, 32, 64), (2, 28, 16), (0, 32, 16)])
def test_plan_refuses_shapes(args):
    with pytest.raises(ValueError, match="first-conv kernel does not take"):
        FC.first_plan(*args)


def test_rule_takes_the_families_first_convs():
    """ResNet-20/56 (16), DenseNet-40 (24) and MobileNet-V2 (32) over the
    32x32 image in the epilogue modes the sites use, not int32 or the
    relu'd f32 (the chain takes those); not a sharded weight, another side,
    more channels, other kernels or columns, nor under _old_form."""
    x = torch.zeros(2, 32, 32, 3)
    for n in FC.N_TAKES:
        op = _op(*_weights(n, n))
        for mode in ("f32", "requant", "poly", "erf", "bins", "bins_int"):
            assert FC.first_conv_takes(x, op, mode)
        assert not FC.first_conv_takes(x, op, "int32") and not FC.first_conv_takes(x, op, "relu")
        with FC._old_form():
            assert not FC.first_conv_takes(x, op, "erf")
    op = _op(*_weights(16, 1))
    assert not FC.first_conv_takes(torch.zeros(2, 28, 28, 3), op, "erf")  # the digit images
    assert not FC.first_conv_takes(torch.zeros(2, 30, 32, 3), op, "erf")
    assert not FC.first_conv_takes(torch.zeros(2, 32, 32, 4), op, "erf")
    assert not FC.first_conv_takes(x.double(), op, "erf")
    assert not FC.first_conv_takes(x, op._replace(shard=types.SimpleNamespace(size=2, rank=0)), "erf")
    assert not FC.first_conv_takes(x, _op(*_weights(64, 2)), "erf")
    k7 = K1.pack_conv_weights(torch.zeros(7, 7, 3, 16, dtype=torch.int8))
    assert not FC.first_conv_takes(x, k7, "erf")


def test_k_order_and_weight_layout():
    """K = 27 in one 32-byte step: position 9 dy + 3 dx + c holds the
    packed weight's (dy, dx, c) column, 27..31 zero; the re-packed bytes in
    wgmma's no-swizzle core matrices, [half][column][16 bytes]."""
    order = FC.first_k_order()
    assert list(order[27:]) == [-1] * 5
    for dy in range(3):
        for dx in range(3):
            for c in range(3):
                assert order[9 * dy + 3 * dx + c] == (3 * dy + dx) * 4 + c
    n = 24
    op = _op(*_weights(n, 3))
    wpk = FC.first_weight(op.wt).numpy()
    assert wpk.shape == (32 * n,) and FC.first_weight(op.wt) is FC.first_weight(op.wt)
    wt = op.wt.numpy()
    for col in range(n):
        for k in range(32):
            want = 0 if k >= 27 else wt[col, order[k]]
            assert wpk[(k // 16) * 16 * n + col * 16 + k % 16] == want


# ------------------------------------------------------ a numpy model of it


def emulate_first(x: np.ndarray, op, plan) -> tuple:
    """The kernel's int32 sums (B * H * 32, N) by its own index math, and
    how many times each output was written: each tile's stage rows and
    band, each lane's K offsets and byte gathers into its A registers
    (a0, a1 rows g and g + 8 at K bytes 4t.., a2, a3 at 16 + 4t..), B from
    the re-packed bytes by the descriptor's layout, the accumulator map."""
    b_all, h, w, _ = x.shape
    n = plan.N
    inv = np.float32(1.0 / S_IMG)
    wpk = FC.first_weight(op.wt).numpy().astype(np.int64)
    kk = np.arange(32)
    bmat = wpk[(kk[None, :] // 16) * 16 * n + np.arange(n)[:, None] * 16 + kk[None, :] % 16]  # (N, 32)
    out = np.zeros((b_all * h * w, n), np.int64)
    hits = np.zeros(b_all * h * w, np.int64)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    koff = np.empty((32, 8), np.int64)
    for j in range(8):
        k = np.where(j < 4, 4 * t + j, 12 + 4 * t + j)
        koff[:, j] = np.where(k < 27, (k // 9) * RP + k % 9, -1)
    for tile in range(plan.n_tiles):
        b, y0 = tile // plan.TY, (tile % plan.TY) * plan.R
        ylo, yhi = max(y0 - 1, 0), min(y0 + plan.R, h - 1)
        stage = x[b, ylo:yhi + 1].reshape(-1)  # the bulk copy's rows, f32
        band = np.zeros((plan.R + 2) * RP, np.uint8)
        for r in range(plan.R + 2):
            y = y0 - 1 + r
            if 0 <= y < h:
                v = stage[(y - ylo) * ROW:(y - ylo + 1) * ROW]
                q = np.clip(np.rint(v * inv), -127, 127).astype(np.int8)  # f32 product, one rounding
                band[r * RP + 4:r * RP + 4 + ROW] = q.view(np.uint8)
        for wg in range(plan.n_wg):
            for mg in range(plan.MG):
                gq = wg * plan.MG + mg
                a = np.zeros((64, 32), np.int64)
                for wq in range(4):
                    row = 2 * gq + (wq >> 1)
                    w0 = row * RP + 1 + 3 * (16 * (wq & 1) + g)  # (32,) each lane's h = 0 window

                    def gather(base, half):
                        offs = koff[:, 4 * half:4 * half + 4]
                        vals = band[np.clip(base[:, None] + offs, 0, None)].view(np.int8).astype(np.int64)
                        return np.where(offs >= 0, vals, 0)  # (32 lanes, 4 bytes)

                    for hh, base in ((0, w0), (1, w0 + 24)):
                        rows = 16 * wq + g + 8 * hh
                        for half in range(2):
                            bytes4 = gather(base, half)
                            for j in range(4):
                                a[rows, 16 * half + 4 * t + j] = bytes4[:, j]
                acc = a @ bmat.T  # (64, N): accumulator 4j + 2h + v is row 16 wq + g + 8h, column 8j + 2t + v
                m = np.arange(64)
                pix = (b * h + y0 + 2 * gq + m // 32) * w + m % 32
                out[pix] = acc
                hits[pix] += 1
    return out, hits


@pytest.mark.parametrize("n", FC.N_TAKES)
@pytest.mark.parametrize("batch, mg, n_wg", [(1, 1, 4), (2, 2, 4), (3, 4, 4), (2, 2, 2), (1, 4, 1)])
def test_emulated_kernel_rebuilds_the_conv(n, batch, mg, n_wg):
    """The model of the kernel at its plans gives linear_q then K1's plain
    int32 conv, every output written once (the image rows at the tiles'
    edges zero-filled, the columns' pad pixels zero)."""
    x = _images(batch, seed=n + batch)
    x[0, 0, :4] = [[400.0, -400.0, 0.5 * S_IMG], [1.5 * S_IMG, -2.5 * S_IMG, 0.0]] * 2  # clip and ties
    op = _op(*_weights(n, 7 * n + mg))
    plan = FC.first_plan(batch, 32, n, mg=mg, n_wg=n_wg)
    got, hits = emulate_first(x, op, plan)
    assert (hits == 1).all()
    want = K1.int8_conv_reference(FC.linear_q(torch.from_numpy(x), S_IMG), op, 1, 1, "int32")
    np.testing.assert_array_equal(got, want.reshape(-1, n).numpy())


# ---------------------------------------------- the plain version against JAX


@functools.lru_cache(maxsize=None)
def _jax_first(impl, act_bits, relu, stage_scale):
    """Jitted JAX: _linear_q, the int8 conv and the site's epilogue (the
    act codes, relu'd where relu; f32 acc * scale + bias; or, where
    stage_scale, DenseNet's stage-buffer requant of acc * scale)."""

    @jax.jit
    def run(x, kern, scale, bias):
        q = JQConv(kern, scale, bias)
        if stage_scale:
            acc = JI._int8_conv_acc(JI._linear_q(x, JI.S_IMG), q, 1, 1)
            value = acc.astype(jnp.float32) * scale
            return jnp.clip(jnp.round(value * (1.0 / jnp.float32(stage_scale))), -127.0, 127.0).astype(jnp.int8)
        h = JI._int8_conv(JI._linear_q(x, JI.S_IMG), q, 1, 1)
        if impl == "f32":
            return h
        codes = JI._erfq_codes(h, act_bits, impl)
        return jnp.maximum(codes, 0) if relu else codes

    return run


@pytest.mark.parametrize("impl, act_bits, relu", [("erf", 8, True), ("erf", 8, False), ("poly", 8, True),
                                                   ("poly", 8, False), ("bins", 4, True), ("f32", 8, False)])
@pytest.mark.parametrize("n", FC.N_TAKES)
def test_first_conv_matches_jax(impl, act_bits, relu, n):
    """The plain first conv (f32 image in) against jitted JAX: codes bit
    for bit, f32 within one ulp (XLA contracts acc * scale + bias as the
    port's one rounding does)."""
    x = _images(2, seed=11 + n)
    kern, scale, bias = _weights(n, 5 * n)
    op = _op(kern, scale, bias)
    g = int(JI._act_g(act_bits))
    act = None if impl == "f32" else K1.act_map(impl, g, torch.device("cpu"), relu=relu)
    got = FC.first_conv(torch.from_numpy(x), op, S_IMG, act).numpy()
    want = np.asarray(_jax_first(impl, act_bits, relu, None)(x, kern, scale, bias))
    assert got.shape == (2, 32, 32, n)
    if impl == "f32":
        np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(want)) > (4 if act_bits == 4 else 40)
    chain = FC.first_conv_chain(torch.from_numpy(x), op, S_IMG, act).numpy()
    np.testing.assert_array_equal(got, chain)


def test_first_conv_bins_int_and_requant_match_jax():
    """The W4A4 bins_int codes (integer cutpoints, relu'd) against JAX's
    bins map, and DenseNet-40's stage-buffer requant of the stem (f32
    acc * scale, then clip(rint(v * (1 / s)))) against jitted JAX."""
    x = _images(2, seed=3)
    kern, scale, bias = _weights(16, 9)
    op = _op(kern, scale, bias)
    cut = K1.pack_act_cutpoints(act_int_cutpoints(QConvInt8(torch.from_numpy(kern), torch.from_numpy(scale),
                                                            torch.from_numpy(bias)), 4), op.wt.shape[0])
    got = FC.first_conv(torch.from_numpy(x), op, S_IMG, cut._replace(relu=True)).numpy()
    want = np.asarray(_jax_first("bins", 4, True, None)(x, kern, scale, bias))
    np.testing.assert_array_equal(got, want)
    kern, scale, _ = _weights(24, 4)
    s_out = 0.021
    inv = torch.full((24,), 1.0 / np.float32(s_out), dtype=torch.float32)  # the JAX graph's f32 1 / s
    rq = K1.pack_conv_weights(torch.from_numpy(kern), torch.from_numpy(scale), inv)
    got = FC.first_conv(torch.from_numpy(x), rq, S_IMG, mode="requant").numpy()
    want = np.asarray(_jax_first("requant", 8, False, s_out)(x, kern, scale, np.zeros(24, np.float32)))
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 40


@pytest.mark.parametrize("family", ["densenet40", "mobilenetv2"])
def test_family_stems_match_jax(family):
    """The families' stems as their forwards run them (the f32 image into
    first_conv) against the JAX graphs' stems: DenseNet-40's acc * scale
    (infer_densenet.py, f32, no bias), MobileNet-V2's relu'd erf codes
    (infer_mobilenet.py)."""
    from alignq_tpu_torch.kernels import infer_densenet as TD
    from alignq_tpu_torch.kernels import infer_mobilenet as TM

    x = _images(2, seed=21)
    if family == "densenet40":
        kern, scale, _ = _weights(24, 12)
        sc = np.float32(scale[0])
        op = TD._k1_pre(TD.QConvPre(torch.from_numpy(kern), torch.tensor(sc)), pad_cin=False)  # as the forward's
        got = FC.first_conv(torch.from_numpy(x), op, S_IMG, mode="f32").numpy()

        @jax.jit
        def stem(x, k):
            acc = jax.lax.conv_general_dilated(JI._linear_q(x, JI.S_IMG), k, (1, 1), [(1, 1)] * 2,
                                               dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                               preferred_element_type=jnp.int32)
            return acc.astype(jnp.float32) * sc

        np.testing.assert_array_equal(got, np.asarray(stem(x, kern)))
    else:
        kern, scale, bias = _weights(32, 13)
        op = _op(kern, scale, bias)
        relu = K1.act_map("erf", 127, torch.device("cpu"), relu=True)
        got = FC.first_conv(torch.from_numpy(x), op, S_IMG, relu).numpy()

        @jax.jit
        def stem(x, k, s, b):
            h = JM._conv(JI._linear_q(x, JI.S_IMG), JQConv(k, s, b), 1, 1)
            return jnp.maximum(JI._erfq_codes(h, 8, "erf"), 0)

        np.testing.assert_array_equal(got, np.asarray(stem(x, kern, scale, bias)))


def test_resnet20_stem_site_goes_through_first_conv(monkeypatch):
    """The ResNet-20 forward's first conv is first_conv on the f32 image
    with the site's map relu'd (its clamp folded into the map), and its
    stream equals the relu'd codes of the chain."""
    _, (qp, x) = TI.build_resnet20_int8(2, device="cpu")
    seen = []
    real = FC.first_conv

    def spy(x_, op, scale, act=None, mode="f32"):
        seen.append((tuple(x_.shape), x_.dtype, op.n, scale, act.impl, act.relu))
        return real(x_, op, scale, act, mode)

    monkeypatch.setattr(TI, "first_conv", spy)
    TI.resnet20_int8_stream(qp, x, act_impl="poly")
    assert seen == [((2, 32, 32, 3), torch.float32, 16, S_IMG, "poly", True)]
