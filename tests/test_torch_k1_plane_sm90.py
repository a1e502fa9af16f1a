"""K1's plane form (csrc/qmatmul_sm90p.cu, kernels/qmatmul.py plane_plan)
on the CPU: its plans and rule at the main path's shapes, the K order and
the re-packed weight's layout, and a numpy model of the kernel (the image
as the bulk copy brings it, a consumer's planes with the halo zero,
column-shifted at stride 1 and stride-sampled at stride 2, each thread's
column and rows; each K step's descriptor start and second-half offset; A
and B read by descriptor; the accumulator map) that rebuilds the conv
against K1's plain int32 conv and jitted JAX. The kernel itself runs on the
card alone (tests/test_torch_cuda_kernels.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from alignq_tpu.kernels import infer as J
from alignq_tpu.kernels.convert import QConvInt8 as JQConv
from alignq_tpu_torch.kernels import qmatmul as K1


def _i8(rng, shape):
    return torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))


def _geo(b, h, w, c, stride, n):
    """k1_plan's arguments of a 3x3 pad-1 conv."""
    return (b, h, w, c, 3, stride, 1, -(-n // 8) * 8, -(-(9 * c) // 32) * 32)


# ------------------------------------------------------------ plans and rule


@pytest.mark.parametrize("batch", [2048, 256, 64, 8, 3])
def test_the_rule_at_resnet20_and_resnet56_shapes(batch):
    """The 16x16 stage's stride-2 conv0 (32x32x16 -> 32) and its 3x3s from
    32 channels to 32 take the plane form at every batch, the stage-1 3x3s
    (32x32x16 -> 16) from batch 33 (ResNet-56's stages have the same
    shapes); block 3's skip keeps the narrow form, block 6 the wide Hopper
    form; per forward 2 of the slice route's 7 K1 launches and 12 of the
    erf route's 21 in the plane form from batch 33
    (chip_smoke.PLANE_PER_FORWARD), 6 below."""
    forms = {}
    for name, b, h, w, c, ks, st, n in chip_smoke.conv_shapes(batch):
        cp = -(-c // 4) * 4
        plan = K1.k1_plan(b, h, w, cp, ks, st, ks // 2, -(-n // 8) * 8, -(-(ks * ks * cp) // 32) * 32)
        forms[name] = type(plan).__name__
    assert {k for k, f in forms.items() if f == "PlanePlan"} == chip_smoke.r20_forms(batch)[1]
    assert forms["stage1 conv"] == ("PlanePlan" if batch >= 33 else "NarrowPlan")
    assert forms["block6 conv1"] == "Sm90Plan" and forms["block3 skip"] == "NarrowPlan"
    for route, i in (("resnet20 slice", 0), ("resnet20 erf", 1)):
        n = sum(counts[i] for key, counts in chip_smoke.conv_shapes(batch).items() if forms[key[0]] == "PlanePlan")
        assert n == (chip_smoke.PLANE_PER_FORWARD[route] if batch >= 33 else {0: 2, 1: 6}[i])
    with K1._mma_form():
        assert isinstance(K1.k1_plan(*_geo(batch, 16, 16, 32, 1, 32)), K1.ConvPlan)


@pytest.mark.parametrize("geo, rows", [((2048, 32, 32, 16, 2, 32), 16), ((256, 16, 16, 32, 1, 32), 8),
                                       ((3, 16, 16, 32, 1, 32), 4), ((1, 16, 16, 16, 1, 16), 16),
                                       ((2, 32, 32, 16, 2, 16), 16), ((512, 32, 32, 16, 1, 16), 8),
                                       ((264, 16, 16, 32, 1, 32), 16), ((64, 32, 32, 16, 2, 32), 4)])
def test_plane_plan_layout(geo, rows):
    """Items (of the most rows that give PLANE_ITEMS of them, else the
    fewest; at N8 = 16 of 4 m64 groups),
    planes, K steps, m64 groups and the regions within a CTA's shared
    memory: the four consumers' stages (an item's image rows) and planes
    (the last step's 16-byte overread and the outputs' staging inside
    them), the table, the vectors, the step table and the barriers."""
    b, h, w, c, stride, n = geo
    p = K1.plane_plan(*_geo(*geo))
    ho = (h - 1) // stride + 1
    assert (p.Ho, p.Wo, p.G, p.NBX, p.TR) == (ho, ho, c // 16, 3 if stride == 1 else 9, rows)
    assert p.BR == (rows + 2 if stride == 1 else rows) and p.TY * rows == ho and p.n_items == b * p.TY
    assert p.BOXB == p.BR * p.Wo * 16 and p.MG * 64 == rows * p.Wo and p.MG in (1, 2, 4)
    assert p.steps == len(K1._plane_steps(p.G)) == (9 if p.G == 2 else 5) and p.KT == 32 * p.steps
    assert p.raw_bytes >= min(stride * (rows - 1) + 3, h) * w * c and p.stage_off >= p.N8 * p.KT
    assert p.plane_off >= p.stage_off + K1.PLANE_CONSUMERS * p.raw_bytes and p.plane_bytes % 128 == 0
    assert p.plane_bytes >= max(p.G * p.NBX * p.BOXB + 16, 4 * 16 * p.N8 * 4)
    assert p.tab_off >= p.plane_off + K1.PLANE_CONSUMERS * p.plane_bytes and p.sb_off >= p.tab_off + 8 * 1024
    assert p.stab_off >= p.sb_off + 8 * p.N8 and p.bar_off >= p.stab_off + 8 * p.steps
    assert p.smem <= K1.SM90_SMEM and p.smem >= p.bar_off + 8 * 9
    for tr in K1.plane_rows(ho, ho):  # at N8 = 16 items of 4 m64 groups only
        p16 = K1.plane_plan(*_geo(*geo), rows=tr)
        assert p16.TR == tr if n > 16 or tr * ho == 256 else p16 is None


@pytest.mark.parametrize("geo", [(2, 32, 32, 16, 2, 64), (2, 32, 32, 24, 1, 16), (2, 12, 12, 16, 1, 16),
                                 (2, 4, 8, 16, 1, 16), (2, 16, 16, 48, 1, 16), (2, 256, 256, 32, 1, 32),
                                 (2, 24, 24, 16, 1, 16)])
def test_plane_plan_refuses_shapes_off_the_form(geo):
    """N8 = 64, C % 16, a row of outputs not a power of 2, an image not
    whole m64 groups, C past two groups (the kernel's K steps are 5 or 9),
    a row of outputs past 128; other kernel sizes and pads."""
    assert K1.plane_plan(*_geo(*geo)) is None
    assert K1.plane_plan(2, 16, 16, 32, 1, 1, 0, 32, 32) is None
    assert K1.plane_plan(2, 16, 16, 32, 3, 1, 0, 32, 288) is None


def test_k_order_and_weight_layout():
    """Each K step's two 16-byte halves are one group at one tap (dx-major
    at stride 1, row-major at stride 2), the odd group's last tap against
    zero columns; the re-packed bytes in wgmma's no-swizzle core matrices,
    [step][half][row][16 bytes]."""
    assert [K1.plane_tap(1, t) for t in range(4)] == [(0, 0), (1, 0), (2, 0), (0, 1)]
    assert [K1.plane_tap(2, t) for t in range(4)] == [(0, 0), (0, 1), (0, 2), (1, 0)]
    rng = np.random.RandomState(4)
    for c, stride in ((16, 2), (32, 1), (16, 1)):
        op = K1.pack_conv_weights(_i8(rng, (3, 3, c, 32)))
        plan = K1.plane_plan(*_geo(2, 16 * stride, 16 * stride, c, stride, 32))
        order = K1._plane_k_order(c, stride)
        steps = K1._plane_steps(c // 16)
        assert len(order) == 32 * len(steps) == plan.KT
        wpk = K1._plane_weight(op.wt, plan).numpy()
        assert wpk.shape == (32 * plan.KT,)
        wt = op.wt.numpy()
        for k, step in enumerate(steps):
            for half, part in enumerate(step):
                cols = order[32 * k + 16 * half:32 * k + 16 * half + 16]
                if part is None:
                    assert (cols == -1).all()
                    continue
                q, tau = part
                dy, dx = K1.plane_tap(stride, tau)
                assert list(cols) == list((3 * dy + dx) * c + 16 * q + np.arange(16))
                for n in (0, 7, 31):
                    got = wpk[k * 32 * 32 + half * 16 * 32 + n * 16:][:16]
                    np.testing.assert_array_equal(got, wt[n, cols])


# ------------------------------------------------------ a numpy model of it


def item_rows(p, item) -> tuple:
    """(image, first output row, first image row, image rows) of an item,
    as the kernel's item_rows computes them."""
    b, oy0 = item // p.TY, (item % p.TY) * p.TR
    ylo = max(p.stride * oy0 - 1, 0)
    return b, oy0, ylo, min(p.stride * (oy0 + p.TR - 1) + 1, p.H - 1) - ylo + 1


def lay_out(raw: np.ndarray, p, oy0, ylo) -> np.ndarray:
    """A consumer's planes of one item as its threads write them: thread
    rt keeps column rt % Wo and rows rt // Wo, + 128 / Wo, ...; plane (q, a)
    row r column i is the pixel (y, x) of the item's image rows as they lie
    (raw, from image row ylo), its 16 channels from 16 q, zero outside the
    image."""
    planes = np.full(p.plane_bytes, 99, np.int8)  # what the planes held before
    for rt in range(128):
        col, row0 = rt % p.Wo, rt // p.Wo
        for q in range(p.G):
            for a in range(p.NBX):
                dy, dx = (0, a) if p.stride == 1 else (a // 3, a % 3)
                xx = p.stride * col + dx - 1
                for r in range(row0, p.BR, 128 // p.Wo):
                    y = oy0 + r - 1 if p.stride == 1 else 2 * (oy0 + r) + dy - 1
                    o = (q * p.NBX + a) * p.BOXB + (r * p.Wo + col) * 16
                    inside = 0 <= y < p.H and 0 <= xx < p.W
                    src = ((y - ylo) * p.W + xx) * p.C + 16 * q
                    planes[o:o + 16] = raw[src:src + 16] if inside else 0
    return planes


def step_table(p) -> list:
    """Each K step's (A start, second-half offset) in a stage, as the
    kernel's tap_off computes them."""

    def tap_off(q, tau):
        if p.stride == 1:
            return (q * p.NBX + tau // 3) * p.BOXB + (tau % 3) * p.Wo * 16
        return (q * p.NBX + tau) * p.BOXB

    pairs, out = (p.G // 2) * 9, []
    for k in range(p.steps):
        if k < pairs:
            j, tau = divmod(k, 9)
            o = tap_off(2 * j, tau)
            out.append((o, tap_off(2 * j + 1, tau) - o))
        else:
            tau = 2 * (k - pairs)
            o = tap_off(p.G - 1, tau)
            out.append((o, tap_off(p.G - 1, tau + 1) - o if tau + 1 < 9 else 16))
    return out


def emulate_plane(x: np.ndarray, op, p) -> np.ndarray:
    """The kernel's int32 sums (B * Ho * Wo, N8) by its own index math, and
    how many times each output was written: an item's planes from the bulk
    copy of its image rows, each m64 group's A rows by the descriptor
    (start e.x + 1024 mg, rows 16 bytes apart, the second 16 bytes e.y on),
    B by the weight's descriptor, summed over the K steps."""
    nb = p.N8
    wpk = K1._plane_weight(op.wt, p).numpy().astype(np.int64)
    tab = step_table(p)
    out = np.zeros((p.B * p.Ho * p.Wo, nb), np.int64)
    hits = np.zeros(p.B * p.Ho * p.Wo, np.int64)
    r = np.arange(64)
    for item in range(p.n_items):
        b, oy0, ylo, rows = item_rows(p, item)
        first = (b * p.H + ylo) * p.W * p.C
        raw = x.reshape(-1)[first:first + rows * p.W * p.C]  # the bulk copy's bytes
        assert raw.size <= p.raw_bytes
        s64 = lay_out(raw, p, oy0, ylo).astype(np.int64)
        for mg in range(p.MG):
            acc = np.zeros((64, nb), np.int64)
            for k, (start, lbo) in enumerate(tab):
                a0 = start + 1024 * mg + 16 * r
                amat = np.concatenate([s64[a0[:, None] + np.arange(16)], s64[a0[:, None] + lbo + np.arange(16)]], 1)
                w0 = k * 32 * nb + 16 * np.arange(nb)
                bmat = np.concatenate([wpk[w0[:, None] + np.arange(16)], wpk[w0[:, None] + 16 * nb + np.arange(16)]],
                                      1)
                acc += amat @ bmat.T
            pix = (b * p.Ho + oy0) * p.Wo + 64 * mg + r
            out[pix] = acc
            hits[pix] += 1
    return out, hits


@pytest.mark.parametrize("batch", [1, 2, 3])
@pytest.mark.parametrize("hw, c, stride, n", [(32, 16, 2, 32), (16, 32, 1, 32), (16, 16, 1, 16), (32, 16, 2, 16),
                                              (16, 32, 1, 16), (32, 16, 1, 16)])
def test_emulated_kernel_rebuilds_the_conv(batch, hw, c, stride, n):
    """The model of the kernel at each item size of its plan gives K1's
    plain int32 conv, every output written once: no halo row computed, the
    image's edges zero in the planes."""
    rng = np.random.RandomState(batch * 100 + c + stride)
    x = _i8(rng, (batch, hw, hw, c))
    op = K1.pack_conv_weights(_i8(rng, (3, 3, c, n)))
    want = K1.int8_conv_reference(x, op, stride, 1, "int32").reshape(-1, n).numpy()
    ho = (hw - 1) // stride + 1
    plans = [K1.plane_plan(*_geo(batch, hw, hw, c, stride, n), rows=tr) for tr in K1.plane_rows(ho, ho)]
    for plan in filter(None, plans):
        got, hits = emulate_plane(x.numpy(), op, plan)
        assert (hits == 1).all()
        np.testing.assert_array_equal(got, want)


def test_emulated_kernel_matches_jax():
    """The model at block 3's stride-2 conv0 and at its conv1, against
    jitted JAX's int8 conv (infer.py _int8_conv_acc)."""
    rng = np.random.RandomState(17)
    for hw, c, stride in ((32, 16, 2), (16, 32, 1)):
        x = _i8(rng, (2, hw, hw, c))
        kern = _i8(rng, (3, 3, c, 32))
        op = K1.pack_conv_weights(kern)
        got, _ = emulate_plane(x.numpy(), op, K1.plane_plan(*_geo(2, hw, hw, c, stride, 32)))
        q = JQConv(jnp.asarray(kern.numpy()), jnp.ones(32, jnp.float32), jnp.zeros(32, jnp.float32))
        want = jax.jit(J._int8_conv_acc, static_argnums=(2, 3))(jnp.asarray(x.numpy()), q, stride, 1)
        np.testing.assert_array_equal(got, np.asarray(want).reshape(-1, 32))


def test_step_starts_and_offsets():
    """Each tap's descriptor start: at stride 1 dy rows (Wo * 16 bytes) into
    its column box, at stride 2 its own box; every second-half offset
    positive (the descriptor's leading byte offset is unsigned)."""
    p1 = K1.plane_plan(*_geo(2, 16, 16, 32, 1, 32))
    tab = step_table(p1)
    assert len(tab) == 9
    for k, (start, lbo) in enumerate(tab):
        dy, dx = K1.plane_tap(1, k)
        assert start == dx * p1.BOXB + dy * 16 * 16 and lbo == 3 * p1.BOXB
    p2 = K1.plane_plan(*_geo(2, 32, 32, 16, 2, 32))
    tab = step_table(p2)
    assert [s for s, _ in tab] == [2 * j * p2.BOXB for j in range(5)]
    assert [o for _, o in tab] == [p2.BOXB] * 4 + [16]
    for geo in ((2, 16, 16, 16, 1, 32), (2, 32, 32, 16, 2, 16)):
        assert all(o > 0 for _, o in step_table(K1.plane_plan(*_geo(*geo))))


@pytest.mark.parametrize("batch, taken", [(2048, True), (256, True), (64, True), (33, True), (32, False), (8, False),
                                          (3, False)])
def test_the_rule_at_the_32x32_convs(batch, taken):
    """The 32x32 3x3s to 16 columns (ResNet-20/56's stage-1 convs over 16
    channels, DenseNet-40's first growth conv over its 24 padded to 32, to
    12) take the plane form where their items (quarters of an image) number
    PLANE_MIN_ITEMS or more, else the narrow form (at batch 8 the narrow
    form won or tied); the 48-channel ones never (the kernel's K steps are
    5 or 9)."""
    for c, n in ((16, 16), (32, 12)):
        plan = K1.k1_plan(*_geo(batch, 32, 32, c, 1, n))
        assert isinstance(plan, K1.PlanePlan if taken else K1.NarrowPlan)
        assert K1.plane_takes(batch, 32, 32, c, 3, 1, 1, 16) == taken
    assert not K1.plane_takes(batch, 32, 32, 48, 3, 1, 1, 16)
    with K1._old_form():
        assert isinstance(K1.k1_plan(*_geo(batch, 32, 32, 16, 1, 16)), K1.NarrowPlan)
        assert isinstance(K1.k1_plan(*_geo(batch, 16, 16, 32, 1, 32)), K1.ConvPlan)
