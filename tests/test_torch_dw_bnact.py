"""The depthwise kernel's tiling and the BN-act table form, on the CPU.

csrc/dwconv.cu cannot run here; its index math can. `_emulate_dw` runs the
kernel's launch plan (kernels/dwconv.py dw_plan) in numpy as the kernel
does: each tile's band copy into a buffer of stale shared-memory bytes,
with the copy loop's carries and the zero-filled border, then each
thread's sliding 3-column window, its __byte_perm transposes and __dp4a
sums. It must give dw_conv_reference's int32 exactly, at every
MobileNet-V2 shape under its serving plan and at the edges on an H100
SXM's 132 SMs, and where a plan differs there, on an H100 PCIe's 114 and
an H100 MIG 1g slice's 16.

`_emulate_dw_sm90` does the same for the Hopper form (kernels/dwconv.py
dw_sm90_plan, csrc/dwconv_sm90.cu): its persistent CTAs' walk, each band
as the TMA box (zero past the tensor's edges) in one of two buffers, the
same taps, and the codes through the map's step table.

The table form of the BN-act pass (kernels/quantize.py bn_act_table,
bn_act_codes_table) must give bn_act_codes' codes exactly. Its kernel's
grid, shared-memory slice and gathers are emulated likewise: each lane's
gathers must fall in its own bank, whatever the values.
"""

import numpy as np
import pytest
import torch

from alignq_tpu_torch.kernels import dwconv as DW
from alignq_tpu_torch.kernels import quantize as K2
from alignq_tpu_torch.kernels.qmatmul import act_map
from alignq_tpu_torch.quant.cdf import fma_f32

CPU = torch.device("cpu")


def _i8(rng, shape, lo=-128, hi=128):
    return torch.from_numpy(rng.randint(lo, hi, shape).astype(np.int8))


# ------------------------------------------------------- the depthwise kernel


def _byte(v, k):
    return (v >> (8 * k)) & 0xFF


def _sbyte(v, k):
    b = _byte(v, k)
    return np.where(b >= 128, b - 256, b)


SMS = {"h100_sxm": 132, "h100_pcie": 114, "h100_mig_1g": 16}


def _byte_perm(a, b, sel):
    """__byte_perm(a, b, sel) on int64 arrays of uint32 values."""
    src = [_byte(a, k) for k in range(4)] + [_byte(b, k) for k in range(4)]
    return sum(src[(sel >> (4 * n)) & 7] << (8 * n) for n in range(4))


def _transpose3(r0, r1, r2):
    """csrc/dwconv.cu transpose3."""
    lo, hi = _byte_perm(r0, r1, 0x5140), _byte_perm(r0, r1, 0x7362)
    return [_byte_perm(lo, r2, 0x0410), _byte_perm(lo, r2, 0x2532), _byte_perm(hi, r2, 0x0610),
            _byte_perm(hi, r2, 0x2732)]


def _dp4a(a, b, c):
    return c + sum(_sbyte(a, k) * _sbyte(b, k) for k in range(4))


def _emulate_dw(x: torch.Tensor, op: DW.DwWeights, plan: DW.DwPlan) -> np.ndarray:
    """csrc/dwconv.cu's int32 result under `plan`, for the images of x
    (x.shape[0] <= plan.B), with its index math in numpy. Asserts each
    output written once, every shared-memory access inside the band."""
    p, s = plan, plan.stride
    xn = x.numpy()
    w4 = op.w.numpy().view(np.uint32).astype(np.int64)  # (9, C / 4) words
    n_img = xn.shape[0]
    out = np.full((n_img, p.Ho, p.Wo, p.C), -(2**40), np.int64)
    rng = np.random.RandomState(0)
    # the CTA's threads (quad, row, x group), threadIdx.x fastest
    q, ry, gx = (a.ravel() for a in np.meshgrid(np.arange(p.CH // 4), np.arange(p.TR), np.arange(p.GX),
                                                indexing="ij"))
    assert q.size == p.threads <= DW.MAX_THREADS
    for b in range(n_img):
        for band in range(p.n_bands):
            for chunk in range(p.n_chunks):
                c0, oy0 = chunk * p.CH, band * p.TR
                ch = min(p.CH, p.C - c0)
                smem = rng.randint(0, 256, p.smem).astype(np.uint8)  # the band buffer, stale bytes
                # 1. the band copy: each thread's pieces, stepped with carries
                nth, nv = p.threads, ch // p.vec
                total = p.HR * p.HC * nv
                dv, dcol, dr = nth % nv, (nth // nv) % p.HC, nth // nv // p.HC
                for tid in range(nth):
                    v, col, r = tid % nv, (tid // nv) % p.HC, tid // nv // p.HC
                    for _ in range(tid, total, nth):
                        iy, ix = oy0 * s - 1 + r, col - 1
                        dst = r * p.RP + col * p.P + v * p.vec
                        assert 0 <= dst and dst + p.vec <= p.smem and dst % p.vec == 0
                        if 0 <= iy < p.H and 0 <= ix < p.W:
                            smem[dst : dst + p.vec] = xn[b, iy, ix, c0 + v * p.vec : c0 + (v + 1) * p.vec].view(np.uint8)
                        else:
                            smem[dst : dst + p.vec] = 0
                        v += dv
                        if v >= nv:
                            v, col = v - nv, col + 1
                        col += dcol
                        if col >= p.HC:
                            col, r = col - p.HC, r + 1
                        r += dr
                words = smem.view(np.uint32).astype(np.int64)
                # 2. each thread's window along its run
                oy = oy0 + ry
                ox_begin = gx * p.RUN
                ox_end = np.minimum(ox_begin + p.RUN, p.Wo)
                live = (4 * q < ch) & (oy < p.Ho) & (ox_begin < ox_end)
                c = c0 + 4 * q
                quad = np.where(live, c // 4, 0)
                wcols = [[w4[dy * 3 + dx, quad] for dy in range(3)] for dx in range(3)]
                qw = [[t & 0x00FFFFFF for t in _transpose3(*wcols[dx])] for dx in range(3)]
                row0 = ry * s * p.RP + 4 * q

                def load_col(band_col, active):
                    at = row0 + band_col * p.P
                    assert (at[active] % 4 == 0).all() and (at[active] + 2 * p.RP + 4 <= p.smem).all()
                    at = np.where(active, at, 0)
                    rows = [words[(at + dy * p.RP) // 4] for dy in range(3)]
                    return _transpose3(*rows)

                def taps(cols):
                    accs = []
                    for j in range(4):
                        acc = np.zeros(q.size, np.int64)
                        for dx, colw in enumerate(cols):
                            acc = _dp4a(colw[j], qw[dx][j], acc)
                        accs.append(acc)
                    return accs

                def store(ox, accs, active):
                    ii = np.nonzero(active)[0]
                    for j in range(4):
                        assert (out[b, oy[ii], ox[ii], c[ii] + j] == -(2**40)).all()  # each output once
                        out[b, oy[ii], ox[ii], c[ii] + j] = accs[j][ii]

                ca = load_col(ox_begin * s, live)
                cb = load_col(ox_begin + 1, live) if s == 1 else None
                for k in range(p.RUN):
                    ox = ox_begin + k
                    active = live & (ox < ox_end)
                    if s == 2:
                        cb = load_col(2 * ox + 1, active)
                    cc = load_col(ox * s + 2, active)
                    store(ox, taps((ca, cb, cc)), active)
                    ca, cb = (cb, cc) if s == 1 else (cc, cb)
    assert (out != -(2**40)).all()  # every output written
    return out


# MobileNet-V2's 10 depthwise shapes under their batch-256 plans (one image
# emulated), then edges: C = 4, C not a multiple of 16 or of the chunk
# (vec 4, a tail chunk), odd sizes at stride 2, batch 1-3 plans (one-row
# bands, narrowed chunks), a wide image (a run longer than 8)
DW_CASES = [
    (256, 32, 32, 32, 1), (256, 32, 32, 96, 1), (256, 32, 32, 144, 1), (256, 32, 32, 144, 2),
    (256, 16, 16, 192, 1), (256, 16, 16, 192, 2), (256, 8, 8, 384, 1), (256, 8, 8, 576, 1),
    (256, 8, 8, 576, 2), (256, 4, 4, 960, 1),
    (1, 5, 5, 4, 1), (2, 7, 9, 4, 2), (3, 9, 7, 144, 2), (2, 11, 13, 100, 1), (1, 5, 5, 20, 2),
    (3, 4, 4, 960, 1), (64, 13, 11, 72, 2), (1, 3, 600, 64, 1),
]
# MobileNet-V2's shapes at small batches, where fewer SMs give other plans
# (deeper bands, wider chunks)
OTHER_CARD_CASES = [
    ("h100_pcie", (2, 4, 4, 960, 1)), ("h100_pcie", (4, 32, 32, 96, 1)), ("h100_pcie", (4, 4, 4, 960, 1)),
    ("h100_pcie", (8, 32, 32, 32, 1)), ("h100_pcie", (8, 32, 32, 96, 1)), ("h100_pcie", (8, 4, 4, 960, 1)),
    ("h100_pcie", (16, 32, 32, 32, 1)), ("h100_pcie", (16, 4, 4, 960, 1)), ("h100_pcie", (32, 32, 32, 32, 1)),
    ("h100_pcie", (64, 32, 32, 32, 1)),
    ("h100_mig_1g", (1, 32, 32, 144, 1)), ("h100_mig_1g", (2, 8, 8, 576, 1)), ("h100_mig_1g", (4, 16, 16, 192, 2)),
    ("h100_mig_1g", (8, 32, 32, 144, 2)), ("h100_mig_1g", (16, 4, 4, 960, 1)), ("h100_mig_1g", (1, 8, 8, 576, 2)),
    ("h100_mig_1g", (2, 32, 32, 96, 1)), ("h100_mig_1g", (4, 8, 8, 384, 1)),
]


@pytest.mark.parametrize("card,case", [("h100_sxm", case) for case in DW_CASES] + OTHER_CARD_CASES)
def test_dw_tiling_emulated(card, case):
    """The plan of each shape on its card, run through the kernel's index
    math and tap sums in numpy, gives the plain int32 conv, every output
    once."""
    plan_b, h, w, c, stride = case
    plan = DW.dw_plan(plan_b, h, w, c, stride, SMS[card])
    if card != "h100_sxm":
        assert plan != DW.dw_plan(plan_b, h, w, c, stride, SMS["h100_sxm"])
    rng = np.random.RandomState(h * 1000 + c + stride)
    x = _i8(rng, (min(plan_b, 2 if plan_b < 256 else 1), h, w, c))
    op = DW.pack_dw_weights(_i8(rng, (3, 3, 1, c)), torch.ones(c), torch.zeros(c))
    want = DW.dw_conv_reference(x, op, stride, "int32").numpy()
    np.testing.assert_array_equal(_emulate_dw(x, op, plan), want)


@pytest.mark.parametrize("card", sorted(SMS))
def test_dw_plans_fill_the_card(card):
    """At the serving batch every MobileNet-V2 launch has at least 2 CTAs
    an SM of the card, threads in range and a band that fits; a shape out
    of range is refused."""
    sms = SMS[card]
    for _, h, w, c, stride in DW_CASES[:10]:
        p = DW.dw_plan(256, h, w, c, stride, sms)
        assert p.n_chunks * p.n_bands * p.B >= 2 * sms
        assert 0 < p.threads <= DW.MAX_THREADS and p.smem <= DW.SMEM_MAX
        assert p.CH % p.vec == 0 and (p.CH // 4) * p.TR * p.GX == p.threads
    with pytest.raises(ValueError):
        DW.dw_plan(1, 8, 8, 6, 1, sms)
    with pytest.raises(ValueError):
        DW.dw_plan(1, 8, 8, 8, 3, sms)


# ------------------------------------------- the depthwise form's Hopper kernel


def _emulate_dw_sm90(x: torch.Tensor, op: DW.DwWeights, plan: DW.DwSm90Plan, act=None) -> np.ndarray:
    """csrc/dwconv_sm90.cu's result under `plan` (int32 sums, or act's codes
    through the map's step table), with its index math in numpy: the
    persistent CTAs' walk over the tiles with two band buffers, each band
    the TMA box at (c0, -1, oy0 * s - 1, b) of (CH, HC, HR), zero past the
    tensor's edges, dense in shared memory; then dwconv.cu's threads,
    windows, transposes and dp4a sums on it (P = CH, RP = HC * CH)."""
    p, s = plan, plan.stride
    xn = x.numpy()
    n_img = xn.shape[0]
    w4 = op.w.numpy().view(np.uint32).astype(np.int64)
    out = np.full((n_img, p.Ho, p.Wo, p.C), -(2**40), np.int64)
    assert p.P == p.CH and p.RP == p.HC * p.CH and p.band_bytes >= p.HR * p.RP and p.band_bytes % 128 == 0
    assert p.tab_off >= 2 * p.band_bytes and p.bar_off >= p.tab_off + 1024 * 8 and p.smem >= p.bar_off + 16 + 128
    q, ry, gx = (a.ravel() for a in np.meshgrid(np.arange(p.CH // 4), np.arange(p.TR), np.arange(p.GX),
                                                indexing="ij"))
    assert q.size == p.threads <= DW.MAX_THREADS
    grid = min(p.n_tiles, 3 * 132)
    buffers = [np.random.RandomState(1).randint(0, 256, p.band_bytes).astype(np.uint8) for _ in range(2)]
    xp = np.zeros((n_img, p.H + 2 * p.HR + 2, p.W + p.HC + 2, p.C + p.CH), np.uint8)  # the map's zero outside
    xp[:, p.HR:p.HR + p.H, 1:1 + p.W, :p.C] = xn.view(np.uint8)
    for cta in range(grid):
        for n, tile in enumerate(range(cta, p.n_tiles, grid)):
            chunk, rest = tile % p.n_chunks, tile // p.n_chunks
            c0, oy0, b = chunk * p.CH, (rest % p.n_bands) * p.TR, rest // p.n_bands
            if b >= n_img:
                continue
            ch = min(p.CH, p.C - c0)
            smem = buffers[n % 2]
            iy0 = oy0 * s - 1 + p.HR  # the box's first row in xp
            box = xp[b, iy0:iy0 + p.HR, 0:p.HC, c0:c0 + p.CH]
            assert box.shape == (p.HR, p.HC, p.CH)
            smem[:p.HR * p.RP] = box.reshape(-1)
            words = smem.view(np.uint32).astype(np.int64)
            oy = oy0 + ry
            ox_begin = gx * p.RUN
            ox_end = np.minimum(ox_begin + p.RUN, p.Wo)
            live = (4 * q < ch) & (oy < p.Ho) & (ox_begin < ox_end)
            c = c0 + 4 * q
            quad = np.where(live, c // 4, 0)
            wcols = [[w4[dy * 3 + dx, quad] for dy in range(3)] for dx in range(3)]
            qw = [[t & 0x00FFFFFF for t in _transpose3(*wcols[dx])] for dx in range(3)]
            row0 = ry * s * p.RP + 4 * q

            def load_col(band_col, active):
                at = row0 + band_col * p.P
                assert (at[active] + 2 * p.RP + 4 <= p.HR * p.RP).all()
                at = np.where(active, at, 0)
                return _transpose3(*[words[(at + dy * p.RP) // 4] for dy in range(3)])

            ca = load_col(ox_begin * s, live)
            cb = load_col(ox_begin + 1, live) if s == 1 else None
            for k in range(p.RUN):
                ox = ox_begin + k
                active = live & (ox < ox_end)
                if s == 2:
                    cb = load_col(2 * ox + 1, active)
                cc = load_col(ox * s + 2, active)
                ii = np.nonzero(active)[0]
                for j in range(4):
                    acc = np.zeros(q.size, np.int64)
                    for dx, colw in enumerate((ca, cb, cc)):
                        acc = _dp4a(colw[j], qw[dx][j], acc)
                    assert (out[b, oy[ii], ox[ii], c[ii] + j] == -(2**40)).all()
                    out[b, oy[ii], ox[ii], c[ii] + j] = acc[ii]
                ca, cb = (cb, cc) if s == 1 else (cc, cb)
    assert (out != -(2**40)).all()
    if act is None:
        return out
    h = fma_f32(torch.from_numpy(out.astype(np.float32)), op.scale, op.bias)
    if act.impl == "bins":
        codes = K2.act_codes(h, act.g, "bins")
        return (torch.clamp_min(codes, 0) if act.relu else codes).numpy()
    return K2.act_codes_table_plain(h, K2.act_table(act.impl, act.g, CPU, act.relu)).numpy()


# MobileNet-V2's shapes at the batches it serves, and the edges the form takes
SM90_DW_CASES = [(b, *case[1:]) for b in (256, 8, 3) for case in DW_CASES[:10]] + [
    case for case in DW_CASES[10:] if case[3] % 16 == 0 and case[2] < 254]


@pytest.mark.parametrize("case", SM90_DW_CASES)
def test_dw_sm90_tiling_emulated(case):
    """The Hopper form's plan of each shape (MobileNet-V2's at batches 256,
    8 and 3, and the edges), run through the kernel's walk, TMA boxes and
    tap sums in numpy, gives the plain int32 conv, every output once."""
    batch, h, w, c, stride = case
    plan = DW.dw_sm90_plan(batch, h, w, c, stride, SMS["h100_sxm"])
    assert plan is not None and plan[:15] == DW.dw_plan(batch, h, w, c, stride, SMS["h100_sxm"])[:15]
    rng = np.random.RandomState(h * 1000 + c + stride + batch)
    x = _i8(rng, (min(batch, 2), h, w, c))
    op = DW.pack_dw_weights(_i8(rng, (3, 3, 1, c)), torch.ones(c), torch.zeros(c))
    np.testing.assert_array_equal(_emulate_dw_sm90(x, op, plan), DW.dw_conv_reference(x, op, stride, "int32").numpy())


@pytest.mark.parametrize("case,impl,g,relu", [
    ((256, 8, 8, 576, 1), "erf", 127, True), ((256, 8, 8, 576, 1), "poly", 127, False),
    ((256, 8, 8, 576, 1), "erf", 7, False), ((256, 8, 8, 576, 1), "bins", 7, True),
    ((256, 32, 32, 144, 2), "erf", 127, True)])
def test_dw_sm90_codes_emulated(case, impl, g, relu):
    """The Hopper form's codes (the step table of the erf and poly maps,
    the bins compares) equal the plain version's."""
    _, h, w, c, stride = case
    plan = DW.dw_sm90_plan(2, h, w, c, stride, SMS["h100_sxm"])
    rng = np.random.RandomState(c + g)
    x = _i8(rng, (2, h, w, c))
    scale = torch.from_numpy((rng.uniform(2e-4, 6e-4, c) * rng.choice([-1, 1], c)).astype(np.float32))
    op = DW.pack_dw_weights(_i8(rng, (3, 3, 1, c)), scale, torch.from_numpy(rng.uniform(-1, 1, c).astype(np.float32)))
    act = act_map(impl, g, CPU, relu)
    want = DW.dw_conv_reference(x, op, stride, impl, act).numpy()
    assert len(np.unique(want)) > g
    np.testing.assert_array_equal(_emulate_dw_sm90(x, op, plan, act), want)


def test_dw_sm90_rule_and_refusals():
    """The rule gives the Hopper form every MobileNet-V2 shape (C % 16 ==
    0) and dwconv.cu the others; the form refuses C % 16 != 0 and boxes
    past TMA's 256 a side."""
    for _, h, w, c, stride in DW_CASES[:10]:
        for batch in (256, 8, 3):
            assert DW.dw_sm90_plan(batch, h, w, c, stride, 132) is not None
    assert DW.dw_sm90_plan(2, 11, 13, 100, 1, 132) is None  # C % 16
    assert DW.dw_sm90_plan(1, 5, 5, 4, 1, 132) is None
    assert DW.dw_sm90_plan(1, 3, 600, 64, 1, 132) is None  # a band row of 602 columns


# ------------------------------------------------------ the BN-act table form


@pytest.mark.parametrize("impl,g,relu", [("erf", 127, True), ("erf", 127, False), ("poly", 127, True),
                                          ("bins", 7, True), ("bins", 7, False)])
@pytest.mark.parametrize("ld,c_live,c_out", [(168, 24, 32), (168, 156, 160), (456, 456, 456), (40, 12, 12),
                                             (72, 36, 48), (168, 4, 16)])
def test_bn_act_table_form_is_the_arithmetic(impl, g, relu, ld, c_live, c_out):
    """The table form's plain version (the table built by bn_act_codes_plain
    over all 256 values, then gathered) equals bn_act_codes_plain exactly on
    random int8 buffers, the live prefix of a wider pitch, zero past
    c_live; and the wrappers take it on CPU tensors."""
    rng = np.random.RandomState(ld + c_live + c_out + g + relu)
    x = _i8(rng, (2, 5, 3, ld))
    s = torch.from_numpy(((rng.rand(c_live) - 0.3) * 0.08).astype(np.float32))
    b = torch.from_numpy((rng.randn(c_live) * 0.7).astype(np.float32))
    act = act_map(impl, g, CPU, relu=relu)
    table = K2.bn_act_table(s, b, act)
    assert table.codes.shape == (256, -(-c_live // 128) * 128) and table.codes.dtype == torch.int8
    want = K2.bn_act_codes_plain(x, c_live, s, b, act, c_out)
    got = K2.bn_act_codes_table_plain(x, c_live, table, c_out)
    assert torch.equal(got, want)
    assert torch.equal(K2.bn_act_codes_table(x, c_live, table, c_out), want)
    # every value of every channel, through the table
    every = torch.arange(-128, 128, dtype=torch.int8)[:, None].expand(256, ld).contiguous()
    assert torch.equal(K2.bn_act_codes_table(every, c_live, table, c_out),
                       K2.bn_act_codes_plain(every, c_live, s, b, act, c_out))


def _emulate_bn_table(x: np.ndarray, table: np.ndarray, c_live: int, c_out: int, sms: int) -> np.ndarray:
    """csrc/quantize.cu bn_table_kernel on x (m, ld) uint8 and the table
    (256, tab_ld) uint8, launched as bn_table_launch launches it on `sms`
    SMs, with its index math in numpy. Asserts each output written once
    and every gather of lane l in bank l."""
    ch, rows, unroll, min_steps, ctas = 128, 16, 8, 2, 2  # TB_CH, TB_ROWS, TB_U, BN_MIN_STEPS, TB_CTAS_PER_SM
    m, tab_ld = x.shape[0], table.shape[1]
    chunks = -(-c_out // ch)
    want, cap = -(-m // (rows * unroll * min_steps)), ctas * sms // chunks
    grid_y = want if want < cap else max(cap, 1)
    step = rows * grid_y
    out = np.full((m, c_out), -1, np.int64)
    lane = np.arange(32)
    rng = np.random.RandomState(1)
    flat = table.reshape(-1)
    for bx in range(chunks):
        c0 = bx * ch
        tab = rng.randint(0, 256, 256 * ch).astype(np.uint8)  # stale shared memory
        if c0 < c_live:
            i = np.arange(256 * ch // 16)
            src = c0 // 16 + (i // (ch // 16)) * (tab_ld // 16) + i % (ch // 16)  # 16-byte pieces
            tab.reshape(-1, 16)[i] = flat.reshape(-1, 16)[src]
        c = c0 + 4 * lane
        act, live = c < c_out, c < c_live
        for by in range(grid_y):
            for y in range(rows):
                for m0 in range(by * rows + y, m, unroll * step):
                    for r in range(m0, min(m0 + unroll * step, m), step):
                        for j in range(4):
                            idx = x[r, np.where(live, c + j, 0)].astype(np.int64) * ch + 4 * lane + j
                            assert ((idx // 4) % 32 == lane).all()  # the lane's own bank
                            code = np.where(live, tab[idx], 0)
                            assert (out[r, c[act] + j] == -1).all()
                            out[r, c[act] + j] = code[act]
    assert (out >= 0).all()
    return out.astype(np.uint8)


@pytest.mark.parametrize("ld,c_live,c_out,m,sms", [(168, 168, 176, 1000, 132), (312, 228, 240, 700, 4),
                                                   (456, 444, 448, 300, 2), (168, 24, 32, 50, 132),
                                                   (168, 4, 16, 40, 1), (44, 20, 24, 513, 3),
                                                   (456, 128, 144, 100, 8)])
def test_bn_table_kernel_emulated(ld, c_live, c_out, m, sms):
    """The table kernel's grid, slice copy and gathers, in numpy, give the
    table form's plain version: every row block and chunk (one past the
    live channels among them), the pitch of the table padded."""
    rng = np.random.RandomState(ld + c_live + m)
    x = _i8(rng, (m, ld))
    c_pad = -(-c_live // 128) * 128
    codes = _i8(rng, (256, c_pad))
    codes[:, c_live:] = 0
    table = K2.BnActTable(codes, torch.zeros(c_live), torch.zeros(c_live), None)
    want = K2.bn_act_codes_table_plain(x, c_live, table, c_out)
    got = _emulate_bn_table(x.numpy().view(np.uint8), codes.numpy().view(np.uint8), c_live, c_out, sms)
    np.testing.assert_array_equal(got.view(np.int8), want.numpy())


def test_bn_act_table_refusals():
    act = act_map("erf", 127, CPU, relu=True)
    table = K2.bn_act_table(torch.ones(8), torch.zeros(8), act)
    x8 = torch.zeros((2, 16), dtype=torch.int8)
    with pytest.raises(TypeError):
        K2.bn_act_codes_table(x8.float(), 8, table)
    with pytest.raises(ValueError):
        K2.bn_act_codes_table(x8, 12, table)
    with pytest.raises(ValueError):
        K2.bn_act_codes_table(x8, 8, table, 6)


def test_densenet_int8_sites_build_each_table_once():
    """The int8 buffer's forward builds each site's table on first use and
    keeps it in the operands: a second forward builds none, and gives the
    same logits."""
    from alignq_tpu_torch.kernels import infer_densenet as D

    fn, (qp, x) = D.build_densenet40_int8(1, device="cpu", depth=10, stage_int8=True)
    ops = D.pack_densenet40_operands(qp, stage_int8=True)
    first = fn(qp, x, stage_int8=True, operands=ops)
    sites = [blk["bn"] for st in ops["stages"] for blk in st["blocks"]]
    sites += [st["trans"]["bn"] for st in ops["stages"] if "trans" in st] + [ops["bn"]]
    assert all(len(site.tables) == 1 for site in sites)
    tables = [next(iter(site.tables.values())) for site in sites]
    assert torch.equal(fn(qp, x, stage_int8=True, operands=ops), first)
    assert all(next(iter(site.tables.values())) is t for site, t in zip(sites, tables))
    # the f32 buffer's sites run the arithmetic: no table
    fn, (qp, x) = D.build_densenet40_int8(1, device="cpu", depth=10)
    ops = D.pack_densenet40_operands(qp)
    fn(qp, x, operands=ops)
    assert not ops["bn"].tables
