"""K1's narrow Hopper form (csrc/qmatmul_sm90n.cu) on the CPU: its rule,
its plans, its K order and a model of its shared-memory layout.

The kernel runs only on the card (tests/test_torch_cuda_kernels.py holds
it against the plain version and against the mma.sync form there). Here
the Python that computes its plan and its layout is tested:
- the planner's rule over every CIFAR graph's K1 launches at batches 256,
  8 and 3 (and ResNet-20's at 2048): which take the narrow form, and the
  counts chip_smoke.py asserts;
- every narrow plan within the SM's 227 KB, its regions apart, its tiles
  covering every row it runs once, its band within its buffer;
- the re-packed K order is a permutation of the packed columns plus zero
  columns;
- a numpy model of the kernel (the resident weight's TMA boxes under their
  swizzle, each chunk's group-major band over the padded batch, the step
  table and A's descriptor reads of its core matrices, B's descriptor
  reads, the warpgroups' rows and K steps, the accumulator map into each
  K share's int32 tile, and the epilogue's sum of the shares over the
  rows that land, the halo's dropped),
  written from the kernel's index math, rebuilds the int32 conv: against
  the port's int8_conv_reference, and against jitted JAX's
  _int8_conv_acc.
"""

import collections

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from alignq_tpu.kernels import infer as J
from alignq_tpu.kernels.convert import QConvInt8 as JQConv
from alignq_tpu_torch.kernels import qmatmul as K1
from test_torch_deploy_families import _family_k1_shapes
from test_torch_k1_sm90 import _swizzle


def _resnet20_shapes(batch):
    """{name: conv_plan args} of ResNet-20's K1 convs at `batch`."""
    out = {}
    for name, b, h, w, c, ks, st, n in chip_smoke.conv_shapes(batch):
        cp = -(-c // 4) * 4
        out[name] = (b, h, w, cp, ks, st, ks // 2, -(-n // 8) * 8, -(-(ks * ks * cp) // 32) * 32)
    return out


def _form(args):
    plan = K1.k1_plan(*args)
    return {K1.Sm90Plan: "sm90", K1.NarrowPlan: "narrow", K1.PlanePlan: "plane", K1.ConvPlan: "mma"}[type(plan)]


@pytest.mark.parametrize("batch", [2048, 256, 64, 8, 3])
def test_the_rule_on_resnet20(batch):
    """ResNet-20's block-3 skip takes the narrow form, its block-6 convs
    the Hopper form, the stride-2 block-3 conv0 and block-3 conv1 the plane
    form, the stage-1 conv the plane form from batch 33 and the narrow form
    below (plane_takes, as measured; chip_smoke.r20_forms); the 4-channel
    stem (as a K1 launch: the forwards give it kernels/first_conv.py) and
    the merged conv the mma.sync form; per forward, 1 of the slice route's
    7 launches in the narrow form, and of the erf route's 21, 1 from batch
    33 (chip_smoke.NARROW_PER_FORWARD) and 7 below."""
    shapes = _resnet20_shapes(batch)
    forms = {name: _form(args) for name, args in shapes.items()}
    narrow, plane = chip_smoke.r20_forms(batch)
    assert {n for n, f in forms.items() if f == "narrow"} == narrow
    assert {n for n, f in forms.items() if f == "sm90"} == {
        "block6 conv0", "block6 skip", "block6 conv1", "block6 merged"}
    assert {n for n, f in forms.items() if f == "plane"} == plane
    assert {n for n, f in forms.items() if f == "mma"} == {"stem conv", "block3 merged"}
    assert K1.narrow_plan(*shapes["block3 conv1"]) is not None and K1.narrow_plan(*shapes["block3 conv0"]) is None
    for route, i in (("resnet20 slice", 0), ("resnet20 erf", 1)):
        n = sum(counts[i] for key, counts in chip_smoke.conv_shapes(batch).items() if forms[key[0]] == "narrow")
        assert n == (chip_smoke.NARROW_PER_FORWARD[route] if batch >= 33 else {0: 1, 1: 7}[i])


@pytest.mark.parametrize("batch", [256, 8, 3])
def test_the_rule_on_the_family_graphs(batch):
    """DenseNet-40's growth convs and transitions and MobileNet-V2's 1x1s
    over 16 or more channels that the Hopper form does not take go to the
    narrow form where narrow_takes gives it them, chip_smoke's counts at
    each batch: at 256 DenseNet-40 keeps its two transitions, its two
    32x32 convs over 48 channels and its 16x16 convs over 176-208 channels
    in mma.sync, and gives its first growth conv (32 channels) the plane
    form; at 8 it keeps its first transition;
    every graph's first conv (over the image's 4 channels) and MobileNet-V2's
    1x1s over 24 channels stay in mma.sync, its 23 wide ones in the Hopper
    form."""
    shapes = _family_k1_shapes(batch)
    dense, mobile = shapes[:1] + shapes[2:40], shapes[1:2] + shapes[40:]  # each graph's first conv, then the rest
    forms = collections.Counter(_form(a) for a in dense)
    plane = int(batch == 256)
    want = {"narrow": chip_smoke.NARROW_PER_FORWARD["densenet40", batch],
            "mma": 39 - plane - chip_smoke.NARROW_PER_FORWARD["densenet40", batch], "plane": plane}
    assert forms == {k: v for k, v in want.items() if v}
    kept = {(a[1], a[3], a[4], a[7]) for a in dense if _form(a) == "mma"}
    assert kept == {(32, 4, 3, 24)} | {256: {(32, 176, 1, 168), (16, 320, 1, 312), (32, 48, 3, 16), (16, 176, 3, 16),
                                             (16, 192, 3, 16), (16, 208, 3, 16)},
                                       8: {(32, 176, 1, 168)}, 3: set()}[batch]
    forms = collections.Counter(_form(a) for a in mobile)
    assert forms["sm90"] == 23 and forms["narrow"] == chip_smoke.NARROW_PER_FORWARD["mobilenetv2", batch]
    assert {a[3] for a in mobile if _form(a) == "mma" and K1.narrow_plan(*a) is None} == {4, 24}
    for args in set(shapes):
        if _form(args) == "narrow":
            _check_plan(K1.k1_plan(*args))
        elif _form(args) == "mma" and K1.narrow_plan(*args) is not None:  # left by the rule: still planned
            assert not K1.narrow_takes(*args[:8])
            _check_plan(K1.narrow_plan(*args))


def test_narrow_plan_refuses_shapes_off_the_form():
    assert K1.narrow_plan(2, 9, 9, 24, 3, 1, 1, 16, 224) is None  # C % 16
    assert K1.narrow_plan(2, 9, 9, 4, 3, 1, 1, 16, 64) is None  # the 4-channel first convs
    assert K1.narrow_plan(2, 9, 9, 16, 5, 1, 0, 16, 416) is None  # 5x5
    assert K1.narrow_plan(2, 9, 9, 16, 7, 2, 3, 16, 800) is None  # 7x7
    assert K1.narrow_plan(2, 9, 9, 16, 3, 1, 0, 16, 160) is None  # 3x3 takes pad 1
    assert K1.narrow_plan(2, 9, 9, 16, 3, 2, 1, 32, 160) is None  # a 3x3 takes stride 1
    assert K1.narrow_plan(2, 9, 9, 16, 1, 2, 0, 32, 32) is not None  # a 1x1 stride 2
    assert K1.narrow_plan(2, 9, 9, 16, 1, 3, 0, 16, 32) is None  # stride 3
    # where both Hopper forms take a shape, the rule gives the wide one
    args = (2, 8, 8, 64, 3, 1, 1, 64, 576)
    assert K1.narrow_plan(*args) is not None and isinstance(K1.k1_plan(*args), K1.Sm90Plan)


def test_forced_form_is_the_only_way_round_the_rule():
    args = _resnet20_shapes(256)["block3 skip"]
    assert isinstance(K1.k1_plan(*args), K1.NarrowPlan)
    with K1._mma_form():
        assert isinstance(K1.k1_plan(*args), K1.ConvPlan)
    assert isinstance(K1.k1_plan(*args), K1.NarrowPlan)


def _check_plan(p):
    """A plan within the SM, its regions in order and apart, its tiles
    over the N blocks covering each row it runs once, its band holding
    every pixel its steps read."""
    assert p.smem <= K1.SM90_SMEM and 2 <= p.n_stages <= K1.NARROW_MAX_STAGES
    assert p.NB in (16, 32, 64) and p.n_blocks * p.NB >= p.N8 > (p.n_blocks - 1) * p.NB
    assert p.MG in (1, K1._mg_max(p.NB)) and p.TM == 64 * p.MG * p.WM and p.n_wg == p.WM * p.WK <= 4
    assert p.C == p.CC * p.n_chunks and p.CC == 16 * p.G and p.KCP == 32 * p.steps
    assert p.steps == len(K1._narrow_steps(p.ksize, p.G)) == -(-p.ksize ** 2 * p.CC // 32)
    assert p.KT == p.n_chunks * p.KCP and p.KT % p.SWZ == 0 and p.n_boxes * p.SWZ == p.KT
    assert p.w_bytes == p.NB * p.KT and p.n_chunks * p.steps >= p.WK
    assert p.w_bytes <= p.stage_off and p.stage_off % 16 == 0 and p.stage_bytes % 16 == 0
    assert p.stage_off + p.n_stages * p.stage_bytes <= p.acc_off and p.acc_off % 16 == 0
    assert p.acc_off + p.WK * p.TM * (p.NB + 8) * 4 <= p.sb_off and p.sb_off % 16 == 0
    assert p.sb_off + 8 * p.NB <= p.tab_off and p.tab_off % 8 == 0
    assert p.tab_off + 8 * p.steps <= p.bar_off and p.bar_off % 8 == 0
    assert 1024 + p.bar_off + 8 * (K1.NARROW_MAX_STAGES + 1) == p.smem
    assert p.G * p.GS == p.a_bytes <= p.stage_bytes and p.GS == 16 * p.NPIX
    if p.ksize == 3:
        assert p.stride == 1 and (p.Hp, p.HC) == (p.H + 2, p.W + 2) and p.MP == p.B * p.Hp * p.HC
    else:
        assert p.MP == p.M == p.B * p.Ho * p.Wo
    rows = (np.arange(p.n_tiles)[:, None] * p.TM + np.arange(p.TM)[None, :]).reshape(-1)
    rows = rows[rows < p.MP]
    assert np.array_equal(np.bincount(rows, minlength=p.MP), np.ones(p.MP))
    assert p.n_items == p.n_tiles * p.n_blocks
    # the farthest byte A's descriptors read: the tile's last row at the
    # last step's second half, within the group's pixels
    for a_off, lbo in _step_table(p):
        assert a_off + lbo + 16 * (p.TM - 1) + 16 <= p.a_bytes
        assert (a_off % p.GS) + (lbo if lbo < p.GS else 0) + 16 * p.TM <= p.GS


def _tap_off(p, t):
    return 0 if p.ksize == 1 else (t // 3) * p.HC + t % 3


def _step_table(p):
    """csrc/qmatmul_sm90n.cu's step table: (A's offset in the band, its
    second 16 bytes' offset from the first) of each K step of a chunk."""
    out = []
    for first, second in K1._narrow_steps(p.ksize, p.G):
        a_off = first[0] * p.GS + 16 * _tap_off(p, first[1])
        if second is None:
            lbo = 16
        elif second[0] != first[0]:
            lbo = p.GS
        else:
            lbo = 16 * (_tap_off(p, second[1]) - _tap_off(p, first[1]))
        out.append((a_off, lbo))
    return out


@pytest.mark.parametrize("batch", [2048, 256, 3])
def test_resnet20_plans_fit_and_cover_every_output_once(batch):
    for name, args in _resnet20_shapes(batch).items():
        plan = K1.k1_plan(*args)
        if isinstance(plan, K1.NarrowPlan):
            _check_plan(plan)
            for option in K1.narrow_options(args[7]):  # every option --k1-ab times
                forced = K1.narrow_plan(*args, option=option)
                if forced is not None:
                    _check_plan(forced)


def test_tiles_follow_the_launch_size():
    """Tall tiles on one warpgroup (MG at its most) at ResNet-20's stage-1
    conv at 2048 (5 K steps; the plane form takes it, narrow_plan still
    plans it), on two at DenseNet-40's 32x32 convs over 64 channels at 256;
    two warpgroups of 64 rows at its 16x16 convs at 256; 64-row tiles with
    K split over 4 warpgroups at its deep 8x8 convs at 256 and at the
    ragged batch 3."""
    p = K1.narrow_plan(*_resnet20_shapes(2048)["stage1 conv"])
    assert (p.MG, p.WM, p.WK, p.TM) == (4, 1, 1, 256)
    p = K1.k1_plan(256, 32, 32, 64, 3, 1, 1, 16, 576)
    assert (p.MG, p.WM, p.WK, p.TM) == (4, 2, 1, 512)
    p = K1.k1_plan(256, 16, 16, 240, 3, 1, 1, 16, 2176)
    assert (p.MG, p.WM, p.WK) == (1, 2, 1)
    # the 1x1s at batch 8: K split where the launch has few work items
    assert K1.k1_plan(8, 8, 8, 576, 1, 1, 0, 96, 576).WK == 4 and K1.k1_plan(8, 8, 8, 96, 1, 1, 0, 96, 96).WK == 2
    assert K1.k1_plan(8, 16, 16, 320, 1, 1, 0, 312, 320).WK == 1  # 5 N blocks: enough items
    deep = (256, 8, 8, 448, 3, 1, 1, 16, 4032)
    p = K1.k1_plan(*deep)
    assert (p.MG, p.WM, p.WK, p.TM) == (1, 1, 4, 64)
    assert K1.k1_plan(3, *deep[1:]).WK == 4


@pytest.mark.parametrize("ksize,c,cc", [(3, 16, 16), (3, 48, 48), (3, 96, 32), (1, 176, 176), (1, 48, 16)])
def test_k_order_is_a_permutation_plus_zero_columns(ksize, c, cc):
    """The re-packed K: every packed (dy, dx, c) column once and zero
    columns (-1) only where a chunk's odd group meets its last tap; each 16
    bytes one group (16 channels) of one tap, in _narrow_steps' order; the
    re-packed weight those columns of the packed one, rows zero-padded to
    the N blocks."""
    order = K1._narrow_k_order(ksize, c, cc)
    taps, g = ksize * ksize, cc // 16
    steps = K1._narrow_steps(ksize, g)
    assert len(order) == (c // cc) * 32 * len(steps)
    assert sorted(order[order >= 0]) == list(range(taps * c))
    assert (order < 0).sum() == (c // cc) * 16 * (g % 2) * (taps % 2)
    halves = order.reshape(c // cc, len(steps), 2, 16)
    for chunk in range(c // cc):
        for k, step in enumerate(steps):
            for h, half in enumerate(step):
                got = halves[chunk, k, h]
                if half is None:
                    assert (got == -1).all()
                else:
                    q, t = half
                    assert np.array_equal(got, t * c + chunk * cc + 16 * q + np.arange(16))
    wt = torch.from_numpy(np.random.RandomState(c).randint(-127, 128, (24, K1._round_up(taps * c, 32))).astype(np.int8))
    p = K1.narrow_plan(2, 6, 6, c, ksize, 1, ksize // 2, 24, wt.shape[1])
    packed = K1._narrow_weight(wt, p._replace(CC=cc, G=g)).numpy()
    assert packed.shape == (32, len(order))  # N8 24 in one block of 32: rows 24-31 zero
    assert (packed[24:] == 0).all() and (packed[:, order < 0] == 0).all()
    np.testing.assert_array_equal(packed[:24, order >= 0], wt.numpy()[:, order[order >= 0]])


# ------------------------------------------------------- the layout model


def _band_image(x, p, tile, chunk):
    """The band buffer of step (tile, chunk): group q of band pixel i at
    q * GS + 16 i, the chunk's channels; a 3x3's pixel i the padded batch's
    position m0 + i (zero in the halo and past the batch), a 1x1's the
    input pixel of output m0 + i."""
    band = np.zeros(p.stage_bytes, dtype=np.int8)
    m0, c0 = tile * p.TM, chunk * p.CC
    pos = m0 + np.arange(p.NPIX)
    if p.ksize == 1:
        ok = pos < p.M
        b, r = np.divmod(np.minimum(pos, p.M - 1), p.Ho * p.Wo)
        oy, ox = np.divmod(r, p.Wo)
        vals = x[b, oy * p.stride, ox * p.stride, c0:c0 + p.CC]
    else:
        b, rem = np.divmod(pos, p.Hp * p.HC)
        iy, ix = np.divmod(rem, p.HC)
        iy, ix = iy - 1, ix - 1
        ok = (b < p.B) & (iy >= 0) & (iy < p.H) & (ix >= 0) & (ix < p.W)
        vals = x[np.minimum(b, p.B - 1), np.clip(iy, 0, p.H - 1), np.clip(ix, 0, p.W - 1), c0:c0 + p.CC]
    vals = np.where(ok[:, None], vals, 0).reshape(p.NPIX, p.G, 16)
    at = np.arange(p.G)[None, :, None] * p.GS + 16 * np.arange(p.NPIX)[:, None, None] + np.arange(16)
    band[at] = vals
    return band


def _out_row(p, pos):
    """csrc/qmatmul_sm90n.cu out_row: the output row of each run row, -1
    for the halo's and past the end."""
    pos = np.asarray(pos)
    if p.ksize == 1:
        return np.where(pos < p.MP, pos, -1)
    b, rem = np.divmod(pos, p.Hp * p.HC)
    oy, ox = np.divmod(rem, p.HC)
    return np.where((pos < p.MP) & (oy < p.H) & (ox < p.W), (b * p.H + oy) * p.W + ox, -1)


def emulate_narrow(x, op, p):
    """Run p's work items through the kernel's index math in numpy. Returns
    (out int32 (M, N8), A (M, Kp) and B (Kp, n_blocks * NB) as wgmma saw
    them, put back in the packed (dy, dx, c) K order)."""
    packed = K1._narrow_weight(op.wt, p).numpy()
    order = K1._narrow_k_order(p.ksize, p.C, p.CC)
    table = _step_table(p)
    out = np.zeros((p.M, p.N8), dtype=np.int64)
    a_seen = np.zeros((p.M, p.Kp), dtype=np.int64)
    b_seen = np.zeros((p.Kp, p.NB * p.n_blocks), dtype=np.int64)
    nk = p.steps
    tid = np.arange(128 * p.n_wg)
    wg, rt = tid >> 7, tid & 127
    wm, wk = wg % p.WM, wg // p.WM
    q, g, t = rt >> 5, (rt & 31) >> 2, rt & 3
    j, hh, v = np.meshgrid(np.arange(p.NB // 8), np.arange(2), np.arange(2), indexing="ij")
    r64 = np.arange(64)
    for nb in range(p.n_blocks):
        # the resident weight: box a holds K bytes a*SWZ.. of rows nb*NB.., swizzled
        wsm = np.zeros(p.w_bytes, dtype=np.int8)
        n = np.arange(p.NB)[:, None]
        for a in range(p.n_boxes):
            box = packed[nb * p.NB + n, a * p.SWZ + np.arange(p.SWZ)[None, :]]
            wsm[a * p.NB * p.SWZ + _swizzle(n * p.SWZ + np.arange(p.SWZ)[None, :], p.SWZ)] = box
        for tile in range(p.n_tiles):
            m0 = tile * p.TM
            acc = np.zeros((p.WK, p.WM, p.MG, 64, p.NB), dtype=np.int64)
            for chunk in range(p.n_chunks):
                band = _band_image(x, p, tile, chunk)
                for k in range(nk):
                    owner = (chunk * nk + k) % p.WK  # the warpgroup over K that takes this step
                    a_off, lbo = table[k]
                    kb = chunk * p.KCP + 32 * k
                    at = (kb // p.SWZ) * p.NB * p.SWZ + _swizzle(
                        np.arange(p.NB)[None, :] * p.SWZ + kb % p.SWZ + np.arange(32)[:, None], p.SWZ)
                    b_mat = wsm[at].astype(np.int64)  # (32 k, NB)
                    cols = order[kb + np.arange(32)]
                    real = cols >= 0
                    b_seen[cols[real][:, None], nb * p.NB + np.arange(p.NB)[None, :]] = b_mat[real]
                    for w_ in range(p.WM):
                        for mg in range(p.MG):
                            # A by descriptor: row r of the group at 16 r from the
                            # group's first row (1 KB a group, MG KB a warpgroup),
                            # the step's first 16 bytes at a_off, the second lbo on
                            start = 1024 * (p.MG * w_ + mg) + a_off
                            rows = start + 16 * r64[:, None]
                            a_mat = np.concatenate([band[rows + np.arange(16)], band[rows + lbo + np.arange(16)]],
                                                   axis=1).astype(np.int64)
                            acc[owner, w_, mg] += a_mat @ b_mat
                            m = _out_row(p, m0 + 64 * (p.MG * w_ + mg) + r64)
                            keep = m >= 0
                            a_seen[m[keep][:, None], cols[real][None, :]] = a_mat[keep][:, real]
            # each warpgroup's sums into its K share's int32 tile (accumulator
            # 4j + 2h + v of thread (q, g, t) of row group mg: tile row
            # 64 (MG wm + mg) + 16q + g + 8h, column 8j + 2t + v); the
            # epilogue adds the shares of each row that lands, columns < N8
            tiles = np.zeros((p.WK, p.TM, p.NB + 8), dtype=np.int64)
            w_, k_ = wm[:, None, None, None], wk[:, None, None, None]
            for mg in range(p.MG):
                r = (16 * q + g)[:, None, None, None] + 8 * hh
                c = 8 * j + 2 * t[:, None, None, None] + v
                tiles[k_, 64 * (p.MG * w_ + mg) + r, c] = acc[k_, w_, mg, r, c]
            m = _out_row(p, m0 + np.arange(p.TM))
            ncols = min(p.NB, p.N8 - nb * p.NB)
            out[m[m >= 0], nb * p.NB:nb * p.NB + ncols] = tiles.sum(axis=0)[m >= 0, :ncols]
    return out, a_seen, b_seen


# (B, H, W, Cin, ksize, stride, N, option, cc): ResNet-20's stage-1 conv,
# block-3 skip and block-3 conv1 at batch 2, DenseNet-40's growth convs (C = 48, 176, 448: an odd
# group, the 16x16 and deepest 8x8 ones) and its first transition at batch
# 1-2; then forced options: K split over 2 and 4 warpgroups, ragged last
# tiles, a ragged last N block (N8 40 of 64), several chunks of an odd
# group count, a 1x1 at stride 2 over 2 chunks, the GEMM form's (1, 1, M, K)
MODEL_FORMS = [
    (2, 32, 32, 16, 3, 1, 16, None, None), (2, 32, 32, 16, 1, 2, 32, None, None),
    (2, 16, 16, 32, 3, 1, 32, None, None), (1, 32, 32, 48, 3, 1, 12, None, None),
    (2, 16, 16, 176, 3, 1, 12, None, None), (2, 8, 8, 448, 3, 1, 12, None, None),
    (2, 8, 8, 176, 1, 1, 168, None, None), (1, 7, 6, 96, 3, 1, 24, (2, 1, 2), 32),
    (3, 5, 7, 48, 3, 1, 40, (1, 2, 2), 16), (2, 5, 7, 48, 3, 1, 16, (1, 1, 4), 16),
    (2, 6, 5, 64, 1, 2, 104, (1, 1, 2), 32), (1, 1, 150, 80, 1, 1, 16, (4, 1, 1), 16),
    (2, 5, 6, 80, 3, 1, 16, (1, 2, 1), 80),
]


@pytest.mark.parametrize("form", MODEL_FORMS)
def test_layout_model_rebuilds_the_conv(form):
    b, h, w, c, ks, st, n, option, cc = form
    rng = np.random.RandomState(b * c + n + ks)
    x = rng.randint(-127, 128, (b, h, w, c)).astype(np.int8)
    kern = rng.randint(-127, 128, (ks, ks, c, n)).astype(np.int8)
    op = K1.pack_conv_weights(torch.from_numpy(kern))
    args = (b, h, w, c, ks, st, ks // 2, *op.wt.shape)
    if option is None:  # the form's own plan of the shape (the rule may give the shape mma.sync)
        p = K1.narrow_plan(*args)
        assert p is not None
    else:
        p = K1._narrow_layout(*args[:8], cc, *option)
        assert p is not None and p.CC == cc
    _check_plan(p)
    out, a_seen, b_seen = emulate_narrow(x, op, p)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(a_seen, K1.gather_taps(xt, ks, st, ks // 2, K1.K_MULT).numpy())
    np.testing.assert_array_equal(b_seen[:, :n], K1.kernel_matrix(torch.from_numpy(kern), K1.K_MULT).numpy())
    want = K1.int8_conv_reference(xt, op, st, ks // 2, "int32").reshape(-1, n).numpy()
    np.testing.assert_array_equal(out[:, :n], want)
    if form in (MODEL_FORMS[0], MODEL_FORMS[5]):  # ResNet-20's stage-1 conv, DenseNet-40's deepest growth conv
        q = JQConv(kern, np.ones(n, np.float32), np.zeros(n, np.float32))
        acc = np.asarray(jax.jit(J._int8_conv_acc, static_argnums=(2, 3))(x, q, st, ks // 2))
        np.testing.assert_array_equal(out[:, :n], acc.reshape(-1, n))
