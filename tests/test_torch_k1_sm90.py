"""K1's Hopper form (csrc/qmatmul_sm90.cu) on the CPU: its plans and a
model of its shared-memory layout.

The kernel runs only on the card (tests/test_torch_cuda_kernels.py holds
it against the plain version and against the mma.sync form there). Here
the Python that computes its plan and its layout is tested:
- every trunk launch that the planner's rule gives the form gets a plan
  within the SM's 227 KB whose tiles write each output once, and the rule
  gives the form the launches it names;
- a numpy model of one step's shared-memory image (the band of a chunk's
  channels, the weight chunk's TMA boxes under their swizzle, the k-word
  table that fills wgmma's A registers, the descriptor's reads of B and
  the accumulator's (row, column) map), written from the kernel's index
  math, rebuilds the matrices gather_taps and kernel_matrix give, and its
  int32 product equals int8_conv_reference exactly.
"""

import collections

import numpy as np
import pytest
import torch

import chip_smoke
from alignq_tpu_torch.kernels import qmatmul as K1
from test_torch_deploy_families import _family_k1_shapes
from test_torch_resnet_imagenet import _trunk_convs


def _plans(arch, batch):
    """[(conv_plan args, launches a forward, the planned form's plan)] of a trunk."""
    out = []
    for (b, h, w, c, ks, st, n), count in collections.Counter(_trunk_convs(arch, batch, 224)).items():
        args = (b, h, w, c, ks, st, ks // 2, n, K1._round_up(ks * ks * c, K1.K_MULT))
        out.append((args, count, K1.k1_plan(*args)))
    return out


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
@pytest.mark.parametrize("batch", [256, 4, 3])
def test_the_rule_gives_the_trunk_convs_the_form(arch, batch):
    """Every 1x1 and 3x3 conv of a trunk takes the Hopper form, all but
    the 7x7 stem (19 of ResNet-18's 20 launches a forward, 52 of
    ResNet-50's 53, as chip_smoke.py asserts), at every batch."""
    n = 0
    for args, count, plan in _plans(arch, batch):
        assert isinstance(plan, K1.Sm90Plan) == (args[4] != 7)
        n += count * isinstance(plan, K1.Sm90Plan)
    assert n == chip_smoke.SM90_PER_FORWARD[arch]


@pytest.mark.parametrize("batch", [256, 8, 3])
def test_the_rule_on_the_cifar_graphs(batch):
    """The CIFAR graphs' launches take the Hopper form where sm90_plan
    takes their shape: MobileNet-V2's 1x1s from 32 channels up (10 of its
    distinct shapes), ResNet-20's block-6 convs over 32 and 64 channels
    (and the merged block-6 conv); no DenseNet-40 launch (its growth of 12
    channels breaks C % 32 and N8 % 64: the narrow Hopper form takes
    chip_smoke.NARROW_PER_FORWARD of its 39 at each batch,
    tests/test_torch_k1_narrow.py holds which), no stem, no 5x5 digit
    conv. Each plan fits and writes every output once."""
    dense = _family_k1_shapes(batch)[:1] + _family_k1_shapes(batch)[2:40]
    assert not any(isinstance(K1.k1_plan(*a), K1.Sm90Plan) for a in dense)
    assert sum(isinstance(K1.k1_plan(*a), K1.NarrowPlan) for a in dense) == \
        chip_smoke.NARROW_PER_FORWARD["densenet40", batch]
    shapes = set(_family_k1_shapes(batch))
    taken = {args for args in shapes if isinstance(K1.k1_plan(*args), K1.Sm90Plan)}
    assert {args for args in shapes if K1.sm90_plan(*args) is not None} == taken
    assert {(h, c, n8) for _, h, _, c, ks, _, _, n8, _ in taken if ks == 1} == {
        (16, 32, 192), (8, 64, 384), (8, 96, 576), (8, 192, 64), (8, 64, 64), (8, 384, 64), (4, 160, 960),
        (4, 160, 320), (4, 320, 1280), (4, 960, 320)}
    assert len(taken) == 10
    for batch_ in (batch, 2048):  # ResNet-20's convs, the bench's batch among them
        r20 = set()
        for name, b, h, w, c, ks, st, n in chip_smoke.conv_shapes(batch_):
            cp = -(-c // 4) * 4
            args = (b, h, w, cp, ks, st, ks // 2, -(-n // 8) * 8, -(-(ks * ks * cp) // 32) * 32)
            plan = K1.k1_plan(*args)
            if isinstance(plan, K1.Sm90Plan):
                r20.add(name)
                _check_plan(plan)
        assert r20 == {"block6 conv0", "block6 skip", "block6 conv1", "block6 merged"}
    for args in taken:
        _check_plan(K1.k1_plan(*args))
    for args in [(batch, 224, 224, 4, 7, 2, 3, 64, 224), (batch, 28, 28, 4, 5, 1, 0, 32, 128),
                 (batch, 12, 12, 32, 5, 1, 0, 48, 800), (batch, 32, 32, 4, 3, 1, 1, 16, 64)]:
        assert isinstance(K1.k1_plan(*args), K1.ConvPlan)


def _check_plan(p):
    """A plan within the SM, its tiles over the N blocks writing each
    output once, every tile's band within its buffer."""
    assert p.smem <= K1.SM90_SMEM and 2 <= p.n_stages <= K1.SM90_MAX_STAGES
    assert p.TM == 64 * p.n_wg and p.n_wg in (1, 2, 4) and p.NB in (64, 128) and p.N8 == p.NB * p.n_blocks
    assert p.C % p.CC == 0 and p.CC % 32 == 0 and p.KC == p.ksize ** 2 * p.CC and p.KC % p.SWZ == 0
    assert p.w_bytes == p.n_boxes * p.NB * p.SWZ and p.n_boxes * p.SWZ == p.KC
    assert p.stage_bytes % 1024 == 0 and p.w_bytes + p.a_bytes <= p.stage_bytes
    assert p.smem >= 1024 + p.n_stages * p.stage_bytes + 8 * K1.SM90_MAX_STAGES + 4 * p.koff_words
    step = p.stride if p.ksize > 1 else 1
    assert (step * p.P) % 64 == 32 and p.P >= p.CC and p.P % 16 == 0
    rows = np.arange(p.n_tiles)[:, None] * p.TM + np.arange(p.TM)[None, :]
    rows = rows[rows < p.M]
    assert np.array_equal(np.bincount(rows, minlength=p.M), np.ones(p.M))
    assert p.n_items == p.n_tiles * p.n_blocks
    if p.ksize > 1:
        m0 = np.arange(p.n_tiles) * p.TM
        m1 = np.minimum(m0 + p.TM, p.M) - 1

        def row(m):
            return m // (p.Ho * p.Wo) * p.Hp + m % (p.Ho * p.Wo) // p.Wo * p.stride

        assert (row(m1) - row(m0) + p.ksize).max() == p.HR
        assert p.HR * p.RP <= p.a_bytes and p.RP == p.HC * p.P and p.HC == p.W + 2
    else:
        assert p.TM * p.P <= p.a_bytes


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
@pytest.mark.parametrize("batch", [256, 3])
def test_trunk_plans_fit_and_cover_every_output_once(arch, batch):
    for args, _, plan in _plans(arch, batch):
        if isinstance(plan, K1.Sm90Plan):
            _check_plan(plan)
            if args[7] % 128 == 0:  # the column-parallel slices at a model axis of 2 (N/2) plan too
                half = K1.sm90_plan(*args[:7], args[7] // 2, args[8])
                assert half is not None
                _check_plan(half)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
@pytest.mark.parametrize("batch", [256, 4, 3])
def test_tiles_are_the_tallest_that_spread_the_launch(arch, batch):
    """A launch's tiles have 256 rows where they give SM90_MIN_ITEMS work
    items or more, else 128 where those do, else 64: every trunk launch
    at batch 256 takes 256, the 7x7 maps at the serving batches 64."""
    for args, _, plan in _plans(arch, batch):
        if not isinstance(plan, K1.Sm90Plan):
            continue
        taller = [K1.sm90_plan(*args, n_wg=n) for n in (4, 2) if n > plan.n_wg]
        assert plan.n_items >= K1.SM90_MIN_ITEMS or plan.n_wg == 1
        assert all(p is None or p.n_items < K1.SM90_MIN_ITEMS for p in taller)
        assert K1.sm90_plan(*args, n_wg=plan.n_wg) == plan
        if batch == 256:
            assert plan.TM == 256
        if args[1] == 7:
            assert plan.TM == (256 if batch == 256 else 64)


def test_sm90_plan_refuses_shapes_off_the_form():
    assert K1.sm90_plan(2, 9, 9, 48, 3, 1, 1, 64, 432) is None  # C % 32
    assert K1.sm90_plan(2, 9, 9, 64, 3, 1, 1, 40, 576) is None  # N8 % 64
    assert K1.sm90_plan(2, 9, 9, 64, 5, 1, 0, 64, 1600) is None  # 5x5
    assert K1.sm90_plan(2, 9, 9, 64, 3, 1, 0, 64, 576) is None  # 3x3 takes pad 1
    assert K1.sm90_plan(2, 9, 9, 64, 1, 3, 0, 64, 64) is None  # stride 3


def test_forced_form_is_the_only_way_round_the_rule():
    """_mma_form, for A/B runs, gives every launch the mma.sync form, and
    the rule holds again after it; shapes off the Hopper form keep the
    mma.sync form either way."""
    for args in [(2, 14, 14, 256, 3, 1, 1, 256, 2304), (2, 8, 8, 64, 3, 1, 1, 64, 576)]:
        assert isinstance(K1.k1_plan(*args), K1.Sm90Plan)
        with K1._mma_form():
            assert isinstance(K1.k1_plan(*args), K1.ConvPlan)
        assert isinstance(K1.k1_plan(*args), K1.Sm90Plan)
    stem = (2, 32, 32, 4, 7, 2, 3, 64, 224)
    assert isinstance(K1.k1_plan(*stem), K1.ConvPlan)
    with K1._mma_form():
        assert isinstance(K1.k1_plan(*stem), K1.ConvPlan)


def test_k_order_is_a_permutation_in_chunk_order():
    """Chunk j of cc channels holds its taps' channels tap after tap, and
    within a 32-byte K step wgmma's position kappa holds k(kappa): lane t's
    registers a0 (kappa 4t..4t+3) and a2 (16+4t..) the bytes 8t..8t+7."""
    order = K1._sm90_k_order(3, 96, 32)
    assert sorted(order) == list(range(9 * 96))
    unperm = np.empty(32, dtype=np.int64)
    kappa = np.arange(32)
    unperm[np.where(kappa < 16, 8 * (kappa // 4) + kappa % 4, 8 * ((kappa - 16) // 4) + 4 + kappa % 4)] = kappa
    logical = order.reshape(-1, 32)[:, unperm].reshape(-1)  # chunk order, before the K-step permutation
    tap, c = np.divmod(logical, 96)
    assert np.array_equal(c // 32, np.repeat(np.arange(3), 9 * 32))
    assert np.array_equal(tap.reshape(3, 9, 32), np.broadcast_to(np.arange(9)[None, :, None], (3, 9, 32)))
    for t in range(4):
        lanes = order.reshape(-1, 32)[:, list(range(4 * t, 4 * t + 4)) + list(range(16 + 4 * t, 20 + 4 * t))]
        assert np.array_equal(lanes - lanes[:, :1], np.broadcast_to(np.arange(8), lanes.shape))


# ------------------------------------------------------- the layout model


def _swizzle(off, swz):
    """TMA's and wgmma's swizzle of a byte offset from a 1024-byte boundary:
    the 16-byte unit within a swz-byte row XORed with the row's index
    within 8 rows (CuTe's Swizzle<log2(swz/16), 4, 3>)."""
    return off ^ ((off >> 3) & ((swz // 16 - 1) << 4))


def _band_row(p, m):
    """csrc/qmatmul_sm90.cu band_row: the padded batch's row of output m's
    top tap row, and its column."""
    b, r = np.divmod(m, p.Ho * p.Wo)
    oy, ox = np.divmod(r, p.Wo)
    return b * p.Hp + oy * p.stride, ox


def _stage_image(x, packed, p, tile, nb, chunk):
    """The shared-memory image of step (tile, N block, chunk): the weight
    chunk's n_boxes TMA boxes (SWZ bytes of K by NB rows each, swizzled,
    zero past the tensor's K), then the band of the chunk's channels."""
    buf = np.zeros(p.w_bytes + p.a_bytes, dtype=np.int8)
    k0 = p.ksize ** 2 * chunk * p.CC
    n = np.arange(p.NB)[:, None]
    j = np.arange(p.SWZ)[None, :]
    for a in range(p.n_boxes):
        k = k0 + a * p.SWZ + j
        box = np.where(k < p.Kp, packed[p.NB * nb + n, np.minimum(k, p.Kp - 1)], 0)
        buf[a * p.NB * p.SWZ + _swizzle(n * p.SWZ + j, p.SWZ)] = box
    band = buf[p.w_bytes:]
    m0, c0 = tile * p.TM, chunk * p.CC
    cc = min(p.CC, p.C - c0)
    if p.ksize == 1:
        m = m0 + np.arange(min(p.TM, p.M - m0))
        gr, ox = _band_row(p, m)
        b, iy = np.divmod(gr, p.Hp)
        pix = x[b, iy, ox * p.stride, c0:c0 + cc]
        band.reshape(-1)[(np.arange(len(m))[:, None] * p.P + np.arange(cc)[None, :])] = pix
    else:
        r0, _ = _band_row(p, m0)
        rows = _band_row(p, min(m0 + p.TM, p.M) - 1)[0] - r0 + p.ksize
        gr = r0 + np.arange(rows)[:, None]
        b, iy = np.divmod(gr, p.Hp)
        iy, ix = iy - p.pad, np.arange(p.HC)[None, :] - p.pad
        inside = (iy >= 0) & (iy < p.H) & (ix >= 0) & (ix < p.W)
        vals = x[np.minimum(b, p.B - 1), np.clip(iy, 0, p.H - 1), np.clip(ix, 0, p.W - 1), c0:c0 + cc]
        vals = np.where(inside[..., None], vals, 0)
        at = np.arange(rows)[:, None, None] * p.RP + np.arange(p.HC)[None, :, None] * p.P + np.arange(cc)
        band[at] = vals
    return buf


def _koff(p):
    """The k-word table: entry 4 ks + t, band offset of k = 32 ks + 8 t of
    a chunk (tap k // CC, channel k % CC)."""
    k = 8 * np.arange(p.koff_words)
    tap, c = np.divmod(k, p.CC)
    return (tap // p.ksize) * p.RP + (tap % p.ksize) * p.P + c


def emulate_sm90(x, op, p):
    """Run p's steps through the kernel's index math in numpy. Returns
    (out int32 (M, N8), A (M, Kp) and B (Kp, N8) as wgmma saw them, put
    back in the packed (dy, dx, c) K order)."""
    packed = K1._sm90_weight(op.wt, p).numpy()
    order = K1._sm90_k_order(p.ksize, p.C, p.CC)
    out = np.zeros((p.M, p.N8), dtype=np.int64)
    a_seen = np.zeros((p.M, p.Kp), dtype=np.int64)
    b_seen = np.zeros((p.Kp, p.N8), dtype=np.int64)
    koff = _koff(p) if p.ksize > 1 else None
    # the threads of the CTA: warpgroup w, warp q, lane (g, t)
    tid = np.arange(128 * p.n_wg)
    wg, q, lane = tid >> 7, (tid >> 5) & 3, tid & 31
    g, t = lane >> 2, lane & 3
    row0 = 64 * wg + 16 * q + g
    for tile in range(p.n_tiles):
        m0 = tile * p.TM
        m = m0 + np.stack([row0, row0 + 8])  # (2, threads)
        if p.ksize == 1:
            base = np.stack([row0, row0 + 8]) * p.P
        else:
            r0, _ = _band_row(p, m0)
            gr, ox = _band_row(p, np.minimum(m, p.M - 1))
            base = (gr - r0) * p.RP + ox * p.stride * p.P
        for nb in range(p.n_blocks):
            acc = np.zeros((p.n_wg, 64, p.NB), dtype=np.int64)
            for chunk in range(p.n_chunks):
                buf = _stage_image(x, packed, p, tile, nb, chunk)
                band = buf[p.w_bytes:]
                nk = (p.KCL if chunk == p.n_chunks - 1 else p.KC) // 32
                for ks in range(nk):
                    off = koff[4 * ks + t] if p.ksize > 1 else 32 * ks + 8 * t
                    # lane t's 8 bytes of rows g (registers a0, a2) and g + 8 (a1, a3)
                    byts = band[(base + off)[..., None] + np.arange(8)]  # (2, threads, 8)
                    a_mat = np.zeros((p.n_wg, 64, 32), dtype=np.int64)
                    for h in range(2):
                        r = 16 * q + g + 8 * h
                        a_mat[wg[:, None], r[:, None], 4 * t[:, None] + np.arange(4)] = byts[h, :, :4]
                        a_mat[wg[:, None], r[:, None], 16 + 4 * t[:, None] + np.arange(4)] = byts[h, :, 4:]
                    # B through the descriptor: row n at n * SWZ of its atom, the
                    # K step's 32 bytes at (32 ks) % SWZ, swizzled
                    kb = 32 * ks
                    at = (kb // p.SWZ) * p.NB * p.SWZ + _swizzle(
                        np.arange(p.NB)[None, :] * p.SWZ + kb % p.SWZ + np.arange(32)[:, None], p.SWZ)
                    b_mat = buf[at].astype(np.int64)  # (32 kappa, NB)
                    acc += a_mat @ b_mat
                    cols = order[p.ksize ** 2 * chunk * p.CC + kb + np.arange(32)]
                    rows_m = (m0 + np.arange(p.n_wg)[:, None] * 64 + np.arange(64)[None, :]).reshape(-1)
                    keep = rows_m < p.M
                    a_seen[rows_m[keep][:, None], cols[None, :]] = a_mat.reshape(-1, 32)[keep]
                    b_seen[cols[:, None], p.NB * nb + np.arange(p.NB)[None, :]] = b_mat
            # wgmma's accumulator: register 4j + 2h + v of thread (q, g, t)
            # of warpgroup w holds (row 16q + g + 8h, column 8j + 2t + v)
            j, h, v = np.meshgrid(np.arange(p.NB // 8), np.arange(2), np.arange(2), indexing="ij")
            reg_row = (16 * q + g)[:, None, None, None] + 8 * h
            reg_col = 8 * j + 2 * t[:, None, None, None] + v
            regs = acc[wg[:, None, None, None], reg_row, reg_col]
            for hh in range(2):
                mm = np.broadcast_to(m[hh][:, None, None], regs[:, :, hh, :].shape)
                ok = mm < p.M
                out[mm[ok], (p.NB * nb + reg_col[:, :, hh, :])[ok]] = regs[:, :, hh, :][ok]
    return out, a_seen, b_seen


# (B, H, W, Cin, ksize, stride, N, cc, n_wg): 3x3 at stride 1 and 2 over 2-3
# chunks (both swizzles of a 3x3 chunk), 1x1 at stride 1 and 2, a ragged
# last 1x1 chunk read past the weight's K, N in 2 blocks of 64, a ragged last
# tile, 1, 2 and 4 warpgroups, the GEMM form's (1, 1, M, K) view
MODEL_FORMS = [
    (2, 5, 7, 128, 3, 1, 128, 64, 4), (3, 7, 6, 96, 3, 2, 64, 32, 2), (2, 6, 5, 320, 1, 1, 64, 256, 2),
    (2, 9, 7, 64, 1, 2, 128, 32, 4), (1, 4, 5, 64, 3, 2, 128, 32, 2), (2, 6, 7, 64, 3, 1, 64, 32, 1),
    (3, 5, 6, 96, 1, 2, 128, 32, 1), (1, 1, 150, 64, 1, 1, 64, 64, 2),
]


@pytest.mark.parametrize("form", MODEL_FORMS)
def test_layout_model_rebuilds_the_conv(form):
    b, h, w, c, ks, st, n, cc, n_wg = form
    rng = np.random.RandomState(b * c + n + ks)
    x = rng.randint(-127, 128, (b, h, w, c)).astype(np.int8)
    op = K1.pack_conv_weights(torch.from_numpy(rng.randint(-127, 128, (ks, ks, c, n)).astype(np.int8)))
    p = K1._sm90_layout(b, h, w, c, ks, st, ks // 2, n, cc, 64 if n == 128 and cc == 32 else min(n, 128), n_wg)
    assert p is not None and p.CC == cc and p.n_wg == n_wg
    if c % cc:
        assert p.KCL < p.KC  # the ragged chunk
    out, a_seen, b_seen = emulate_sm90(x, op, p)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(a_seen, K1.gather_taps(xt, ks, st, ks // 2, K1.K_MULT).numpy())
    kmat = K1.kernel_matrix(torch.from_numpy(op.wt.numpy()[:n].T.reshape(ks, ks, c, n)), K1.K_MULT).numpy()
    np.testing.assert_array_equal(b_seen[:, :n], kmat)
    want = K1.int8_conv_reference(xt, op, st, ks // 2, "int32").reshape(-1, n).numpy()
    np.testing.assert_array_equal(out[:, :n], want)
