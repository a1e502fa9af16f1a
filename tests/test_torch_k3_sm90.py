"""K3's Hopper form (csrc/stage_kernel_sm90.cu) on the CPU: its requant,
its plans, its weight re-pack and a model of its layout.

The kernel runs only on the card (tests/test_torch_cuda_kernels.py holds
it against the plain version and against stage_kernel.cu's form there).
Here the Python that computes its constants, its plan and its layout is
tested:
- the block-edge requant's multiply-shift equals clip((2K+m)//(2m), 0, g)
  for every int16 K and every multiplier m of a run of up to MAX_BLOCKS;
- every K3 run of ResNet-20 and ResNet-56 at batches 2048, 256, 8 and 3
  takes the form, within the SM's 227 KB, each image in one CTA;
- the weight re-pack is a permutation of the zero-padded K that gives the
  weight back;
- a numpy model of a CTA (the plane's TMA boxes under their swizzle, block
  0's requant as it arrives, the k-word table that fills wgmma's A
  registers, the weight slot's TMA boxes read by the descriptor, the
  epilogue's pixel and channel map, the residual epilogue's plane words and
  the next block's x8), written from the kernel's index math, rebuilds
  stage_identity_blocks_nhwc_reference's stream bit for bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from alignq_tpu_torch.kernels import stage_kernel as K3
from alignq_tpu_torch.kernels.infer import _identity_runs, residual_multipliers
from alignq_tpu_torch.quant.cdf import fma_f32

CU = Path(K3.__file__).resolve().parents[1] / "csrc" / "stage_kernel_sm90.cu"


@pytest.mark.parametrize("g", [7, 127])
def test_requant_mulshift_is_exact_for_every_code(g):
    """Every int16 K (the relu'd stream's K >= 0, and negative ones) and
    every m in 1..MAX_BLOCKS + 1: the kernel's umulhi by requant_magic(m)
    equals the plain version's floor division and clip."""
    k = np.arange(-32768, 32768, dtype=np.int64)
    for m in range(1, K3.MAX_BLOCKS + 2):
        want = np.clip(np.floor_divide(2 * k + m, 2 * m), 0, g)
        np.testing.assert_array_equal(K3.requant_mulshift(k, m, g), want)
        plain = K3._requant(torch.from_numpy(k[32768:]).to(torch.int32), m, g).numpy()
        np.testing.assert_array_equal(K3.requant_mulshift(k[32768:], m, g), plain)
        assert 0 < K3.requant_magic(m) < 2**32
    with pytest.raises(ValueError):
        K3.requant_magic(K3.MAX_BLOCKS + 2)


def _runs(depth):
    """(C, H*W side, ms) of each K3 run of a CIFAR PreAct ResNet's forward."""
    n = (depth - 2) // 6
    has_skip = [i > 0 and i % n == 0 for i in range(3 * n)]
    ms = residual_multipliers(has_skip)
    layers = [{"skip": None} if s else {} for s in has_skip]
    return [(16 << (i // n), 32 >> (i // n), tuple(ms[i:j])) for i, j in _identity_runs(layers)]


def test_the_cifar_runs():
    assert _runs(20) == [(16, 32, (1, 2, 3)), (32, 16, (2, 3)), (64, 8, (2, 3))]
    assert [(c, hw, len(ms)) for c, hw, ms in _runs(56)] == [(16, 32, 9), (32, 16, 8), (64, 8, 8)]


def _check_plan(p):
    """A plan within the SM whose groups hold each image once, its boxes
    tiling the group's plane, its warpgroups each with a tile."""
    hw = p.H * p.W
    assert p.smem <= K3.SM90_SMEM and p.C in K3.CHANNELS and 1 <= p.n_blocks <= K3.MAX_BLOCKS
    assert 1 <= p.n_wg <= K3.K3_MAX_WG[p.C] and p.n_wg <= p.imgs * hw // 64
    assert p.KP == -(-9 * p.C // 32) * 32 and p.KP % p.SWZ == 0 and p.P == K3.K3_PITCH[p.C]
    assert p.plane_bytes == p.imgs * hw * 2 * p.C and p.plane_bytes % 1024 == 0
    assert p.w_slot >= p.C * p.KP and p.w_slot % (8 * p.SWZ) == 0
    assert p.halo_bytes >= p.imgs * (p.H + 2) * (p.W + 2) * p.P and p.halo_bytes % 16 == 0
    assert p.smem == 1024 + p.plane_bytes + 2 * p.w_slot + 2 * p.halo_bytes + 4 * (p.KP // 8) + 24
    assert p.BR <= 256 and (p.imgs * hw) % p.BR == 0 and (p.BR * 2 * p.C) % 1024 == 0
    groups = np.arange(p.n_groups)[:, None] * p.imgs + np.arange(p.imgs)[None, :]
    assert np.array_equal(np.bincount(groups[groups < p.B], minlength=p.B), np.ones(p.B))


@pytest.mark.parametrize("depth", [20, 56])
@pytest.mark.parametrize("batch", [2048, 256, 8, 3])
def test_every_cifar_run_takes_the_form(depth, batch):
    """The planner gives the Hopper form every K3 run of ResNet-20 and
    ResNet-56 (8 and 9 blocks: the weights stream); several 8x8 and 16x16
    images a CTA only where the batch still gives K3_MIN_CTAS CTAs; 4
    warpgroups only on a 32x32 image at batches below it."""
    for c, hw, ms in _runs(depth):
        p = K3.k3_plan(batch, hw, hw, c, len(ms))
        assert isinstance(p, K3.K3Plan)
        _check_plan(p)
        assert (p.imgs, p.n_wg) == {(8, 2048): (4, 2), (16, 2048): (2, 2), (32, 2048): (1, 2)}.get(
            (hw, batch), {8: (1, 1), 16: (1, 2), 32: (1, 4)}[hw])
        with K3._old_form():
            assert K3._planned(batch, hw, hw, c, len(ms)) is None
        assert K3._planned(batch, hw, hw, c, len(ms)) == p


def test_shapes_off_the_form_keep_the_mma_sync_form():
    assert K3.k3_plan(4, 4, 4, 32, 2) is None  # 16 pixels: no whole m64 tile
    assert K3.k3_plan(4, 8, 8, 48, 2) is None  # C
    assert K3.k3_plan(4, 8, 8, 16, K3.MAX_BLOCKS + 1) is None
    assert K3.k3_plan(4, 64, 64, 16, 2) is None  # one image past the SM
    assert K3.k3_plan(4, 16, 16, 64, 2, imgs=1, n_wg=4) is None  # 2 warpgroups at most at C=64
    for c in K3.CHANNELS:
        for imgs in K3.K3_IMGS:
            for n_wg in (1, 2, 4):
                p = K3.k3_plan(9, 8, 8, c, 8, imgs=imgs, n_wg=n_wg)
                if p is not None:
                    _check_plan(p)


def test_plan_matches_the_kernels_struct():
    """K3Plan's fields in the order of the kernel's Plan (the C side also
    checks the count: k3_sm90_plan_ints)."""
    body = re.search(r"struct Plan \{\s*int ([^;]*);", CU.read_text()).group(1)
    assert [f.strip() for f in body.split(",")] == list(K3.K3Plan._fields)
    # the kernel's halo pitch and thread bound, which the planner mirrors
    pitch, wgs = K3.K3_PITCH, K3.K3_MAX_WG
    assert f"P = C == 16 ? {pitch[16]} : (C == 32 ? {pitch[32]} : {pitch[64]});" in CU.read_text()
    assert wgs[16] == wgs[32]
    assert f"return C == 64 ? {128 * wgs[64]} : {128 * wgs[16]};" in CU.read_text()


@pytest.mark.parametrize("c", [16, 32, 64])
def test_weight_repack_is_a_permutation_that_gives_the_weight_back(c):
    rng = np.random.RandomState(c)
    wt = torch.from_numpy(rng.randint(-127, 128, (3, 2, c, 9 * c)).astype(np.int8))
    order = K3._k3_k_order(c)
    kp = -(-9 * c // 32) * 32
    assert sorted(order) == list(range(kp))
    packed = K3._k3_weight(wt)[1]
    assert packed.shape == (6 * c, kp) and packed.is_contiguous()
    back = packed[:, torch.from_numpy(np.argsort(order))]
    assert torch.equal(back[:, : 9 * c], wt.reshape(-1, 9 * c))
    assert not back[:, 9 * c :].any()
    assert K3._k3_weight(wt)[1] is packed  # made once per weight
    # lane t's registers a0 (kappa 4t..4t+3) and a2 (16+4t..) hold k = 8t..8t+7
    for t in range(4):
        lanes = order.reshape(-1, 32)[:, list(range(4 * t, 4 * t + 4)) + list(range(16 + 4 * t, 20 + 4 * t))]
        assert np.array_equal(lanes - lanes[:, :1], np.broadcast_to(np.arange(8), lanes.shape))


# ------------------------------------------------------- the layout model


def _swizzle(off, swz):
    """TMA's and wgmma's swizzle of a byte offset from a 1024-byte boundary:
    the 16-byte unit within a swz-byte row XORed with the row's index
    within 8 rows (CuTe's Swizzle<log2(swz/16), 4, 3>)."""
    return off ^ ((off >> 3) & ((swz // 16 - 1) << 4))


def _koff(p):
    """The k-word table: entry q, halo offset of k = 8q (tap k // C,
    channel k % C) from a pixel's top-left tap; K's zero tail the last tap."""
    k = 8 * np.arange(p.KP // 8)
    tap, c = np.divmod(k, p.C)
    wp = p.W + 2
    return np.where(tap < 9, ((tap // 3) * wp + tap % 3) * p.P + c, (2 * wp + 2) * p.P)


def _halo_base(p, r):
    """Halo offset of pixel r of a group's top-left tap."""
    img, rem = np.divmod(r, p.H * p.W)
    y, x = np.divmod(rem, p.W)
    return ((img * (p.H + 2) + y) * (p.W + 2) + x) * p.P


def _slot_image(packed, p, j):
    """Weight slot of conv j: its KP / SWZ TMA boxes, SWZ bytes of K by C
    rows each, swizzled."""
    slot = np.zeros(p.w_slot, dtype=np.int8)
    n = np.arange(p.C)[:, None]
    col = np.arange(p.SWZ)[None, :]
    for a in range(p.KP // p.SWZ):
        slot[a * p.C * p.SWZ + _swizzle(n * p.SWZ + col, p.SWZ)] = packed[j * p.C + n, a * p.SWZ + col]
    return slot


def _conv(p, xin, slot, koff, m_rows, scale, bias, g):
    """One conv of a group through the kernel's tiles: wgmma's A from the
    halo buffer at the table's offsets, lane t's 8 bytes into registers a0
    and a2 (row g) and a1 and a3 (row g + 8); B through the descriptor;
    then the act codes of each tile row below m_rows, by channel."""
    ks_n = p.KP // 32
    out = np.zeros((m_rows, p.C), dtype=np.int64)
    for tile in range(-(-m_rows // 64)):
        q, g_, h = np.meshgrid(np.arange(4), np.arange(8), np.arange(2), indexing="ij")
        rows = (16 * q + g_ + 8 * h).reshape(-1)  # a warp's 16 rows of the tile, for each warp
        r = tile * 64 + rows
        base = _halo_base(p, np.minimum(r, m_rows - 1))
        off = koff.reshape(ks_n, 4)  # (K step, lane t)
        byts = xin[base[:, None, None, None] + off[None, :, :, None] + np.arange(8)].astype(np.int64)
        a = np.empty((len(rows), ks_n, 32), dtype=np.int64)
        a[:, :, :16] = byts[..., :4].reshape(len(rows), ks_n, 16)  # a0 / a1: kappa 4t..4t+3
        a[:, :, 16:] = byts[..., 4:].reshape(len(rows), ks_n, 16)  # a2 / a3: kappa 16+4t..
        acc = np.zeros((len(rows), p.C), dtype=np.int64)
        for ks in range(ks_n):
            kb = 32 * ks
            at = (kb // p.SWZ) * p.C * p.SWZ + _swizzle(
                np.arange(p.C)[None, :] * p.SWZ + kb % p.SWZ + np.arange(32)[:, None], p.SWZ)
            acc += a[:, ks, :] @ slot[at].astype(np.int64)
        # accumulator 4j + 2h + v of lane (g, t): row g + 8h, column 8j + 2t + v
        keep = r < m_rows
        out[r[keep]] = acc[keep]
    hj = fma_f32(torch.from_numpy(out).float(), scale, bias)
    return K3._poly_codes(hj, float(g)).numpy()


def emulate_k3(x, wt, scale, bias, ms, g, p):
    """Run plan p's CTAs through the kernel's index math in numpy on the
    NHWC int16 stream x; returns the stream it stores."""
    b_, h_, w_, c = x.shape
    hw = h_ * w_
    packed = K3._k3_weight(wt)[1].numpy()
    stream = x.numpy().reshape(-1, c).view(np.uint8).reshape(-1, 2 * c)
    out = np.zeros_like(stream)
    koff = _koff(p)
    interior = (w_ + 3) * p.P
    for cta in range(p.n_groups):
        img0 = cta * p.imgs
        m_rows = min(p.imgs, b_ - img0) * hw
        row_base = img0 * hw
        n_boxes = -(-m_rows // p.BR)
        # the plane's TMA boxes: BR pixels of 2C bytes, swizzled; past the tensor zero
        plane = np.zeros(p.plane_bytes, dtype=np.uint8)
        rows = np.arange(n_boxes * p.BR)
        src = row_base + rows
        vals = np.where((src < len(stream))[:, None], stream[np.minimum(src, len(stream) - 1)], 0)
        plane[_swizzle(rows[:, None] * 2 * c + np.arange(2 * c)[None, :], 2 * c)] = vals
        mask = (2 * c // 16 - 1) << 4

        def word_at(r, co):
            """The plane's byte offset of pixel r's channels co, co + 1."""
            prow = r * 2 * c
            return prow + ((2 * co) ^ ((prow >> 3) & mask))

        def int16_at(at):
            return (plane[at].astype(np.int64) | plane[at + 1].astype(np.int64) << 8).astype(np.uint16).view(
                np.int16).astype(np.int64)

        xa = np.zeros(p.halo_bytes, dtype=np.int8)
        xb = np.zeros(p.halo_bytes, dtype=np.int8)
        r = np.arange(m_rows)[:, None]
        co = 2 * np.arange(c // 2)[None, :]
        dst = _halo_base(p, r) + interior + co
        # block 0's requant as the plane arrives
        for v in range(2):
            xa[dst + v] = K3.requant_mulshift(int16_at(word_at(r, co) + 2 * v), ms[0], g)
        for blk in range(len(ms)):
            a1 = _conv(p, xa, _slot_image(packed, p, 2 * blk), koff, m_rows,
                       scale[blk, 0], bias[blk, 0], g)
            codes = np.maximum(a1, 0)
            xb[_halo_base(p, r) + interior + np.arange(c)[None, :]] = codes
            a2 = _conv(p, xb, _slot_image(packed, p, 2 * blk + 1), koff, m_rows, scale[blk, 1], bias[blk, 1], g)
            # the residual epilogue: pixel r's word of channels co, co + 1
            for v in range(2):
                w_at = word_at(r, co) + 2 * v
                new = np.maximum(a2[:, v::2] + int16_at(w_at), 0)
                plane[w_at], plane[w_at + 1] = new & 0xFF, (new >> 8) & 0xFF
                if blk + 1 < len(ms):
                    xa[dst + v] = K3.requant_mulshift(new, ms[blk + 1], g)
        # the TMA store: the group's boxes, rows past the tensor dropped
        keep = src < len(stream)
        out[src[keep]] = plane[_swizzle(rows[keep][:, None] * 2 * c + np.arange(2 * c)[None, :], 2 * c)]
    return torch.from_numpy(out.view(np.int16).reshape(x.shape).copy())


# (C, H, B, ms, g, imgs, n_wg): the three widths, several images a CTA with
# a ragged last group, a group of several tiles an image, 1 to 4
# warpgroups, the A4 grid; runs of 1 to 3 blocks (multipliers 1 to 3 and
# 9). The warpgroups order the tiles, not their values.
MODEL_CASES = [
    (16, 16, 3, (1, 2, 3), 127, 2, 2),
    (16, 8, 5, (2,), 7, 4, 4),
    (32, 8, 3, (2, 3), 127, 2, 1),
    (32, 16, 2, (9,), 127, 1, 4),
    (64, 8, 3, (2, 3), 127, 2, 2),
    (64, 8, 2, (1, 2, 3), 127, 1, 1),
]


@pytest.mark.parametrize("case", MODEL_CASES)
def test_layout_model_rebuilds_the_stream(case):
    c, hw, b, ms, g, imgs, n_wg = case
    rng = np.random.RandomState(c + hw + b)
    n = len(ms)
    wt = torch.from_numpy(rng.randint(-20, 20, (n, 2, c, 9 * c)).astype(np.int8))
    scale = torch.from_numpy(rng.rand(n, 2, c).astype(np.float32) * 1e-3)
    bias = torch.from_numpy((rng.rand(n, 2, c).astype(np.float32) - 0.5) * 0.1)
    x = torch.from_numpy(rng.randint(0, 4 * g, (b, hw, hw, c)).astype(np.int16))
    p = K3.k3_plan(b, hw, hw, c, n, imgs=imgs, n_wg=n_wg)
    assert p is not None and (p.imgs, p.n_wg) == (imgs, n_wg)
    _check_plan(p)
    got = emulate_k3(x, wt, scale, bias, ms, g, p)
    want = K3.stage_identity_blocks_nhwc_reference(x, wt, scale, bias, ms, g)
    assert torch.equal(got, want)
