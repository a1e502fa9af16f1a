"""The BN-act table pass's Hopper kernel (csrc/bn_table_sm90.cu) on the CPU:
its plans, a numpy model of its walk, and its bank property.

The kernel runs only on the card (tests/test_torch_cuda_kernels.py holds
it against quantize.cu's bn_table_kernel and the plain version there, bit
for bit). Here:
- bn_table_plan plans every one of DenseNet-40's 39 int8-buffer sites at
  batches 256, 8 and 3 within an SM's shared memory, its tiles covering
  every row once and its batches of work items full (8 items a warp where
  the CTAs fill the grid, else 16); it refuses the shapes the kernel does
  not take, naming them; the rule bn_table_takes gives the kernel the four
  sites of at most 64 code channels at every batch (the count chip_smoke.py
  asserts);
- a numpy model of the kernel, written from its index math (each warp's
  tiles, the work items and their lanes, the x words each lane loads
  (none past c_live), the table's shared-memory layout with its tail
  replicas, the gathers at the lane's column), rebuilds the plain version
  (bn_act_codes_table_plain) and JAX's codes of `_pre_act_conv_int8buf`
  (jitted) on seeded buffers;
- in every gather of every site's plan the 32 lanes hit 32 distinct banks,
  for random values and for values clustered near 0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from alignq_tpu.kernels import infer as JI
from alignq_tpu_torch.kernels import qmatmul as K1
from alignq_tpu_torch.kernels import quantize as K2

SMS = 132
# DenseNet-40's 39 int8-buffer sites: (block, c_live, the buffer's pitch);
# each block's 12 layers and its transition, then the head
SITES = [(blk, c0 + 12 * i, ld) for blk, (c0, ld) in enumerate(((24, 168), (168, 312), (312, 456)))
         for i in range(13)]


def _rows(blk: int, batch: int) -> int:
    return batch * (32 >> blk) ** 2


def _c_out(c_live: int, ld: int) -> int:
    """The site's codes' pitch: c_live padded to 16 (K1's input), the head's own."""
    return c_live if c_live == ld == 456 else -(-c_live // 16) * 16


def _check_plan(p):
    """What csrc/bn_table_sm90.cu's plan_ok asks, the tiles' cover, and full batches."""
    quads = p.c_out // 4
    assert quads == 32 * p.F + p.T and 0 <= p.T < 32 and p.RT == (32 // p.T if p.T else 0)
    assert p.P % 128 == 0 and 32 * p.F + p.RT * p.T <= p.P // 4 <= 32 * p.F + 32
    assert (p.n_tiles - 1) * p.R < p.M <= p.n_tiles * p.R and 1 <= p.ctas <= min(p.n_tiles, 3 * SMS)
    assert p.U in K2.BN_TABLE_ITEMS and p.bar_off == 256 * p.P and p.smem == p.bar_off + 8
    fm = -(-65536 // p.F) if p.F else 0  # the kernel's u / F as (u fm) >> 16, exact for a tile's items
    u = np.arange(p.R * p.F)
    assert p.R * (p.F + 1) < 2**12 and ((u * fm) >> 16 == u // max(p.F, 1)).all()
    per_tile = p.R * p.F + (-(-p.R // p.RT) if p.T else 0)  # a tile's work items: at most one batch
    assert per_tile <= p.U or p.R == 1
    more = (p.R + 1) * p.F + (-(-(p.R + 1) // p.RT) if p.T else 0)
    assert more > p.U or p.R * p.ctas * K2.BN_TABLE_WARPS >= p.M  # as many rows as fill it, or all a warp has
    fit = (K2.BN_TABLE_SMEM - 1024) // (p.smem + 1024)
    assert p.ctas <= min(fit, K2.BN_TABLE_PER_SM) * SMS


@pytest.mark.parametrize("batch", [256, 8, 3])
def test_plans_of_densenet40s_sites(batch):
    for blk, c_live, ld in SITES:
        m, c_out = _rows(blk, batch), _c_out(c_live, ld)
        _check_plan(K2.bn_table_plan(m, ld, c_live, c_out, SMS))
        for items in K2.BN_TABLE_ITEMS:
            _check_plan(K2.bn_table_plan(m, ld, c_live, c_out, SMS, items=items))


@pytest.mark.parametrize("batch,items", [(256, 8), (8, 16), (3, 16)])
def test_the_rule_on_densenet40(batch, items):
    """The kernel takes block 1's four sites of at most 64 code channels
    (c_live 24-60), bn_table_kernel the other 35, at every batch; 8 items
    a warp where the CTAs fill the grid (batch 256), 16 where they do not."""
    taken = [(c_live, ld) for blk, c_live, ld in SITES
             if K2.bn_table_takes(_rows(blk, batch), ld, c_live, _c_out(c_live, ld), SMS)]
    assert taken == [(24, 168), (36, 168), (48, 168), (60, 168)]
    assert len(taken) == chip_smoke.BN_TABLE_SM90_PER_FORWARD
    for c_live, ld in taken:
        p = K2.bn_table_plan(_rows(0, batch), ld, c_live, _c_out(c_live, ld), SMS)
        assert p.U == items and (p.ctas == K2.BN_TABLE_PER_SM * SMS) == (items == 8)


@pytest.mark.parametrize("args,what", [
    ((64, 168, 26, 32), "c_live % 4"), ((64, 168, 24, 30), "c_out % 4"), ((64, 166, 24, 32), "ld % 4"),
    ((64, 168, 48, 32), "c_live <= c_out"), ((64, 2048, 2048, 2048), "a table past shared memory"),
])
def test_plan_refuses_shapes_off_the_kernel(args, what):
    with pytest.raises(ValueError, match="does not take"):
        K2.bn_table_plan(*args, SMS)
    assert not K2.bn_table_takes(*args, SMS)


@pytest.mark.parametrize("items", [4, 12, 32])
def test_plan_refuses_items_off_the_kernel(items):
    with pytest.raises(ValueError, match="items a warp"):
        K2.bn_table_plan(3072, 168, 24, 32, SMS, items=items)


def test_the_layouts_columns():
    """The shared-memory table: full chunks as they are, the tail's
    replicas at quad 32F + r T, zero elsewhere."""
    p = K2.bn_table_plan(3072, 168, 36, 48, SMS)  # c_out 48: 12 tail quads, 2 replicas
    assert (p.F, p.T, p.RT, p.P) == (0, 12, 2, 128)
    pos = K2.bn_table_positions(p)
    np.testing.assert_array_equal(pos, np.r_[np.arange(12), np.arange(12), np.full(8, -1)])
    p = K2.bn_table_plan(16384, 456, 456, 456, SMS)  # 114 quads: 3 chunks and 18 tail quads, 1 replica
    assert (p.F, p.T, p.RT, p.P) == (3, 18, 1, 512)
    np.testing.assert_array_equal(K2.bn_table_positions(p), np.r_[np.arange(114), np.full(14, -1)])


def emulate_bn_table_sm90(x: np.ndarray, laid: np.ndarray, p, banks=None) -> np.ndarray:
    """csrc/bn_table_sm90.cu on x (M, ld) uint8 and the laid-out table
    (256, P) uint8, index for index: each warp's tiles in its order, every
    work item's lanes in batches of U, the x words each loads (0 past
    c_live), the gathers from the layout at the lane's column, the codes
    stored straight to the output. Appends to banks, per gather
    instruction, the banks of its lanes and which lanes work. Returns the
    codes (M, c_out) uint8."""
    out = np.full((p.M, p.c_out), 0xEE, np.uint8)  # poison: every byte must be stored
    covered = np.zeros(p.M, np.int64)
    flat = laid.reshape(-1).astype(np.int64)
    lanes = np.arange(32)
    walkers = p.ctas * K2.BN_TABLE_WARPS  # the warps, each its own tiles
    for walker in range(walkers):
        for tile in range(walker, p.n_tiles, walkers):
            m0 = tile * p.R
            rows = min(p.R, p.M - m0)
            n_full = rows * p.F
            n_items = n_full + (-(-rows // p.RT) if p.T else 0)
            u = np.arange(n_items)[:, None]
            full = u < n_full
            rf = u // max(p.F, 1)
            tail_r = (u - n_full) * p.RT + (lanes // p.T if p.T else 0 * lanes)
            r = np.where(full, rf, tail_r)  # (items, lanes)
            q = np.where(full, 32 * (u - rf * p.F) + lanes, 32 * p.F + (lanes % p.T if p.T else 0))
            pos = np.where(full, q, 32 * p.F + lanes)
            on = full | ((lanes < p.RT * p.T) & (tail_r < rows))
            rc = np.minimum(r, rows - 1)
            live = on & (4 * q < p.c_live)
            xs = np.where(live[..., None], x[m0 + rc[..., None], np.minimum(4 * q[..., None] + np.arange(4), p.ld - 1)],
                          0).astype(np.int64)  # (items, lanes, 4)
            addr = xs * p.P + 4 * pos[..., None] + np.arange(4)
            codes = flat[addr]
            rr, qq = r[on], q[on]
            out[m0 + rr[:, None], 4 * qq[:, None] + np.arange(4)] = codes[on]
            if banks is not None:
                for j in range(4):
                    banks.append(((addr[..., j] // 4) % 32, on))
            covered[m0 : m0 + rows] += 1
    assert (covered == 1).all()
    return out


def _site(seed, m, ld, c_live, impl="erf", clustered=False):
    """A stage buffer (m, ld) int8 and a site's (s, b) whose codes span the
    map; clustered: activation codes near 0, as a DenseNet buffer holds."""
    rng = np.random.RandomState(seed)
    if clustered:
        x = np.clip(np.round(rng.laplace(0, 3, (m, ld))), -127, 127).astype(np.int8)
    else:
        x = rng.randint(-128, 128, (m, ld)).astype(np.int8)
    s = (rng.uniform(0.005, 0.03, c_live) * rng.choice([-1, 1], c_live)).astype(np.float32)
    b = rng.uniform(-1, 1.5, c_live).astype(np.float32)
    return x, s, b


@functools.lru_cache(maxsize=None)
def _jax_codes(act_bits, impl):
    def codes(buf, s, b):
        hh = buf.astype(jnp.float32) * s + b  # _pre_act_conv_int8buf's (svec * bn.scale) folded into s
        return jnp.maximum(JI._erfq_codes(hh, act_bits, impl), 0)

    return jax.jit(codes)


@pytest.mark.parametrize("blk,c_live,ld", [s for i, s in enumerate(SITES) if i % 4 == 0 or s[1] in (36, 168, 456)])
def test_kernel_model_rebuilds_the_plain_pass(blk, c_live, ld):
    """Sites of every block (batch 3's rows), at each batch of work items:
    the model equal to the plain version and to jitted JAX's codes."""
    m, c_out = _rows(blk, 3), _c_out(c_live, ld)
    x, s, b = _site(c_live + ld, m, ld, c_live)
    act = K1.act_map("erf", 127, torch.device("cpu"), relu=True)
    table = K2.bn_act_table(torch.from_numpy(s), torch.from_numpy(b), act)
    want = K2.bn_act_codes_table_plain(torch.from_numpy(x), c_live, table, c_out).numpy().view(np.uint8)
    jax_codes = np.asarray(_jax_codes(8, "erf")(x[:, :c_live], s, b)).astype(np.int8).view(np.uint8)
    np.testing.assert_array_equal(want[:, :c_live], jax_codes)
    assert (want[:, c_live:] == 0).all() and want.max() > 0
    for items in K2.BN_TABLE_ITEMS:
        p = K2.bn_table_plan(m, ld, c_live, c_out, SMS, items=items)
        laid = K2.bn_table_layout(table, p).numpy().view(np.uint8)
        np.testing.assert_array_equal(emulate_bn_table_sm90(x.view(np.uint8), laid, p), want)


@functools.lru_cache(maxsize=None)
def _poly_table(c_live, ld):
    """A site's table of the relu'd poly map on _site's (s, b), built once
    for both value distributions."""
    _, s, b = _site(c_live, 1, ld, c_live)
    act = K1.act_map("poly", 127, torch.device("cpu"), relu=True)
    return K2.bn_act_table(torch.from_numpy(s), torch.from_numpy(b), act)


@pytest.mark.parametrize("clustered", [False, True])
def test_gathers_hit_32_banks_at_every_site(clustered):
    """Every gather of every site's plan at batch 256: the working lanes'
    32 distinct banks (the tiles of a few warps; the lanes' columns do not
    depend on the tile), whatever the values; the idle lanes only a tail
    item's past RT T."""
    for blk, c_live, ld in SITES:
        c_out = _c_out(c_live, ld)
        p = K2.bn_table_plan(_rows(blk, 256), ld, c_live, c_out, SMS)
        few = p._replace(M=4 * p.R * K2.BN_TABLE_WARPS, n_tiles=4 * K2.BN_TABLE_WARPS, ctas=1)  # 4 tiles a warp
        x, _, _ = _site(c_live, few.M, ld, c_live, clustered=clustered)
        table = _poly_table(c_live, ld)
        banks = []
        got = emulate_bn_table_sm90(x.view(np.uint8), K2.bn_table_layout(table, few).numpy().view(np.uint8), few,
                                    banks)
        want = K2.bn_act_codes_table_plain(torch.from_numpy(x), c_live, table, c_out).numpy().view(np.uint8)
        np.testing.assert_array_equal(got, want)
        for bank, on in banks:  # idle lanes each take a bank of their own, below 0
            hit = np.sort(np.where(on, bank, -1 - np.arange(32)), axis=1)
            assert (np.diff(hit, axis=1) != 0).all(), (c_live, ld)
        on = np.concatenate([o for _, o in banks[::4]])
        want_on = (p.R * p.c_out // 4) / (32 * (p.R * p.F + (-(-p.R // p.RT) if p.T else 0)))
        assert on.mean() == pytest.approx(want_on) and want_on >= 0.6
