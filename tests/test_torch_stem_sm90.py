"""The ImageNet trunks' stem kernel (csrc/stem_sm90.cu) on the CPU: its
plans, its rule, its K order, a numpy model of its layout, and the stem's
CPU path against jitted JAX.

The kernel runs only on the card (tests/test_torch_cuda_kernels.py holds
it against the chain it replaced there, bit for bit). Here:
- stem_plan takes the trunks' shapes (224x224 at the engines' batches,
  the tests' 64x64) within the SM's 227 KB, its regions apart, its tiles
  covering every pooled row once and its band every byte the taps read;
  it refuses the shapes the kernel does not take, naming them;
- the rule (stem_takes) and the only way round it (_old_form);
- the re-packed weight holds every packed (dy, dx, c) column once and
  zeros for dx = 7;
- a numpy model of the kernel, written from its index math (the band's
  TMA slabs over the prep pass's padded rows with their zero fill, each lane's two 8-byte A loads, B's
  core-matrix order, the accumulator rows of a tile, the pool of the sums
  by each column's sign, the one code of each pooled output through the
  table form and its windows), rebuilds the pooled stream of the CPU path
  (stem_chain) bit for bit;
- the stem's CPU path (stem_pool_codes on CPU tensors) equals JAX's stem
  (_linear_q, _conv, _erfq_codes, max, reduce_window) jitted, bit for bit,
  at 64x64, batches 2 and 3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignq_tpu.kernels import infer as JI
from alignq_tpu.kernels import infer_resnet_imagenet as JR
from alignq_tpu.kernels.convert import QConvInt8 as JQConv
from alignq_tpu_torch.kernels import qmatmul as K1
from alignq_tpu_torch.kernels.infer import S_IMG, _linear_q
from alignq_tpu_torch.kernels import stem as ST
from alignq_tpu_torch.kernels.quantize import (act_codes, act_codes_table_plain, act_table, act_table_steps,
                                               act_table_window)
from alignq_tpu_torch.quant.cdf import fma_f32

G = {8: 127, 4: 7}


def _operands(seed, b, h, w):
    """f32 images and a conv1 whose h = acc * scale + bias spans the
    codes: int8 kernel, scales of both signs, biases in [-1, 1]."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, h, w, 3) * 1.2).astype(np.float32)
    k = rng.randint(-127, 128, (7, 7, 3, 64)).astype(np.int8)
    scale = (rng.uniform(1e-5, 4e-5, 64) * rng.choice([-1, 1], 64)).astype(np.float32)
    bias = rng.uniform(-1, 1, 64).astype(np.float32)
    return x, k, scale, bias


def _window_operands(seed, b, h, w, impl):
    """Operands whose pooled h land in the map's non-monotone windows: a
    faint image (codes of -1..1), scales of 2^-24 (an ulp of h near 1 for
    two units of the sum) and each column's bias at the start of one of
    the map's irregular steps, so that a window's sums straddle it."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, h, w, 3) * 0.02).astype(np.float32)
    k = rng.randint(-127, 128, (7, 7, 3, 64)).astype(np.int8)
    wa, wz = act_table_steps(impl, 127)
    irregular = np.nonzero((wz >= wa) & (np.arange(len(wa)) >= 127))[0]  # steps to codes >= 1
    bias = wa[irregular[np.arange(64) % len(irregular)]].astype(np.float32)
    scale = (np.float32(2.0 ** -24) * rng.choice([-1, 1], 64)).astype(np.float32)
    return x, k, scale, bias


def _port_op(k, scale, bias):
    return K1.pack_conv_weights(torch.from_numpy(k), torch.from_numpy(scale), torch.from_numpy(bias))


def _act(impl, bits):
    return K1.act_map(impl, G[bits], torch.device("cpu"), relu=True)


@functools.lru_cache(maxsize=None)
def _jax_stem(bits, impl):
    @jax.jit
    def stem(q, a):
        h = JR._conv(JI._linear_q(a, JI.S_IMG), q, 2, 3)
        c = jnp.maximum(JI._erfq_codes(h, bits, impl).astype(jnp.int16), 0)
        return jax.lax.reduce_window(c, jnp.int16(jnp.iinfo(jnp.int16).min), jax.lax.max, (1, 3, 3, 1),
                                     (1, 2, 2, 1), [(0, 0), (1, 1), (1, 1), (0, 0)])

    return stem


# ------------------------------------------------------------------ plans


def _check_plan(p):
    assert p.smem <= ST.SMEM_MAX and p.BR <= 256 and p.CR == 2 * p.R + 1 and p.BR == 4 * p.R + 7
    regions = [(0, 2 * p.band_bytes), (p.w_off, p.w_off + 7 * 2048), (p.acc_off, p.acc_off + p.MT * 288),
               (p.tab_off, p.tab_off + 512 * 8), (p.sb_off, p.sb_off + 512), (p.bar_off, p.bar_off + 24)]
    for (a0, a1), (b0, b1) in zip(regions, regions[1:]):
        assert a1 <= b0
    assert regions[-1][1] + 1024 <= p.smem
    assert all(o % 16 == 0 for o in (p.w_off, p.acc_off, p.tab_off, p.sb_off)) and p.bar_off % 8 == 0
    # the band: rows 4 py0 - 5 .. of every conv row's 7 taps, bytes -12 .. 8 Wo + 12 of a row
    assert p.NS * 256 >= 8 * p.Wo + 24
    assert 2 * (p.CR - 1) + 7 == p.BR
    # every pooled row in one tile; the tile's conv rows 2 py0 - 1 .. cover its windows
    rows = np.zeros(p.B * p.Hp, int)
    for tile in range(p.n_tiles):
        b, ty = divmod(tile, p.TY)
        for i in range(p.R):
            if ty * p.R + i < p.Hp:
                rows[b * p.Hp + ty * p.R + i] += 1
    assert (rows == 1).all()
    assert p.n_groups * 64 >= p.MT > (p.n_groups - 1) * 64


@pytest.mark.parametrize("b,hw", [(256, 224), (4, 224), (3, 224), (2, 224), (2, 64), (3, 64), (1, 60)])
def test_plans_of_the_served_shapes(b, hw):
    p = ST.stem_plan(b, hw, hw, 3, 64)
    _check_plan(p)
    assert (p.Ho, p.Wo, p.Hp, p.Wp) == ((hw + 1) // 2, (hw + 1) // 2, (hw + 1) // 4, (hw + 1) // 4)
    if hw == 224:
        assert (p.R, p.n_tiles, p.MT, p.n_groups, p.NS) == (2, b * 28, 560, 9, 4)


@pytest.mark.parametrize("shape,what", [
    ((2, 66, 64, 3, 64), "even conv output"),  # Ho = 33
    ((2, 64, 62, 3, 64), "W % 4"),
    ((2, 64, 64, 3, 32), "to 64"),
    ((2, 64, 64, 5, 64), "3 \\(or 4\\) channels"),
    ((0, 64, 64, 3, 64), "images \\(0, 64, 64, 3\\)"),
])
def test_plan_refuses_shapes_off_the_kernel(shape, what):
    with pytest.raises(ValueError, match=what):
        ST.stem_plan(*shape)


def test_plan_refuses_tiles_past_shared_memory():
    with pytest.raises(ValueError, match="bytes of shared memory"):
        ST.stem_plan(2, 224, 224, 3, 64, r=3)


def test_the_rule():
    x, k, scale, bias = _operands(0, 2, 64, 64)
    op, act = _port_op(k, scale, bias), _act("erf", 8)
    xt = torch.from_numpy(x)
    assert ST.stem_takes(xt, op, act)
    assert ST.stem_takes(xt, op, _act("poly", 8)) and ST.stem_takes(xt, op, _act("bins", 4))
    assert not ST.stem_takes(xt, op, act._replace(relu=False))
    assert not ST.stem_takes(xt[:, :62], op, act)  # an odd conv output
    assert ST.stem_takes(xt[:, :, :60].contiguous(), op, act)  # W = 60: W % 4 == 0, Wo = 30
    assert not ST.stem_takes(xt[:, :, :62], op, act)
    assert not ST.stem_takes(xt.double(), op, act)
    half = K1.pack_conv_weights(torch.from_numpy(k[..., :32]), torch.from_numpy(scale[:32]),
                                torch.from_numpy(bias[:32]))
    assert not ST.stem_takes(xt, half, act)
    assert not ST.stem_takes(xt, op._replace(shard=object()), act)
    with ST._old_form():
        assert not ST.stem_takes(xt, op, act)
    assert ST.stem_takes(xt, op, act)


def test_prep_layout():
    x = torch.from_numpy(_operands(1, 2, 8, 12)[0])
    q = ST.stem_prep(x)
    assert q.shape == (2, 8, 16, 4) and q.dtype == torch.int8
    assert (q[:, :, :3] == 0).all() and (q[:, :, -1] == 0).all() and (q[..., 3] == 0).all()
    np.testing.assert_array_equal(q[:, :, 3:-1, :3].numpy(), _linear_q(x, S_IMG).numpy())


def test_k_order_is_the_packed_columns_and_zeros():
    order = ST.stem_k_order()
    assert order.shape == (7 * 2048,)
    live = order[order >= 0]
    assert len(live) == 64 * 196 and len(np.unique(live)) == len(live)
    n, col = live // 224, live % 224
    assert set(np.unique(col)) == set(range(196)) and (np.bincount(n) == 196).all()
    # every K step's 32 positions of a column: one image row dy, dx 0..6 of it
    steps = order.reshape(7, 2, 8, 8, 16).transpose(0, 2, 3, 1, 4).reshape(7, 64, 32)
    for dy in range(7):
        cols = steps[dy][steps[dy] >= 0] % 224
        assert ((cols // 4) // 7 == dy).all()


# ------------------------------------------------------------------ the kernel's model


def emulate_stem(xq, packed, scale, bias, act, plan, hits=None):
    """The stem kernel in numpy, index for index: xq (B, H, W, 4) int8, the
    re-packed weight (14336,) int8, scale and bias (64,) f32, act the map
    (relu'd). Returns the pooled codes int16 (B, Hp, Wp, 64); appends to
    hits the pooled outputs whose h fell in a window of the table."""
    p = plan
    rowbytes = xq.reshape(p.B, p.H, (p.W + 4) * 4).astype(np.int64)  # the prep pass's padded rows
    # B: step dy's [h][q][i][j] -> column 8q + i, K position 16h + j
    wb = packed.astype(np.int64).reshape(7, 2, 8, 8, 16).transpose(0, 2, 3, 1, 4).reshape(7, 64, 32)
    table = None if act.impl == "bins" else act_table(act.impl, act.g, torch.device("cpu"), relu=True)
    m = np.arange(p.n_groups * 64)
    mc = np.minimum(m, p.MT - 1)
    r, ox = mc // p.Wo, mc % p.Wo
    lanes = np.arange(4)
    pos = 8 * ox[:, None] + 8 * lanes[None, :]  # (rows, lane): a lane's 8 bytes of its row, + 12
    out = np.zeros((p.B, p.Hp, p.Wp, 64), np.int16)
    for tile in range(p.n_tiles):
        b, ty = divmod(tile, p.TY)
        py0 = ty * p.R
        band = np.zeros((p.NS, p.BR, 256), np.int64)  # the TMA boxes: slab s from padded row byte 256 s
        for s in range(p.NS):
            x0 = 256 * s
            lo, hi = x0, min(x0 + 256, (p.W + 4) * 4)
            for row in range(p.BR):
                iy = 4 * py0 - 5 + row
                if 0 <= iy < p.H and hi > lo:
                    band[s, row, lo - x0:hi - x0] = rowbytes[b, iy, lo:hi]
        flat = band.reshape(-1)
        acc = np.zeros((len(m), 64), np.int64)
        for dy in range(7):
            off = (pos // 256) * p.BR * 256 + (2 * r[:, None] + dy) * 256 + pos % 256
            got = flat[off[..., None] + np.arange(8)]  # (rows, lane, 8)
            a = np.zeros((len(m), 32), np.int64)
            for t in range(4):  # a0/a1: positions 4t.., a2/a3: 16 + 4t..
                a[:, 4 * t:4 * t + 4] = got[:, t, :4]
                a[:, 16 + 4 * t:16 + 4 * t + 4] = got[:, t, 4:]
            acc += a @ wb[dy].T
        acc = acc[:p.MT].reshape(p.CR, p.Wo, 64)
        # the pool: per pooled output its window's largest (scale >= 0) or
        # least sum, the pad row -1 and column -1 left out; one map of it;
        # inside a window of the table, the largest of the sums' own codes
        big = 1 << 40
        wins = []
        for fill in (-big, big):
            accp = np.concatenate([np.full((p.CR, 1, 64), fill), acc], 1)  # column -1
            if py0 == 0:
                accp[0] = fill  # conv row -1
            wins.append(np.stack([accp[rr:rr + 2 * p.R:2][:p.R, cc:cc + 2 * p.Wp:2][:, :p.Wp]
                                  for rr in range(3) for cc in range(3)]))  # (9, R, Wp, 64)
        valid = wins[0] != -big
        a = np.where(scale < 0, wins[1].min(0), wins[0].max(0))
        h = fma_f32(torch.from_numpy(a.astype(np.float32)), torch.from_numpy(scale), torch.from_numpy(bias))
        if table is None:
            code = np.maximum(act_codes(h, act.g, "bins").numpy().astype(np.int16), 0)
        else:
            code = act_codes_table_plain(h, table).numpy().astype(np.int16)
            hn = h.numpy()
            inwin = (hn >= table.lo) & (hn <= table.hi) & act_table_window(hn, table)
            if hits is not None:
                hits.append(int(inwin.sum()))
            for i, px, n in zip(*np.nonzero(inwin)):
                v = wins[0][:, i, px, n][valid[:, i, px, n]]
                hk = fma_f32(torch.from_numpy(v.astype(np.float32)), float(scale[n]), float(bias[n]))
                code[i, px, n] = max(0, int(act_codes(hk, act.g, act.impl).max()))
        n_rows = min(p.R, p.Hp - py0)
        out[b, py0:py0 + n_rows] = code[:n_rows]
    return out


@pytest.mark.parametrize("b,h,w,impl,bits", [(2, 64, 64, "erf", 8), (3, 64, 64, "poly", 8), (2, 64, 64, "bins", 4),
                                             (1, 60, 64, "erf", 8), (1, 32, 48, "erf", 4)])
def test_kernel_model_rebuilds_the_plain_stem(b, h, w, impl, bits):
    x, k, scale, bias = _operands(b + h + w, b, h, w)
    op, act = _port_op(k, scale, bias), _act(impl, bits)
    plan = ST.stem_plan(b, h, w, 3, 64)
    xq = ST.stem_prep(torch.from_numpy(x)).numpy()
    got = emulate_stem(xq, ST.stem_weight(op.wt).numpy(), scale, bias, act, plan)
    want = ST.stem_chain(torch.from_numpy(x), op, act).numpy()
    assert got.shape == want.shape == (b, plan.Hp, plan.Wp, 64)
    assert want.max() > 0 and (want == 0).any()  # the codes span the relu
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", ["erf", "poly"])
def test_kernel_model_in_the_maps_windows(impl):
    """Pooled h inside the map's windows, where the pool takes every sum's
    own code: the model still rebuilds the plain stem, having taken that
    path."""
    x, k, scale, bias = _window_operands(5, 2, 64, 64, impl)
    op, act = _port_op(k, scale, bias), _act(impl, 8)
    plan = ST.stem_plan(2, 64, 64, 3, 64)
    hits = []
    got = emulate_stem(ST.stem_prep(torch.from_numpy(x)).numpy(), ST.stem_weight(op.wt).numpy(), scale, bias, act,
                       plan, hits)
    np.testing.assert_array_equal(got, ST.stem_chain(torch.from_numpy(x), op, act).numpy())
    assert sum(hits) > 20


@pytest.mark.parametrize("b", [2, 3])
@pytest.mark.parametrize("impl,bits", [("erf", 8), ("poly", 8), ("bins", 4)])
def test_cpu_stem_equals_jitted_jax(b, impl, bits):
    x, k, scale, bias = _operands(10 + b, b, 64, 64)
    want = np.asarray(_jax_stem(bits, impl)(JQConv(k, scale, bias), x))
    got = ST.stem_pool_codes(torch.from_numpy(x), _port_op(k, scale, bias), _act(impl, bits))
    assert got.dtype == torch.int16 and want.dtype == np.int16
    np.testing.assert_array_equal(got.numpy(), want)
