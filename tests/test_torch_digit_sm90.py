"""The digit DANN's conv kernel (csrc/digit_sm90.cu) on the CPU: its plans,
its rule, its weight re-pack, a numpy model of its layout, and the digit
forward's CPU path against jitted JAX.

The kernel runs only on the card (tests/test_torch_cuda_kernels.py holds
it against the chain it replaced there, bit for bit). Here:
- digit_plan plans both convs at batches 3, 256 and 2048 within the SM's
  227 KB, its regions apart, its tiles covering every image once;
- the rule (digit_takes) and the only way round it (_old_form);
- the re-packed weight holds every packed (dy, dx, c) column once, in
  wgmma's core-matrix order;
- a numpy model of the kernel, written from its index math (conv 1: the
  prep pass's rows, each lane's 4-byte taps, the pool's M order; conv 2:
  the two TMA boxes' planes and the descriptors' strides; both: B's
  core-matrix order, the accumulator's rows and columns, the pool of the
  sums by each column's sign across lanes and rows, one code a pooled
  output through the table form and its windows), rebuilds the chain's
  pooled codes (digit_chain) bit for bit, also where the pooled h are
  steered into the maps' non-monotone windows;
- the forward's CPU path (logits) equals JAX's mnist_dann_int8_forward
  jitted.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import random_like

from alignq_tpu.kernels import infer_digit as JDig
from alignq_tpu_torch import interop
from alignq_tpu_torch.kernels import digit as DS
from alignq_tpu_torch.kernels import infer_digit as TDig
from alignq_tpu_torch.kernels import qmatmul as K1
from alignq_tpu_torch.kernels.quantize import act_codes, act_codes_table_plain, act_table, act_table_steps, act_table_window
from alignq_tpu_torch.quant.cdf import fma_f32

CPU = torch.device("cpu")
SMS = 132
G = {8: 127, 4: 7}


def _check_plan(p):
    c = DS.CONVS[p.conv]
    assert (p.N, p.in_bytes, p.out_bytes, p.w_bytes, p.groups) == (c.n, c.in_bytes, c.out_bytes, c.w_bytes, c.groups)
    assert (p.n_tiles - 1) * p.IMG < p.B <= p.n_tiles * p.IMG and 1 <= p.ctas <= min(p.n_tiles, DS.PER_SM * SMS)
    assert p.w_off == 0 and p.stage_off >= p.w_bytes and p.stage_off % 128 == 0
    assert p.stage_bytes >= p.IMG * p.in_bytes and p.stage_bytes % 128 == 0
    assert p.out_off == p.stage_off + p.S * p.stage_bytes and p.obuf_bytes >= p.IMG * p.out_bytes
    assert p.tab_off >= p.out_off + 2 * p.obuf_bytes and p.sb_off >= p.tab_off + 512 * 8
    assert p.bar_off >= p.sb_off + 8 * p.N and p.smem >= p.bar_off + 8 * (p.S + 1) and p.smem <= DS.SMEM_MAX
    assert 128 * p.n_wg <= 512 and p.IMG * p.in_bytes % 16 == 0 and p.out_bytes % 16 == 0


@pytest.mark.parametrize("conv", [1, 2])
@pytest.mark.parametrize("b", [3, 256, 2048])
def test_plans(conv, b):
    p = DS.digit_plan(conv, b, SMS)
    _check_plan(p)
    if conv == 1:  # an image's 9 m64 groups split evenly over the warpgroups
        assert p.groups * p.IMG % p.n_wg == 0
    for img, wg in ((1, 1), (4, 4), (8, 2)):
        _check_plan(DS.digit_plan(conv, b, SMS, img, wg))
    with pytest.raises(ValueError, match="shared memory"):
        DS.digit_plan(conv, b, SMS, img=64)


def _operands(seed, conv, b, faint=False, impl="erf"):
    """The conv's input (conv 1: f32 images in [-1, 1]; conv 2: relu'd
    codes) and a weight whose h = acc * scale + bias spans the codes
    (scales of both signs); faint: operands whose pooled h land in the
    map's windows (small inputs, scales of 2^-24 or 2^-26, each column's bias at the
    start of one of the map's irregular steps, so that a window's sums
    straddle it)."""
    rng = np.random.RandomState(seed)
    cin, n = (3, 32) if conv == 1 else (32, 48)
    if conv == 1:
        x = rng.uniform(-1, 1, (b, 28, 28, 3)) * (0.03 if faint else 1.0)
        x = x.astype(np.float32)
    else:
        x = rng.randint(0, 3 if faint else 128, (b, 12, 12, 32)).astype(np.int8)
    k = rng.randint(-127, 128, (5, 5, cin, n)).astype(np.int8)
    if faint:
        wa, wz = act_table_steps(impl, 127)
        irregular = np.nonzero((wz >= wa) & (np.arange(len(wa)) >= 127))[0]
        bias = wa[irregular[np.arange(n) % len(irregular)]].astype(np.float32)
        # conv 2's 800 products spread acc 4x wider than conv 1's 100
        scale = (np.float32(2.0 ** (-24 if conv == 1 else -26)) * rng.choice([-1, 1], n)).astype(np.float32)
    else:
        spread = 127 * np.sqrt(25 * cin) * (1 if conv == 1 else 64)
        scale = (rng.uniform(0.5, 2.0, n) * rng.choice([-1, 1], n) / spread).astype(np.float32)
        bias = rng.uniform(-1, 1, n).astype(np.float32)
    op = K1.pack_conv_weights(torch.from_numpy(k), torch.from_numpy(scale), torch.from_numpy(bias))
    return torch.from_numpy(x), op, scale, bias


def _act(impl, bits):
    return K1.act_map(impl, G[bits], CPU, relu=True)


def test_the_rule():
    for conv in (1, 2):
        x, op, _, _ = _operands(0, conv, 2)
        act = _act("erf", 8)
        assert DS.digit_takes(conv, x, op, act)
        assert DS.digit_takes(conv, x, op, _act("poly", 8)) and DS.digit_takes(conv, x, op, _act("bins", 4))
        assert not DS.digit_takes(conv, x, op, K1.act_map("erf", 127, CPU, relu=False))
        assert not DS.digit_takes(3 - conv, x, op, act)
        assert not DS.digit_takes(conv, x[:, :-1], op, act)
        with DS._old_form():
            assert not DS.digit_takes(conv, x, op, act)
        assert DS.digit_takes(conv, x, op, act)
    x, op, _, _ = _operands(0, 1, 2)
    assert not DS.digit_takes(1, x.to(torch.float64), op, _act("erf", 8))


@pytest.mark.parametrize("conv", [1, 2])
def test_weight_repack_is_core_matrix_order(conv):
    _, op, _, _ = _operands(1, conv, 1)
    packed = DS.digit_weight(op.wt).numpy()
    n, kp = op.wt.shape
    assert packed.size == DS.CONVS[conv].w_bytes == n * kp
    s, h, q, i, j = np.meshgrid(np.arange(kp // 32), np.arange(2), np.arange(n // 8), np.arange(8), np.arange(16),
                                indexing="ij")
    np.testing.assert_array_equal(packed.reshape(-1), op.wt.numpy()[8 * q + i, 32 * s + 16 * h + j].reshape(-1))
    assert DS.digit_weight(op.wt) is DS.digit_weight(op.wt)  # made once a weight


def _codes(h, act, table):
    if table is None:
        return np.maximum(act_codes(h, act.g, "bins").numpy().astype(np.int64), 0)
    return act_codes_table_plain(h, table).numpy().astype(np.int64)


def _pool_and_map(acc, groups, scale, bias, act, hits):
    """The epilogue on sums acc (..., 4 window sums, N): the largest (or,
    for a negative scale, the least) sum, one code through the table, and
    in a window the largest of the four sums' own codes."""
    table = None if act.impl == "bins" else act_table(act.impl, act.g, CPU, relu=True)
    pooled = np.where(scale < 0, acc.min(-2), acc.max(-2))
    h = fma_f32(torch.from_numpy(pooled.astype(np.float32)), torch.from_numpy(scale), torch.from_numpy(bias))
    code = _codes(h, act, table)
    if table is not None:
        hn = h.numpy()
        win = (hn >= table.lo) & (hn <= table.hi) & act_table_window(hn, table)
        hits.append(int(win.sum()))
        for idx in zip(*np.nonzero(win)):
            n = idx[-1]
            own = fma_f32(torch.from_numpy(acc[idx[:-1]][:, n].astype(np.float32)), float(scale[n]), float(bias[n]))
            code[idx] = max(0, int(act_codes(own, act.g, act.impl).max()))
    return code


def emulate_conv1(xq, packed, scale, bias, act, plan, hits):
    """Conv 1 in numpy, index for index: xq the prep pass's (B, 28, 32, 4)
    int8, the re-packed weight (4, 2, 32, 16). Returns (B, 12, 12, 32)."""
    b_n = xq.shape[0]
    img_bytes = xq.reshape(b_n, -1).astype(np.int64)
    wmat = packed.astype(np.int64).transpose(0, 2, 1, 3).reshape(4, 32, 32)  # [s][n][16h + j]
    r = np.arange(64)
    wq, h, gq = r // 16, (r % 16) // 8, r % 8
    t = np.arange(4)
    out = np.zeros((b_n, 144, 32), np.int64)
    for tile in range(plan.n_tiles):
        for i in range(min(plan.IMG, b_n - tile * plan.IMG)):
            img = img_bytes[tile * plan.IMG + i]
            for gg in range(plan.groups):
                pooled_p = 16 * gg + 4 * wq + (gq >> 2) + 2 * h
                oy = 2 * (pooled_p // 12) + ((gq >> 1) & 1)
                ox = 2 * (pooled_p % 12) + (gq & 1)
                off = oy * 128 + 4 * (ox + 3)  # (64,)
                acc = np.zeros((64, 32), np.int64)
                for s in range(4):
                    a = np.zeros((64, 32), np.int64)
                    for half in range(2):  # words t (a0/a1) and 4 + t (a2/a3)
                        j = 8 * s + 4 * half + t
                        o = np.where(j < 25, (j // 5) * 128 + 4 * (j % 5), 0)
                        a[:, 16 * half + 4 * t[:, None] + np.arange(4)] = \
                            img[(off[:, None, None] + o[None, :, None] + np.arange(4))]
                    acc += a @ wmat[s].T
                # a window: rows 4P' .. 4P' + 3 of the group (gq & 3 its position)
                win_sums = acc.reshape(16, 4, 32)
                assert (pooled_p.reshape(16, 4) == pooled_p.reshape(16, 4)[:, :1]).all()
                out[tile * plan.IMG + i, pooled_p.reshape(16, 4)[:, 0]] = _pool_and_map(win_sums, 1, scale, bias, act,
                                                                                        hits)
    return out.reshape(b_n, 12, 12, 32)


def emulate_conv2(xin, packed, scale, bias, act, plan, hits):
    """Conv 2 in numpy, index for index: xin (B, 12, 12, 32) int8 codes, the
    re-packed weight (25, 2, 48, 16). Returns (B, 4, 4, 48)."""
    b_n = xin.shape[0]
    wmat = packed.astype(np.int64).transpose(0, 2, 1, 3).reshape(25, 48, 32)
    m = np.arange(64)
    oy, ox = m // 8, m % 8
    out = np.zeros((b_n, 16, 48), np.int64)
    plane = 144 * 16
    for tile in range(plan.n_tiles):
        b0 = tile * plan.IMG
        stage = np.zeros(plan.IMG * 2 * plane, np.int64)  # the two boxes: half h of every image, then the other
        for hh in range(2):
            for i in range(plan.IMG):
                if b0 + i < b_n:
                    src = xin[b0 + i].reshape(144, 32)[:, 16 * hh : 16 * hh + 16].astype(np.int64)
                    base = hh * plan.IMG * plane + i * plane
                    stage[base : base + plane] = src.reshape(-1)
        for i in range(min(plan.IMG, b_n - b0)):
            acc = np.zeros((64, 48), np.int64)
            for j in range(25):
                dy, dx = divmod(j, 5)
                k = np.arange(32)
                # descriptor: start i plane + (dy 12 + dx) 16, row r of core
                # matrix oy at + 16 r, the next oy 192 on, K half kk // 16 LBO on
                addr = (i * plane + (dy * 12 + dx) * 16 + oy[:, None] * 192 + ox[:, None] * 16 +
                        (k // 16) * plan.IMG * plane + k % 16)
                acc += stage[addr] @ wmat[j].T
            # accumulator row 16 wq + gq + 8h = output (2 wq + h, gq): a window
            # is h = 0, 1 of lanes gq and gq ^ 1
            sums = acc.reshape(4, 2, 4, 2, 48).transpose(0, 2, 1, 3, 4).reshape(16, 4, 48)  # [py, px][4][n]
            out[b0 + i] = _pool_and_map(sums, 1, scale, bias, act, hits)
    return out.reshape(b_n, 4, 4, 48)


def _emulate(conv, x, op, scale, bias, act, hits):
    plan = DS.digit_plan(conv, x.shape[0], SMS)
    packed = DS.digit_weight(op.wt).numpy()
    if conv == 1:
        return emulate_conv1(DS.digit_prep(x).numpy(), packed, scale, bias, act, plan, hits)
    return emulate_conv2(x.numpy(), packed, scale, bias, act, plan, hits)


@pytest.mark.parametrize("conv", [1, 2])
@pytest.mark.parametrize("b,impl,bits", [(3, "erf", 8), (2, "poly", 8), (2, "bins", 4)])
def test_kernel_model_rebuilds_the_chain(conv, b, impl, bits):
    x, op, scale, bias = _operands(conv + b, conv, b)
    act = _act(impl, bits)
    got = _emulate(conv, x, op, scale, bias, act, [])
    want = DS.digit_chain(conv, x, op, act).numpy()
    assert got.shape == want.shape and want.dtype == np.int8
    assert want.max() > 0 and (want == 0).any()  # the codes span the relu
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(DS.conv_pool(conv, x, op, act).numpy(), want)  # the CPU path is the chain


@pytest.mark.parametrize("conv", [1, 2])
@pytest.mark.parametrize("impl", ["erf", "poly"])
def test_kernel_model_in_the_maps_windows(conv, impl):
    """Pooled h inside the map's windows, where the kernel takes every
    sum's own code: the model still rebuilds the chain, having taken that
    path."""
    x, op, scale, bias = _operands(7, conv, 2, faint=True, impl=impl)
    act = _act(impl, 8)
    hits = []
    got = _emulate(conv, x, op, scale, bias, act, hits)
    np.testing.assert_array_equal(got, DS.digit_chain(conv, x, op, act).numpy())
    assert sum(hits) > 10


@functools.lru_cache(maxsize=None)
def _digit_trees(seed=4):
    return random_like(interop.init_mnist_dann_params(torch.Generator().manual_seed(0), "cpu"), seed)


@functools.lru_cache(maxsize=None)
def _jax_digit():
    return jax.device_get(jax.jit(JDig.convert_mnist_dann)(*_digit_trees()))


@pytest.mark.parametrize("impl", ["erf", "poly"])
def test_cpu_forward_equals_jitted_jax(impl):
    jq = _jax_digit()
    x = np.random.RandomState(9).uniform(-1, 1, (3, 28, 28, 3)).astype(np.float32)
    want = jax.jit(functools.partial(JDig.mnist_dann_int8_forward, act_impl=impl))(jq, x)
    tq = interop.qparams_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    got = TDig.mnist_dann_int8_forward(tq, torch.from_numpy(x), act_impl=impl)
    for g_, w_ in zip(got, want):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g_.numpy(), w_, rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(w_).max())))
    assert got[0].shape == (3, 10) and got[1].shape == (3, 2)
