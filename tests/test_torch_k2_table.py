"""K2's step table and its Hopper form's plan (kernels/quantize.py k2_table,
k2_plan; csrc/cdf_quant_sm90.cu) on the CPU.

K2's map, clip(rint(erf_AS(x / sqrt2) * 127), +-127), is a step function
of the f32 x; its table ('as', grid 127) holds each step's threshold in a
bucket of x and every bucket's code below it, the end codes past the
steps. Here, with the table built on the CPU from the plain map
(cdf_quantize_int8_plain):
- the table map (act_codes_table_plain) and the kernel's lookup
  (k2_codes_table_plain) equal the plain map, exactly, on every
  f32 within ACT_TABLE_SCAN ulps of every step, on 2^20 seeded bit patterns
  across the whole range, and on the special values (+-0, the least
  denormals, +-FLT_MAX, +-inf, NaN);
- the kernel's lookup equals the JAX kernel (Pallas in interpret mode) on
  the seeded shapes of tests/test_torch_quantize.py;
- the table's layout: every bucket, the end codes past the steps;
- the entry point takes views at storage offsets 0-3;
- the plan: grid, steps and tail, and a numpy model of the kernel's walk
  that covers every element once.
chip_smoke.py builds the table on the card from the direct kernel's own
codes and checks it, and the kernel against that kernel, over all 2^32
patterns.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from alignq_tpu.kernels import quantize as JQ
from alignq_tpu_torch.kernels import quantize as Q

CPU = torch.device("cpu")
CSRC = Path(Q.__file__).resolve().parents[1] / "csrc"


def _plain(x: np.ndarray) -> np.ndarray:
    return Q.cdf_quantize_int8_plain(torch.from_numpy(x)).numpy()


def _steps_window() -> np.ndarray:
    wa, _ = Q.act_table_steps("as", 127)
    span = np.arange(-Q.ACT_TABLE_SCAN, Q.ACT_TABLE_SCAN + 1)
    return Q._f32_of_key((Q._f32_key(wa)[:, None] + span[None, :]).ravel())


def _random_bits() -> np.ndarray:
    rng = np.random.default_rng(18)
    return rng.integers(0, 2**32, 1 << 20, dtype=np.uint64).astype(np.uint32).view(np.float32)


def _specials() -> np.ndarray:
    tiny, big = np.float32(1e-45), np.finfo(np.float32).max
    return np.float32([0.0, -0.0, tiny, -tiny, big, -big, np.inf, -np.inf, np.nan, -np.nan])


POINTS = {"steps": _steps_window, "random bits": _random_bits, "specials": _specials}


@pytest.mark.parametrize("points", sorted(POINTS))
@pytest.mark.parametrize("form", ["table", "kernel"])
def test_table_map_equals_the_plain_map(points, form):
    x = torch.from_numpy(POINTS[points]())
    look_up = Q.act_codes_table_plain if form == "table" else Q.k2_codes_table_plain
    np.testing.assert_array_equal(look_up(x, Q.k2_table(CPU)).numpy(), _plain(x.numpy()))


@pytest.mark.parametrize("shape,seed", [((130, 48), 0), ((512, 1024), 1), ((7, 33, 5), 2)])
def test_kernel_lookup_equals_jax_kernel(shape, seed):
    x = (np.random.RandomState(seed).randn(*shape) * 1.5).astype(np.float32)
    want = np.asarray(JQ.cdf_quantize_int8(x))
    got = Q.k2_codes_table_plain(torch.from_numpy(x), Q.k2_table(CPU)).numpy()
    np.testing.assert_array_equal(got, want)


def test_table_layout():
    """Every bucket, 0 to 1023; one step a bucket at most; the codes below
    the steps non-decreasing from -127 to 127; no window in the CPU's map;
    the buckets between the steps' those of the table act_table_steps
    gives."""
    t = Q.k2_table(CPU)
    e = t.entries.numpy()
    assert t.b_lo == 0 and len(e) == Q.ACT_TABLE_BUCKETS and not t.relu
    base = (e[:, 0] & 0xFFFF) - 127
    assert base[0] == -127 and base[-1] == 127 and (np.diff(base) >= 0).all()
    steps = np.isfinite(e[:, 1].view(np.float32))
    assert steps.sum() == 254 and not (e[:, 0] >> 16).any()
    _, _, b_lo, core = Q._act_table_arrays("as", 127, False)
    np.testing.assert_array_equal(e[b_lo:b_lo + len(core)], core)
    with pytest.raises(ValueError, match="grid 127"):
        Q.act_table_steps("as", 7)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_entry_point_takes_any_storage_offset(offset):
    base = torch.from_numpy((np.random.RandomState(offset).randn(4099 + offset) * 1.5).astype(np.float32))
    view = base[offset:]
    assert view.storage_offset() == offset
    got = Q.cdf_quantize_int8(view)
    np.testing.assert_array_equal(got.numpy(), _plain(view.contiguous().numpy()))


SIZES = [1, 3, 15, 16, 17, 4096, 4097, 1_000_003] + [n for b in (2048, 256, 8) for n in
                                                     (b * 1024 * 16, b * 256 * 32, b * 64 * 64)]


@pytest.mark.parametrize("n", SIZES)
def test_plan(n):
    sms, per_sm = 132, 5
    p = Q.k2_plan(n, sms, per_sm)
    assert p.tiles == -(-n // Q.K2_TILE) and p.ctas == min(p.tiles, sms * per_sm)
    assert p.steps == -(-p.tiles // p.ctas) and p.tail == n % 16
    assert 1 <= p.ctas <= p.tiles  # the C entry refuses more CTAs than tiles


@pytest.mark.parametrize("n", [1, 17, 4095, 4096 + 513, 3 * 4096 + 1000, 1_000_003])
def test_kernel_walk_covers_every_element_once(n):
    """A numpy model of the kernel's walk: CTA c takes tiles c, c + G, ...;
    thread t's quad j of a tile starts at 512 warp + 4 (lane + 32 j); a
    thread whose 16 elements all lie before n loads them whole, else each
    element before n alone (the masked tail)."""
    p = Q.k2_plan(n, 4, 2)  # a small card: several tiles a CTA
    t = np.arange(Q.K2_THREADS)
    off = 512 * (t // 32) + 4 * (t % 32)
    qstep = 128
    seen = np.zeros(n, np.int64)
    steps = np.zeros(p.ctas, np.int64)
    for c in range(p.ctas):
        for tile in range(c, p.tiles, p.ctas):
            steps[c] += 1
            e = tile * Q.K2_TILE + off[:, None, None] + (np.arange(4) * qstep)[None, :, None] + np.arange(4)
            e = e.reshape(Q.K2_THREADS, 16)
            full = e.max(1) < n
            assert (~full).sum() <= Q.K2_THREADS and (full | (tile == p.tiles - 1)).all()
            live = e[e < n]
            np.add.at(seen, live, 1)
    assert (seen == 1).all() and steps.max() == p.steps


def test_rule():
    assert not Q.k2_takes(Q.K2_MIN_N - 1) and Q.k2_takes(Q.K2_MIN_N)
    assert all(Q.k2_takes(n) for b in (2048, 256) for n in (b * 1024 * 16, b * 256 * 32, b * 64 * 64))
    assert not any(Q.k2_takes(n) for n in (8 * 1024 * 16, 8 * 256 * 32, 8 * 64 * 64))


def test_source_constants():
    """csrc/cdf_quant_sm90.cu's CTA, elements a thread and buckets are the
    wrapper's."""
    src = (CSRC / "cdf_quant_sm90.cu").read_text()
    assert re.search(r"constexpr int THREADS = (\d+);", src).group(1) == str(Q.K2_THREADS)
    assert re.search(r"constexpr int PER_THREAD = (\d+);", src).group(1) == str(Q.K2_PER_THREAD)
    assert "constexpr int N_TAB = act::BUCKETS;" in src  # every bucket: k2_table's entries
    assert "constexpr int QSTEP = 128;" in src  # the walk test_kernel_walk_covers_every_element_once models
    hdr = (CSRC / "act_codes.cuh").read_text()
    assert re.search(r"constexpr int BUCKETS = (\d+);", hdr).group(1) == str(Q.ACT_TABLE_BUCKETS)
    assert re.search(r"constexpr int AS = (\d+);", hdr).group(1) == "8"
