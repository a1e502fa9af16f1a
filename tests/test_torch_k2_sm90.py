"""K2's Hopper form (csrc/cdf_quant_sm90.cu) against its direct kernel
(csrc/quantize.cu cdf_quant_kernel), bit for bit, on the card.

Needs a CUDA card and nvcc: every test takes the `cuda` fixture, which
skips without one. Imports no JAX:

    python -m pytest tests/test_torch_k2_sm90.py -q --noconftest

The Hopper form maps through a step table built on the card from the
direct kernel's own codes, so the two agree on every f32: here at the
act-site sizes and a ragged n, at storage offsets 0-3
through the entry point, on every pattern within 2^20 ulps of each step,
on NaN and the infinities, and on two chunks of 2^28 patterns that hold
every step; and the card's table against the direct map over all 2^32
patterns (chip_smoke.py checks the kernel over all 2^32 too).
"""

import pytest
import torch

from alignq_tpu_torch.kernels import _build
from alignq_tpu_torch.kernels import quantize as K2

pytestmark = pytest.mark.cuda

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _both(x: torch.Tensor):
    """The direct kernel's codes and the Hopper form's (raw launches) of a
    contiguous, aligned x."""
    old, new = (torch.empty(x.shape, dtype=torch.int8, device=x.device) for _ in range(2))
    K2._k2_launch(x, old)
    K2._k2_sm90_launch(x, new, K2.device_k2_plan(x))
    torch.cuda.synchronize()
    return old, new


SIZES = [b * per for b in (2048, 256, 8) for per in (1024 * 16, 256 * 32, 64 * 64)] + [1_000_003, 1, 17, 4097]


@pytest.mark.parametrize("n", SIZES)
def test_sizes_bit_for_bit(cuda, n):
    x = torch.randn(n, generator=torch.Generator(device=cuda).manual_seed(n % 1009), device=cuda) * 1.5
    old, new = _both(x)
    assert torch.equal(old, new)


@pytest.mark.parametrize("n", [4099, K2.K2_MIN_N + 4099])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_entry_point_at_any_offset(cuda, n, offset):
    base = torch.randn(n + offset, generator=torch.Generator(device=cuda).manual_seed(offset), device=cuda) * 1.5
    view = base[offset:]
    before = dict(_build.launches)
    got = K2.cdf_quantize_int8(view)
    torch.cuda.synchronize()
    assert _build.launches[K2.KERNEL] == before.get(K2.KERNEL, 0) + 1
    assert _build.launches[K2.KERNEL_SM90] == before.get(K2.KERNEL_SM90, 0) + int(K2.k2_takes(n))
    old, new = _both(view.clone())  # an aligned copy: the raw launches take 16-byte aligned data
    assert torch.equal(got, old) and torch.equal(got, new)
    want = K2.cdf_quantize_int8_plain(view)
    diff = got != want  # the card's expf and the plain version's may differ in their last bit
    assert diff.sum().item() <= 1e-6 * n + 1 and ((got.int() - want.int()).abs() <= 1).all()


def test_every_pattern_near_the_steps(cuda):
    wa, _ = K2.act_table_steps("as", 127, K2._k2_where(cuda))
    keys = torch.from_numpy(K2._f32_key(wa)).to(cuda)
    span = torch.arange(-(1 << 20), 1 << 20, device=cuda, dtype=torch.int64)
    for first in range(0, len(keys), 16):  # 16 steps at a time: 32M patterns
        k = (keys[first:first + 16, None] + span[None, :]).reshape(-1)
        bits = torch.where(k >= 0, k, (-(k + 1)) | -0x80000000).to(torch.int32)  # the f32 order's keys to bits
        old, new = _both(bits.view(torch.float32))
        assert torch.equal(old, new), first


def test_nan_and_infinities(cuda):
    x = torch.tensor([float("nan"), -float("nan"), float("inf"), -float("inf"), 0.0, -0.0] * 3, device=cuda)
    nan_bits = torch.tensor([0x7F800001, 0x7FFFFFFF, -0x7FFFFFFF, -1], dtype=torch.int32, device=cuda)
    x = torch.cat([x, nan_bits.view(torch.float32)])
    old, new = _both(x)
    assert torch.equal(old, new)
    assert new.tolist() == [0, 0, 127, -127, 0, 0] * 3 + [0] * 4


@pytest.mark.parametrize("start", [0x38000000, 0xB8000000])
def test_chunks_that_hold_every_step(cuda, start):
    """2^28 consecutive patterns from start: |x| from 3e-5 to 1.3e5, every
    step of one sign."""
    lo = start - (1 << 32) if start >= 1 << 31 else start
    x = (torch.arange(1 << 28, dtype=torch.int32, device=cuda) + lo).view(torch.float32)
    old, new = _both(x)
    assert torch.equal(old, new)


def test_card_table_every_f32(cuda):
    from alignq_tpu_torch.kernels import stem

    assert stem.act_table_differences("as", 127, False, cuda) == (0, None)
