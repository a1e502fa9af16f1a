"""The digit DANN's 5x5 convs as one Hopper kernel each, with their act
codes and the 2x2 max pool after them (csrc/digit_sm90.cu).

The JAX serving graph's conv block (alignq_tpu/kernels/infer_digit.py
mnist_dann_int8_forward) is a 5x5 VALID int8 conv with its BN folded, the
act codes relu'd, and the 2x2 stride-2 max pool of the codes. `conv_pool`
returns that pooled stream, int8 (B, Ho/2, Wo/2, N), for the net's two
convs:

- conv1, the f32 image (B, 28, 28, 3) to 32 channels (B, 12, 12, 32): on
  a CUDA tensor the prep pass of csrc/stem_sm90.cu at the digit scale
  (`digit_prep`: `_linear_q`, the channels padded to 4, rows of 32
  pixels) and one launch of the kernel;
- conv2, conv1's pooled codes (B, 12, 12, 32) to 48 channels (B, 4, 4,
  48): one launch;
- on a CUDA input whose shape or map the kernel does not take
  (`digit_takes`), the chain it replaced (`digit_chain`): K1's 5x5 form
  (kernels/qmatmul.py), then the max pool of the codes;
- on a CPU tensor, `digit_chain` too, K1 then being its plain version.

The form agrees with the chain bit for bit (chip_smoke.py holds it so on
every launch of the digit forward at batches 3, 256 and 2048). Launches
count under DIGIT (and under K1's KERNEL, CODES and MODE keys, as the
conv they replace did), the prep pass under PREP; `_old_form()` gives
every conv the chain, for A/B runs only.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from alignq_tpu_torch.kernels import _build
from alignq_tpu_torch.kernels import qmatmul as K1
from alignq_tpu_torch.kernels import stem as ST
from alignq_tpu_torch.kernels.infer import _linear_q
from alignq_tpu_torch.kernels.quantize import act_table

DIGIT = K1.KERNEL + ":ks5_sm90"  # launch-counter key of the kernel
PREP = DIGIT + ":prep"  # ... of the pass before conv1
S_DIGIT = 1.0 / 127.0  # digit images lie in [-1, 1]: the whole code range, no clip
_INV_S_DIGIT = float(np.float32(1.0 / S_DIGIT))  # _linear_q's multiplier, as the f32 the multiply takes
SMEM_MAX = 227 * 1024  # shared memory a CTA may take on an H100
_MODE = {"poly": 3, "erf": 4, "bins": 5}  # csrc/k1_epilogue.cuh's mode codes
_TABLE_BYTES = 512 * 8  # csrc/digit_sm90.cu TABLE_ROOM entries of 8 bytes


class _Conv(NamedTuple):
    """A conv's fixed geometry, as csrc/digit_sm90.cu's C1_* and C2_*."""

    hw: int  # the input's side
    cin: int  # channels of the packed weight
    n: int  # channels out
    in_bytes: int  # an image in shared memory
    out_bytes: int  # its pooled codes
    w_bytes: int  # the re-packed weight
    groups: int  # m64 groups an image
    pooled: int  # the pooled side


CONVS = {1: _Conv(28, 4, 32, 28 * 128, 144 * 32, 4 * 32 * 32, 9, 12),
         2: _Conv(12, 32, 48, 2 * 144 * 16, 16 * 48, 25 * 48 * 32, 1, 4)}
STAGES = 4
PER_SM = 2  # CTAs an SM at most
BIG_BATCH = 1024  # conv 1's tiles grow from this batch on


def default_option(conv: int, b: int) -> tuple:
    """(images a tile, warpgroups) by the rule measured on the card
    (chip_smoke.py --bn-digit-ab): conv 1 an image a tile over 3
    warpgroups (3 of its 9 m64 groups each), 4 images over 4 from
    BIG_BATCH on; conv 2 an image a warpgroup, 2 a tile."""
    if conv == 1:
        return (4, 4) if b >= BIG_BATCH else (1, 3)
    return (2, 2)


class DigitPlan(NamedTuple):
    """One launch's tiling, in the order of csrc/digit_sm90.cu's Plan."""

    conv: int
    B: int
    N: int
    IMG: int  # images a tile
    n_wg: int  # warpgroups a CTA
    S: int  # stages
    n_tiles: int
    ctas: int
    in_bytes: int
    out_bytes: int
    w_bytes: int
    groups: int
    w_off: int
    stage_off: int
    stage_bytes: int
    out_off: int
    obuf_bytes: int
    tab_off: int
    sb_off: int
    bar_off: int
    smem: int


def _r(v: int, m: int) -> int:
    return -(-v // m) * m


def digit_plan(conv: int, b: int, sms: int, img: Optional[int] = None, n_wg: Optional[int] = None) -> DigitPlan:
    """The plan of conv `conv` (1 or 2) over b images on a card of `sms`
    SMs: tiles of `img` images, `n_wg` warpgroups a CTA (default
    default_option's; others for A/B runs), STAGES deep, at most PER_SM
    CTAs an SM (as many as fit) and one a tile. Raises ValueError for a
    plan past a CTA's shared memory or threads."""
    if conv not in CONVS or b < 1:
        raise ValueError(f"the digit kernel takes conv 1 or 2 over at least one image, got conv {conv}, {b}")
    d_img, d_wg = default_option(conv, b)
    img, n_wg = img or d_img, n_wg or d_wg
    c = CONVS[conv]
    if not (1 <= n_wg <= 4 and 1 <= img <= 256):
        raise ValueError(f"tiles of {img} images, {n_wg} warpgroups: off the kernel's range")
    stage_off = _r(c.w_bytes, 128)
    stage_bytes = _r(img * c.in_bytes, 128)
    out_off = stage_off + STAGES * stage_bytes
    obuf = _r(img * c.out_bytes, 16)
    tab_off = out_off + 2 * obuf
    sb_off = tab_off + _TABLE_BYTES
    bar_off = sb_off + 8 * c.n
    smem = bar_off + 8 * (STAGES + 1)
    if smem > SMEM_MAX:
        raise ValueError(f"conv {conv} in tiles of {img} images: {smem} bytes of shared memory")
    n_tiles = -(-b // img)
    return DigitPlan(conv, b, c.n, img, n_wg, STAGES, n_tiles, min(n_tiles, PER_SM * sms), c.in_bytes, c.out_bytes,
                     c.w_bytes, c.groups, 0, stage_off, stage_bytes, out_off, obuf, tab_off, sb_off, bar_off, smem)


_OLD_FORM = False  # set only by _old_form


@contextlib.contextmanager
def _old_form():
    """Every conv inside takes the chain the kernel replaced (digit_chain).
    For A/B runs and the card's comparisons (chip_smoke.py --bn-digit-ab);
    the main path never calls it."""
    global _OLD_FORM
    saved, _OLD_FORM = _OLD_FORM, True
    try:
        yield
    finally:
        _OLD_FORM = saved


def digit_takes(conv: int, x: torch.Tensor, op: K1.K1Weights, act: K1.ActMap) -> bool:
    """The rule: the kernel takes conv 1 over f32 NHWC images (B, 28, 28,
    3) and conv 2 over int8 codes (B, 12, 12, 32), each with its whole
    (unsharded) 5x5 weight (4 -> 32, 32 -> 48 channels) and the erf, poly
    or bins map relu'd."""
    if _OLD_FORM or conv not in CONVS or x.ndim != 4 or x.shape[0] < 1:
        return False
    c = CONVS[conv]
    want = (torch.float32, 3) if conv == 1 else (torch.int8, c.cin)
    if (x.dtype, x.shape[-1]) != want or tuple(x.shape[1:3]) != (c.hw, c.hw):
        return False
    if op.ksize != 5 or op.cin != c.cin or op.n != c.n or op.shard is not None or \
            tuple(op.wt.shape) != (c.n, _r(25 * c.cin, K1.K_MULT)):
        return False
    return act.impl in _MODE and act.relu


def max_pool2(c: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 VALID max pool of NHWC codes."""
    b, h, w, n = c.shape
    c = c[:, : h // 2 * 2, : w // 2 * 2]
    return c.reshape(b, h // 2, 2, w // 2, 2, n).amax(dim=(2, 4))


def _conv_input(conv: int, x: torch.Tensor) -> torch.Tensor:
    """conv's int8 input as the chain takes it: conv 1's image by _linear_q."""
    return _linear_q(x, S_DIGIT) if conv == 1 else x


def digit_chain(conv: int, x: torch.Tensor, op: K1.K1Weights, act: K1.ActMap) -> torch.Tensor:
    """The conv block as separate passes: _linear_q (conv 1), K1's 5x5 form
    (its plain version on a CPU tensor), the max pool. int8 (B, Ho/2,
    Wo/2, N). On a CPU tensor the plain version of the kernel."""
    return max_pool2(K1.int8_conv_codes(_conv_input(conv, x), op, 1, 0, act))


def digit_reference(conv: int, x: torch.Tensor, op: K1.K1Weights, act: K1.ActMap) -> torch.Tensor:
    """The plain version of the kernel on any device: _linear_q (conv 1),
    K1's plain conv (int8_conv_reference), the max pool."""
    return max_pool2(K1.int8_conv_reference(_conv_input(conv, x), op, 1, 0, act.impl, act))


# id(wt) -> [a weak reference to wt, its re-packed copy]: an entry goes with its weight
_WEIGHTS: dict = {}


def digit_weight(wt: torch.Tensor) -> torch.Tensor:
    """wt (N, Kp) re-packed for the kernel, made once per weight tensor and
    kept while it lives: K step s (32 bytes of K, K1's (dy, dx, c) order) in
    wgmma's no-swizzle core-matrix order, [s][half h][column group q][column
    i][byte j] = wt[8q + i, 32s + 16h + j]."""
    key = id(wt)
    hit = _WEIGHTS.get(key)
    if hit is None or hit[0]() is not wt:
        n, kp = wt.shape
        packed = wt.reshape(n, kp // 32, 2, 16).permute(1, 2, 0, 3).contiguous()
        hit = [weakref.ref(wt, lambda _, k=key: _WEIGHTS.pop(k, None)), packed]
        _WEIGHTS[key] = hit
    return hit[1]


def _lib() -> ctypes.CDLL:
    lib = _build.load("digit_sm90")
    if not getattr(lib, "_argtypes_set", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.digit_launch.argtypes = [p, p, p, p, p, f, f, i, i, p, i, i, p, ctypes.POINTER(i), p]
        lib.digit_launch.restype = i
        lib.digit_plan_ints.restype = i
        if lib.digit_plan_ints() != len(DigitPlan._fields):
            raise RuntimeError("csrc/digit_sm90.cu's Plan does not match DigitPlan")
        lib._argtypes_set = True
    return lib


def digit_prep(x: torch.Tensor) -> torch.Tensor:
    """_linear_q of the f32 images (B, 28, 28, 3) at S_DIGIT in the layout
    conv 1's launch reads: int8 (B, 28, 32, 4), the channels
    zero-padded to 4, 3 zero columns on the left and 1 on the right, by
    csrc/stem_sm90.cu's prep kernel (counted under PREP) on a CUDA tensor;
    the plain passes on a CPU tensor."""
    if x.device.type == "cpu":
        return F.pad(_linear_q(x, S_DIGIT), (0, 1, 3, 1))
    x = x.contiguous()
    b, h, w, _ = x.shape
    q = torch.empty((b, h, w + 4, 4), dtype=torch.int8, device=x.device)
    if q.numel():
        ST._prep_launch(x, q, _INV_S_DIGIT)
        _build.launches[PREP] += 1
    return q


def _digit_launch(xin: torch.Tensor, op: K1.K1Weights, act: K1.ActMap, plan: DigitPlan, out: torch.Tensor) -> None:
    """One launch of digit_kernel on checked operands: xin conv 1's prepped
    images (B, 28, 32, 4) or conv 2's codes (B, 12, 12, 32), int8; op's
    weight re-packed (digit_weight); out (B, Hp, Wp, N) int8. Counts
    nothing (the wrapper does)."""
    t = act_table(act.impl, act.g, xin.device) if act.impl != "bins" else None
    with _build.on_device(xin.device):
        err = _lib().digit_launch(
            xin.data_ptr(), digit_weight(op.wt).data_ptr(), op.scale.data_ptr(), op.bias.data_ptr(),
            *((None, 0.0, 0.0, 0, 0) if t is None else ST._table_args(t)),
            None if act.bnd is None else act.bnd.data_ptr(), act.g, _MODE[act.impl], out.data_ptr(),
            K1._plan_ints(plan), torch.cuda.current_stream(xin.device).cuda_stream,
        )
    _build.check(err, "digit_sm90.cu digit_kernel")


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def conv_pool(conv: int, x: torch.Tensor, op: K1.K1Weights, act: K1.ActMap) -> torch.Tensor:
    """The digit net's conv block `conv`: conv 1 over f32 NHWC images (B,
    28, 28, 3), conv 2 over conv 1's pooled codes; its packed weight and
    act map (relu'd) -> the pooled codes int8 (B, Hp, Wp, N). The kernel
    (after the prep pass, for conv 1) where digit_takes gives it the shape,
    else digit_chain (always on a CPU tensor)."""
    if x.device.type == "cpu" or not digit_takes(conv, x, op, act):
        return digit_chain(conv, x, op, act)
    if len({t.device for t in (x, *op[:3])}) != 1:
        raise ValueError("the input and the packed weight must lie on one device")
    xin = digit_prep(x) if conv == 1 else x.contiguous()
    if xin.data_ptr() % 16:
        raise ValueError("the digit kernel needs a 16-byte aligned input")
    c = CONVS[conv]
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    plan = digit_plan(conv, x.shape[0], _sms(dev))
    out = torch.empty((x.shape[0], c.pooled, c.pooled, c.n), dtype=torch.int8, device=x.device)
    _digit_launch(xin, op, act, plan, out)
    _build.launches[DIGIT] += 1
    _build.launches[K1.KERNEL] += 1
    _build.launches[K1.CODES] += 1
    _build.launches[K1.MODE.format(act.impl)] += 1
    return out
