"""The CIFAR nets' first conv as one Hopper kernel, image in
(csrc/first_conv_sm90.cu).

The JAX serving graphs of ResNet-20/56, DenseNet-40 and MobileNet-V2 begin
alike (alignq_tpu/kernels/infer.py:131 `_linear_q`, then :235 `_int8_conv`
and the act codes; infer_densenet.py:258, infer_mobilenet.py:127): the f32
image quantized by a reciprocal multiply, then a 3x3 pad-1 int8 conv over
its 3 channels with its BN folded, then the site's epilogue. `first_conv`
returns that conv's output (B, H, W, N) in K1's epilogue modes (the act
codes, relu'd or not; f32; the stage buffer's requant; int32 and the
relu'd f32, which no site uses, by the chain):

- on a CUDA tensor whose shape the kernel takes (`first_conv_takes`: f32
  images (B, H, 32, 3) with H % 8 == 0, a whole 3x3 weight over the 3
  channels to 16, 24 or 32 columns), one launch of `first_conv_kernel`:
  the quantization in registers, K = 27 in one wgmma K step, the epilogue
  of csrc/k1_epilogue.cuh (the erf and poly codes through their step
  tables);
- on any other CUDA input, the chain it replaced (`first_conv_chain`):
  `linear_q`, then K1 (kernels/qmatmul.py; its pad pass widens the 3
  channels to 4, and its mma.sync form takes the conv);
- on a CPU tensor, `first_conv_chain` too, K1 then being its plain version.

The kernel agrees with the chain bit for bit (chip_smoke.py holds it so on
every first conv of the served graphs). Launches count under FIRST (and
under K1's KERNEL, family, MODE and ks3 keys, as the conv they replace
did); `_old_form()` gives every first conv the chain, for A/B runs only.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from alignq_tpu_torch.kernels import _build
from alignq_tpu_torch.kernels import qmatmul as K1

FIRST = K1.KERNEL + ":first_sm90"  # launch-counter key of the kernel
N_TAKES = (16, 24, 32)  # the columns it takes: ResNet-20/56, DenseNet-40, MobileNet-V2
MODES = ("f32", "requant", "poly", "erf", "bins", "bins_int")  # the epilogue modes the sites use
W_IMG = 32  # the image side it takes (CIFAR's)
FIRST_WG = 4  # warpgroups a CTA
FIRST_STAGES = 4  # its ring's stages
TALL_TILES = 2 * 132  # tiles of the most rows that give this many (two a CTA on an H100)
SMEM_MAX = 227 * 1024  # shared memory a CTA may take on an H100
# csrc/first_conv_sm90.cu's ROW_F32, RP (bytes) and act_codes.cuh TABLE_MAX (entries of 8 bytes)
_ROW_F32, _RP, _TABLE_BYTES = W_IMG * 3 * 4, 192, 1024 * 8


class FirstPlan(NamedTuple):
    """One launch's tiling, in the order of csrc/first_conv_sm90.cu's Plan."""

    B: int
    H: int
    N: int
    R: int  # output rows a tile: 2 * MG * n_wg
    TY: int  # tiles an image
    n_tiles: int
    n_wg: int  # warpgroups a CTA
    MG: int  # m64 groups (two output rows each) a warpgroup takes a tile
    S: int  # stages of the ring
    stage_bytes: int
    band_bytes: int
    obuf_bytes: int  # a warp's output buffer
    w_off: int
    stage_off: int
    band_off: int
    obuf_off: int
    tab_off: int
    sb_off: int
    bar_off: int
    smem: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def first_option(b: int, h: int) -> int:
    """MG by the rule measured on the card (PERF.md, the first-conv
    kernel): tiles of 32 rows (MG 4 on FIRST_WG warpgroups), else 16 (MG 2),
    where they number TALL_TILES or more, else of 8 (MG 1): at 2048 whole
    32-row images were the fastest, at 256 16-row tiles, at 8 the 8-row
    ones."""
    return next((mg for mg in (4, 2) if h % (8 * mg) == 0 and b * h // (8 * mg) >= TALL_TILES), 1)


def first_plan(b: int, h: int, n: int, mg: Optional[int] = None, n_wg: int = FIRST_WG) -> FirstPlan:
    """The kernel's plan over images (b, h, 32, 3) to n columns: tiles of
    2 * mg * n_wg output rows (mg by first_option where None). Raises
    ValueError, naming the shape, for one it does not take."""
    mg = first_option(b, h) if mg is None else mg
    r = 2 * mg * n_wg
    shape = f"images ({b}, {h}, {W_IMG}, 3) to {n} columns, tiles of {r} rows"
    if b < 1 or h < 1 or n not in N_TAKES or mg not in (1, 2, 4) or n_wg not in (1, 2, 4) or h % r:
        raise ValueError(f"the first-conv kernel does not take {shape}")
    stage_bytes = _round_up((r + 2) * _ROW_F32, 128)
    band_bytes = _round_up((r + 2) * _RP, 128)
    obuf_bytes = 16 * n * 4  # a warp's 16 rows in the widest mode (f32)
    stage_off = _round_up(32 * n, 128)
    band_off = stage_off + FIRST_STAGES * stage_bytes
    obuf_off = band_off + 2 * band_bytes
    tab_off = obuf_off + 4 * n_wg * obuf_bytes
    sb_off = tab_off + _TABLE_BYTES
    bar_off = sb_off + 8 * n
    smem = bar_off + 8 * (FIRST_STAGES + 1)
    if smem > SMEM_MAX:
        raise ValueError(f"the first-conv kernel does not take {shape}: {smem} bytes of shared memory a CTA")
    return FirstPlan(b, h, n, r, h // r, b * (h // r), n_wg, mg, FIRST_STAGES, stage_bytes, band_bytes, obuf_bytes, 0,
                     stage_off, band_off, obuf_off, tab_off, sb_off, bar_off, smem)


_OLD_FORM = False  # set only by _old_form


@contextlib.contextmanager
def _old_form():
    """Every first conv inside takes the chain the kernel replaced
    (first_conv_chain). For the A/B timing of the two (chip_smoke.py
    --first-plane-ab) and the card's checks; the main path never calls
    it."""
    global _OLD_FORM
    saved, _OLD_FORM = _OLD_FORM, True
    try:
        yield
    finally:
        _OLD_FORM = saved


def first_conv_takes(x: torch.Tensor, op: K1.K1Weights, mode: str) -> bool:
    """The rule: the kernel takes f32 NHWC images (B, H, 32, 3) with H %
    8 == 0 and a whole (unsharded) packed 3x3 weight over the 3 channels to
    16, 24 or 32 columns, in the epilogue modes the sites use (MODES:
    ResNet-20/56's codes of every map, relu'd, DenseNet-40's f32 and
    requant, MobileNet-V2's relu'd codes; not int32 or relu'd f32)."""
    if _OLD_FORM or x.ndim != 4 or x.dtype != torch.float32 or tuple(x.shape[2:]) != (W_IMG, 3):
        return False
    if op.ksize != 3 or op.cin != 4 or op.n not in N_TAKES or op.shard is not None or \
            tuple(op.wt.shape) != (op.n, 64):
        return False
    return mode in MODES and x.shape[0] > 0 and x.shape[1] % 8 == 0


def linear_q(x: torch.Tensor, scale: float) -> torch.Tensor:
    """The image's int8 codes by a reciprocal multiply, as the JAX graph's
    stem input quantization: clip(rint(x * (1 / scale)), +-127), one f32
    rounding of the multiply (the kernel's arithmetic, __fmul_rn)."""
    return torch.clamp(torch.round(x * (1.0 / scale)), -127.0, 127.0).to(torch.int8)


def first_conv_chain(x: torch.Tensor, op: K1.K1Weights, scale: float, act: Optional[K1.ActMap] = None,
                     mode: str = "f32") -> torch.Tensor:
    """The first conv as separate passes: linear_q, then K1 (its plain
    version on a CPU tensor): the act codes where act is given, else the
    epilogue `mode`. (B, H, W, N)."""
    xq = linear_q(x, scale)
    return K1.int8_conv_codes(xq, op, 1, 1, act) if act is not None else K1.int8_conv_packed(xq, op, 1, 1, mode)


def first_conv_reference(x: torch.Tensor, op: K1.K1Weights, scale: float, act: Optional[K1.ActMap] = None,
                         mode: str = "f32") -> torch.Tensor:
    """The kernel's plain version on any device: linear_q, then K1's plain
    conv (int8_conv_reference)."""
    return K1.int8_conv_reference(linear_q(x, scale), op, 1, 1, act.impl if act is not None else mode, act)


@functools.lru_cache(maxsize=None)
def first_k_order() -> np.ndarray:
    """The kernel's 32 K positions as indices into the packed (dy, dx, c)
    columns of a 4-channel 3x3 weight, -1 for a zero byte: position k =
    9 dy + 3 dx + c (c < 3) for k < 27, then 5 zeros."""
    k = np.arange(32)
    dy, dx, c = k // 9, (k % 9) // 3, k % 3
    return np.where(k < 27, (3 * dy + dx) * 4 + c, -1)


# id(wt) -> [a weak reference to wt, its re-packed copy]: an entry goes with its weight
_WEIGHTS: dict = {}


def first_weight(wt: torch.Tensor) -> torch.Tensor:
    """wt (N, 64) re-packed for the kernel: its columns in first_k_order,
    laid out as wgmma's no-swizzle core matrices ([half][row][16 bytes],
    32 * N bytes), made once per weight tensor and kept while it lives."""
    key = id(wt)
    hit = _WEIGHTS.get(key)
    if hit is None or hit[0]() is not wt:
        order = torch.from_numpy(first_k_order()).to(wt.device)
        ext = torch.nn.functional.pad(wt, (0, 1))  # a zero column
        cols = ext.index_select(1, torch.where(order < 0, wt.shape[1], order))
        packed = cols.reshape(wt.shape[0], 2, 16).permute(1, 0, 2).contiguous().reshape(-1)
        hit = [weakref.ref(wt, lambda _, k=key: _WEIGHTS.pop(k, None)), packed]
        _WEIGHTS[key] = hit
    return hit[1]


def _lib() -> ctypes.CDLL:
    lib = _build.load("first_conv_sm90")
    if not getattr(lib, "_argtypes_set", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.first_conv_launch.argtypes = [p, p, p, p, p, f, f, i, i, p, p, p, p, i, i, i, f, p,
                                          ctypes.POINTER(i), p]
        lib.first_conv_launch.restype = i
        lib.first_conv_plan_ints.restype = i
        if lib.first_conv_plan_ints() != len(FirstPlan._fields):
            raise RuntimeError("csrc/first_conv_sm90.cu's Plan does not match FirstPlan")
        lib._argtypes_set = True
    return lib


def _first_launch(x: torch.Tensor, op: K1.K1Weights, scale: float, act: Optional[K1.ActMap], mode: str,
                  plan: FirstPlan, out: torch.Tensor) -> None:
    """One launch of first_conv_kernel on checked operands: x (B, H, 32, 3)
    f32 contiguous, op's weight re-packed (first_weight), out (B * H * 32,
    N) of the mode's type (`mode` the act's impl in a codes mode). Counts
    nothing (the wrapper does). A launch that fails raises."""
    bnd, sgn, t1, t2 = (None,) * 4 if act is None else act[2:6]

    def ptr(t):
        return None if t is None else t.data_ptr()

    with _build.on_device(x.device):
        err = _lib().first_conv_launch(
            x.data_ptr(), first_weight(op.wt).data_ptr(), op.scale.data_ptr(), op.bias.data_ptr(),
            *K1.table_args(act, mode, x.device), ptr(bnd), ptr(sgn), ptr(t1), ptr(t2),
            0 if act is None else act.g, int(act is not None and act.relu), K1._MODE[mode],
            float(np.float32(1.0 / scale)), out.data_ptr(), K1._plan_ints(plan),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, "first_conv_sm90.cu first_conv_kernel")


def first_conv(x: torch.Tensor, op: K1.K1Weights, scale: float, act: Optional[K1.ActMap] = None,
               mode: str = "f32") -> torch.Tensor:
    """The first conv of a CIFAR net: f32 NHWC images (B, H, W, 3) quantized
    at `scale`, conv'd (3x3, pad 1) with a packed weight (pack_conv_weights
    over the 3 channels): the act codes (B, H, W, N) int8 where act is
    given, else the epilogue `mode` ('f32', 'relu', 'int32' or 'requant').
    The kernel where first_conv_takes gives it the shape, else
    first_conv_chain (always on a CPU tensor)."""
    if act is not None:
        K1._check_act(op, act)
        mode = act.impl
    elif mode not in K1._FAMILY:
        raise ValueError(f"unknown mode {mode!r}")
    if x.device.type == "cpu" or not first_conv_takes(x, op, mode):
        return first_conv_chain(x, op, scale, act, mode)
    tensors = [x, *op[:3]] + ([t for t in act[2:6] if t is not None] if act is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the images, the packed weight and the act map must lie on one device")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("the first-conv kernel needs 16-byte aligned images")
    b, h, w, _ = x.shape
    plan = first_plan(b, h, op.n)
    dtype = {"int32": torch.int32, "f32": torch.float32, "relu": torch.float32}.get(mode, torch.int8)
    out = torch.empty((b * h * w, op.n), dtype=dtype, device=x.device)
    _first_launch(x, op, scale, act, mode, plan, out)
    _build.launches[FIRST] += 1
    _build.launches[K1.KERNEL] += 1
    _build.launches[f"{K1.KERNEL}:{K1._FAMILY.get(mode, 'codes')}"] += 1
    _build.launches[K1.MODE.format(mode)] += 1
    _build.launches[K1.FORM.format(3)] += 1
    return out.reshape(b, h, w, op.n)
