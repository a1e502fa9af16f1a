"""Depthwise 3x3 int8 conv with a fused dequant or act-code epilogue: K1's
depthwise form.

The JAX serving graph of MobileNet-V2 runs its depthwise convs through
XLA's conv_general_dilated with feature_group_count = C
(alignq_tpu/kernels/infer_mobilenet.py:39-49); PyTorch has no int8 conv on
CUDA. On a CUDA tensor `dw_conv` launches a tiled direct kernel (one
channel a group gives an MMA nothing to contract over) in one of two
forms that `device_plan` chooses by a written rule: csrc/dwconv_sm90.cu
(bands by TMA into persistent CTAs, the erf and poly maps through their
step tables; `dw_sm90_plan`) wherever C % 16 == 0, every MobileNet-V2
depthwise conv; csrc/dwconv.cu (`dw_plan`) for the other shapes. The two
agree bit for bit. On a CPU tensor it runs the plain version beside them,
`dw_conv_reference`, which sums the 9 taps in int32.

Its launches count under K1's family, DW = 'int8_matmul_dequant:dw', and
not in K1's own total; those of the Hopper form under DW_SM90 too.
`_old_form()` gives every launch csrc/dwconv.cu, for A/B runs only.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional, Union

import torch

from alignq_tpu_torch.kernels import _build
from alignq_tpu_torch.kernels.quantize import ActTable, act_codes, act_table
from alignq_tpu_torch.quant.cdf import fma_f32

DW = "int8_matmul_dequant:dw"  # launch-counter key
DW_SM90 = DW + ":sm90"  # ... of the Hopper form's launches
_MODE = {"int32": 0, "f32": 1, "poly": 3, "erf": 4, "bins": 5}
CHUNK = 64  # most channels a CTA takes
RUN = 8  # outputs a thread takes along x
THREADS, MAX_THREADS = 256, 512  # threads a CTA: the aim, the most
SMEM_MAX = 227 * 1024


class DwWeights(NamedTuple):
    """A depthwise kernel laid out once for the kernel: w (9, C) int8, the
    taps (dy, dx) in row-major order; scale and bias (C,) f32."""

    w: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor


def pack_dw_weights(kernel_hwio: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> DwWeights:
    """An HWIO (3, 3, 1, C) int8 depthwise kernel and its (C,) f32 epilogue."""
    if tuple(kernel_hwio.shape[:3]) != (3, 3, 1):
        raise ValueError(f"a (3, 3, 1, C) depthwise kernel expected, got {tuple(kernel_hwio.shape)}")
    c = kernel_hwio.shape[3]
    return DwWeights(kernel_hwio.reshape(9, c).to(torch.int8).contiguous(),
                     scale.to(torch.float32).reshape(c).contiguous(), bias.to(torch.float32).reshape(c).contiguous())


def _out_hw(h: int, w: int, stride: int):
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, m: int) -> int:
    return _cdiv(a, m) * m


class DwPlan(NamedTuple):
    """One depthwise launch's tiling, in the order of csrc/dwconv.cu's Plan.

    A CTA takes a tile, CH channels (the last chunk fewer) of a band of TR
    output rows of one image: n_chunks x n_bands x B of them. Its threads
    are (CH / 4 quads, TR rows, GX groups along x), each with a run of RUN
    outputs. The tile's input, HR x HC pixels with the halo, sits in shared
    memory at a pixel pitch P and a row pitch RP (bytes), copied in pieces
    of vec bytes; smem is its size."""

    B: int
    H: int
    W: int
    C: int
    Ho: int
    Wo: int
    stride: int
    CH: int
    n_chunks: int
    TR: int
    n_bands: int
    RUN: int
    GX: int
    HR: int
    HC: int
    P: int
    RP: int
    vec: int
    threads: int
    smem: int


@functools.lru_cache(maxsize=None)
def dw_plan(b: int, h: int, w: int, c: int, stride: int, sms: int) -> DwPlan:
    """The tiling of one depthwise launch over x (b, h, w, c) int8 on a
    card of `sms` SMs. The channels split into the fewest chunks of at most
    CHUNK (a multiple of 16 where c is, so that the band copies 16 bytes a
    piece); a thread takes RUN outputs along x (more where the row would
    need over MAX_THREADS threads); a band as many output rows as bring the
    CTA to THREADS. While the grid holds fewer than 2 CTAs an SM, the bands
    thin to one row and then the chunks narrow; then the bands of an image
    even out. The band's
    row pitch is padded so that the quads of the rows a warp spans read
    distinct banks."""
    if c % 4 or stride not in (1, 2):
        raise ValueError(f"the depthwise kernel takes channels in fours at stride 1 or 2, got C={c}, "
                         f"stride {stride}")
    ho, wo = _out_hw(h, w, stride)
    if h * w * c >= 2**31 or b > 65535:
        raise ValueError(f"x ({b}, {h}, {w}, {c}) is out of the depthwise kernel's range")
    vec = 16 if c % 16 == 0 else 4
    n_chunks = _cdiv(c, CHUNK)
    ch = _round_up(_cdiv(c, n_chunks), vec)
    run = min(RUN, wo)
    while ch // 4 * _cdiv(wo, run) > MAX_THREADS:
        run += 1
    gx = _cdiv(wo, run)
    tr = max(1, min(ho, THREADS // (ch // 4 * gx)))
    while b * _cdiv(ho, tr) * _cdiv(c, ch) < 2 * sms:
        if tr > 1:
            tr = _cdiv(tr, 2)
        elif ch > vec:
            ch = _round_up(ch // 2, vec)
        else:
            break
    tr = _cdiv(ho, _cdiv(ho, tr))  # the bands of one image even
    q = ch // 4
    hr, hc = (tr - 1) * stride + 3, (wo - 1) * stride + 3
    rp = hc * ch
    if q < 32 and 32 % q == 0:  # a warp spans 32 / q rows, stride*RP bytes apart
        for pad in range(0, 32 * vec, vec):
            if (stride * (rp + pad) // 4) % 32 == q:
                rp += pad
                break
    smem = hr * rp
    if smem > SMEM_MAX:
        raise ValueError(f"a depthwise band of {smem} bytes exceeds shared memory")
    return DwPlan(b, h, w, c, ho, wo, stride, ch, _cdiv(c, ch), tr, _cdiv(ho, tr), run, gx, hr, hc, ch, rp, vec,
                  q * tr * gx, smem)


class DwSm90Plan(NamedTuple):
    """One launch of the Hopper form (csrc/dwconv_sm90.cu's Plan): dw_plan's
    tiling with the band as TMA writes its box, dense (P = CH, RP = HC *
    CH); then the tiles the persistent CTAs walk, a band buffer's bytes
    (two of them) and the offsets of the map's table and the mbarriers."""

    B: int
    H: int
    W: int
    C: int
    Ho: int
    Wo: int
    stride: int
    CH: int
    n_chunks: int
    TR: int
    n_bands: int
    RUN: int
    GX: int
    HR: int
    HC: int
    P: int
    RP: int
    vec: int
    threads: int
    smem: int
    n_tiles: int
    band_bytes: int
    tab_off: int
    bar_off: int


_TABLE_BYTES = 1024 * 8  # csrc/act_codes.cuh TABLE_MAX entries of 8 bytes


@functools.lru_cache(maxsize=None)
def dw_sm90_plan(b: int, h: int, w: int, c: int, stride: int, sms: int) -> Optional[DwSm90Plan]:
    """The Hopper form's plan of a depthwise launch over x (b, h, w, c) int8
    on a card of `sms` SMs, or None where the form does not take it: C %
    16 (a TMA box's channels are 16-byte multiples), or a box or shared
    memory past its limits. The tiling is dw_plan's."""
    p = dw_plan(b, h, w, c, stride, sms)
    if c % 16 or p.CH % 16 or max(p.CH, p.HC, p.HR) > 256:
        return None
    rp = p.HC * p.CH
    band = _round_up(p.HR * rp, 128)
    tab_off = 2 * band
    bar_off = tab_off + _TABLE_BYTES
    smem = bar_off + 16 + 128  # and the base's alignment to 128 bytes
    if smem > SMEM_MAX:
        return None
    return DwSm90Plan(*p[:15], p.CH, rp, p.vec, p.threads, smem, p.B * p.n_bands * p.n_chunks, band, tab_off, bar_off)


_OLD_FORM = False  # set only by _old_form


@contextlib.contextmanager
def _old_form():
    """Every depthwise launch inside takes csrc/dwconv.cu. For the A/B
    timing of the forms (chip_smoke.py --stem-dw-ab) and the card tests;
    the main path never calls it."""
    global _OLD_FORM
    saved, _OLD_FORM = _OLD_FORM, True
    try:
        yield
    finally:
        _OLD_FORM = saved


def dw_conv_reference(x: torch.Tensor, op: DwWeights, stride: int, mode: str = "f32", act=None) -> torch.Tensor:
    """Plain depthwise conv: the 9 taps of the zero-padded x summed in
    int32 (exact), then the epilogue: int32, f32 acc * scale + bias rounded
    once, or with act (an ActMap) its codes, relu'd where act.relu."""
    b, h, w, c = x.shape
    ho, wo = _out_hw(h, w, stride)
    xp = torch.nn.functional.pad(x.to(torch.int32), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((b, ho, wo, c), dtype=torch.int32, device=x.device)
    wt = op.w.to(torch.int32)
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy : dy + stride * (ho - 1) + 1 : stride, dx : dx + stride * (wo - 1) + 1 : stride, :]
            acc += tap * wt[dy * 3 + dx]
    if mode == "int32" and act is None:
        return acc
    y = fma_f32(acc.to(torch.float32), op.scale, op.bias)
    if act is None:
        return y
    codes = act_codes(y, act.g, act.impl)
    return torch.clamp_min(codes, 0) if act.relu else codes


def _lib() -> ctypes.CDLL:
    lib = _build.load("dwconv")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dw_conv_launch.argtypes = [p, p, p, p, p, ctypes.POINTER(i), i, p, i, i, p]
        lib.dw_conv_launch.restype = i
        lib.dw_plan_ints.restype = i
        if lib.dw_plan_ints() != len(DwPlan._fields):
            raise RuntimeError("csrc/dwconv.cu's Plan does not match DwPlan")
        lib._argtypes_set = True
    return lib


def dw_conv(x: torch.Tensor, op: DwWeights, stride: int = 1, mode: str = "f32", act=None) -> torch.Tensor:
    """Depthwise 3x3 conv, pad 1, of NHWC int8 codes x (B, H, W, C) with a
    packed kernel: (B, Ho, Wo, C) int32 (mode 'int32'), f32 (mode 'f32'),
    or with act (an ActMap: 'poly', 'erf' or 'bins', relu optional) int8
    codes. csrc/dwconv.cu on a CUDA tensor, dw_conv_reference on a CPU
    tensor."""
    impl = mode if act is None else act.impl
    if impl not in _MODE:
        raise ValueError(f"unknown depthwise epilogue {impl!r}")
    if x.dtype != torch.int8 or op.w.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {x.dtype} and {op.w.dtype}")
    if x.ndim != 4 or x.shape[-1] != op.w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} does not fit a depthwise kernel of {op.w.shape[1]} channels")
    if stride not in (1, 2):
        raise ValueError(f"stride 1 or 2, got {stride}")
    if x.device.type == "cpu":
        return dw_conv_reference(x, op, stride, mode, act)
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("the depthwise kernel needs a 16-byte aligned input")
    tensors = [x, *op] + ([act.bnd] if act is not None and act.bnd is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("x, the packed kernel and the act map must lie on one device")
    b, h, w, c = x.shape
    plan = device_plan(x, stride)  # raises on a shape out of the kernel's range
    dtype = {"int32": torch.int32, "f32": torch.float32}.get(impl, torch.int8)
    out = torch.empty((b, plan.Ho, plan.Wo, c), dtype=dtype, device=x.device)
    if out.numel():
        _dw_launch(x, op, plan, impl, act, out)
        _build.launches[DW] += 1
        if isinstance(plan, DwSm90Plan):
            _build.launches[DW_SM90] += 1
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def device_plan(x: torch.Tensor, stride: int) -> Union[DwPlan, DwSm90Plan]:
    """The plan of a launch over x (a CUDA tensor) on its card, by the
    rule: the Hopper form (dw_sm90_plan) wherever it takes the shape (C %
    16 == 0: every MobileNet-V2 depthwise conv, faster at batches 256 and 8
    summed over a forward, PERF.md PR 15), else dwconv.cu's (dw_plan)."""
    sms = _sm_count(x.device.index)
    plan = None if _OLD_FORM else dw_sm90_plan(*x.shape, stride, sms)
    return dw_plan(*x.shape, stride, sms) if plan is None else plan


@functools.lru_cache(maxsize=None)
def _plan_ints(plan: DwPlan):
    return (ctypes.c_int * len(plan))(*plan)


def _sm90_lib() -> ctypes.CDLL:
    lib = _build.load("dwconv_sm90")
    if not getattr(lib, "_argtypes_set", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dw_sm90_launch.argtypes = [p, p, p, p, p, ctypes.POINTER(i), i, p, f, f, i, i, p, i, i, p]
        lib.dw_sm90_launch.restype = i
        lib.dw_sm90_plan_ints.restype = i
        if lib.dw_sm90_plan_ints() != len(DwSm90Plan._fields):
            raise RuntimeError("csrc/dwconv_sm90.cu's Plan does not match DwSm90Plan")
        lib._argtypes_set = True
    return lib


def _table_args(t: Optional[ActTable]) -> tuple:
    """The map's table as the C entry takes it: entries, lo, hi, b_lo, n."""
    if t is None:
        return None, 0.0, 0.0, 0, 0
    return t.entries.data_ptr(), t.lo, t.hi, t.b_lo, t.entries.shape[0]


def _dw_launch(x, op: DwWeights, plan: Union[DwPlan, DwSm90Plan], impl: str, act: Optional[object], out) -> None:
    """One launch of the form of plan on checked operands (DwPlan:
    csrc/dwconv.cu; DwSm90Plan: csrc/dwconv_sm90.cu, with the map's step
    table for erf and poly). Counts nothing (the wrapper does)."""
    bnd = None if act is None or act.bnd is None else act.bnd.data_ptr()
    g, relu = (0, 0) if act is None else (act.g, int(act.relu))
    if isinstance(plan, DwSm90Plan):
        table = act_table(impl, g, x.device, bool(relu)) if impl in ("erf", "poly") else None
        with _build.on_device(x.device):
            err = _sm90_lib().dw_sm90_launch(
                x.data_ptr(), op.w.data_ptr(), op.scale.data_ptr(), op.bias.data_ptr(), out.data_ptr(),
                _plan_ints(plan), _MODE[impl], *_table_args(table), bnd, g, relu,
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        _build.check(err, "dwconv_sm90.cu dw_sm90_kernel")
        return
    lib = _lib()
    with _build.on_device(x.device):
        err = lib.dw_conv_launch(
            x.data_ptr(), op.w.data_ptr(), op.scale.data_ptr(), op.bias.data_ptr(), out.data_ptr(),
            _plan_ints(plan), _MODE[impl], bnd, g, relu, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, "dwconv.cu dw_conv_kernel")
