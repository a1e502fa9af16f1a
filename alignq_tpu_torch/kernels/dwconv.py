"""Depthwise 3x3 int8 conv with a fused dequant or act-code epilogue: K1's
depthwise form.

The JAX serving graph of MobileNet-V2 runs its depthwise convs through
XLA's conv_general_dilated with feature_group_count = C
(alignq_tpu/kernels/infer_mobilenet.py:39-49); PyTorch has no int8 conv on
CUDA. On a CUDA tensor `dw_conv` launches csrc/dwconv.cu, a direct kernel
(one channel a group gives an MMA nothing to contract over); on a CPU
tensor it runs the plain version beside it, `dw_conv_reference`, which
sums the 9 taps in int32.

Its launches count under K1's family, DW = 'int8_matmul_dequant:dw', and
not in K1's own total.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from alignq_tpu_torch.kernels import _build
from alignq_tpu_torch.kernels.quantize import act_codes
from alignq_tpu_torch.quant.cdf import fma_f32

DW = "int8_matmul_dequant:dw"  # launch-counter key
_MODE = {"int32": 0, "f32": 1, "poly": 3, "erf": 4, "bins": 5}


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
        lib.dw_conv_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p, i, i, p]
        lib.dw_conv_launch.restype = i
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
    b, h, w, c = x.shape
    if c % 4:
        raise ValueError(f"the depthwise kernel takes channels in fours, got {c}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("the depthwise kernel needs a 16-byte aligned input")
    tensors = [x, *op] + ([act.bnd] if act is not None and act.bnd is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("x, the packed kernel and the act map must lie on one device")
    ho, wo = _out_hw(h, w, stride)
    dtype = {"int32": torch.int32, "f32": torch.float32}.get(impl, torch.int8)
    out = torch.empty((b, ho, wo, c), dtype=dtype, device=x.device)
    if out.numel():
        _dw_launch(x, op, stride, impl, act, out)
        _build.launches[DW] += 1
    return out


def _dw_launch(x, op: DwWeights, stride: int, impl: str, act: Optional[object], out) -> None:
    """One launch of csrc/dwconv.cu on checked operands. Counts nothing
    (the wrapper does)."""
    lib = _lib()
    b, h, w, c = x.shape
    bnd = None if act is None or act.bnd is None else act.bnd.data_ptr()
    with _build.on_device(x.device):
        err = lib.dw_conv_launch(
            x.data_ptr(), op.w.data_ptr(), op.scale.data_ptr(), op.bias.data_ptr(), out.data_ptr(),
            b, h, w, c, stride, _MODE[impl], bnd, 0 if act is None else act.g, int(act is not None and act.relu),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, "dwconv.cu dw_conv_kernel")
