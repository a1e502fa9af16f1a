"""CDF-alignment quantization to int8 (kernel K2), and the act-site code
maps that K1 runs in its epilogue.

Port of alignq_tpu/kernels/quantize.py. `cdf_quantize_int8` maps f32 of
any shape to int8 codes clip(round(erf(x/sqrt2) * 127), +-127), erf being
Abramowitz-Stegun 7.1.26 as the TPU kernel computes it. On a CUDA tensor it
launches csrc/quantize.cu; on a CPU tensor it runs the plain version,
`cdf_quantize_int8_plain`, which repeats the kernel's arithmetic. Both
follow the JAX kernel under jit: a multiply by the f32 reciprocal of sqrt2,
and every `a * b + c` rounded once (quant/cdf.py fma_f32), including
`1 - poly * exp(-z^2)`.

`act_codes` and `int_bin_codes` are the plain act-site maps of the serving
graph (kernels/infer.py): codes = clip(round(c(h) * g), +-g), c the erf,
poly or boundary-bin CDF, or integer compare chains on the int32
accumulator. The same maps run on the card in K1's codes epilogue
(csrc/act_codes.cuh, kernels/qmatmul.py int8_matmul_codes).

`bn_act_codes` is DenseNet's pre-activation site, bn -> act_q -> relu over
the live-channel prefix of a stage buffer, as one pass: the fused BN-act
code kernel of csrc/quantize.cu on a CUDA tensor, `bn_act_codes_plain` on
a CPU tensor. Over an int8 buffer a site's map takes 256 values a channel:
`bn_act_table` builds the site's codes of every value once, by
`bn_act_codes` itself, and `bn_act_codes_table` gathers from it (the
table kernel of csrc/quantize.cu on a CUDA tensor,
`bn_act_codes_table_plain` on a CPU tensor).
"""

from __future__ import annotations

import ctypes
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from alignq_tpu_torch.kernels import _build
from alignq_tpu_torch.quant.cdf import _INV_SQRT2, erf_f32, erf_grid_boundaries, erf_sqrt2, fma_f32

KERNEL = "cdf_quantize_int8"  # launch-counter key
BN_ACT = "bn_act_codes"  # launch-counter key of the BN-act kernels, both forms
BN_ACT_ARITH = BN_ACT + ":arith"  # ... of the arithmetic form (bn_act_codes)
BN_ACT_TABLE = BN_ACT + ":table"  # ... of the table form (bn_act_codes_table)
Q_MAX = 127.0
TABLE_CHANNELS = 128  # a code table's pitch is a multiple of this: csrc/quantize.cu's chunk, TB_CH
_BN_ACT_MODE = {"poly": 3, "erf": 4, "bins": 5}

# A&S 7.1.26, each constant rounded once to f32 as JAX casts a Python float
# (csrc/quantize.cu carries the same values as hex literals)
_AS_P = float(np.float32(0.3275911))
_AS_A = tuple(float(np.float32(a)) for a in (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429))


def _quantize(c: torch.Tensor, g: float) -> torch.Tensor:
    return torch.clamp(torch.round(c * g), -g, g).to(torch.int8)


def cdf_quantize_int8_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, value for value as the
    JAX kernel computes under jit."""
    z = x * _INV_SQRT2
    az = torch.abs(z)
    t = 1.0 / fma_f32(az, _AS_P, 1.0)
    poly = torch.full_like(t, _AS_A[-1])
    for a in _AS_A[-2::-1]:
        poly = fma_f32(poly, t, a)
    poly = poly * t
    y = fma_f32(-poly, torch.exp(-az * az), 1.0)
    return _quantize(torch.sign(z) * y, Q_MAX)


def cdf_quantize_int8_reference(x: torch.Tensor) -> torch.Tensor:
    """XLA's erf of x / sqrt2 (the JAX reference, which runs eagerly and so
    divides: no constant is there to fold into a reciprocal)."""
    return _quantize(erf_f32(x / np.float32(np.sqrt(2.0))), Q_MAX)


def _lib() -> ctypes.CDLL:
    lib = _build.load("quantize")
    if not getattr(lib, "_argtypes_set", False):
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.cdf_quant_launch.argtypes = [p, p, ctypes.c_longlong, p]
        lib.cdf_quant_launch.restype = i
        lib.bn_act_launch.argtypes = [p, i, p, p, p, ctypes.c_longlong, i, i, i, i, p, i, i, p]
        lib.bn_act_launch.restype = i
        lib.bn_table_launch.argtypes = [p, p, i, p, ctypes.c_longlong, i, i, i, p]
        lib.bn_table_launch.restype = i
        lib._argtypes_set = True
    return lib


def cdf_quantize_int8(x: torch.Tensor) -> torch.Tensor:
    """Fused Phi-transform + int8 rounding: f32 of any shape -> int8 of the
    same shape. K2 on a CUDA tensor, its plain version on a CPU tensor."""
    if x.dtype != torch.float32:
        raise TypeError(f"cdf_quantize_int8 takes float32, got {x.dtype}")
    if x.layout != torch.strided:
        raise ValueError(f"cdf_quantize_int8 takes a dense tensor, got layout {x.layout}")
    if x.device.type == "cpu":
        return cdf_quantize_int8_plain(x)
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("K2 needs a 16-byte aligned input")
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel():
        _k2_launch(x, out)
        _build.launches[KERNEL] += 1
    return out


def _k2_launch(x: torch.Tensor, out: torch.Tensor) -> None:
    """One launch of csrc/quantize.cu on x (f32, contiguous, 16-byte
    aligned) into out (int8, as many elements). Counts nothing (the
    wrapper does)."""
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cdf_quant_launch(x.data_ptr(), out.data_ptr(), x.numel(), stream)
    _build.check(err, "quantize.cu cdf_quant_kernel")


def act_codes(h: torch.Tensor, g: int, impl: str) -> torch.Tensor:
    """Act-site codes round(c(h) * g) in int8 storage. impl: 'erf' | 'poly'
    | 'bins' (g <= 15: compares against the exact erf-grid boundaries)."""
    if impl == "bins":
        if g > 15:
            raise ValueError("bins impl is for the A4/A2 grids (A8 g=127: use poly)")
        acc = torch.zeros(h.shape, dtype=torch.int8, device=h.device)
        for tk in erf_grid_boundaries(int(g)):
            tk = float(tk)
            acc = acc + (h >= tk).to(torch.int8) - (h <= -tk).to(torch.int8)
        return acc
    return _quantize(erf_sqrt2(h, impl), float(g))


def int_bin_codes(acc: torch.Tensor, sgn: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    """Act codes from the raw int32 accumulator (M, N) by integer compare
    chains against per-channel cutpoints: sgn (N,), t1 and t2 (g, N)."""
    a = acc * sgn  # fold negative BN scales into the comparand
    codes = torch.zeros(acc.shape, dtype=torch.int8, device=acc.device)
    for k in range(t1.shape[0]):
        codes = codes + (a >= t1[k]).to(torch.int8) - (a <= t2[k]).to(torch.int8)
    return codes


def bn_act_codes_plain(x: torch.Tensor, c_live: int, s: torch.Tensor, b: torch.Tensor, act,
                       c_out: int) -> torch.Tensor:
    """The BN-act code kernel's arithmetic in plain PyTorch: codes of
    fma(x, s, b) over the first c_live channels of x (..., ld), relu'd
    where act.relu, zero-padded to c_out channels."""
    h = fma_f32(x[..., :c_live].to(torch.float32), s, b)
    codes = act_codes(h, act.g, act.impl)
    if act.relu:
        codes = torch.clamp_min(codes, 0)
    return torch.nn.functional.pad(codes, (0, c_out - c_live))


def bn_act_codes(x: torch.Tensor, c_live: int, s: torch.Tensor, b: torch.Tensor, act,
                 c_out: Optional[int] = None) -> torch.Tensor:
    """A pre-activation site over a stage buffer x (..., ld), f32 values or
    int8 codes: int8 (..., c_out) codes max?(map(x[..., c] * s[c] + b[c]))
    for c < c_live (one rounding), zero for c_live <= c < c_out (default
    c_live). act: the site's map (kernels/qmatmul.py ActMap: impl 'poly',
    'erf' or 'bins', g, bnd, relu); s, b: (c_live,) f32. The fused BN-act
    code kernel of csrc/quantize.cu on a CUDA tensor, reading the prefix in
    place; bn_act_codes_plain on a CPU tensor."""
    c_out = c_live if c_out is None else c_out
    if x.dtype not in (torch.float32, torch.int8):
        raise TypeError(f"bn_act_codes takes an f32 or int8 buffer, got {x.dtype}")
    if act.impl not in _BN_ACT_MODE:
        raise ValueError(f"bn_act_codes maps poly, erf or bins, got {act.impl!r}")
    _check_prefix(x, c_live, c_out)
    if s.shape != (c_live,) or b.shape != (c_live,):
        raise ValueError(f"s and b must be ({c_live},), got {tuple(s.shape)} and {tuple(b.shape)}")
    if x.device.type == "cpu":
        return bn_act_codes_plain(x, c_live, s, b, act, c_out)
    x = x.contiguous()
    s, b = s.to(torch.float32).contiguous(), b.to(torch.float32).contiguous()
    if x.data_ptr() % 16:
        raise ValueError("the BN-act code kernel needs a 16-byte aligned buffer")
    if len({t.device for t in (x, s, b)}) != 1:
        raise ValueError("the buffer, s and b must lie on one device")
    out = torch.empty((*x.shape[:-1], c_out), dtype=torch.int8, device=x.device)
    if out.numel():
        _bn_act_launch(x, c_live, s, b, act, out)
        _build.launches[BN_ACT] += 1
        _build.launches[BN_ACT_ARITH] += 1
    return out


def _check_prefix(x: torch.Tensor, c_live: int, c_out: int) -> None:
    """The BN-act kernels' range: a live prefix of c_live <= min(ld, c_out)
    channels of x (..., ld), multiples of 4, under 2^30 rows."""
    ld = x.shape[-1]
    if not (0 < c_live <= min(ld, c_out)) or c_live % 4 or c_out % 4 or ld % 4:
        raise ValueError(f"c_live={c_live}, c_out={c_out}, pitch {ld}: multiples of 4 with c_live <= both")
    if x.numel() // ld >= 2**30:
        raise ValueError(f"{x.numel() // ld} rows: the BN-act kernels index rows with 32-bit ints")


def _bn_act_launch(x, c_live: int, s, b, act, out) -> None:
    """One launch of csrc/quantize.cu's bn_act_kernel on checked operands
    (x contiguous and 16-byte aligned, s and b (c_live,) f32, out int8
    (..., c_out)). Counts nothing (the wrapper does)."""
    lib = _lib()
    m_rows = x.numel() // x.shape[-1]
    with _build.on_device(x.device):
        err = lib.bn_act_launch(
            x.data_ptr(), int(x.dtype == torch.int8), s.data_ptr(), b.data_ptr(), out.data_ptr(), m_rows,
            x.shape[-1], c_live, out.shape[-1], _BN_ACT_MODE[act.impl],
            None if act.bnd is None else act.bnd.data_ptr(), act.g, int(act.relu),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, "quantize.cu bn_act_kernel")


class BnActTable(NamedTuple):
    """A pre-activation site's codes of every int8 input value: codes
    (256, c_pad) int8, codes[v & 255, c] the site's code of the value v in
    channel c < c_live (c_pad: c_live rounded up to TABLE_CHANNELS, the
    columns past c_live zero); and the (s, b, act) it was built from."""

    codes: torch.Tensor
    s: torch.Tensor
    b: torch.Tensor
    act: Any


def _table_pitch(c_live: int) -> int:
    return -(-c_live // TABLE_CHANNELS) * TABLE_CHANNELS


def bn_act_table(s: torch.Tensor, b: torch.Tensor, act) -> BnActTable:
    """The code table of a site (s, b (c_live,) f32, act its map) over an
    int8 buffer: bn_act_codes over a (256, c_pad) int8 tensor whose row r
    holds the value int8(r) in every channel, its first c_live channels
    live. So the table is bn_act_codes' own codes, on s's device (the
    arithmetic kernel on a card, the plain version on the CPU). Built once
    a site and map."""
    c_live = s.shape[0]
    c_pad = _table_pitch(c_live)
    values = torch.arange(256, device=s.device).to(torch.uint8).view(torch.int8)  # r -> int8(r)
    codes = bn_act_codes(values[:, None].expand(256, c_pad).contiguous(), c_live, s, b, act, c_pad)
    return BnActTable(codes, s, b, act)


def bn_act_codes_table_plain(x: torch.Tensor, c_live: int, table: BnActTable, c_out: int) -> torch.Tensor:
    """The table kernel in plain PyTorch: each live code gathered from the
    table by its byte and its channel, zero-padded to c_out channels."""
    idx = x[..., :c_live].to(torch.int64) & 255
    codes = table.codes[idx, torch.arange(c_live, device=x.device)]
    return torch.nn.functional.pad(codes, (0, c_out - c_live))


def bn_act_codes_table(x: torch.Tensor, c_live: int, table: BnActTable, c_out: Optional[int] = None) -> torch.Tensor:
    """A pre-activation site over an int8 stage buffer x (..., ld) through
    its code table (bn_act_table): int8 (..., c_out) codes, the same as
    bn_act_codes(x, c_live, table.s, table.b, table.act, c_out). The table
    kernel of csrc/quantize.cu on a CUDA tensor, reading the prefix in
    place; bn_act_codes_table_plain on a CPU tensor."""
    c_out = c_live if c_out is None else c_out
    if x.dtype != torch.int8 or table.codes.dtype != torch.int8:
        raise TypeError(f"the table form takes an int8 buffer and table, got {x.dtype} and {table.codes.dtype}")
    if table.s.shape != (c_live,) or table.codes.shape != (256, _table_pitch(c_live)):
        raise ValueError(f"a table of {c_live} channels, (256, {_table_pitch(c_live)}), expected; got one of "
                         f"{table.s.shape[0]}, {tuple(table.codes.shape)}")
    _check_prefix(x, c_live, c_out)
    if x.device.type == "cpu":
        return bn_act_codes_table_plain(x, c_live, table, c_out)
    x = x.contiguous()
    if x.data_ptr() % 16 or table.codes.data_ptr() % 16:
        raise ValueError("the BN-act table kernel needs a 16-byte aligned buffer and table")
    if x.device != table.codes.device:
        raise ValueError("the buffer and the table must lie on one device")
    out = torch.empty((*x.shape[:-1], c_out), dtype=torch.int8, device=x.device)
    if out.numel():
        _bn_table_launch(x, c_live, table, out)
        _build.launches[BN_ACT] += 1
        _build.launches[BN_ACT_TABLE] += 1
    return out


def _bn_table_launch(x, c_live: int, table: BnActTable, out) -> None:
    """One launch of csrc/quantize.cu's bn_table_kernel on checked operands
    (x int8 contiguous and 16-byte aligned, the table's codes (256, c_pad),
    out int8 (..., c_out)). Counts nothing (the wrapper does)."""
    lib = _lib()
    with _build.on_device(x.device):
        err = lib.bn_table_launch(
            x.data_ptr(), table.codes.data_ptr(), table.codes.shape[1], out.data_ptr(), x.numel() // x.shape[-1],
            x.shape[-1], c_live, out.shape[-1], torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, "quantize.cu bn_table_kernel")
