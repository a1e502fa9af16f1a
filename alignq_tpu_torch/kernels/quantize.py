"""CDF-alignment quantization to int8 (kernel K2), and the act-site code
maps that K1 runs in its epilogue.

Port of alignq_tpu/kernels/quantize.py. `cdf_quantize_int8` maps f32 of
any shape to int8 codes clip(round(erf(x/sqrt2) * 127), +-127), erf being
Abramowitz-Stegun 7.1.26 as the TPU kernel computes it. On a CUDA tensor it
launches csrc/cdf_quant_sm90.cu (the map through its step table,
`k2_table(device)`, built on the card from the codes of csrc/quantize.cu's
direct kernel, which `_old_form` gives every launch for A/B runs); on a CPU tensor it runs the plain version,
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
`bn_act_codes` itself, and `bn_act_codes_table` gathers from it: on a CUDA
tensor csrc/bn_table_sm90.cu (persistent CTAs whose warps each walk their
own rows, every lane at work; `bn_table_plan`) where
`bn_table_takes` gives it the shape (sites of at most 64 code channels,
where it measured faster), else the table kernel of csrc/quantize.cu;
`bn_act_codes_table_plain` on a CPU tensor.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import weakref
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from alignq_tpu_torch.kernels import _build
from alignq_tpu_torch.quant.cdf import _INV_SQRT2, erf_f32, erf_grid_boundaries, erf_sqrt2, fma_f32

KERNEL = "cdf_quantize_int8"  # launch-counter key, both forms
KERNEL_SM90 = KERNEL + ":sm90"  # ... of its Hopper form (csrc/cdf_quant_sm90.cu)
BN_ACT = "bn_act_codes"  # launch-counter key of the BN-act kernels, both forms
BN_ACT_ARITH = BN_ACT + ":arith"  # ... of the arithmetic form (bn_act_codes)
BN_ACT_TABLE = BN_ACT + ":table"  # ... of the table form (bn_act_codes_table), both kernels
BN_ACT_TABLE_SM90 = BN_ACT_TABLE + ":sm90"  # ... of its Hopper kernel (csrc/bn_table_sm90.cu)
BN_ACT_TABLE_CHUNKED = BN_ACT_TABLE + ":chunked"  # ... of csrc/quantize.cu's bn_table_kernel
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
    same shape. K2 on a CUDA tensor (csrc/cdf_quant_sm90.cu where k2_takes
    gives it the size, counted under KERNEL and KERNEL_SM90; else, and under
    _old_form, csrc/quantize.cu's direct kernel, under KERNEL alone), its
    plain version on a CPU tensor. The kernels read 16-byte aligned f32: a
    tensor whose data does not start so (a view into its storage) is
    copied to a fresh buffer first, as a non-contiguous one is; such views
    are rare, and the copy keeps the kernels' loads and stores whole on a
    single path."""
    if x.dtype != torch.float32:
        raise TypeError(f"cdf_quantize_int8 takes float32, got {x.dtype}")
    if x.layout != torch.strided:
        raise ValueError(f"cdf_quantize_int8 takes a dense tensor, got layout {x.layout}")
    if x.device.type == "cpu":
        return cdf_quantize_int8_plain(x)
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel():
        if _k2_device_launch(x, out):
            _build.launches[KERNEL_SM90] += 1
        _build.launches[KERNEL] += 1
    return out


def _k2_device_launch(x: torch.Tensor, out: torch.Tensor) -> bool:
    """One launch of the form the entry point gives x (f32, contiguous,
    16-byte aligned, on a card) into out: the Hopper form where k2_takes
    (and not under _old_form), else the direct kernel. Returns whether it
    was the Hopper form; counts nothing (the wrapper does)."""
    if _OLD_K2_FORM or not k2_takes(x.numel()):
        _k2_launch(x, out)
        return False
    _k2_sm90_launch(x, out, device_k2_plan(x))
    return True


def _k2_launch(x: torch.Tensor, out: torch.Tensor) -> None:
    """One launch of csrc/quantize.cu's direct kernel on x (f32, contiguous,
    16-byte aligned) into out (int8, as many elements). Counts nothing (the
    wrapper does)."""
    lib = _lib()
    with _build.on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cdf_quant_launch(x.data_ptr(), out.data_ptr(), x.numel(), stream)
    _build.check(err, "quantize.cu cdf_quant_kernel")


# K2's Hopper form (csrc/cdf_quant_sm90.cu)
K2_THREADS = 256  # its CTA
K2_PER_THREAD = 16  # elements a thread a step: four 16-byte loads
K2_TILE = K2_THREADS * K2_PER_THREAD  # elements a CTA a step
K2_MIN_N = 1 << 19  # the rule: the Hopper form takes n >= this, the direct kernel the rest


def k2_takes(n: int) -> bool:
    """The rule: whether the Hopper form takes a launch of n elements. By
    chip_smoke.py --k2-ab (ABBA, cold L2) the direct kernel was faster at
    n of 32K-256K (0.1-0.4 us a launch, the act-site sizes of batches 8 and
    16: the Hopper form's table copy and larger code are a fixed cost
    there), the two tied at 512K, and the Hopper form was faster from 1M
    up."""
    return n >= K2_MIN_N


class K2Plan(NamedTuple):
    """One launch of csrc/cdf_quant_sm90.cu over n elements."""

    n: int
    tiles: int  # of K2_TILE elements, the last one ragged where n % K2_TILE
    ctas: int  # persistent CTAs: one wave, or one a tile where fewer
    steps: int  # tiles a CTA takes at most
    tail: int  # elements of the ragged last group of 16 (n % 16), masked in the last step


def k2_plan(n: int, sms: int, per_sm: int) -> K2Plan:
    """The plan of K2's Hopper form over n elements on a card of `sms` SMs
    that holds `per_sm` of its CTAs an SM (the occupancy calculator's):
    tiles of K2_TILE elements, dealt round-robin to one wave of persistent
    CTAs (fewer where there are fewer tiles)."""
    if n < 1 or sms < 1 or per_sm < 1:
        raise ValueError(f"K2's Hopper form takes n >= 1 on a card it fits, got n={n}, {sms} SMs, {per_sm} an SM")
    tiles = -(-n // K2_TILE)
    ctas = min(tiles, sms * per_sm)
    return K2Plan(n, tiles, ctas, -(-tiles // ctas), n % K2_PER_THREAD)


def _k2_where(device: torch.device) -> str:
    """The device whose map K2's table on `device` is built from: its own
    (the card's expf differs from the CPU's in its last bit)."""
    if device.type == "cpu":
        return "cpu"
    return f"cuda:{device.index if device.index is not None else torch.cuda.current_device()}"


@functools.lru_cache(maxsize=None)
def k2_table(device: torch.device) -> "ActTable":
    """The step table K2's Hopper form reads on `device`, built once a
    process and device from the device's own map (act_table_steps: on a
    card, launches of csrc/quantize.cu's direct kernel): an ActTable of K2's
    map ('as', grid 127, not relu'd) that holds every bucket of [-4, 4),
    the end codes (-127, 127) in those past [lo, hi], so that the kernel
    needs no select at lo and hi: the bucket's clamp to the table gives
    them."""
    g = int(Q_MAX)
    lo, hi, b_lo, entries = _act_table_arrays("as", g, False, _k2_where(device))
    end = np.int32([0, np.float32(np.nan).view(np.int32)])  # an entry with no step, its code -g (+ g: 0)
    below, above = np.tile(end, (b_lo, 1)), np.tile(end + [2 * g, 0], (ACT_TABLE_BUCKETS - b_lo - len(entries), 1))
    entries = np.concatenate([below, entries, above]).astype(np.int32)
    return ActTable("as", g, False, lo, hi, 0, torch.from_numpy(entries).to(device))


@functools.lru_cache(maxsize=None)
def _k2_per_sm(device_index: int) -> int:
    with _build.on_device(torch.device("cuda", device_index)):
        per_sm = _k2_lib().cdf_quant_sm90_per_sm()
    if per_sm < 1:
        raise RuntimeError(f"cdf_quant_sm90.cu: the occupancy query gave {per_sm}")
    return per_sm


def device_k2_plan(x: torch.Tensor) -> K2Plan:
    """The Hopper form's plan over x (a CUDA tensor) on its card."""
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    return k2_plan(x.numel(), _sms(dev), _k2_per_sm(dev))


def _k2_lib() -> ctypes.CDLL:
    lib = _build.load("cdf_quant_sm90")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cdf_quant_sm90_launch.argtypes = [p, p, ctypes.c_longlong, i, p, i, p]
        lib.cdf_quant_sm90_launch.restype = i
        lib.cdf_quant_sm90_per_sm.argtypes = []
        lib.cdf_quant_sm90_per_sm.restype = i
        lib._argtypes_set = True
    return lib


def _k2_sm90_launch(x: torch.Tensor, out: torch.Tensor, plan: K2Plan) -> None:
    """One launch of csrc/cdf_quant_sm90.cu on x (f32, contiguous, 16-byte
    aligned) into out (int8, as many elements) by its plan. Counts nothing
    (the wrapper does)."""
    t = k2_table(x.device)
    with _build.on_device(x.device):
        err = _k2_lib().cdf_quant_sm90_launch(
            x.data_ptr(), out.data_ptr(), plan.n, plan.ctas, t.entries.data_ptr(), t.entries.shape[0],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "cdf_quant_sm90.cu cdf_quant_sm90_kernel")


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
    bn_act_codes(x, c_live, table.s, table.b, table.act, c_out). On a CUDA
    tensor csrc/bn_table_sm90.cu where bn_table_takes gives it the shape
    (counted under BN_ACT_TABLE_SM90), else csrc/quantize.cu's table kernel
    (under BN_ACT_TABLE_CHUNKED), each reading the prefix in place;
    bn_act_codes_table_plain on a CPU tensor."""
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
        plan = device_table_plan(x, c_live, c_out)
        _bn_table_launch(x, c_live, table, out, plan)
        _build.launches[BN_ACT] += 1
        _build.launches[BN_ACT_TABLE] += 1
        _build.launches[BN_ACT_TABLE_CHUNKED if plan is None else BN_ACT_TABLE_SM90] += 1
    return out


def _bn_table_launch(x, c_live: int, table: BnActTable, out, plan: Optional["BnTablePlan"] = None) -> None:
    """One launch of the table form on checked operands (x int8 contiguous
    and 16-byte aligned, the table's codes (256, c_pad), out int8 (...,
    c_out)): csrc/bn_table_sm90.cu on its plan, or csrc/quantize.cu's
    bn_table_kernel where plan is None. Counts nothing (the wrapper does)."""
    with _build.on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan is None:
            err = _lib().bn_table_launch(
                x.data_ptr(), table.codes.data_ptr(), table.codes.shape[1], out.data_ptr(), x.numel() // x.shape[-1],
                x.shape[-1], c_live, out.shape[-1], stream)
            what = "quantize.cu bn_table_kernel"
        else:
            err = _sm90_lib().bn_table_sm90_launch(x.data_ptr(), bn_table_layout(table, plan).data_ptr(),
                                                   out.data_ptr(), _plan_ints(plan), stream)
            what = "bn_table_sm90.cu bn_table_sm90_kernel"
    _build.check(err, what)


# The Hopper form of the table pass (csrc/bn_table_sm90.cu)
BN_TABLE_THREADS = 512  # its CTA: 16 warps
BN_TABLE_WARPS = BN_TABLE_THREADS // 32
BN_TABLE_SMEM = 227 * 1024  # shared memory an SM gives its CTAs on an H100
BN_TABLE_PER_SM = 3  # CTAs an SM at most, where their tables fit
BN_TABLE_ITEMS = (8, 16)  # work items a warp loads at once: 8 where the CTAs fill the grid, else 16
BN_TABLE_MAX_C_OUT = 64  # the rule: the Hopper kernel takes the sites of at most this many code channels
BN_TABLE_REUSE = 1.0  # a CTA moves at least this many times its table's bytes of rows (so fewer CTAs on small buffers)


class BnTablePlan(NamedTuple):
    """One launch of csrc/bn_table_sm90.cu, in the order of its Plan."""

    M: int  # rows
    ld: int  # the buffer's pitch
    c_live: int
    c_out: int
    F: int  # full chunks of 32 quads a row: c_out // 128
    T: int  # tail quads past them
    RT: int  # rows a tail item: 32 // T (0 without a tail)
    P: int  # the table's pitch in shared memory, a multiple of 128
    R: int  # rows a warp's tile
    n_tiles: int
    ctas: int
    U: int  # work items a warp loads at once
    bar_off: int
    smem: int


def bn_table_plan(m_rows: int, ld: int, c_live: int, c_out: int, sms: int,
                  items: Optional[int] = None) -> BnTablePlan:
    """The plan of the table pass's Hopper kernel over m_rows rows of pitch
    ld, c_live live channels, codes at pitch c_out, on a card of `sms` SMs:
    tiles of the rows whose work items fill one batch of `items` a warp;
    as many CTAs an SM as BN_TABLE_PER_SM whose tables fit, or fewer where
    a CTA would move less than BN_TABLE_REUSE times its table's bytes.
    items (8 or 16) defaults to 8 where the CTAs fill the grid and 16
    where they do not (chip_smoke.py --bn-digit-ab at DenseNet-40's
    narrow sites: 8 faster at batch 256, 16 at batch 8); A/B runs set it.
    Raises ValueError, naming the shape, for one it does not take: c_live,
    c_out or ld off the kernel's alignment of 4, or a table past a CTA's
    shared memory."""
    shape = f"{m_rows} rows of pitch {ld}, {c_live} live channels to {c_out}"
    if not (0 < c_live <= min(ld, c_out)) or c_live % 4 or c_out % 4 or ld % 4 or not 0 < m_rows < 2**30:
        raise ValueError(f"the table pass's Hopper kernel does not take {shape}: c_live, c_out and ld must be "
                         f"multiples of 4, c_live <= c_out, ld")
    if items is not None and items not in BN_TABLE_ITEMS:
        raise ValueError(f"{items} items a warp: one of {BN_TABLE_ITEMS}")
    f, t = divmod(c_out // 4, 32)
    rt = 32 // t if t else 0
    p = 128 * -(-(32 * f + rt * t) // 32)
    tab = 256 * p
    per_sm = min((BN_TABLE_SMEM - 1024) // (tab + 8 + 1024), BN_TABLE_PER_SM)  # each CTA's table, barrier, reserve
    if per_sm < 1:
        raise ValueError(f"the table pass's Hopper kernel does not take {shape}: a {tab}-byte table")
    ctas = max(1, min(per_sm * sms, math.ceil(m_rows * (c_live + c_out) / (BN_TABLE_REUSE * tab))))
    if items is None:
        items = BN_TABLE_ITEMS[0] if ctas == per_sm * sms else BN_TABLE_ITEMS[1]
    r = 1  # the most rows whose items fit one batch: R F full items and ceil(R / RT) tail ones
    while (r + 1) * f + (-(-(r + 1) // rt) if t else 0) <= items:
        r += 1
    r = max(1, min(r, math.ceil(m_rows / (ctas * BN_TABLE_WARPS))))
    n_tiles = -(-m_rows // r)
    return BnTablePlan(m_rows, ld, c_live, c_out, f, t, rt, p, r, n_tiles, min(ctas, n_tiles), items, tab, tab + 8)


def bn_table_takes(m_rows: int, ld: int, c_live: int, c_out: int, sms: int) -> bool:
    """The rule: whether the Hopper kernel takes a launch, that is one of
    at most BN_TABLE_MAX_C_OUT code channels that bn_table_plan plans. At
    DenseNet-40's sites (chip_smoke.py --bn-digit-ab, per launch, ABBA)
    the kernel beat bn_table_kernel at c_out 32-64 (block 1's first four)
    at batch 256 and tied it at batch 8, and lost at c_out 80-128, 176 and
    every block-2 and block-3 site at both; bn_table_kernel keeps those.
    Its two wins past 128 channels (c_out 144, batch 256 only) are left to
    bn_table_kernel too: it lost there at batch 8."""
    if c_out > BN_TABLE_MAX_C_OUT:
        return False
    try:
        bn_table_plan(m_rows, ld, c_live, c_out, sms)
    except ValueError:
        return False
    return True


_OLD_TABLE_FORM = False  # set only by _old_form
_OLD_K2_FORM = False  # set only by _old_form


@contextlib.contextmanager
def _old_form():
    """Every table pass inside runs csrc/quantize.cu's bn_table_kernel, and
    every K2 launch its direct kernel. For A/B runs and the card's
    comparisons (chip_smoke.py --bn-digit-ab, --k2-ab); the main path never
    calls it."""
    global _OLD_TABLE_FORM, _OLD_K2_FORM
    saved, _OLD_TABLE_FORM, _OLD_K2_FORM = (_OLD_TABLE_FORM, _OLD_K2_FORM), True, True
    try:
        yield
    finally:
        _OLD_TABLE_FORM, _OLD_K2_FORM = saved


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _cached_plan(m_rows: int, ld: int, c_live: int, c_out: int, sms: int) -> Optional[BnTablePlan]:
    return bn_table_plan(m_rows, ld, c_live, c_out, sms) if bn_table_takes(m_rows, ld, c_live, c_out, sms) else None


def device_table_plan(x: torch.Tensor, c_live: int, c_out: int) -> Optional[BnTablePlan]:
    """The Hopper kernel's plan of a table pass over x (a CUDA tensor) on
    its card, or None where the kernel does not take it (or under
    _old_form): csrc/quantize.cu's bn_table_kernel runs it then."""
    if _OLD_TABLE_FORM:
        return None
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    return _cached_plan(x.numel() // x.shape[-1], x.shape[-1], c_live, c_out, _sms(dev))


def bn_table_positions(plan: BnTablePlan) -> np.ndarray:
    """The channel quad each 4-byte column of the table's shared-memory
    layout holds (-1: none): quads 0 .. 32F - 1 as they are, then RT
    replicas of the T tail quads, replica r at column 32F + r T."""
    pos = np.arange(plan.P // 4)
    full = 32 * plan.F
    tail = full + (pos - full) % plan.T if plan.T else pos
    return np.where(pos < full, pos, np.where(pos < full + plan.RT * plan.T, tail, -1))


# (id(codes), P, F, T, RT) -> [a weak reference to codes, the laid-out table]: an entry goes with its table
_LAYOUTS: dict = {}


def bn_table_layout(table: BnActTable, plan: BnTablePlan) -> torch.Tensor:
    """A site's table as csrc/bn_table_sm90.cu copies it into shared
    memory: (256, P) int8, column 4i + j the table's channel 4
    bn_table_positions(plan)[i] + j (zero where none), made once per table
    and layout and kept while the table lives."""
    codes = table.codes
    key = (id(codes), plan.P, plan.F, plan.T, plan.RT)
    hit = _LAYOUTS.get(key)
    if hit is None or hit[0]() is not codes:
        cols = 4 * bn_table_positions(plan)[:, None] + np.arange(4)
        cols = np.where((cols >= 0) & (cols < codes.shape[1]), cols, codes.shape[1]).reshape(-1)  # past the table: 0
        padded = torch.cat([codes, codes.new_zeros(256, 1)], 1)
        laid = padded[:, torch.from_numpy(cols).to(codes.device)].contiguous()
        hit = [weakref.ref(codes, lambda _, k=key: _LAYOUTS.pop(k, None)), laid]
        _LAYOUTS[key] = hit
    return hit[1]


def _sm90_lib() -> ctypes.CDLL:
    lib = _build.load("bn_table_sm90")
    if not getattr(lib, "_argtypes_set", False):
        p = ctypes.c_void_p
        lib.bn_table_sm90_launch.argtypes = [p, p, p, ctypes.POINTER(ctypes.c_int), p]
        lib.bn_table_sm90_launch.restype = ctypes.c_int
        lib.bn_table_sm90_plan_ints.restype = ctypes.c_int
        if lib.bn_table_sm90_plan_ints() != len(BnTablePlan._fields):
            raise RuntimeError("csrc/bn_table_sm90.cu's Plan does not match BnTablePlan")
        lib._argtypes_set = True
    return lib


@functools.lru_cache(maxsize=None)
def _plan_ints(plan):
    return (ctypes.c_int * len(plan))(*plan)


# The table form of the erf and poly code maps and of K2's ("as") map
# (csrc/act_codes.cuh table_code): h's bucket floor(fl(h * ACT_TABLE_INV_W +
# ACT_TABLE_OFF)), one f32 rounding, holds at most one step of the code,
# since the widest grid's steps are >= 0.0098 apart (the erf and A&S maps at
# g = 127) and a bucket is 1/128 wide.
ACT_TABLE_BUCKETS = 1024  # the buckets of h in [-4, 4): every step of both maps lies within |h| < 3
ACT_TABLE_INV_W = 128.0
ACT_TABLE_OFF = 512.0
ACT_TABLE_SCAN = 4096  # ulps each side of a step searched for the map's non-monotone window


class ActTable(NamedTuple):
    """The erf or poly code map of grid g, or K2's ('as', g 127) (relu'd:
    max(code, 0)) as a table of its steps. Below lo the code is the least (0 relu'd, else -g), above
    hi it is g; h in [lo, hi] lies in one of the buckets b_lo .. b_lo + n -
    1, and entry i = (base + g | w << 16, t) of bucket b_lo + i gives the
    code base + (h >= t) (t an f32 bit pattern, NaN where the bucket has no
    step), except within w - 1 ulps above t (w = 0: nowhere), where the
    f32 map is not monotone (a window of a few ulps at some steps) and the
    code is the map's own. A window that runs on into the next bucket is
    that bucket's too (its t the step's, its base one less). K2's table
    (k2_table) holds every bucket, b_lo 0."""

    impl: str
    g: int
    relu: bool
    lo: float
    hi: float
    b_lo: int
    entries: torch.Tensor  # (n, 2) int32


def _f32_key(h: np.ndarray) -> np.ndarray:
    """f32 -> int64 in the f32 order (-0.0 just below +0.0)."""
    b = np.ascontiguousarray(h, np.float32).view(np.int32).astype(np.int64)
    return np.where(b >= 0, b, -(b & 0x7FFFFFFF) - 1)


def _f32_of_key(k) -> np.ndarray:
    k = np.asarray(k, np.int64)
    return np.where(k >= 0, k, (-(k + 1)) | -0x80000000).astype(np.int32).view(np.float32)


def act_table_bucket(h: np.ndarray) -> np.ndarray:
    """The bucket of each f32 h, as the device computes it: h * 128 + 512
    is exact in float64, so its cast is the one rounding of __fmaf_rn."""
    with np.errstate(over="ignore", invalid="ignore"):  # beyond f32's range: the end buckets
        u = (np.asarray(h, np.float32).astype(np.float64) * ACT_TABLE_INV_W + ACT_TABLE_OFF).astype(np.float32)
    return np.clip(np.floor(np.nan_to_num(u, nan=0.0)), 0, ACT_TABLE_BUCKETS - 1).astype(np.int64)


def _map_codes(h: np.ndarray, impl: str, g: int, where: str = "cpu") -> np.ndarray:
    """The map's codes of the f32 h, as the device `where` computes them:
    K2's on a card by csrc/quantize.cu's direct kernel (its expf is the
    card's), every other map by its plain version (their f32 operations
    round alike everywhere)."""
    x = torch.from_numpy(np.ascontiguousarray(h, np.float32))
    if impl != "as":
        return act_codes(x, g, impl).numpy().astype(np.int64)
    if where == "cpu":
        return cdf_quantize_int8_plain(x).numpy().astype(np.int64)
    x = x.to(where)
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel():
        _k2_launch(x, out)
    return out.cpu().numpy().astype(np.int64)


@functools.lru_cache(maxsize=None)
def act_table_steps(impl: str, g: int, where: str = "cpu"):
    """(wa, wz) f32 arrays over the steps k = -g + 1 .. g of the map, as the
    device `where` computes it (_map_codes): wa the first h whose code
    reaches k, wz the last one still below it (wz < wa where the step is
    monotone; else [wa, wz] is its window). Each step found by bisection
    over the f32 order, its window by a scan of ACT_TABLE_SCAN ulps each
    side (on a card, some 32 launches of a few hundred values and one of
    2M)."""
    if impl not in ("erf", "poly", "as"):
        raise ValueError(f"the table form maps erf or poly, or K2's map 'as', got {impl!r}")
    if impl == "as" and g != int(Q_MAX):
        raise ValueError(f"K2's map has grid {int(Q_MAX)}, got {g}")
    ks = np.arange(-g + 1, g + 1)
    lo = np.full(ks.shape, _f32_key(np.float32([-8.0]))[0])
    hi = np.full(ks.shape, _f32_key(np.float32([8.0]))[0])
    ends = _map_codes(_f32_of_key(np.stack([lo[0], hi[0]])), impl, g, where)
    if ends[0] != -g or ends[1] != g:
        raise ValueError(f"the {impl} map of grid {g} does not span +-{g} on [-8, 8]")
    while (hi - lo > 1).any():
        mid = (lo + hi) // 2
        ge = _map_codes(_f32_of_key(mid), impl, g, where) >= ks
        hi, lo = np.where(ge, mid, hi), np.where(ge, lo, mid)
    span = np.arange(-ACT_TABLE_SCAN, ACT_TABLE_SCAN + 1)
    keys = hi[:, None] + span[None, :]
    codes = _map_codes(_f32_of_key(keys.ravel()), impl, g, where).reshape(keys.shape)
    if ((codes != ks[:, None]) & (codes != ks[:, None] - 1)).any():
        raise ValueError(f"the {impl} map of grid {g} has steps closer than {ACT_TABLE_SCAN} ulps")
    reached = codes >= ks[:, None]
    first = reached.argmax(1)
    last = reached.shape[1] - 1 - (~reached)[:, ::-1].argmax(1)
    if (first == 0).any() or (last == reached.shape[1] - 1).any():
        raise ValueError(f"a window of the {impl} map of grid {g} reaches past {ACT_TABLE_SCAN} ulps")
    return _f32_of_key(hi + span[first]), _f32_of_key(hi + span[last])


@functools.lru_cache(maxsize=None)
def _act_table_arrays(impl: str, g: int, relu: bool, where: str = "cpu"):
    wa, wz = act_table_steps(impl, g, where)
    k0 = 1 if relu else -g + 1  # the first step the table holds
    wa, wz = wa[k0 + g - 1:], wz[k0 + g - 1:]
    lo, hi = wa[0], max(wz[-1], _f32_of_key(_f32_key(wa[-1:]) - 1)[0])  # hi: the last h below g
    steps = act_table_bucket(wa)
    b_lo, b_hi = int(act_table_bucket(lo[None])[0]), int(act_table_bucket(hi[None])[0])
    if len(np.unique(steps)) != len(steps):
        raise ValueError(f"two steps of the {impl} map of grid {g} share a bucket")
    buckets = np.arange(b_lo, b_hi + 1)
    base = (k0 - 1) + np.searchsorted(steps, buckets, side="left")  # the code below the bucket's own step
    t = np.full(len(buckets), np.nan, np.float32)  # no h reaches a NaN
    t[steps - b_lo] = wa
    w = np.zeros(len(buckets), np.int64)
    for a, z in zip(wa[wz >= wa], wz[wz >= wa]):  # irregular steps: every bucket the window touches
        if (a < 0) != (z < 0):
            raise ValueError(f"a window of the {impl} map of grid {g} spans 0")
        ulps = int(_f32_key(z[None])[0] - _f32_key(a[None])[0])
        first, last = int(act_table_bucket(a[None])[0]), int(act_table_bucket(z[None])[0])
        w[first - b_lo] = ulps + 1
        for b in range(first + 1, last + 1):  # the window's tail: the step's t, the code below it
            if not np.isnan(t[b - b_lo]):
                raise ValueError(f"a window of the {impl} map of grid {g} runs into another step's bucket")
            t[b - b_lo], base[b - b_lo], w[b - b_lo] = a, base[b - b_lo] - 1, ulps + 1
    entries = np.stack([(base + g) | (w << 16), t.view(np.int32).astype(np.int64)], 1).astype(np.int32)
    return float(lo), float(hi), b_lo, entries


@functools.lru_cache(maxsize=None)
def act_table(impl: str, g: int, device: torch.device, relu: bool = True) -> ActTable:
    """The table of the erf or poly map of grid g (relu'd or not) on a
    device, built once a process from the plain map (act_codes,
    act_table_steps). K2's map has its own, k2_table."""
    lo, hi, b_lo, entries = _act_table_arrays(impl, int(g), bool(relu))
    return ActTable(impl, int(g), bool(relu), lo, hi, b_lo, torch.from_numpy(entries.copy()).to(device))


def act_table_window(h: np.ndarray, table: ActTable) -> np.ndarray:
    """Whether each f32 h (in [lo, hi]) lies in its bucket's window: within
    w - 1 ulps above the entry's t, counted on t's side of 0."""
    e = table.entries.cpu().numpy()
    i = np.clip(act_table_bucket(h) - table.b_lo, 0, len(e) - 1)
    hb = np.asarray(h, np.float32).view(np.int32).astype(np.int64)
    tb = e[i, 1].astype(np.int64)
    d = np.where(e[i, 1].view(np.float32) >= 0, hb - tb, tb - hb)
    return (d >= 0) & (d < (e[i, 0] >> 16))


def act_codes_table_plain(h: torch.Tensor, table: ActTable) -> torch.Tensor:
    """The table map in plain PyTorch: the least code below lo, g above
    hi, else the bucket's base and step, and the map itself (on the CPU) in
    a window (csrc/act_codes.cuh table_code, which looks up a clamped
    bucket for every h and selects); K2's map gives NaN the code 0, as its
    kernels select."""
    e = table.entries.cpu().numpy()
    hn = h.detach().cpu().numpy().astype(np.float32)
    with np.errstate(invalid="ignore"):
        mid = (hn >= table.lo) & (hn <= table.hi)
        codes = np.where(hn > table.hi, table.g, 0 if table.relu else -table.g).astype(np.int64)
        hm = hn[mid]
        i = act_table_bucket(hm) - table.b_lo
        cm = (e[i, 0] & 0xFFFF) - table.g + (hm >= e[i, 1].view(np.float32))
        window = act_table_window(hm, table)
    if window.any():
        direct = _map_codes(hm[window], table.impl, table.g)
        cm[window] = np.maximum(direct, 0) if table.relu else direct
    codes[mid] = cm
    if table.impl == "as":
        codes[np.isnan(hn)] = 0
    return torch.from_numpy(codes.astype(np.int8)).to(h.device)


def k2_codes_table_plain(x: torch.Tensor, table: ActTable) -> torch.Tensor:
    """K2's Hopper form in plain PyTorch, as csrc/cdf_quant_sm90.cu looks
    its table up (k2_table, every bucket): x's bucket clamped to the
    table's; the entry's base + (x >= t), the map's own code (on the CPU)
    in a window; 0 for NaN."""
    if table.impl != "as" or table.b_lo or len(table.entries) != ACT_TABLE_BUCKETS:
        raise ValueError("k2_codes_table_plain reads K2's table (k2_table)")
    e = table.entries.cpu().numpy()
    xn = x.detach().cpu().numpy().astype(np.float32)
    i = act_table_bucket(xn)
    with np.errstate(invalid="ignore"):
        codes = (e[i, 0] & 0xFFFF).astype(np.int64) - table.g + (xn >= e[i, 1].view(np.float32))
    window = act_table_window(xn, table)
    if window.any():
        codes[window] = _map_codes(xn[window], "as", table.g)
    codes[np.isnan(xn)] = 0
    return torch.from_numpy(codes.astype(np.int8)).to(x.device)
