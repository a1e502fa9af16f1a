"""int8 x int8 -> int32 matmul with a fused dequant epilogue (kernel K1).

Port of alignq_tpu/kernels/qmatmul.py. On a CUDA tensor the wrappers
launch csrc/qmatmul.cu (an s8 tensor-core GEMM, `mma.sync` m16n8k32); on
a CPU tensor they run the plain PyTorch version beside them, which the
tests hold against the JAX reference. The port also routes every int8
conv outside the stage kernel through K1 (kernels/infer.py gathers the
taps into an (M, K) matrix), since PyTorch has no int8 conv on CUDA.

The weight side is laid out for the kernel by `pack_k1_weights`; a caller
that reuses a weight (the forward, given kernels/infer.py
pack_int8_operands) packs it once and calls `int8_matmul_packed`, or
`int8_matmul_codes` for an act site: K1's codes epilogue maps the
accumulators straight to int8 act codes (the fused form of K2,
csrc/act_codes.cuh), so the f32 (M, N) tensor is never stored.

Epilogue `acc * scale + bias` is one f32 rounding: `__fmaf_rn` in CUDA,
`fma_f32` (float64 evaluation, one cast) in the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from alignq_tpu_torch.kernels import _build
from alignq_tpu_torch.kernels.quantize import act_codes, int_bin_codes
from alignq_tpu_torch.quant.cdf import erf_grid_boundaries, fma_f32

K_MULT = 32  # depth of one m16n8k32 int8 MMA: K is zero-padded to it
N_MULT = 8  # width of one MMA n-tile
KERNEL = "int8_matmul_dequant"  # launch-counter key of every launch
# and of each family of epilogue modes: "int8_matmul_dequant:codes" etc.
_MODE = {"int32": 0, "f32": 1, "relu": 2, "poly": 3, "erf": 4, "bins": 5, "bins_int": 6}
_FAMILY = {"int32": "int32", "f32": "f32", "relu": "f32"}
CODES = KERNEL + ":codes"
F32 = KERNEL + ":f32"


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def gather_taps(
    x: torch.Tensor, ksize: int, stride: int = 1, padding: int = 0, k_mult: int = 1
) -> torch.Tensor:
    """The taps of a ksize x ksize conv over NHWC `x`, as the (B*Ho*Wo, K)
    matrix whose columns run (dy, dx, c) like an HWIO kernel reshaped to
    (ksize*ksize*C, Cout); K is zero-padded to a multiple of k_mult."""
    b, h, w, c = x.shape
    if padding:
        x = torch.nn.functional.pad(x, (0, 0, padding, padding, padding, padding))
    ho = (h + 2 * padding - ksize) // stride + 1
    wo = (w + 2 * padding - ksize) // stride + 1
    taps = [
        x[:, dy : dy + stride * (ho - 1) + 1 : stride, dx : dx + stride * (wo - 1) + 1 : stride, :]
        for dy in range(ksize)
        for dx in range(ksize)
    ]
    k = ksize * ksize * c
    if _round_up(k, k_mult) > k:
        taps.append(x.new_zeros((b, ho, wo, _round_up(k, k_mult) - k)))
    return torch.cat(taps, dim=-1).reshape(b * ho * wo, -1)


def kernel_matrix(kernel_hwio: torch.Tensor, k_mult: int = 1) -> torch.Tensor:
    """HWIO kernel as the (K, Cout) matrix matching gather_taps' columns."""
    kh, kw, cin, cout = kernel_hwio.shape
    k = kh * kw * cin
    mat = kernel_hwio.reshape(k, cout)
    return torch.nn.functional.pad(mat, (0, 0, 0, _round_up(k, k_mult) - k))


def int8_matmul_int32_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain (M, K) @ (K, N) -> int32. float64 is exact here: every
    product and partial sum is an integer below 2^53."""
    return (x.double() @ w.double()).to(torch.int32)


def int8_matmul_dequant_reference(x, w, scale, bias=None, relu=False):
    """Plain y = relu?((x @ w) * scale + bias), the epilogue rounded once."""
    acc = int8_matmul_int32_reference(x, w).float()
    y = fma_f32(acc, scale.reshape(1, -1), 0.0 if bias is None else bias.reshape(1, -1))
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y


def _lib() -> ctypes.CDLL:
    lib = _build.load("qmatmul")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qmm_launch.argtypes = [p, p, p, p, p, i, i, i, i, p, p, p, p, i, p]
        lib.qmm_launch.restype = i
        lib._argtypes_set = True
    return lib


class K1Weights(NamedTuple):
    """A (K, N) int8 weight and its epilogue, laid out once as K1 takes
    them: wt is W^T, (N8, K32) int8 zero-padded (the MMA's column-major B
    operand); scale and bias are (N8,) f32, zero-padded; n is the true N."""

    wt: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor
    n: int


def pack_k1_weights(w: torch.Tensor, scale=None, bias=None) -> K1Weights:
    """Lay out w (K, N) int8 and its (N,) f32 scale/bias (None: 0) for K1."""
    k, n = w.shape
    kp, np_ = _round_up(k, K_MULT), _round_up(n, N_MULT)
    wt = torch.nn.functional.pad(w.t(), (0, kp - k, 0, np_ - n)).contiguous()

    def vec(v):
        v = torch.zeros(n, device=w.device) if v is None else v.to(torch.float32)
        return torch.nn.functional.pad(v, (0, np_ - n)).contiguous()

    return K1Weights(wt, vec(scale), vec(bias), n)


class ActMap(NamedTuple):
    """An act site's code map as K1's codes epilogue takes it. impl: 'poly'
    | 'erf' | 'bins' | 'bins_int'; g: the grid's largest code. bins: bnd,
    the (g,) f32 erf-grid boundaries. bins_int: sgn (N8,) and t1, t2
    (g, N8) int32 per-column cutpoints (kernels/infer.py
    act_int_cutpoints), zero-padded to the packed weight's width. Fields a
    map does not use are None."""

    impl: str
    g: int
    bnd: Optional[torch.Tensor] = None
    sgn: Optional[torch.Tensor] = None
    t1: Optional[torch.Tensor] = None
    t2: Optional[torch.Tensor] = None


@functools.lru_cache(maxsize=None)
def act_map(impl: str, g: int, device: torch.device) -> ActMap:
    """The poly, erf or bins map of grid g on a device, laid out once per
    process (bins_int, which is per site, is pack_act_cutpoints')."""
    if impl not in ("poly", "erf", "bins"):
        raise ValueError(f"unknown act impl {impl!r}")
    if impl == "bins":
        if g > 15:
            raise ValueError("bins impl is for the A4/A2 grids (A8 g=127: use poly)")
        return ActMap(impl, g, bnd=torch.from_numpy(erf_grid_boundaries(g)).to(device))
    return ActMap(impl, g)


def pack_act_cutpoints(cut, n8: int) -> ActMap:
    """A site's bins_int cutpoints {'sgn': (N,), 't1', 't2': (g, N)} int32
    as an ActMap, zero-padded to n8 columns."""
    n = cut["sgn"].shape[0]

    def pad(t):
        return torch.nn.functional.pad(t.to(torch.int32), (0, n8 - n)).contiguous()

    return ActMap("bins_int", int(cut["t1"].shape[0]), sgn=pad(cut["sgn"]), t1=pad(cut["t1"]), t2=pad(cut["t2"]))


def _chain(x: torch.Tensor, op: K1Weights) -> torch.Tensor:
    """x (M, K) int8 checked against a packed weight, K zero-padded to its depth."""
    if x.dtype != torch.int8 or op.wt.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {x.dtype} and {op.wt.dtype}")
    kp = op.wt.shape[1]
    if x.ndim != 2 or x.shape[1] > kp:
        raise ValueError(f"x {tuple(x.shape)} does not chain with a packed weight of depth {kp}")
    if x.shape[1] != kp:
        x = torch.nn.functional.pad(x, (0, kp - x.shape[1]))
    return x


def _launch_k1(x, op: K1Weights, mode: str, dtype, act: Optional[ActMap] = None) -> torch.Tensor:
    """K1 on CUDA operands that _chain prepared, into a new (M, N) out."""
    tensors = [x, *op[:3]] + ([t for t in act[2:] if t is not None] if act is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("x, the packed weight and the act map must lie on one device")
    x = x.contiguous()
    if x.data_ptr() % 16 or op.wt.data_ptr() % 16:
        raise ValueError("K1 needs 16-byte aligned operands")
    np_ = op.wt.shape[0]
    out = torch.empty((x.shape[0], np_), device=x.device, dtype=dtype)
    if x.shape[0]:
        _qmm_launch(x, op.wt, op.scale, op.bias, out, mode, act)
        _build.launches[KERNEL] += 1
        _build.launches[f"{KERNEL}:{_FAMILY.get(mode, 'codes')}"] += 1
    return out if np_ == op.n else out[:, : op.n]


def int8_matmul_packed(x: torch.Tensor, op: K1Weights, mode: str = "f32") -> torch.Tensor:
    """x (M, K) int8 @ a packed weight: the raw int32 accumulator
    (mode 'int32') or the f32 epilogue (mode 'f32', or 'relu' with relu).
    K1 on a CUDA tensor, its plain version on a CPU tensor."""
    if mode not in _FAMILY:
        raise ValueError(f"unknown mode {mode!r}")
    x = _chain(x, op)
    if x.device.type == "cpu":
        w = op.wt[: op.n].t()
        if mode == "int32":
            return int8_matmul_int32_reference(x, w)
        return int8_matmul_dequant_reference(x, w, op.scale[: op.n], op.bias[: op.n], relu=mode == "relu")
    return _launch_k1(x, op, mode, torch.int32 if mode == "int32" else torch.float32)


def int8_matmul_codes_reference(x: torch.Tensor, op: K1Weights, act: ActMap) -> torch.Tensor:
    """Plain codes: act_codes of the f32 epilogue, or int_bin_codes of the
    int32 accumulator for bins_int."""
    x = _chain(x, op)
    n = op.n
    w = op.wt[:n].t()
    if act.impl == "bins_int":
        return int_bin_codes(int8_matmul_int32_reference(x, w), act.sgn[:n], act.t1[:, :n], act.t2[:, :n])
    return act_codes(int8_matmul_dequant_reference(x, w, op.scale[:n], op.bias[:n]), act.g, act.impl)


def int8_matmul_codes(x: torch.Tensor, op: K1Weights, act: ActMap) -> torch.Tensor:
    """The act codes (M, N) int8 of x (M, K) int8 @ a packed weight: K1's
    codes epilogue on a CUDA tensor, int8_matmul_codes_reference on a CPU
    tensor."""
    x = _chain(x, op)
    if x.device.type == "cpu":
        return int8_matmul_codes_reference(x, op, act)
    if act.impl == "bins_int" and act.sgn.shape[0] != op.wt.shape[0]:
        raise ValueError("the cutpoints are not padded to the packed weight's width")
    return _launch_k1(x, op, act.impl, torch.int8, act)


def _qmm_launch(x, wt, sp, bp, out, mode: str, act: Optional[ActMap] = None) -> None:
    """One launch of csrc/qmatmul.cu on operands _chain prepared: x (M, Kp)
    and wt (N, Kp) int8, scale/bias (N,) f32 (unread in modes 'int32' and
    'bins_int'), out (M, N); act, the map of a codes mode. Counts nothing
    (the wrapper does)."""
    lib = _lib()

    def ptr(t):
        return None if t is None else t.data_ptr()

    bnd, sgn, t1, t2 = (None,) * 4 if act is None else act[2:]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.qmm_launch(
            x.data_ptr(), wt.data_ptr(), sp.data_ptr(), bp.data_ptr(),
            out.data_ptr(), x.shape[0], wt.shape[0], x.shape[1], _MODE[mode],
            ptr(bnd), ptr(sgn), ptr(t1), ptr(t2), 0 if act is None else act.g, stream,
        )
    _build.check(err, "qmatmul.cu qmm_kernel")


def int8_matmul_dequant(
    x: torch.Tensor,  # (M, K) int8
    w: torch.Tensor,  # (K, N) int8
    scale: torch.Tensor,  # (N,) f32 combined act*weight dequant scale
    bias: torch.Tensor | None = None,  # (N,) f32 fused bias / BN shift
    relu: bool = False,
) -> torch.Tensor:
    """y[M, N] = relu?((x @ w) * scale + bias) in f32."""
    if x.device.type == "cpu":
        return int8_matmul_dequant_reference(x, w, scale, bias, relu)
    return int8_matmul_packed(x, pack_k1_weights(w, scale, bias), "relu" if relu else "f32")


def int8_matmul_int32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Raw int32 accumulator (M, N) of x @ w: K1 with no epilogue (the
    bins_int act sites compare it against integer cutpoints)."""
    if x.device.type == "cpu":
        return int8_matmul_int32_reference(x, w)
    return int8_matmul_packed(x, pack_k1_weights(w), "int32")
