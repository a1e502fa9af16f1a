"""Gaussian CDF alignment transform (port of alignq_tpu/quant/cdf.py).

Rounding rule of the port: every `a * b + c` of an f32 epilogue is ONE
rounding, as the JAX package's jitted graph evaluates it (XLA contracts
`a * b + c` into a fused multiply-add). CUDA code uses `__fmaf_rn`; the
plain PyTorch code evaluates in float64 and casts once to float32,
rounding the sum to odd first where the cast would round twice
(`fma_f32`): the correctly rounded f32 FMA.

Likewise XLA turns a division by a compile-time constant into a multiply
by its reciprocal, so `z / sqrt2` is evaluated here as `z * (1/sqrt2)`.

The QAT path calls the same functions under autograd, at f32 or f64. At
f64 every function computes in f64 (as the JAX package's layers do under
x64): torch.erf, the poly grid's float64 coefficients, plain `a * b + c`.
erf's gradient is the analytic 2/sqrt(pi) * exp(-z^2), as JAX
differentiates lax.erf, not the derivative of the f32 approximation.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from alignq_tpu_torch.dist import collectives as C

_SQRT2 = math.sqrt(2.0)
_INV_SQRT2 = 1.0 / _SQRT2
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_TWO_OVER_SQRT_PI = 2.0 / math.sqrt(math.pi)

# torch.exp of a CPU tensor runs MKL's VML vsExp/vdExp on chunks of 2048
# elements, one OpenMP thread each. When VML's first call in a process
# comes from several threads at once, on a loaded host one chunk can come
# out ~1e-4 relative off (seen in gaussian_pdf2, tests/test_torch_convert.py;
# later calls are exact). One call on a single element runs on this thread
# alone and does that first call here, for both types the port uses.
for _dtype in (torch.float32, torch.float64):
    torch.exp(torch.zeros(1, dtype=_dtype))
del _dtype

# Degree-15 odd minimax-fit polynomial for erf(z/sqrt2) on |z| <= 3 (Horner
# in z^2); the same coefficients as the JAX package's ERF_SQRT2_POLY. The
# CUDA stage kernel carries their f32 roundings as hex literals
# (csrc/stage_kernel.cu, checked by tests/test_torch_stage_kernel.py).
ERF_SQRT2_POLY = (
    0.7978767035812473,
    -0.132937421134101,
    0.01987666573612765,
    -0.00232242597697477,
    2.0980537887739438e-4,
    -1.3852070586107547e-5,
    5.848221808977707e-7,
    -1.157208553963603e-8,
)
# each coefficient rounded to f32 once, as JAX casts a Python float constant
_POLY_F32 = tuple(float(np.float32(c)) for c in ERF_SQRT2_POLY)


# The f32 erf the JAX package computes: XLA's rational approximation,
# erf(x) = x * P(x^2) / Q(x^2) on x clamped to +-3.7439211, Horner steps
# rounded once. torch.erf is another approximation and differs from it by
# an ulp or two on more than half of all inputs, which flips act codes at
# rounding ties; this one is bit-identical to jax.lax.erf (tests/test_torch_convert.py).
_ERF_CLAMP = float(np.float32(3.7439211))
_ERF_P = tuple(float(np.float32(c)) for c in (
    0.00022905065861350646, 0.0034082910107109506, 0.050955695062380861,
    0.18520832239976145, 1.128379143519084,
))
_ERF_Q = tuple(float(np.float32(c)) for c in (
    -1.1791602954361697e-7, 0.000023547966471313185, 0.0010179625278914885,
    0.014070470171167667, 0.11098505178285362, 0.49746925110067538, 1.0,
))


def _horner_cast(u64: torch.Tensor, coefs):
    """The f32 Horner chain acc = acc * u + c over coefs (f32 constants),
    each step a float64 evaluation cast to f32, and the mask of elements
    where some cast might have rounded twice (there fma_f32's chain must
    be taken instead). No synchronisation. Only midpoints are checked:
    over u in [0, 3.75^2] erf's chains stay above 2e-5 in magnitude, far
    from f32's subnormals (the first Q step is the least: -1.18e-7 u +
    2.35e-5)."""
    acc = torch.full(u64.shape, coefs[0], dtype=torch.float32, device=u64.device)
    flag = torch.zeros(u64.shape, dtype=torch.bool, device=u64.device)
    for c in coefs[1:]:
        s = acc.double() * u64 + c
        acc = s.float()
        flag.logical_or_(torch.bitwise_and(s.view(torch.int64), _LOW29) == _HALF29)
    return acc, flag


def _horner_fma(u: torch.Tensor, coefs) -> torch.Tensor:
    """The same chain, each step fma_f32."""
    acc = torch.full(u.shape, coefs[0], dtype=torch.float32, device=u.device)
    for c in coefs[1:]:
        acc = fma_f32(acc, u, c)
    return acc


@torch.no_grad()
def erf_f32(x: torch.Tensor) -> torch.Tensor:
    """erf on f32 tensors, evaluated as the JAX package's XLA graph does
    (values only: differentiate through `erf`). Each Horner step rounds
    once, as fma_f32's; its checks are made once for both chains, and the
    few elements they flag are evaluated again step by step by fma_f32."""
    xc = torch.clamp(x, -_ERF_CLAMP, _ERF_CLAMP)
    x2 = xc * xc
    x64 = x2.double()  # an f32 value in float64
    p, flag_p = _horner_cast(x64, _ERF_P)
    q, flag_q = _horner_cast(x64, _ERF_Q)
    if x.device.type != "meta" and bool(flag_p.logical_or_(flag_q).any()):
        at = flag_p.nonzero(as_tuple=True)
        p[at], q[at] = _horner_fma(x64[at], _ERF_P), _horner_fma(x64[at], _ERF_Q)
    return xc * p / q


def _f64(v):
    return v.double() if torch.is_tensor(v) else v


_LOW29 = (1 << 29) - 1  # the float64 mantissa bits below an f32's 24
_HALF29 = 1 << 28  # those bits at an f32 rounding midpoint
_F32_MIN_BITS = 0x00800000  # the bits of f32's smallest normal, 2^-126


def _double_rounding_candidates(s: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Where the f32 cast r of a float64 sum s might round the exact sum
    otherwise (fma_f32): s an f32 rounding midpoint, or r nonzero
    subnormal or 2^-126. A bool mask, no host synchronisation."""
    mid = torch.bitwise_and(s.view(torch.int64), _LOW29) == _HALF29
    # |r|'s bits less one, as unsigned, below those of f32's smallest normal
    low = torch.bitwise_and(r.view(torch.int32), 0x7FFFFFFF).sub_(1).bitwise_and_(0x7FFFFFFF)
    return mid.logical_or_(low < _F32_MIN_BITS)


def _at(v, shape, at):
    """The elements of v, broadcast to `shape`, at the coordinates `at`."""
    return v.detach().expand(shape)[at] if torch.is_tensor(v) else v


def fma_f32(a, b, c) -> torch.Tensor:
    """f32 `a * b + c` of f32 operands, rounded once, as `__fmaf_rn` and
    XLA's contracted multiply-add round it.

    The float64 product of two f32 values is exact; the float64 sum s of
    it and c is not, and its cast r to f32 rounds the exact result
    otherwise only where s is an f32 rounding midpoint (the 29 mantissa
    bits below f32's 24 read 1 then zeros) or r is subnormal or 2^-126 (a
    zero r is right: a nonzero exact sum below 2^-149 in magnitude is
    exact in float64, since its terms' lowest bits lie above 2^-198). At those few
    elements the add's error comes from TwoSum and s is rounded to odd
    (moved one float64 ulp toward the error where its last bit is even),
    whose cast rounds the exact result correctly: 53 bits hold 2 * 24 + 2,
    so no f32 midpoint lies between the odd-rounded sum and the exact one.
    The gradient is that of a * b + c."""
    c64 = _f64(c)
    p = _f64(a) * _f64(b)
    s = p + c64
    if s.ndim == 0:
        return fma_f32(*(v.reshape(1) if torch.is_tensor(v) else v for v in (a, b, c))).reshape(())
    r = s.float()
    if r.device.type == "meta":  # shapes only (train/state.py admm_sites)
        return r
    with torch.no_grad():
        s0 = s.detach()
        cand = _double_rounding_candidates(s0, r.detach())
        if not bool(cand.any()):
            return r
        idx = cand.reshape(-1).nonzero().squeeze(1)
        at = torch.unravel_index(idx, s0.shape)
        ps, ss, cs = _at(p, s0.shape, at), s0[at], _at(c64, s0.shape, at)
        t = ss - ps
        err = (ps - (ss - t)) + (cs - t)
        # |err| > 0 is false where err is NaN (an infinite sum): no nudge there
        nudge = (err.abs() > 0) & ((ss.view(torch.int64) & 1) == 0)
        fixed = torch.where(nudge, torch.nextafter(ss, err * math.inf), ss).float()
        if not r.requires_grad:
            r[at] = fixed
            return r
        delta = torch.zeros_like(r)
        delta[at] = fixed - r.detach()[at]
    return r + delta


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """`a * b + c` in a's type: one rounding at f32 (fma_f32), plain f64."""
    return a * b + c if a.dtype == torch.float64 else fma_f32(a, b, c)


class _Erf(torch.autograd.Function):
    """erf_f32's values with erf's analytic gradient (jax.lax.erf's JVP:
    2/sqrt(pi) * exp(-x^2)); without it autograd would differentiate the
    clamped rational approximation, which is flat beyond +-3.74."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return erf_f32(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (_TWO_OVER_SQRT_PI * torch.exp(-(x * x)))


def erf(x: torch.Tensor) -> torch.Tensor:
    """erf at x's type, differentiable: erf_f32 at f32, torch.erf at f64."""
    return torch.erf(x) if x.dtype == torch.float64 else _Erf.apply(x)


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """jnp.clip as min(max(x, lo), hi), the bounds floats or tensors that
    broadcast against x: where x equals a bound its gradient is 1/2, as
    lax.max/lax.min split a tie (torch.maximum and torch.minimum split it
    the same way; torch.clamp would give 1)."""
    lo, hi = (b if torch.is_tensor(b) else x.new_tensor(b) for b in (lo, hi))
    return torch.minimum(torch.maximum(x, lo), hi)


def _poly_parts(z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(zc, acc) of the poly grid: erf_sqrt2(z, 'poly') == zc * acc, with
    zc = clip(z, -3, 3) and acc the Horner sum in zc^2, each step
    `acc*u + c` rounded once (f32; the f64 coefficients in plain f64)."""
    zc = _clip(z, -3.0, 3.0)
    u = zc * zc
    coefs = ERF_SQRT2_POLY if z.dtype == torch.float64 else _POLY_F32
    acc = torch.full_like(u, coefs[-1])
    for c in coefs[-2::-1]:
        acc = _fma(acc, u, c)
    return zc, acc


def erf_sqrt2(z: torch.Tensor, impl: str = "erf") -> torch.Tensor:
    """erf(z/sqrt2) == 2*Phi_{0,1}(z) - 1, the act-site CDF alignment map.

    impl='erf': erf. impl='poly': the ERF_SQRT2_POLY grid, each
    Horner step `acc*u + c` rounded once (module docstring)."""
    if impl == "erf":
        return erf(z * _INV_SQRT2)
    if impl == "poly":
        zc, acc = _poly_parts(z)
        return zc * acc
    raise ValueError(f"unknown cdf impl {impl!r}")


def erf_grid_boundaries(g: int) -> np.ndarray:
    """f32 decision boundaries t_k = sqrt2 * erfinv((k - 0.5) / g), k=1..g,
    of the erf act-quant grid: code(h) >= k iff h >= t_k. Computed in
    float64 with scipy and rounded once to f32."""
    from scipy.special import erfinv

    ks = (np.arange(1, g + 1, dtype=np.float64) - 0.5) / g
    return (np.sqrt(2.0) * erfinv(ks)).astype(np.float32)


def gaussian_cdf(x: torch.Tensor, mean, std, impl: str = "erf") -> torch.Tensor:
    """Phi_{mean,std}(x). The erf branch keeps the JAX package's float
    association: z = (x - mean) / (std * sqrt2), then erf."""
    if impl == "erf":
        z = (x - mean) / (std * _SQRT2)
        return 0.5 * (1.0 + erf(z))
    if impl == "poly":
        # `1 + zc * acc` is one more multiply-add: rounded once
        zc, acc = _poly_parts((x - mean) / std)
        return 0.5 * _fma(zc, acc, 1.0)
    raise ValueError(f"unknown cdf impl {impl!r}")


def gaussian_pdf2(x: torch.Tensor, mean, std) -> torch.Tensor:
    """2 * phi_{mean,std}(x)."""
    z = (x - mean) / std
    return 2.0 * _INV_SQRT_2PI * torch.exp(-0.5 * z * z) / std


def tensor_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor (mean, std) with Bessel correction (ddof=1). Of the whole
    tensor where x is a rank's slice of one split over the model axis
    (dist/collectives.py model_shard, whole_mean_std): torch's mean and
    std of the gathered whole tensor, bit for bit one process's, their
    gradients summed over the ranks."""
    stats = C.whole_mean_std(x)
    return (x.mean(), x.std(correction=1)) if stats is None else stats


def channel_stats(x: torch.Tensor, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel (mean, std) of a conv kernel: reduce all but the
    channel `axis` (-1 for HWIO, 0 for the QAT layers' OIHW), keepdims,
    ddof=1."""
    axis %= x.ndim
    dims = tuple(d for d in range(x.ndim) if d != axis)
    return x.mean(dim=dims, keepdim=True), x.std(dim=dims, correction=1, keepdim=True)


def cdf_transform(
    x: torch.Tensor,
    mean,
    std,
    *,
    affine: bool,
    act_range: Optional[float] = None,
    impl: str = "erf",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(c, pdf) of the CDF alignment map, pdf = 2*phi(x).

    affine=False (variant a): c = Phi(x) in [0, 1].
    affine=True (variant b): c = 2*Phi(x) - 1, times act_range when given
    (activations), before any rounding."""
    c = gaussian_cdf(x, mean, std, impl)
    if affine:
        c = c * 2.0 - 1.0
        if act_range is not None:
            c = c * act_range
    return c, gaussian_pdf2(x, mean, std)
