"""Baseline quantizers: uniform, DoReFa, BWN/BWNF, LSQ, APoT, LLSQ (port of
alignq_tpu/quant/baselines.py).

Plain functions on tensors. Learnable parameters (LSQ's step, APoT's and
LLSQ's clips) are passed in; the modules in nn/layers.py own them. Each JAX
custom_vjp is a torch.autograd.Function with the same backward. Conv
kernels are OIHW here (HWIO in the JAX package): a per-output-channel
statistic keeps axis 0 and reduces over the others.

Where the two libraries can part at f32:
- `_grad_scale` returns (s - s*k) + s*k, which is not always s. Jitted JAX
  rounds each of the three ops on its own (XLA contracts neither), as
  eager PyTorch does.
- Jitted JAX divides by a constant as a multiply by its reciprocal (the
  port's rule throughout): APoT's uniform grid does the same. Means
  (jnp.mean's sum / n) may still part by an ulp.
- APoT's projection and LLSQ's octave search take an argmin; both
  libraries give a tie to the first index. LLSQ's three summed errors are
  summed in another order than XLA's, so a near-tie at f32 can flip the
  search (tests/test_torch_baselines.py counts the flips).
"""

from __future__ import annotations

import functools
import itertools
from typing import Optional

import numpy as np
import torch

from alignq_tpu_torch.dist import collectives as C
from alignq_tpu_torch.quant.cdf import _clip, tensor_stats
from alignq_tpu_torch.quant.ste import round_ste, uniform_quantize

# ----------------------------------------------------------------- uniform


def _mean_abs(w: torch.Tensor) -> torch.Tensor:
    """mean|w|, detached: the whole tensor's where w is a rank's slice of
    one split over the model axis."""
    with torch.no_grad():
        return C.shard_whole(w).abs().mean()


def uniform_weight(w: torch.Tensor, w_bit: int) -> torch.Tensor:
    """w_bit == 1: the sign scaled by mean|w| (detached); else the raw grid."""
    if w_bit == 32:
        return w
    if w_bit == 1:
        e = _mean_abs(w)
        return uniform_quantize(w / e, 1) * e
    return uniform_quantize(w, w_bit)


def uniform_act(a: torch.Tensor, a_bit: int) -> torch.Tensor:
    """Clip to [0, 1] (jnp.clip's gradient), then the uniform grid."""
    if a_bit == 32:
        return a
    return uniform_quantize(_clip(a, 0.0, 1.0), a_bit)


# ------------------------------------------------------------------ DoReFa


def dorefa_weight(w: torch.Tensor, w_bit: int) -> torch.Tensor:
    if w_bit == 32:
        return w
    if w_bit == 1:
        e = _mean_abs(w)
        return uniform_quantize(w / e, 1) * e
    t = torch.tanh(w)
    max_w = C.shard_whole(t.detach()).abs().max()
    u = t / (2.0 * max_w) + 0.5
    return max_w * (2.0 * uniform_quantize(u, w_bit) - 1.0)


dorefa_act = uniform_act  # identical in the reference

# --------------------------------------------------------------- BWN / BWNF


def bwn_weight(w: torch.Tensor, w_bit: int) -> torch.Tensor:
    """Binary-Weight-Net: a per-tensor alpha = mean|w| (detached)."""
    if w_bit == 32:
        return w
    return _mean_abs(w) * uniform_quantize(w, w_bit)


def bwnf_weight(w: torch.Tensor, w_bit: int) -> torch.Tensor:
    """BWN with an alpha per output filter: OIHW reduces over (1, 2, 3)."""
    if w_bit == 32:
        return w
    alpha = w.abs().mean(dim=tuple(range(1, w.ndim)), keepdim=True).detach()
    return alpha * uniform_quantize(w, w_bit)


# --------------------------------------------------------------------- LSQ


def _grad_scale(x: torch.Tensor, scale: float) -> torch.Tensor:
    """The value (x - x*scale) + x*scale, each op rounded on its own; the
    gradient scaled by `scale`."""
    return (x - x * scale).detach() + x * scale


def lsq_quantize(x: torch.Tensor, s: torch.Tensor, bits: int, *, is_activation: bool) -> torch.Tensor:
    """Learned-step-size quantization; the step's gradient is scaled by
    1/sqrt(numel * Qp), numel that of x (the whole batch for an
    activation: the global batch under a data-parallel gather step)."""
    if bits == 32:
        return x
    if is_activation:
        qn, qp = 0, 2**bits - 1
    else:
        qn, qp = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    # the rows scale with the batch; a weight's numel is the whole tensor's
    numel = C.global_rows(x.numel()) if is_activation else C.shard_numel(x.numel())
    scale = _grad_scale(s, 1.0 / float(np.sqrt(numel * qp)))
    y = _clip(x / scale, float(qn), float(qp))
    return round_ste(y) * scale


def lsq_init_step(x: torch.Tensor, bits: int, *, is_activation: bool) -> torch.Tensor:
    """The data-dependent init of the step: 2 * mean|x| / sqrt(Qp)."""
    qp = (2**bits - 1) if is_activation else (2 ** (bits - 1) - 1)
    return x.abs().mean() * 2.0 * (1.0 / float(np.sqrt(qp)))


# -------------------------------------------------------------------- APoT


@functools.lru_cache(maxsize=None)
def build_power_value(b: int = 2, additive: bool = True) -> np.ndarray:
    """The additive powers-of-two levels for clip threshold 1, f32,
    normalized by an f32 reciprocal multiply as the reference does."""
    base_a, base_b, base_c = [0.0], [0.0], [0.0]
    if additive:
        if b == 2:
            for i in range(3):
                base_a.append(2 ** (-i - 1))
        elif b == 4:
            for i in range(3):
                base_a.append(2 ** (-2 * i - 1))
                base_b.append(2 ** (-2 * i - 2))
        elif b == 6:
            for i in range(3):
                base_a.append(2 ** (-3 * i - 1))
                base_b.append(2 ** (-3 * i - 2))
                base_c.append(2 ** (-3 * i - 3))
        elif b == 3:
            for i in range(3):
                if i < 2:
                    base_a.append(2 ** (-i - 1))
                else:
                    base_b.append(2 ** (-i - 1))
                    base_a.append(2 ** (-i - 2))
        elif b == 5:
            for i in range(3):
                if i < 2:
                    base_a.append(2 ** (-2 * i - 1))
                    base_b.append(2 ** (-2 * i - 2))
                else:
                    base_c.append(2 ** (-2 * i - 1))
                    base_a.append(2 ** (-2 * i - 2))
                    base_b.append(2 ** (-2 * i - 3))
    else:
        for i in range(2**b - 1):
            base_a.append(2 ** (-i - 1))
    values = sorted(set(a + bb + c for a, bb, c in itertools.product(base_a, base_b, base_c)))
    values = np.asarray(values, dtype=np.float32)
    return values * np.float32(1.0 / values.max())


def _project_to_levels(x: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """The nearest level; a tie goes to the first (lower) level."""
    idx = torch.argmin((x.unsqueeze(-1) - levels).abs(), dim=-1)
    return levels[idx]


def _levels(bits: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(build_power_value(bits, True)).to(device=like.device, dtype=like.dtype)


def _apot_project(v: torch.Tensor, bits: int, power: bool) -> torch.Tensor:
    """The power levels, or the uniform grid of 2^bits - 1 steps: `/ n` by
    the reciprocal multiply, as jitted JAX divides by a constant."""
    if power:
        return _project_to_levels(v, _levels(bits, v))
    n = float(2**bits - 1)
    return torch.round(v * n) * (1.0 / n)


class _APoTWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, alpha, bits, power):
        wa = w / alpha
        wc = torch.clamp(wa, -1.0, 1.0)
        out = _apot_project(wc.abs(), bits, power) * torch.sign(wc) * alpha
        ctx.save_for_backward(wa, out / alpha)
        return out

    @staticmethod
    def backward(ctx, g):
        # the weight's gradient is the identity (unclipped); alpha's is the
        # sign outside the clip range and wq - wa inside
        wa, wq = ctx.saved_tensors
        outside = (wa.abs() > 1.0).to(g.dtype)
        grad_alpha = torch.sum(g * (torch.sign(wa) * outside + (wq - wa) * (1.0 - outside)))
        return g, grad_alpha.reshape(()), None, None


def apot_weight_quant(w: torch.Tensor, alpha: torch.Tensor, bits: int, power: bool) -> torch.Tensor:
    """APoT's weight projection with the learnable clip alpha, on a weight
    already normalized by its mean and std."""
    return _APoTWeight.apply(w, alpha, bits, power)


def apot_weight(w: torch.Tensor, alpha: torch.Tensor, w_bit: int) -> torch.Tensor:
    """APoT's weight path: normalize by the detached mean and std (ddof 1),
    then project on w_bit - 1 bits, the power levels from w_bit 3 up."""
    if w_bit == 32:
        return w
    with torch.no_grad():
        mean, std = tensor_stats(w)
    return apot_weight_quant((w - mean) / std, alpha, w_bit - 1, w_bit > 2)


class _APoTAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, alpha, bits, power):
        aa = a / alpha
        out = _apot_project(torch.clamp(aa, max=1.0), bits, power) * alpha
        ctx.save_for_backward(aa, out / alpha)
        return out

    @staticmethod
    def backward(ctx, g):
        aa, aq = ctx.saved_tensors
        over = (aa > 1.0).to(g.dtype)
        grad_alpha = torch.sum(g * (over + (aq - aa) * (1.0 - over)))
        return g * (1.0 - over), grad_alpha.reshape(()), None, None


def apot_act_quant(a: torch.Tensor, alpha: torch.Tensor, bits: int, power: bool) -> torch.Tensor:
    """APoT's activation projection (clamped at 1 from above only)."""
    return _APoTAct.apply(a, alpha, bits, power)


# -------------------------------------------------------------------- LLSQ


def quan_alpha(alpha: torch.Tensor, bits: int) -> torch.Tensor:
    """The scale itself on a `bits`-bit power-of-two grid."""
    if bits == 32:
        return alpha
    q_code = bits - torch.ceil(torch.log2(alpha.max()) + 1 - 1e-5)
    lo, hi = -(2.0 ** (bits - 1)), 2.0 ** (bits - 1) - 1
    return torch.clamp(torch.round(alpha * 2.0**q_code), lo, hi) / 2.0**q_code


def _llsq_round(x, alpha, pwr, lo):
    return torch.clamp(torch.round(x / alpha), lo, pwr - 1) * alpha


def _octave(x, a, pwr, lo, dims, axis=None):
    """-1, 0 or 1: which of a/2, a, 2a reconstructs x with the least summed
    squared error over dims (a tie to the first); with a data-parallel
    axis, the errors summed over its ranks (x a batch: the global batch's
    octave)."""
    errs = torch.stack([torch.sum((x - _llsq_round(x, s, pwr, lo)) ** 2, dim=dims) for s in (a / 2, a, a * 2)])
    if axis is not None:
        errs = C.batch_sum(errs, axis)
    return torch.argmin(errs, dim=0) - 1


class _LLSQWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, alpha, bit, per_channel, rows):
        pwr = 2 ** (bit - 1)
        a = quan_alpha(alpha, 16)
        if rows is not None:
            a = a[rows]
        ctx.save_for_backward(w, a)
        ctx.bit, ctx.per_channel, ctx.rows, ctx.alpha_shape = bit, per_channel, rows, alpha.shape
        return _llsq_round(w, a, pwr, -pwr)

    @staticmethod
    def backward(ctx, g):
        # the octave search: alpha's gradient is -alpha^2 times the offset
        # of the best of alpha/2, alpha, 2 alpha (independent of g)
        w, a = ctx.saved_tensors
        pwr = 2 ** (ctx.bit - 1)
        dims = tuple(range(1, w.ndim)) if ctx.per_channel else tuple(range(w.ndim))
        d = _octave(w, a, pwr, -pwr, dims)
        ga = -(a**2) * d.to(a.dtype).reshape(a.shape)
        if ctx.rows is not None:  # alpha's rows this slice uses
            ga, part = a.new_zeros(ctx.alpha_shape), ga
            ga[ctx.rows] = part
        return g, ga, None, None, None


def llsq_weight_quant(w: torch.Tensor, alpha: torch.Tensor, bit: int, per_channel: bool,
                      rows: Optional[slice] = None) -> torch.Tensor:
    """LLSQ's weight rounding with alpha 16-bit-quantized on the fly; alpha
    per output channel, (Cout, 1, 1, 1) for an OIHW kernel. rows: w is
    these output channels of the kernel (a column-parallel rank's slice),
    alpha whole: its 16-bit grid is set by the whole alpha's max, and its
    gradient is nonzero on the rows only."""
    return _LLSQWeight.apply(w, alpha, bit, per_channel, rows)


class _LLSQAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, alpha, bit, signed):
        pwr = 2 ** (bit - 1)
        ctx.save_for_backward(a, alpha)
        ctx.bit, ctx.signed = bit, signed
        ctx.axis = C.current_axis()  # the backward runs on autograd's threads
        return _llsq_round(a, alpha, pwr, -pwr if signed else 0)

    @staticmethod
    def backward(ctx, g):
        x, alpha = ctx.saved_tensors
        pwr = 2 ** (ctx.bit - 1)
        lo = -pwr if ctx.signed else 0
        d = _octave(x, alpha, pwr, lo, tuple(range(x.ndim)), ctx.axis)
        if ctx.signed:
            mask = (x >= -pwr * alpha) & (x <= (pwr - 1) * alpha)
        else:
            mask = (x >= 0) & (x <= (pwr * 2 - 1) * alpha)
        return g * mask.to(g.dtype), -(alpha**2) * d.to(alpha.dtype), None, None


def llsq_act_quant(a: torch.Tensor, alpha: torch.Tensor, bit: int, signed: bool) -> torch.Tensor:
    """LLSQ's activation rounding with its octave-search backward."""
    return _LLSQAct.apply(a, alpha, bit, signed)

