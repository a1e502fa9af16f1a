"""Quantized layers: BatchNorm, QConv, QDense, StageRequant, QuantAct
(port of alignq_tpu/nn/layers.py).

Activations are NCHW and conv kernels OIHW, PyTorch's layouts (the JAX
package's are NHWC and HWIO; interop.py converts). Parameter and buffer
names are flax's (`kernel`, `bias`, `scale`; BatchNorm's `mean`, `var`),
so a state_dict key `layers_0.conv0.kernel` is the flax path
`layers_0/conv0/kernel`.

Every method of the JAX package: 'ours' (AlignQ CDF alignment), the
baselines 'uniform', 'uniform_admm', 'dorefa', 'bwn', 'bwnf', 'lsq', 'apot'
and 'llsq' (quant/baselines.py), and 'fp' (identity). The baselines'
learnable parameters carry flax's names and inits: QConv's `lsq_step_w`,
`lsq_step_a`, `wgt_alpha`, `act_alpha` and `alpha_w` (per output channel,
(Cout, 1, 1, 1) beside the OIHW kernel; JAX's (1, 1, 1, Cout)), QuantAct's
`alpha` (LLSQ).

The f32 convs and the head must run true f32: the JAX package pins
Precision.HIGHEST because reduced-precision passes cost 6.6 points of W4A4
train-vs-deploy agreement. On CUDA that means TF32 off for cuDNN and
matmul, which the trainer's entry point sets (train/loop.py fit).

Under a data-parallel step in gather mode (dist/collectives.py
batch_axis) the batch couplings are global: BatchNorm's sums, StageRequant's
batch statistic, QuantAct's D over every rank's rows.

Column-parallel (dist/sharding.py shard_model): a QConv or QDense whose
`shard` is a model axis holds its rank's slice of the output channels as
its kernel. Its weight quantizer takes the whole tensor's statistics,
its input and the quantizer's scalar parameters enter the slice's
computation (dist/collectives.py enter_shard), and its output's channels
are gathered right after the conv or the matmul, so that everything
after it (bias, BatchNorm, the act sites, ADMM, the head) is replicated
over the model axis.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from alignq_tpu_torch.admm.correlation import corr_discrepancy
from alignq_tpu_torch.dist import collectives as C
from alignq_tpu_torch.quant import baselines as B
from alignq_tpu_torch.quant.fake_quant import act_cdf, quantize_act, quantize_weight
from alignq_tpu_torch.quant.ste import requant_ste, uniform_quantize

CONV_METHODS = ("ours", "uniform", "uniform_admm", "dorefa", "bwn", "bwnf", "lsq", "apot", "llsq", "fp")


def _uniform(shape, bound: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """U(-bound, bound) drawn on the CPU (torch's default conv/linear init,
    kaiming_uniform(a=sqrt(5)) == U(-1/sqrt(fan_in), 1/sqrt(fan_in)))."""
    return (torch.rand(shape, generator=generator, dtype=torch.float64) * 2.0 - 1.0).mul(bound).float()


class BatchNorm(nn.Module):
    """BatchNorm over the channels of NCHW with flax's rule: momentum 0.9
    in flax's sense (running = 0.9 * running + 0.1 * batch), eps 1e-5, the
    batch variance BIASED and from the fast E[x^2] - E[x]^2 estimator
    (clipped at 0), and the running variance updated with it. The deploy
    graph folds the running variance into every conv's scale, so
    torch.nn.BatchNorm2d's unbiased running variance would change the
    exported codes."""

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if train:
            dims = (0,) + tuple(range(2, x.ndim))
            if C.current_axis() is None:
                mean = x.mean(dim=dims)
                var = torch.maximum(x.new_zeros(()), (x * x).mean(dim=dims) - mean * mean)
            else:  # the global batch's: one sum over the ranks of [sum x, sum x^2]
                n = C.global_rows(x.numel() // x.shape[1])
                sums = C.batch_sum(torch.stack([x.sum(dim=dims), (x * x).sum(dim=dims)])) / n
                mean = sums[0]
                var = torch.maximum(x.new_zeros(()), sums[1] - mean * mean)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = x - mean.reshape(shape)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return y * mul.reshape(shape) + self.bias.reshape(shape)


class QConv(nn.Module):
    """Quantized 2-D convolution, NCHW in and out, kernel OIHW
    ((features, in_features // groups, k, k)); with use_bias a `bias` (the
    digit DANN's convs), U(-1/sqrt(fan_in), 1/sqrt(fan_in)) as flax's,
    added after the conv. groups is flax's
    feature_group_count: groups == in_features == features is a depthwise
    conv. The weight quantizer's statistics stay per tensor.

    method: the weight quantizer (CONV_METHODS). 'lsq' and 'apot' also
    quantize the conv's input activation at a_bit, with their own
    parameters (the reference's 'none' ordering); APoT's input uses the
    weight's bits, as the JAX package does. An unknown method raises
    ValueError.

    mxu_dtype (torch.bfloat16): both conv operands in bf16 and the output
    cast back to f32, the opt-in fast path; None runs true f32 (f64 at
    f64)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3, stride: int = 1, padding: int = 0,
                 w_bit: int = 8, method: str = "ours", variant: str = "b", channelwise: bool = False,
                 mxu_dtype=None, groups: int = 1, init: str = "torch", generator: Optional[torch.Generator] = None,
                 a_bit: int = 8, use_bias: bool = False):
        super().__init__()
        if method not in CONV_METHODS:
            raise ValueError(f"unknown quant method {method!r}")
        self.stride, self.padding, self.groups = stride, padding, groups
        self.w_bit, self.a_bit, self.method, self.variant, self.channelwise = w_bit, a_bit, method, variant, channelwise
        self.mxu_dtype = mxu_dtype
        shape = (features, in_features // groups, kernel_size, kernel_size)
        if init == "he_fan_out":
            # normal(0, sqrt(2 / (k * k * features))): DenseNet's conv init
            std = math.sqrt(2.0 / (kernel_size * kernel_size * features))
            kernel = (torch.randn(shape, generator=generator, dtype=torch.float64) * std).float()
        else:
            kernel = _uniform(shape, 1.0 / math.sqrt(shape[1] * kernel_size * kernel_size), generator)
        self.kernel = nn.Parameter(kernel)
        self.use_bias = use_bias
        if use_bias:
            self.bias = nn.Parameter(_uniform((features,), 1.0 / math.sqrt(shape[1] * kernel_size * kernel_size),
                                              generator))
        if method == "lsq":
            if w_bit < 32:
                self.lsq_step_w = nn.Parameter(B.lsq_init_step(kernel, w_bit, is_activation=False))
            if a_bit < 32:
                self.lsq_step_a = nn.Parameter(torch.ones(()))
        elif method == "apot":
            if w_bit < 32:
                self.wgt_alpha = nn.Parameter(torch.tensor(3.0))
            if a_bit < 32:
                self.act_alpha = nn.Parameter(torch.tensor(8.0))
        elif method == "llsq" and w_bit < 32:
            # flax's variance_scaling(2, fan_out, truncated_normal) of a
            # (1, 1, 1, Cout) shape: std sqrt(2 / Cout) / 0.8796..., cut at 2 std
            std = math.sqrt(2.0 / features) / 0.87962566103423978
            alpha = torch.empty((features, 1, 1, 1), dtype=torch.float64)
            torch.nn.init.trunc_normal_(alpha, 0.0, std, -2 * std, 2 * std, generator=generator)
            self.alpha_w = nn.Parameter(alpha.float())
        self.shard = None  # the model axis of a column-parallel layer (dist/sharding.py shard_model)

    def _weight(self) -> torch.Tensor:
        """The quantized kernel (this rank's slice of it where sharded: the
        statistics the whole tensor's, the quantizer's own parameters
        entering the slice's computation)."""
        w, m, bits, shard = self.kernel, self.method, self.w_bit, self.shard
        with C.model_shard(shard, 0):
            if m == "ours":
                return quantize_weight(w, bits, variant=self.variant, channelwise=self.channelwise,
                                       channel_axis=0).wq
            if m == "uniform":
                return B.uniform_weight(w, bits)
            if m == "uniform_admm":  # the ablation's raw grid, no 1-bit rescale
                return uniform_quantize(w, bits)
            if m == "dorefa":
                return B.dorefa_weight(w, bits)
            if m == "bwn":
                return B.bwn_weight(w, bits)
            if m == "bwnf":
                return B.bwnf_weight(w, bits)
            if m == "lsq" and bits < 32:
                return B.lsq_quantize(w, C.enter_shard(self.lsq_step_w, shard), bits, is_activation=False)
            if m == "apot" and bits < 32:
                return B.apot_weight(w, C.enter_shard(self.wgt_alpha, shard), bits)
            if m == "llsq" and bits < 32:
                rows = None if shard is None else slice(shard.rank * w.shape[0], (shard.rank + 1) * w.shape[0])
                return B.llsq_weight_quant(w, C.enter_shard(self.alpha_w, shard), bits, True, rows)
            return w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self._weight()
        if self.a_bit < 32:
            if self.method == "lsq":
                x = B.lsq_quantize(x, self.lsq_step_a, self.a_bit, is_activation=True)
            elif self.method == "apot":
                x = B.apot_act_quant(x, self.act_alpha, self.w_bit - 1, self.w_bit > 2)
        groups = self.groups
        if self.shard is not None:  # column-parallel: this rank's output channels
            x = C.enter_shard(x, self.shard)
            if groups > 1:  # a grouped conv's slice reads its groups' input channels
                groups //= self.shard.size
                cin = x.shape[1] // self.shard.size
                x = x[:, self.shard.rank * cin:(self.shard.rank + 1) * cin]
        if self.mxu_dtype is not None:
            y = F.conv2d(x.to(self.mxu_dtype), w.to(self.mxu_dtype), stride=self.stride, padding=self.padding,
                         groups=groups).float()
        else:
            y = F.conv2d(x, w, stride=self.stride, padding=self.padding, groups=groups)
        y = C.gather_channels(y, self.shard, 1)
        return y + self.bias.reshape(1, -1, 1, 1) if self.use_bias else y


class QDense(nn.Module):
    """Quantized linear layer, kernel (in, out) as flax's; the FP head
    (method 'fp') by default."""

    def __init__(self, in_features: int, features: int, w_bit: int = 32, method: str = "fp", variant: str = "b",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w_bit, self.method, self.variant = w_bit, method, variant
        bound = 1.0 / math.sqrt(in_features)
        self.kernel = nn.Parameter(_uniform((in_features, features), bound, generator))
        self.bias = nn.Parameter(_uniform((features,), bound, generator))
        self.shard = None  # as QConv's: the kernel's output columns split over it

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel
        if self.method == "ours" and self.w_bit < 32:
            with C.model_shard(self.shard, 1):
                w = quantize_weight(w, self.w_bit, variant=self.variant).wq
        y = torch.matmul(C.enter_shard(x, self.shard), w)
        return C.gather_channels(y, self.shard, -1) + self.bias


CALIBS = ("max", "ema", "ema_p999")


def _percentile_by_channel(x: torch.Tensor, q: float) -> torch.Tensor:
    """The q-th percentile of x (NCHW or NC) over every axis but the
    channel axis 1, interpolated linearly as jnp.percentile does: position
    q/100 * (n - 1) and its weights in x's dtype, the two order statistics
    beside it read by topk (only the top ~0.1% of a column is sorted; no
    size limit, where torch.quantile refuses inputs over 2^24 elements)."""
    cols = x.transpose(0, 1).reshape(x.shape[1], -1)
    n = cols.shape[1]
    npd = np.float64 if x.dtype == torch.float64 else np.float32
    pos = npd(q) / npd(100) * npd(n - 1)
    lo = min(max(int(np.floor(pos)), 0), n - 1)
    hi = min(max(int(np.ceil(pos)), 0), n - 1)
    w_hi = pos - np.floor(pos)
    w_lo = npd(1) - w_hi
    top = torch.topk(cols, n - lo, dim=1, sorted=True).values  # descending: top[:, n-1-i] is the i-th smallest
    return top[:, n - 1 - lo] * float(w_lo) + top[:, n - 1 - hi] * float(w_hi)


class StageRequant(nn.Module):
    """Calibrated per-channel int8 requantization site: DenseNet's int8
    stage buffer (kernels/infer_densenet.py stage_int8), trained through.

    A buffer `amax` (C,), zero at init, holds the per-channel |value|
    statistic, a BatchNorm-like statistic: only a train forward updates it,
    and the current batch's statistic takes part in that step. calib 'max'
    keeps the running max; 'ema' an EMA (ema_decay) of the batch's max,
    'ema_p999' of its per-channel 99.9th percentile, the first update
    seeding the EMA. The value is requant_ste(x, s, g) with the detached
    scale s = max(amax, 1e-6) * (1/g): clip(round(x / s), -g, g) * s, the
    rounding the deployed conv epilogue applies to the same value."""

    def __init__(self, features: int, g: int = 127, calib: str = "max", ema_decay: float = 0.99):
        super().__init__()
        if calib not in CALIBS:
            raise ValueError(f"unknown StageRequant calib {calib!r}; have {CALIBS}")
        self.g, self.calib, self.ema_decay = g, calib, ema_decay
        self.register_buffer("amax", torch.zeros(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            with torch.no_grad():
                absx = x.detach().abs()
                if self.calib == "ema_p999":
                    stat = _percentile_by_channel(C.gather_rows(absx), 99.9)
                else:
                    stat = C.batch_max(absx.amax(dim=(0,) + tuple(range(2, x.ndim))))
                if self.calib == "max":
                    self.amax.copy_(torch.maximum(self.amax, stat))
                else:
                    d = self.ema_decay
                    self.amax.copy_(torch.where(self.amax > 0, d * self.amax + (1 - d) * stat, stat))
        scale = torch.clamp_min(self.amax, 1e-6) * (1.0 / self.g)
        return requant_ste(x, scale.detach(), self.g)


class QuantAct(nn.Module):
    """Activation fake-quantizer with the optional ADMM side output.

    With admm on, a sink (a dict) given to forward receives this site's
    B x B discrepancy D under `site` (its flax path, `layers_0/act_q0/d`;
    set by the model), and the train step builds the trans loss from it:
    eval, which passes no sink, stays loss-free.

    method: 'ours' (CDF alignment), 'uniform' and 'dorefa' (clip to [0, 1],
    then the uniform grid), 'bwn' and 'bwnf' (the unclipped uniform grid),
    'uniform_admm' (the unclipped grid, with an ADMM D of the identity
    transform, which is 0), 'llsq' (learned scale `alpha`, U[0, 1) at init)
    and 'fp' (identity). Another method raises ValueError where the JAX
    package's does: in forward, past the 32-bit short cut.

    stage 'align' (with 'ours'): at a_bit == 32 the activation still goes
    through the CDF transform, unrounded, the alignment-only FP32 stage of
    the domain-adaptation presets; any other stage keeps the identity."""

    def __init__(self, a_bit: int = 8, act_range: float = 2.0, method: str = "ours", variant: str = "b",
                 admm: bool = False, cdf_impl: str = "erf", corr_eps: float = 1e-5, stage: str = "quant",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.a_bit, self.act_range, self.method, self.variant = a_bit, act_range, method, variant
        self.admm, self.cdf_impl, self.corr_eps, self.stage = admm, cdf_impl, corr_eps, stage
        self.site = "d"
        if method == "llsq" and a_bit < 32:
            self.alpha = nn.Parameter(torch.rand((), generator=generator, dtype=torch.float64).float())

    def _cdf(self, x: torch.Tensor) -> torch.Tensor:
        return act_cdf(x, act_range=self.act_range, variant=self.variant, impl=self.cdf_impl)

    def forward(self, x: torch.Tensor, sink: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        corr = self.admm and sink is not None
        if self.a_bit == 32 and not corr:
            return self._cdf(x) if self.stage == "align" and self.method == "ours" else x
        b = x.shape[0]
        if self.method == "ours":
            if corr and self.a_bit < 32:
                sink[self.site] = corr_discrepancy(C.gather_rows(x.reshape(b, -1)),
                                                   C.gather_rows(self._cdf(x).reshape(b, -1)), eps=self.corr_eps)
            if self.a_bit == 32:
                return self._cdf(x) if self.stage == "align" else x
            return quantize_act(x, self.a_bit, act_range=self.act_range, variant=self.variant, impl=self.cdf_impl)
        if self.method in ("uniform", "dorefa"):
            return B.uniform_act(x, self.a_bit)
        if self.method in ("bwn", "bwnf"):
            return uniform_quantize(x, self.a_bit)
        if self.method == "uniform_admm":
            if corr and self.a_bit < 32:
                xf = C.gather_rows(x.reshape(b, -1))
                sink[self.site] = corr_discrepancy(xf, xf, eps=self.corr_eps)
            return uniform_quantize(x, self.a_bit)
        if self.method == "llsq":
            if self.a_bit == 32:
                return x
            return B.llsq_act_quant(x, B.quan_alpha(self.alpha, 32), self.a_bit, False)
        if self.method == "fp":
            return x
        raise ValueError(f"unknown act quant method {self.method!r}")
