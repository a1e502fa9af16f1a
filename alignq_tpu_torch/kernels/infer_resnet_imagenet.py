"""True-INT8 ImageNet-layout ResNet-18/34/50 feature trunk (port of the
trunk half of alignq_tpu/kernels/infer_resnet_imagenet.py), value for value
as the JAX package runs it under jit.

- The stem (the image's quantize, the 7x7 stride-2 conv1, its relu'd codes
  and the 3x3 stride-2 max pool of the codes) is one kernel on the card,
  kernels/stem.py stem_pool_codes (csrc/stem_sm90.cu, after a prep pass
  that quantizes the image and pads its channels to 4); on the CPU, and
  for shapes that kernel does not take, the chain it replaced: K1's 7x7
  form, then the pool on an exact f16 copy of the codes.
- Every other conv is kernel K1 (kernels/qmatmul.py) on NHWC int8 codes
  read in place: the blocks' 1x1 and 3x3 convs, the 1x1 downsamples.
  Every act site is K1's codes epilogue (K2's map), relu'd on the codes
  where the graph applies relu; the downsample, which has no act site,
  takes K1's f32 epilogue.
- The residual stream starts as int16 codes and stays integer until the
  first downsample mixes in its f32 epilogue; block inputs are requantized
  per batch (per-tensor max scale, on the device): in exact integer
  arithmetic while the stream is codes (_dynamic_q_codes), in f32 after
  (_dynamic_q). That scale enters the block-input convs' epilogues as
  (q.scale * s_in), an (N,) f32 product made on the device, so K1's
  `acc * scale + bias` stays one rounding.
- Returns the pooled penultimate feature (no head).
- The domain-adaptation nets serve on this trunk (dann_int8_forward,
  dsan_int8_forward, mdd_int8_forward, each with its converter): the trunk
  in INT8, its heads f32 products outside any kernel (torch.matmul, TF32
  off), as JAX computes them outside any Pallas kernel.

Rounding rules of jitted JAX, held here: `max|x| / 127` divides by a
constant, so it is a multiply by the f32 reciprocal; `x / s` divides by a
traced value, so it is a true division; `act_scale / 127.0` is rounded to
f32 once; the f32 stream's `a * act_scale + identity` is one FMA; a mean
is a sum times the f32 reciprocal of the count.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from alignq_tpu_torch.device import resolve_device
from alignq_tpu_torch.dist import collectives as C
from alignq_tpu_torch.kernels.convert import fold_conv_bn
from alignq_tpu_torch.kernels.infer import S_IMG, _act_g
from alignq_tpu_torch.kernels.qmatmul import K1Weights, act_map, int8_conv_codes, int8_conv_packed, pack_conv_weights
from alignq_tpu_torch.kernels.stem import stem_pool_codes
from alignq_tpu_torch.quant.cdf import fma_f32

Heads = Dict[str, Any]

IMPLS = ("erf", "poly", "bins")  # the trunk's act maps ('bins' for A4/A2)


def _f32(v: float) -> float:
    """v rounded to f32, as a Python float (exact in any later f32 op)."""
    return float(np.float32(v))


_RECIP_127 = _f32(1.0 / 127.0)


def _dynamic_q(x: torch.Tensor):
    """Per-tensor dynamic symmetric int8 of a generic f32 stream: (codes,
    scale). s = max(max|x| * f32(1/127), 1e-12); codes = clip(round(x /
    s), +-127), a true division. max|x| is the global batch's: under a
    mesh's data axis (serve.py) a MAX over its ranks."""
    s = torch.clamp_min(C.batch_max(x.abs().amax()) * _RECIP_127, _f32(1e-12))
    return torch.clamp(torch.round(x / s), -127.0, 127.0).to(torch.int8), s


def _dynamic_q_codes(k: torch.Tensor, act_scale: float):
    """_dynamic_q of a grid-aligned code stream (value = K * act_scale) in
    exact integer arithmetic: codes = floor((254 K + K_max) / (2 K_max)),
    round half up of 127 K / K_max, clipped; scale = K_max * f32(act_scale
    / 127). K_max = max(max|K|, 1) stays on the device; the global
    batch's, as _dynamic_q's."""
    k = k.to(torch.int32)
    kmax = torch.clamp_min(C.batch_max(k.abs().amax()), 1)
    c = torch.div(2 * 127 * k + kmax, 2 * kmax, rounding_mode="floor")
    return torch.clamp(c, -127, 127).to(torch.int8), kmax.to(torch.float32) * _f32(act_scale / 127.0)


def convert_resnet_imagenet(
    params: Dict[str, Any],
    batch_stats: Dict[str, Any],
    weight_bits: int = 8,
    act_bits: int = 8,
) -> Dict[str, Any]:
    """Fold a trained ResNetFeature (18/34/50: the blocks are walked
    structurally) into {'conv1': QConvInt8, 'layers': [{'conv1', 'conv2',
    'conv3' (Bottleneck), 'downsample'}]}. The stem folds the image scale;
    a block's input convs (conv1, downsample) fold 1.0, their input scale
    coming at run time; conv2 and conv3 fold the act grid's scale."""
    act_scale = 2.0 / _act_g(act_bits)

    def fold(block, conv, bn, in_scale):
        p = params[block] if block else params
        s = batch_stats[block] if block else batch_stats
        return fold_conv_bn(p[conv]["kernel"], p[bn]["scale"], p[bn]["bias"], s[bn]["mean"], s[bn]["var"],
                            act_scale=in_scale, bits=weight_bits)

    out: Dict[str, Any] = {"conv1": fold(None, "conv1", "bn1", S_IMG), "layers": []}
    names = sorted((k for k in params if k.startswith("layer")), key=lambda s: (int(s[5]), int(s.split("_")[1])))
    for name in names:
        blk = {"conv1": fold(name, "conv1", "bn1", 1.0), "conv2": fold(name, "conv2", "bn2", act_scale)}
        if "conv3" in params[name]:
            blk["conv3"] = fold(name, "conv3", "bn3", act_scale)
        if "downsample_conv" in params[name]:
            blk["downsample"] = fold(name, "downsample_conv", "downsample_bn", 1.0)
        out["layers"].append(blk)
    return out


def pack_resnet_imagenet_operands(qparams: Dict[str, Any]) -> Dict[str, Any]:
    """Every conv laid out once for K1: {'conv1': K1Weights, 'layers':
    [{name: K1Weights}]} beside qparams."""

    def k1(q):
        return pack_conv_weights(q.kernel_int8, q.scale, q.bias)

    return {"conv1": k1(qparams["conv1"]), "layers": [{k: k1(q) for k, q in blk.items()} for blk in qparams["layers"]]}


def _scaled(op: K1Weights, s_in: torch.Tensor) -> K1Weights:
    """A block-input conv's epilogue scale times the run-time input scale
    (one f32 rounding, as jitted JAX's q.scale * in_scale)."""
    return op._replace(scale=op.scale * s_in)


def resnet_imagenet_int8_streams(
    qparams: Dict[str, Any], x: torch.Tensor, act_bits: int = 8, act_impl: str = "erf",
    operands: Optional[Dict[str, Any]] = None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """The trunk one stage at a time: first {'out'}, the stem's pooled
    relu'd codes (B, H, W, 64) int16; then for each block {'in': its input
    codes (int8), 'last': its last act site's codes (int16, no relu),
    'out': the residual stream after it (int16 codes, or f32 from the first
    downsample on)}. act_impl: 'erf' | 'poly' | 'bins' (A4/A2). operands:
    pack_resnet_imagenet_operands(qparams), made once; None lays the
    weights out here."""
    if act_impl not in IMPLS:
        raise ValueError(f"the ImageNet trunk serves act_impl {IMPLS}, got {act_impl!r}")
    g = int(_act_g(act_bits))
    act_scale = 2.0 / g
    ops = pack_resnet_imagenet_operands(qparams) if operands is None else operands
    relu = act_map(act_impl, g, x.device, relu=True)
    bare = act_map(act_impl, g, x.device)

    # stem: conv1 7x7 s2 -> bn -> act_q0 -> relu -> max pool, on the codes
    out_c, out_f = stem_pool_codes(x, ops["conv1"], relu), None
    yield {"out": out_c}
    for i, (blk, bops) in enumerate(zip(qparams["layers"], ops["layers"])):
        bottleneck = "conv3" in blk
        # the stride sits on conv2 (Bottleneck) or conv1 (BasicBlock) and on
        # the downsample; structurally, a downsample past the first block
        stride = 2 if ("downsample" in blk and i > 0) else 1
        x8, s_in = _dynamic_q_codes(out_c, act_scale) if out_c is not None else _dynamic_q(out_f)
        if "downsample" in blk:
            identity_f, identity_c = int8_conv_packed(x8, _scaled(bops["downsample"], s_in), stride, 0, "f32"), None
        else:
            identity_c, identity_f = out_c, out_f
        if bottleneck:
            r = int8_conv_codes(x8, _scaled(bops["conv1"], s_in), 1, 0, relu)
            r = int8_conv_codes(r, bops["conv2"], stride, 1, relu)
            a_last = int8_conv_codes(r, bops["conv3"], 1, 0, bare)
        else:
            r = int8_conv_codes(x8, _scaled(bops["conv1"], s_in), stride, 1, relu)
            a_last = int8_conv_codes(r, bops["conv2"], 1, 1, bare)
        a_last = a_last.to(torch.int16)
        if identity_c is not None:
            out_c, out_f = torch.clamp_min(a_last + identity_c, 0), None
        else:
            out_c, out_f = None, torch.relu(fma_f32(a_last.to(torch.float32), _f32(act_scale), identity_f))
        yield {"in": x8, "last": a_last, "out": out_c if out_c is not None else out_f}


def _spatial_mean(v: torch.Tensor) -> torch.Tensor:
    """jnp.mean over (H, W) of NHWC f32: the sum times f32(1/(H*W))."""
    return v.sum(dim=(1, 2)) * _f32(1.0 / (v.shape[1] * v.shape[2]))


def resnet_imagenet_int8_forward(
    qparams: Dict[str, Any], x: torch.Tensor, act_bits: int = 8, act_impl: str = "erf",
    operands: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """INT trunk: NHWC f32 images (B, S, S, 3) -> the pooled feature
    (B, 512 or 2048), f32. On CUDA the stem is one stem-kernel launch (and
    its prep pass) and every other conv one K1 launch; both count under
    K1's KERNEL key (ResNet-18: 20, ResNet-34: 36, ResNet-50: 53 a
    forward)."""
    for stage in resnet_imagenet_int8_streams(qparams, x, act_bits, act_impl, operands):
        pass
    out = stage["out"]
    if out.dtype == torch.int16:
        return _spatial_mean(out.to(torch.float32)) * _f32(2.0 / _act_g(act_bits))
    return _spatial_mean(out)


def _dense(x: torch.Tensor, head: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.matmul(x, head["kernel"]) + head["bias"]


def dann_int8_forward(qparams: Dict[str, Any], heads: Heads, x: torch.Tensor, act_bits: int = 8,
                      act_impl: str = "erf", operands: Optional[Dict[str, Any]] = None):
    """A trained DANN: the INT8 trunk, then the f32 class and domain heads
    on its feature (the GRL is the identity at inference). Returns (class
    logits, domain logits)."""
    feat = resnet_imagenet_int8_forward(qparams, x, act_bits, act_impl, operands)
    return _dense(feat, heads["class_classifier"]), _dense(feat, heads["domain_classifier"])


def convert_dann(params: Dict[str, Any], batch_stats: Dict[str, Any], weight_bits: int = 8, act_bits: int = 8):
    """A trained DANN's flax-layout tree -> (the trunk's qparams, the f32
    heads)."""
    qparams = convert_resnet_imagenet(params["feature"], batch_stats.get("feature", {}), weight_bits, act_bits)
    return qparams, {k: dict(params[k]) for k in ("class_classifier", "domain_classifier")}


def dsan_int8_forward(qparams: Dict[str, Any], heads: Heads, x: torch.Tensor, act_bits: int = 8,
                      act_impl: str = "erf", operands: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """A trained DSAN: the INT8 trunk, the f32 bottleneck where it was
    trained with one, the class head. Returns class logits (LMMD is
    training-only)."""
    feat = resnet_imagenet_int8_forward(qparams, x, act_bits, act_impl, operands)
    if "bottle" in heads:
        feat = _dense(feat, heads["bottle"])
    return _dense(feat, heads["cls_fc"])


def convert_dsan(params: Dict[str, Any], batch_stats: Dict[str, Any], weight_bits: int = 8, act_bits: int = 8):
    """A trained DSAN's tree -> (the trunk's qparams, {'cls_fc'[, 'bottle']})."""
    qparams = convert_resnet_imagenet(params["feature_layers"], batch_stats.get("feature_layers", {}), weight_bits,
                                      act_bits)
    heads = {"cls_fc": dict(params["cls_fc"])}
    if "bottle" in params:
        heads["bottle"] = dict(params["bottle"])
    return qparams, heads


def mdd_int8_forward(qparams: Dict[str, Any], heads: Heads, x: torch.Tensor, act_bits: int = 8,
                     act_impl: str = "erf", operands: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """A trained MDD net: the INT8 trunk, the f32 bottleneck (fc -> its
    BatchNorm's statistics -> relu) where it has one, the class MLP (fc0 ->
    relu -> fc1). Returns class logits (the adversarial head and the
    dropouts are training-only)."""
    feat = resnet_imagenet_int8_forward(qparams, x, act_bits, act_impl, operands)
    if "bottleneck_fc" in heads:
        bn = heads["bottleneck_bn"]
        feat = (_dense(feat, heads["bottleneck_fc"]) - bn["mean"]) * torch.rsqrt(bn["var"] + _f32(1e-5))
        feat = torch.relu(fma_f32(feat, bn["scale"], bn["bias"]))
    cls = heads["classifier"]
    return _dense(torch.relu(_dense(feat, cls["fc0"])), cls["fc1"])


def convert_mdd(params: Dict[str, Any], batch_stats: Dict[str, Any], weight_bits: int = 8, act_bits: int = 8):
    """A trained MDDNet's tree -> (the trunk's qparams, the bottleneck fc
    and its BatchNorm's scale, bias, mean and var where it has one, and the
    class MLP; the adversarial head is dropped)."""
    qparams = convert_resnet_imagenet(params["base_network"], batch_stats.get("base_network", {}), weight_bits,
                                      act_bits)
    heads: Dict[str, Any] = {"classifier": {k: dict(params["classifier"][k]) for k in ("fc0", "fc1")}}
    if "bottleneck_fc" in params:
        heads["bottleneck_fc"] = dict(params["bottleneck_fc"])
        p, s = params["bottleneck_bn"], batch_stats["bottleneck_bn"]
        heads["bottleneck_bn"] = {"scale": p["scale"], "bias": p["bias"], "mean": s["mean"], "var": s["var"]}
    return qparams, heads


def build_resnet_imagenet_int8(arch: str, batch: int, device=None, seed: int = 0, image_size: int = 224,
                               act_bits: int = 8):
    """(fn, args) pair: the int8 trunk forward and (qparams, x) on fresh
    random params of `arch` (torch generator seeds seed+1) and images
    (seed), (batch, image_size, image_size, 3)."""
    from alignq_tpu_torch.interop import init_resnet_imagenet_params

    dev = resolve_device(device)
    x = torch.randn((batch, image_size, image_size, 3), generator=torch.Generator().manual_seed(seed)).to(dev)
    params, stats = init_resnet_imagenet_params(arch, torch.Generator().manual_seed(seed + 1), dev)
    return resnet_imagenet_int8_forward, (convert_resnet_imagenet(params, stats, act_bits=act_bits), x)
