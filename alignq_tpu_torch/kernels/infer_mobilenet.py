"""True-INT8 MobileNet-V2 inference graph (port of
alignq_tpu/kernels/infer_mobilenet.py), value for value as the JAX package
runs it under jit.

- every conv+bn folds to an int8 conv with a per-channel (scale, bias)
  epilogue; the 1x1 convs and the stem run on K1 (kernels/qmatmul.py), the
  depthwise 3x3 convs on K1's depthwise form (kernels/dwconv.py);
- the act sites are those kernels' codes epilogues: codes = round(c(h) *
  g) of the folded conv's h, relu'd on the codes where the graph applies
  ReLU6 (act values are bounded by act_range = 2 < 6, so the 6-clamp never
  binds); the f32 h is never stored;
- stride-1 blocks add the relu'd shortcut codes to conv3's codes on the act
  grid, and the block output requantizes onto the next block's input grid
  in exact integer arithmetic (kernels/infer.py _requant_codes, signed: a3
  has no relu). The inter-block stream is int8 codes.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import torch

from alignq_tpu_torch.device import resolve_device
from alignq_tpu_torch.interop import init_mobilenetv2_params
from alignq_tpu_torch.kernels.convert import fold_conv_bn
from alignq_tpu_torch.kernels.dwconv import dw_conv, pack_dw_weights
from alignq_tpu_torch.kernels.first_conv import first_conv
from alignq_tpu_torch.kernels.infer import S_IMG, _act_g, _requant_codes
from alignq_tpu_torch.kernels.qmatmul import act_map, int8_conv_codes, pack_conv_weights

# (expansion, out_planes, num_blocks, stride): the CIFAR/SVHN MobileNet-V2 of
# alignq_tpu/models/mobilenetv2.py (reference mobilenetV2.py:77-83)
CFG = ((1, 16, 1, 1), (6, 24, 2, 1), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


def convert_mobilenetv2(
    params: Dict[str, Any],
    batch_stats: Dict[str, Any],
    weight_bits: int = 8,
    act_bits: int = 8,
) -> Dict[str, Any]:
    """Fold every conv+bn pair into integer form. Each conv's epilogue
    folds its input's scale: the stem S_IMG; conv1 and the shortcut the
    block input's (act_scale after the stem or a stride-2 block, s_res =
    2*act_scale after a stride-1 block); conv2 and conv3 act_scale."""
    act_scale = 2.0 / _act_g(act_bits)
    s_res = 4.0 / _act_g(act_bits)

    def fold_path(block, conv_name, bn_name, act_scale_in):
        blk_p = params[block] if block else params
        blk_s = batch_stats[block] if block else batch_stats
        return fold_conv_bn(
            blk_p[conv_name]["kernel"],
            blk_p[bn_name]["scale"], blk_p[bn_name]["bias"],
            blk_s[bn_name]["mean"], blk_s[bn_name]["var"],
            act_scale=act_scale_in, bits=weight_bits,
        )

    out: Dict[str, Any] = {"conv1": fold_path(None, "conv1", "bn1", S_IMG), "blocks": []}
    in_scale = act_scale  # stem output: relu(codes) * act_scale
    idx = 0
    for _, _, num_blocks, stride in CFG:
        for s in [stride] + [1] * (num_blocks - 1):
            name = f"layers_{idx}"
            # stride-1 blocks carry the quantized shortcut branch
            blk = {
                "conv1": fold_path(name, "conv1", "bn1", in_scale),
                "conv2": fold_path(name, "conv2", "bn2", act_scale),
                "conv3": fold_path(name, "conv3", "bn3", act_scale),
            }
            if s == 1:
                blk["shortcut"] = fold_path(name, "shortcut_conv", "shortcut_bn", in_scale)
            out["blocks"].append(blk)
            in_scale = s_res if s == 1 else act_scale
            idx += 1
    out["conv2"] = fold_path(None, "conv2", "bn2", in_scale)
    out["linear"] = {"kernel": params["linear"]["kernel"], "bias": params["linear"]["bias"]}
    return out


def pack_mobilenetv2_operands(qparams: Dict[str, Any]) -> Dict[str, Any]:
    """The forward's weights laid out once in the forms its kernels take: a
    tree beside qparams with K1Weights for 'conv1', 'conv2' (the head) and
    each block's 'conv1', 'conv3' and 'shortcut', and DwWeights for each
    block's depthwise 'conv2'."""

    def k1(q):
        return pack_conv_weights(q.kernel_int8, q.scale, q.bias)

    blocks = []
    for blk in qparams["blocks"]:
        ops = {k: k1(blk[k]) for k in ("conv1", "conv3", "shortcut") if k in blk}
        ops["conv2"] = pack_dw_weights(blk["conv2"].kernel_int8, blk["conv2"].scale, blk["conv2"].bias)
        blocks.append(ops)
    return {"conv1": k1(qparams["conv1"]), "blocks": blocks, "conv2": k1(qparams["conv2"])}


def mobilenetv2_int8_streams(
    qparams: Dict[str, Any], x: torch.Tensor, act_bits: int = 8, act_impl: str = "erf",
    operands: Optional[Dict[str, Any]] = None,
) -> Iterator[torch.Tensor]:
    """The integer graph up to the head, one stream at a time: the stem's
    relu'd codes, then each block's int8 output stream (B, H, W, C) (signed
    codes on the next consumer's input grid). act_impl: 'erf' | 'poly' |
    'bins' (A4/A2). operands: pack_mobilenetv2_operands(qparams), made
    once; None lays the weights out here."""
    if act_impl not in ("erf", "poly", "bins"):
        raise ValueError(f"MobileNet-V2 serves act_impl 'erf', 'poly' or 'bins', got {act_impl!r}")
    g = _act_g(act_bits)
    ops = pack_mobilenetv2_operands(qparams) if operands is None else operands
    relu = act_map(act_impl, int(g), x.device, relu=True)  # act site, then ReLU6 == relu
    bare = act_map(act_impl, int(g), x.device)  # act_q3: no relu

    # stem: conv1 -> bn1 -> act_q1 -> relu; its m=1 requant is the identity
    x8 = first_conv(x, ops["conv1"], S_IMG, relu)
    yield x8
    for blk, bops in zip(qparams["blocks"], ops["blocks"]):
        stride = 1 if "shortcut" in blk else 2
        r = int8_conv_codes(x8, bops["conv1"], 1, 0, relu)
        r = dw_conv(r, bops["conv2"], stride, act=relu)
        a3_c = int8_conv_codes(r, bops["conv3"], 1, 0, bare).to(torch.int16)
        if "shortcut" in blk:
            sc_c = int8_conv_codes(x8, bops["shortcut"], 1, 0, relu).to(torch.int16)
            # residual sum in [-g, 2g] -> the S_RES grid (m=2), stored int8
            x8 = _requant_codes(a3_c + sc_c, 2, g, signed=True)
        else:
            x8 = _requant_codes(a3_c, 1, g, signed=True)  # bare act codes: the m=1 clamp
        yield x8


def mobilenetv2_int8_head(qparams: Dict[str, Any], x8: torch.Tensor, act_bits: int = 8, act_impl: str = "erf",
                          operands: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """The head conv's relu'd codes, mean-pooled (an exact sum of integer
    codes), then the linear head in float64, rounded once."""
    g = _act_g(act_bits)
    op = pack_conv_weights(qparams["conv2"].kernel_int8, qparams["conv2"].scale, qparams["conv2"].bias) \
        if operands is None else operands["conv2"]
    out = int8_conv_codes(x8, op, 1, 0, act_map(act_impl, int(g), x8.device, relu=True))
    feat = torch.mean(out.to(torch.float32), dim=(1, 2)) * (2.0 / g)
    kern, bias = qparams["linear"]["kernel"], qparams["linear"]["bias"]
    return (feat.double() @ kern.double() + bias.double()).float()


def mobilenetv2_int8_forward(
    qparams: Dict[str, Any], x: torch.Tensor, act_bits: int = 8, act_impl: str = "erf",
    operands: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """INT forward: NHWC f32 images (B, 32, 32, 3) -> logits (B, classes).
    On CUDA 50 K1 launches (stem, 17 conv1, 17 conv3, 14 shortcuts, head)
    and 17 depthwise launches a forward."""
    ops = pack_mobilenetv2_operands(qparams) if operands is None else operands
    for x8 in mobilenetv2_int8_streams(qparams, x, act_bits, act_impl, ops):
        pass
    return mobilenetv2_int8_head(qparams, x8, act_bits, act_impl, ops)


def build_mobilenetv2_int8(batch: int, device=None, seed: int = 0, act_bits: int = 8):
    """(fn, args) pair: the int8 forward and (qparams, x) on fresh random
    params (torch generator seeds seed+1) and images (seed)."""
    dev = resolve_device(device)
    x = torch.randn((batch, 32, 32, 3), generator=torch.Generator().manual_seed(seed)).to(dev)
    params, stats = init_mobilenetv2_params(torch.Generator().manual_seed(seed + 1), dev)
    return mobilenetv2_int8_forward, (convert_mobilenetv2(params, stats, act_bits=act_bits, weight_bits=8), x)
