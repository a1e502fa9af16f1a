"""True-INT8 PreAct ResNet inference graph (port of
alignq_tpu/kernels/infer.py).

The graph, value for value as the JAX package runs it under jit:

    conv -> bn -> act_q -> (relu) -> ... residual add -> relu

- act sites quantize at production (right after the folded conv+bn):
  codes = round(c(h) * g), c = erf(h/sqrt2) | the poly grid | boundary bins;
- relu, residual adds and block-input requantizations run on integer codes
  (int16 stream in act_scale units), so they are exact;
- every conv takes int8 codes; BN folds into its f32 (scale, bias)
  epilogue, one rounding per `acc * scale + bias` (quant/cdf.py fma_f32).

Tensors keep the JAX package's layouts at the public functions: NHWC
activations, HWIO kernels. On CUDA every conv outside the stage kernel is
kernel K1's implicit-GEMM conv, which reads the NHWC codes in place
(kernels/qmatmul.py int8_conv_packed): PyTorch has no int8 conv there. The
first conv reads the f32 image itself (kernels/first_conv.py: the image's
quantization, the conv and its codes in one kernel).
Every act site after such a conv is K1's codes epilogue (int8_conv_codes):
the conv's f32 output is never stored. Runs of identity blocks go through
kernel K3 on the same NHWC stream. On the CPU the same code runs the
kernels' plain versions.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from alignq_tpu_torch.device import resolve_device
from alignq_tpu_torch.interop import init_preact_resnet_params
from alignq_tpu_torch.kernels.convert import QConvInt8, fold_conv_bn, grid_max
from alignq_tpu_torch.kernels.first_conv import first_conv
from alignq_tpu_torch.kernels.first_conv import linear_q as _linear_q
from alignq_tpu_torch.kernels.qmatmul import (
    ActMap,
    K1Weights,
    act_map,
    int8_conv_codes,
    int8_conv_packed,
    pack_act_cutpoints,
    pack_conv_weights,
)
from alignq_tpu_torch.kernels.quantize import act_codes, int_bin_codes
from alignq_tpu_torch.kernels.stage_kernel import pack_block_weights, stage_identity_blocks_nhwc
from alignq_tpu_torch.quant.cdf import erf_grid_boundaries

ACT_SCALE = 2.0 / 127.0  # act_range=2 over the symmetric 127 grid
S_IMG = 3.0 / 127.0  # normalized-image scale (CIFAR norm ~ [-2.5, 2.7])
ACT_RANGE = 2.0


def residual_multipliers(has_skip):
    """Exact per-block input bounds as integer multiples of act_range:
    stem -> 1; identity block -> in + 1; stride block -> 2."""
    ms, m = [], 1  # stem relu output
    for skip in has_skip:
        ms.append(m)
        m = 1 + (1 if skip else m)
    return ms


def residual_bounds(has_skip, act_range: float = ACT_RANGE):
    """Per-block input-value bounds (residual_multipliers * act_range)."""
    return [m * act_range for m in residual_multipliers(has_skip)]


def _act_g(act_bits: int) -> float:
    return float(grid_max(act_bits))


def _erfq_codes(h: torch.Tensor, act_bits: int = 8, impl: str = "erf") -> torch.Tensor:
    """Act-site codes round(c(h) * g) in int8 storage (g = 127 for A8, 7
    for A4). impl: 'erf' | 'poly' | 'bins' (A4/A2: compares against the
    exact erf-grid boundaries). K1's codes epilogue runs the same map."""
    return act_codes(h, int(_act_g(act_bits)), impl)


def _requant_codes(k: torch.Tensor, m: int, g: float, signed: bool = False) -> torch.Tensor:
    """Residual-stream requantization in exact integer arithmetic:
    round-half-up (2K + m) // (2m), floor division, clipped to [0, g]
    (or [-g, g] when signed)."""
    if not isinstance(m, int):
        raise TypeError("m must be a Python int")
    gi = int(g)
    lo = -gi if signed else 0
    k = k.to(torch.int32)
    if m == 1:
        return torch.clamp(k, lo, gi).to(torch.int8)
    q = torch.div(2 * k + m, 2 * m, rounding_mode="floor")
    return torch.clamp(q, lo, gi).to(torch.int8)


def _k1_weights(q: QConvInt8) -> K1Weights:
    """A folded conv's kernel and epilogue laid out for K1's conv form."""
    return pack_conv_weights(q.kernel_int8, q.scale, q.bias)


def _conv_k1(x_int8, q, stride, padding, op, mode, act=None):
    """K1's conv on NHWC int8 codes: the act codes where act is given
    (int8), else the epilogue `mode` ('f32' or 'int32')."""
    op = _k1_weights(q) if op is None else op
    if act is None:
        return int8_conv_packed(x_int8, op, stride, padding, mode)
    return int8_conv_codes(x_int8, op, stride, padding, act)


def _int8_conv_acc(x_int8: torch.Tensor, q: QConvInt8, stride: int = 1, padding: int = 1,
                   op: Optional[K1Weights] = None):
    """Raw int32 accumulator of one folded conv (no dequant epilogue).
    op: q laid out for K1 once (pack_int8_operands); None lays it out here."""
    return _conv_k1(x_int8, q, stride, padding, op, "int32")


def _int8_conv(x_int8: torch.Tensor, q: QConvInt8, stride: int = 1, padding: int = 1,
               op: Optional[K1Weights] = None, act: Optional[ActMap] = None):
    """One folded conv with its f32 dequant epilogue, acc * scale + bias;
    with act, that epilogue's int8 act codes instead."""
    return _conv_k1(x_int8, q, stride, padding, op, "f32", act)


def _int8_conv_1x1_pallas(x_int8: torch.Tensor, q: QConvInt8, stride: int = 1,
                          op: Optional[K1Weights] = None, act: Optional[ActMap] = None):
    """1x1 conv as K1 directly, its stride read in place, with the fused
    epilogue (f32, or the int8 act codes with act)."""
    return _conv_k1(x_int8, q, stride, 0, op, "f32", act)


def _merged_skip_conv(q0: QConvInt8, qs: QConvInt8) -> QConvInt8:
    """conv0 (3x3) and skip (1x1) as one 3x3 conv over concatenated output
    channels: the skip kernel padded to 3x3, zero but the centre tap."""
    ks3 = torch.nn.functional.pad(qs.kernel_int8, (0, 0, 0, 0, 1, 1, 1, 1))
    km = torch.cat([q0.kernel_int8, ks3], dim=3)
    return QConvInt8(km, torch.cat([q0.scale, qs.scale]), torch.cat([q0.bias, qs.bias]))


def _int8_conv_merged_skip(x_int8: torch.Tensor, q0: QConvInt8, qs: QConvInt8, stride: int,
                           op: Optional[K1Weights] = None, act: Optional[ActMap] = None):
    """Stage-boundary conv0 (3x3, pad 1) and skip (1x1, pad 0) as ONE conv
    (_merged_skip_conv): bit-identical accumulators. (f32 halves, or with
    act their int8 act codes.)"""
    h = _int8_conv(x_int8, _merged_skip_conv(q0, qs), stride, 1, op, act)
    c0 = q0.kernel_int8.shape[3]
    return h[..., :c0], h[..., c0:]


def act_int_cutpoints(q: QConvInt8, act_bits: int):
    """Per-channel int32 decision cutpoints of the A4/A2 erf act grid,
    folded through this conv's dequant+BN epilogue (host numpy, float64):

        code(A) >= k   iff  sgn*A >= ceil(( t_k - bias_c) / |scale_c|)
        code(A) <= -k  iff  sgn*A <= floor((-t_k - bias_c) / |scale_c|)

    Degenerate scale_c == 0 channels get always/never sentinel cutpoints."""
    g = int(_act_g(act_bits))
    if g > 15:
        raise ValueError("bins_int is for the A4/A2 grids (A8 g=127: use poly)")
    s = q.scale.detach().cpu().numpy().astype(np.float64)
    b = q.bias.detach().cpu().numpy().astype(np.float64)
    sgn = np.where(s >= 0, 1, -1).astype(np.int32)
    mag = np.abs(s)
    big = np.int64(2**31 - 2)  # beyond any reachable accumulator
    t1 = np.empty((g, s.size), np.int64)
    t2 = np.empty((g, s.size), np.int64)
    nz = mag > 0
    safe = np.where(nz, mag, 1.0)
    for k, tk in enumerate(float(t) for t in erf_grid_boundaries(g)):
        t1[k] = np.where(
            nz,
            np.clip(np.ceil((tk - b) / safe), -big, big),
            np.where(b >= tk, -big, big),
        ).astype(np.int64)
        t2[k] = np.where(
            nz,
            np.clip(np.floor((-tk - b) / safe), -big, big),
            np.where(b <= -tk, big, -big),
        ).astype(np.int64)
    dev = q.scale.device
    return {
        "sgn": torch.from_numpy(sgn).to(dev),
        "t1": torch.from_numpy(t1.astype(np.int32)).to(dev),
        "t2": torch.from_numpy(t2.astype(np.int32)).to(dev),
    }


def _int_bin_codes(acc: torch.Tensor, cut) -> torch.Tensor:
    """Act codes from the raw int32 accumulator by integer compare chains
    against per-channel cutpoints (see act_int_cutpoints). K1's codes
    epilogue runs the same chains."""
    return int_bin_codes(acc, cut["sgn"], cut["t1"], cut["t2"])


def augment_int_cutpoints(qparams: Dict[str, Any], act_bits: int) -> Dict[str, Any]:
    """Add integer act cutpoints ('*_cut' entries) to a qparams tree,
    enabling resnet20_int8_forward(act_impl='bins_int'). A4/A2 only."""
    out = dict(qparams)
    out["conv0_cut"] = act_int_cutpoints(qparams["conv0"], act_bits)
    layers = []
    for blk in qparams["layers"]:
        nb = dict(blk)
        nb["cut0"] = act_int_cutpoints(blk["conv0"], act_bits)
        nb["cut1"] = act_int_cutpoints(blk["conv1"], act_bits)
        if "skip" in blk:
            nb["cut_skip"] = act_int_cutpoints(blk["skip"], act_bits)
        layers.append(nb)
    out["layers"] = layers
    return out


def convert_preact_resnet(
    params: Dict[str, Any],
    batch_stats: Dict[str, Any],
    weight_bits: int = 8,
    act_bits: int = 8,
) -> Dict[str, Any]:
    """Fold every conv+bn pair of a PreActResNet (any depth: `layers_*` is
    walked structurally) into integer form. Each conv's epilogue folds its
    own input scale: stem S_IMG, block conv0/skip the exact per-block
    residual bound, conv1 the act grid scale."""
    g = _act_g(act_bits)

    def fold(conv, bn_params, bn_stats, act_scale):
        return fold_conv_bn(
            conv["kernel"], bn_params["scale"], bn_params["bias"],
            bn_stats["mean"], bn_stats["var"], act_scale=act_scale, bits=weight_bits,
        )

    out: Dict[str, Any] = {"conv0": fold(params["conv0"], params["bn"], batch_stats["bn"], S_IMG)}
    names = sorted((k for k in params if k.startswith("layers_")), key=lambda s: int(s.split("_")[1]))
    ms = residual_multipliers(["skip_conv" in params[n] for n in names])
    out["layers"] = []
    for name, m in zip(names, ms):
        p, s = params[name], batch_stats[name]
        in_scale = m * ACT_RANGE / g
        blk = {
            "conv0": fold(p["conv0"], p["bn0"], s["bn0"], in_scale),
            "conv1": fold(p["conv1"], p["bn1"], s["bn1"], ACT_RANGE / g),
            "in_scale": in_scale,
            "m": m,  # informational: the forward derives m from the block structure
        }
        if "skip_conv" in p:
            blk["skip"] = fold(p["skip_conv"], p["skip_bn"], s["skip_bn"], in_scale)
        out["layers"].append(blk)
    out["logit"] = {"kernel": params["logit"]["kernel"], "bias": params["logit"]["bias"]}
    return out


def _identity_runs(layers) -> List[Tuple[int, int]]:
    """(first, stop) of each maximal run of identity (no-skip) blocks."""
    runs, i = [], 0
    while i < len(layers):
        j = i
        while j < len(layers) and "skip" not in layers[j]:
            j += 1
        if j > i:
            runs.append((i, j))
        i = j + 1
    return runs


def pack_int8_operands(qparams: Dict[str, Any]) -> Dict[str, Any]:
    """The forward's weights laid out once in the forms its kernels take,
    so that a forward given them (operands=) re-lays out nothing. A tree
    beside qparams: K1Weights for 'conv0' and for each block's 'conv0',
    'conv1', 'skip' and 'merged' (conv0 + skip, for fuse_skip); and under
    'stage', K3's (wt, scale, bias) for each run of identity blocks, keyed
    by the run's first block. Where qparams has bins_int cutpoints
    (augment_int_cutpoints), each site's are laid out for K1's codes
    epilogue too, as ActMaps under the same keys ('conv0_cut'; 'cut0',
    'cut1', 'cut_skip')."""
    layers = qparams["layers"]
    blocks = []
    for blk in layers:
        ops = {k: _k1_weights(blk[k]) for k in ("conv0", "conv1", "skip") if k in blk}
        if "skip" in blk:
            ops["merged"] = _k1_weights(_merged_skip_conv(blk["conv0"], blk["skip"]))
        for key, conv in (("cut0", "conv0"), ("cut1", "conv1"), ("cut_skip", "skip")):
            if key in blk:
                ops[key] = pack_act_cutpoints(blk[key], ops[conv].wt.shape[0])
        blocks.append(ops)
    out = {
        "conv0": _k1_weights(qparams["conv0"]),
        "layers": blocks,
        "stage": {i: pack_block_weights(layers[i:j]) for i, j in _identity_runs(layers)},
    }
    if "conv0_cut" in qparams:
        out["conv0_cut"] = pack_act_cutpoints(qparams["conv0_cut"], out["conv0"].wt.shape[0])
    return out


def _stage_kernel_chunk_imgs(c: int, h: int, w: int, batch: int) -> int:
    """Images per CTA of the CUDA stage kernel. One: a CTA holds one
    image's plane in shared memory (up to ~74 KB at 32x32x16), and one
    image per CTA gives the grid the most CTAs to spread over the SMs."""
    return 1


def resnet20_int8_stream(
    qparams: Dict[str, Any], x: torch.Tensor, act_bits: int = 8,
    use_pallas_1x1: bool = False, fuse_skip: bool = False,
    act_impl: str = "erf", use_stage_kernel: bool = False,
    stream: str = "int16", operands: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """The integer graph up to the head: the final residual code stream,
    (B, H, W, C) int16 in act_scale units. Knobs as resnet20_int8_forward."""
    g = _act_g(act_bits)
    bins_int = act_impl == "bins_int"
    if bins_int:
        if "conv0_cut" not in qparams:
            raise ValueError("act_impl='bins_int' needs augment_int_cutpoints(qparams, act_bits)")
        rows = qparams["conv0_cut"]["t1"].shape[0]
        if rows != int(g):
            raise ValueError(
                f"cutpoints were built for a grid of {rows} levels, the forward's "
                f"act_bits={act_bits} needs {int(g)}"
            )
        if use_pallas_1x1 or fuse_skip or use_stage_kernel:
            raise ValueError("bins_int pairs with the plain conv path")
    if stream not in ("int16", "int8"):
        raise ValueError(f"stream must be 'int16' or 'int8', got {stream!r}")
    if use_stage_kernel and act_impl != "poly":
        raise ValueError("stage kernel pairs with the poly act grid")
    if use_stage_kernel and stream == "int8":
        raise ValueError("stage kernel carries the int16 stream")

    ops = pack_int8_operands(qparams) if operands is None else operands
    if bins_int and "conv0_cut" not in ops:
        raise ValueError("operands lack the bins_int cutpoints: pack them after augment_int_cutpoints")
    # the act map of every site but bins_int's, whose cutpoints are per site
    site_act = None if bins_int else act_map(act_impl, int(g), x.device)

    def _site_codes(x8_in, q, cut, stride_, pad_, op):
        # cut: the site's bins_int cutpoints as laid out in ops
        return _int8_conv(x8_in, q, stride_, pad_, op, cut if bins_int else site_act)

    layers = qparams["layers"]
    ms = residual_multipliers(["skip" in blk for blk in layers])
    runs = dict(_identity_runs(layers))
    # stem: conv0 -> bn -> act_q0 -> relu, from the f32 image in one kernel
    # (kernels/first_conv.py), the relu in its map
    stem_act = (ops["conv0_cut"] if bins_int else site_act)._replace(relu=True)
    out_c = first_conv(x, ops["conv0"], S_IMG, stem_act).to(torch.int16)
    if stream == "int8":
        c8 = out_c.to(torch.int8)  # codes on the current block's m*act_scale grid

    i = 0
    while i < len(layers):
        blk, bops = layers[i], ops["layers"][i]
        if use_stage_kernel and i in runs:
            j = runs[i]
            wt, scale, bias = ops["stage"][i]
            out_c = stage_identity_blocks_nhwc(out_c, wt, scale, bias, tuple(ms[i:j]), g=int(g))
            i = j
            continue
        m = ms[i]
        stride = 2 if "skip" in blk else 1
        x8 = c8 if stream == "int8" else _requant_codes(out_c, m, g)
        if "skip" in blk:
            # shortcut = act_skip_q(skip_bn(skip_conv(x))), no relu
            if use_pallas_1x1:
                sc_c = _int8_conv_1x1_pallas(x8, blk["skip"], stride, bops["skip"], site_act).to(torch.int16)
                a0 = _site_codes(x8, blk["conv0"], None, stride, 1, bops["conv0"])
            elif fuse_skip:
                a0, sc_c = _int8_conv_merged_skip(x8, blk["conv0"], blk["skip"], stride, bops["merged"], site_act)
                sc_c = sc_c.to(torch.int16)
            else:
                sc_c = _site_codes(x8, blk["skip"], bops.get("cut_skip"), stride, 0, bops["skip"]).to(torch.int16)
                a0 = _site_codes(x8, blk["conv0"], bops.get("cut0"), stride, 1, bops["conv0"])
        else:
            # int16 stream: the full-resolution code sum; int8 stream: the
            # requantized codes scaled back to grid-1 units (m * c8)
            sc_c = m * c8.to(torch.int16) if stream == "int8" else out_c
            a0 = _site_codes(x8, blk["conv0"], bops.get("cut0"), stride, 1, bops["conv0"])
        r0 = torch.clamp_min(a0, 0)  # relu on codes == relu on values
        a1_c = _site_codes(r0, blk["conv1"], bops.get("cut1"), 1, 1, bops["conv1"]).to(torch.int16)
        out_c = torch.clamp_min(a1_c + sc_c, 0)  # residual add + relu, in codes
        if stream == "int8" and i + 1 < len(layers):
            c8 = _requant_codes(out_c, ms[i + 1], g)
        i += 1
    return out_c


def resnet20_int8_head(qparams: Dict[str, Any], out_c: torch.Tensor, act_bits: int = 8):
    """Mean-pool and head on the final code stream. The pooled sum of
    integer codes is exact in f32; the head is evaluated in float64 and
    rounded once, so it departs from any f32 evaluation by its rounding."""
    act_scale = ACT_RANGE / _act_g(act_bits)
    feat = torch.mean(out_c.to(torch.float32), dim=(1, 2)) * act_scale
    kern, bias = qparams["logit"]["kernel"], qparams["logit"]["bias"]
    return (feat.double() @ kern.double() + bias.double()).float()


def resnet20_int8_forward(
    qparams: Dict[str, Any], x: torch.Tensor, act_bits: int = 8,
    use_pallas_1x1: bool = False, fuse_skip: bool = False,
    act_impl: str = "erf", use_stage_kernel: bool = False,
    stream: str = "int16", operands: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """INT forward: NHWC f32 images (B, 32, 32, 3) -> logits (B, classes).

    act_impl: 'erf' | 'poly' | 'bins' | 'bins_int' (A4/A2; needs
    augment_int_cutpoints). stream: 'int16' (exact code sums) | 'int8'
    (requantized codes as the stored stream). use_pallas_1x1: the stride-2
    skip convs as K1 matmuls. fuse_skip: conv0 and skip as one
    double-width conv. use_stage_kernel: runs of identity blocks through
    kernel K3 (poly act grid and int16 stream only). operands:
    pack_int8_operands(qparams), made once; None lays the weights out on
    every call."""
    out_c = resnet20_int8_stream(
        qparams, x, act_bits, use_pallas_1x1=use_pallas_1x1, fuse_skip=fuse_skip,
        act_impl=act_impl, use_stage_kernel=use_stage_kernel, stream=stream, operands=operands,
    )
    return resnet20_int8_head(qparams, out_c, act_bits)


convert_resnet20 = convert_preact_resnet  # works for any PreActResNet depth


def build_resnet20_int8(batch: int, device=None, seed: int = 0):
    """(fn, args) pair: the int8 forward and (qparams, x) on fresh random
    params (torch generator seeds seed+1) and images (seed)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, 32, 32, 3), generator=gen).to(dev)
    params, batch_stats = init_preact_resnet_params(
        20, torch.Generator().manual_seed(seed + 1), dev
    )
    return resnet20_int8_forward, (convert_resnet20(params, batch_stats), x)
