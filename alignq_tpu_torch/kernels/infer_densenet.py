"""True-INT8 DenseNet-40 inference graph (port of
alignq_tpu/kernels/infer_densenet.py), value for value as the JAX package
runs it under jit.

DenseNet is pre-activation (bn -> act_q -> relu -> conv): BN is separated
from the previous conv by the concat, so it cannot fold into a conv
epilogue. It stays a per-channel f32 affine, run with the act map and the
relu as one pass over the live-channel prefix of the stage buffer: the
fused BN-act code kernel (kernels/quantize.py bn_act_codes), reading the
buffer in place and writing contiguous codes for the conv. Over the int8
buffer a site's map is a table of the 256 values a channel, built on the
site's first use and kept in the operands (bn_act_table,
bn_act_codes_table). Every conv
(stem, the 3x3 block convs, the 1x1 transitions) runs on K1
(kernels/qmatmul.py) with the epilogue `acc * scale` (the scale a scalar
act_scale * w_scale).

Each stage's feature map lives in one preallocated buffer of its final
width (`prealloc`, the default; the concat formulation is the other knob);
each block's conv output is written into its slice. In stage_int8 mode the
buffer holds int8 codes with per-channel scales `svec`: each consumer's BN
folds over them (h = codes * (svec * bn.scale) + bn.bias, the product
folded once at load), and each block's conv writes its slice through K1's
requant epilogue, clip(rint((acc * scale) * (1 / out_scale)), +-127).

The transitions' 2x2 average pool sums each window in row-major order,
((a + b) + c) + d, then divides by 4, as XLA's reduce_window does on the
CPU in this graph.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from alignq_tpu_torch.device import resolve_device
from alignq_tpu_torch.interop import init_densenet_params
from alignq_tpu_torch.kernels.convert import grid_max, quantize_weight_int8
from alignq_tpu_torch.kernels.first_conv import first_conv
from alignq_tpu_torch.kernels.infer import S_IMG, _act_g
from alignq_tpu_torch.kernels.qmatmul import act_map, int8_conv_packed, pack_conv_weights, requant_int8
from alignq_tpu_torch.kernels.quantize import BnActTable, bn_act_codes, bn_act_codes_table, bn_act_table

C_ALIGN = 16  # the BN-act codes' channels are zero-padded to it: K1 copies 16-byte pieces


class BNAffine(NamedTuple):
    scale: torch.Tensor  # gamma / sqrt(var + eps)
    bias: torch.Tensor  # beta - mean * scale


class PreActSite(NamedTuple):
    """A pre-activation site's BN-act operands: s, b (c_live,) f32, and the
    code tables of the maps it has run over an int8 buffer, by (impl, g,
    relu), each built on first use."""

    s: torch.Tensor
    b: torch.Tensor
    tables: Dict[Tuple[str, int, bool], BnActTable]


class QConvPre(NamedTuple):
    kernel_int8: torch.Tensor
    scale: torch.Tensor  # 0-d f32: act_scale * w_scale


def _bn_affine(p, s, eps=1e-5) -> BNAffine:
    inv = p["scale"] / torch.sqrt(s["var"] + eps)
    return BNAffine(inv.to(torch.float32), (p["bias"] - s["mean"] * inv).to(torch.float32))


def convert_densenet40(
    params: Dict[str, Any],
    batch_stats: Dict[str, Any],
    weight_bits: int = 8,
    act_bits: int = 8,
    stage_int8: bool = False,
) -> Dict[str, Any]:
    """Freeze a DenseNet (any depth 3n+4) into integer form: 'conv1' (the
    stem, QConvPre), 'stages' (per stage 'blocks' of {'bn', 'conv'} and
    but for the last a 'trans'), 'bn' and 'fc'. stage_int8: also the
    calibrated StageRequant scales (a DenseNet(stage_int8=True) QAT run):
    'stem_scale', each block's and transition's 'out_scale', and per stage
    'svec', the (c_final,) value scales of its buffer."""
    act_scale = 2.0 / _act_g(act_bits)

    def qconv(block, name, in_scale):
        k = params[block][name]["kernel"] if block else params[name]["kernel"]
        scale = torch.tensor(in_scale / grid_max(weight_bits), dtype=torch.float32, device=k.device)
        return QConvPre(quantize_weight_int8(k, weight_bits), scale)

    def req_scale(*path):
        s = batch_stats
        for p in path:
            s = s[p]
        # reciprocal multiply, as StageRequant's scale expression
        return torch.clamp_min(s["amax"], 1e-6).to(torch.float32) * (1.0 / 127.0)

    out: Dict[str, Any] = {"conv1": qconv(None, "conv1", S_IMG), "stages": []}
    if stage_int8:
        seed_scale = req_scale("requant_stem")
        out["stem_scale"] = seed_scale
    n = sum(1 for k in params if k.startswith("dense1_"))
    for stage in range(3):
        blocks = []
        svec = [seed_scale] if stage_int8 else None
        for i in range(n):
            name = f"dense{stage + 1}_{i}"
            blk = {"bn": _bn_affine(params[name]["bn1"], batch_stats[name]["bn1"]),
                   "conv": qconv(name, "conv1", act_scale)}
            if stage_int8:
                blk["out_scale"] = req_scale(name, "requant")
                svec.append(blk["out_scale"])
            blocks.append(blk)
        entry: Dict[str, Any] = {"blocks": blocks}
        if stage_int8:
            entry["svec"] = torch.cat(svec)
        if stage < 2:
            tname = f"trans{stage + 1}"
            entry["trans"] = {"bn": _bn_affine(params[tname]["bn1"], batch_stats[tname]["bn1"]),
                              "conv": qconv(tname, "conv1", act_scale)}
            if stage_int8:
                seed_scale = req_scale(tname, "requant")
                entry["trans"]["out_scale"] = seed_scale
        out["stages"].append(entry)
    out["bn"] = _bn_affine(params["bn"], batch_stats["bn"])
    out["fc"] = {"kernel": params["fc"]["kernel"], "bias": params["fc"]["bias"]}
    return out


def _c_pad(c: int) -> int:
    return -(-c // C_ALIGN) * C_ALIGN


def _k1_pre(q: QConvPre, inv_out: Optional[torch.Tensor] = None, pad_cin: bool = True):
    """A QConvPre laid out for K1, over its input's channels padded to
    C_ALIGN where pad_cin (zero weights there: a pre-act site's codes), the
    scalar scale broadcast; the bias is 0, or for the requant epilogue the
    (N,) reciprocal of the output's scale."""
    k = q.kernel_int8
    if pad_cin:
        k = torch.nn.functional.pad(k, (0, 0, 0, _c_pad(k.shape[2]) - k.shape[2]))
    n = k.shape[3]
    scale = q.scale.to(torch.float32).reshape(()).expand(n)
    return pack_conv_weights(k, scale, torch.zeros(n, device=k.device) if inv_out is None else inv_out)


def _reciprocal(out_scale: torch.Tensor) -> torch.Tensor:
    """1 / out_scale in f32, as the JAX graph's `1.0 / out_scale`."""
    return 1.0 / out_scale.to(torch.float32)


def pack_densenet40_operands(qparams: Dict[str, Any], stage_int8: bool = False) -> Dict[str, Any]:
    """The forward's weights laid out once: K1Weights of every conv ('conv'
    of the stem, each block and transition; in stage_int8 mode the stem's
    and the blocks' with their requant reciprocals) and each pre-act site's
    PreActSite ('bn': s, b; in stage_int8 mode s = svec * bn.scale, the
    buffer scale folded in), in a tree of the forward's order."""
    if stage_int8 and "stem_scale" not in qparams:
        raise ValueError("the stage_int8 forward needs convert_densenet40(stage_int8=True)")

    def site(bn, svec=None, c=None):
        s = bn.scale.reshape(-1)
        if svec is not None:
            s = svec[:c] * s
        return PreActSite(s.to(torch.float32).contiguous(), bn.bias.reshape(-1).to(torch.float32).contiguous(), {})

    stem_inv = _reciprocal(qparams["stem_scale"]) if stage_int8 else None
    out: Dict[str, Any] = {"conv": _k1_pre(qparams["conv1"], stem_inv, pad_cin=False), "stages": []}
    svec = None
    for entry in qparams["stages"]:
        svec = entry["svec"] if stage_int8 else None
        blocks = []
        for blk in entry["blocks"]:
            c_now = blk["conv"].kernel_int8.shape[2]
            inv = _reciprocal(blk["out_scale"]) if stage_int8 else None
            blocks.append({"bn": site(blk["bn"], svec, c_now), "conv": _k1_pre(blk["conv"], inv)})
        st: Dict[str, Any] = {"blocks": blocks}
        if "trans" in entry:
            t = entry["trans"]
            st["trans"] = {"bn": site(t["bn"], svec, t["conv"].kernel_int8.shape[2]), "conv": _k1_pre(t["conv"])}
            if stage_int8:
                st["trans"]["inv_out"] = _reciprocal(t["out_scale"])
        out["stages"].append(st)
    out["bn"] = site(qparams["bn"], svec, qparams["bn"].scale.numel())
    return out


def _site_codes(buf: torch.Tensor, c_live: int, site: PreActSite, act, c_out: Optional[int] = None) -> torch.Tensor:
    """bn -> act_q -> relu codes of buf's first c_live channels, zero-padded
    to c_out: over an int8 buffer through the site's code table for act
    (built on first use), over an f32 one by the arithmetic pass."""
    if buf.dtype != torch.int8:
        return bn_act_codes(buf, c_live, site.s, site.b, act, c_out)
    key = (act.impl, act.g, act.relu)
    if key not in site.tables:
        site.tables[key] = bn_act_table(site.s, site.b, act)
    return bn_act_codes_table(buf, c_live, site.tables[key], c_out)


def _pre_act_conv(buf: torch.Tensor, c_live: int, sops: Dict[str, Any], act, padding: int,
                  mode: str) -> torch.Tensor:
    """bn -> act_q -> relu -> int8 conv (JAX's _pre_act_conv, and
    _pre_act_conv_int8buf where buf holds int8 codes): the BN-act codes of
    buf's first c_live channels, zero-padded to C_ALIGN, then K1 with the
    epilogue `mode` ('f32' acc * scale, or 'requant' onto the output's
    buffer grid, as JAX's _requant_write)."""
    codes = _site_codes(buf, c_live, sops["bn"], act, _c_pad(c_live))
    return int8_conv_packed(codes, sops["conv"], 1, padding, mode)


def _stage_prealloc(out: torch.Tensor, block_ops, growth: int, act, mode: str) -> torch.Tensor:
    """One dense stage on a preallocated buffer of the stage's final width
    (JAX's _stage_prealloc; _stage_prealloc_int8 where out holds int8 codes
    and mode is 'requant'): block i reads its c_now live channels in place
    and writes its growth channels after them."""
    b, h, w, c = out.shape
    buf = torch.zeros((b, h, w, c + growth * len(block_ops)), dtype=out.dtype, device=out.device)
    buf[..., :c] = out
    for i, bops in enumerate(block_ops):
        c_now = c + growth * i
        buf[..., c_now : c_now + growth] = _pre_act_conv(buf, c_now, bops, act, 1, mode)
    return buf


def _avg_pool2(v: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, NHWC f32: ((a + b) + c) + d, then / 4."""
    return (((v[:, 0::2, 0::2] + v[:, 0::2, 1::2]) + v[:, 1::2, 0::2]) + v[:, 1::2, 1::2]) / 4.0


def densenet40_int8_buffers(
    qparams: Dict[str, Any], x: torch.Tensor, act_bits: int = 8, act_impl: str = "erf",
    prealloc: bool = True, stage_int8: bool = False, operands: Optional[Dict[str, Any]] = None,
) -> Iterator[torch.Tensor]:
    """The graph up to the head, one stage at a time: each stage's buffer
    after its blocks, (B, H, W, c_final) f32 values, or int8 codes in
    stage_int8 mode; the last is the head's input. Knobs as
    densenet40_int8_forward."""
    if act_impl not in ("erf", "poly", "bins"):
        raise ValueError(f"DenseNet serves act_impl 'erf', 'poly' or 'bins', got {act_impl!r}")
    ops = pack_densenet40_operands(qparams, stage_int8) if operands is None else operands
    act = act_map(act_impl, int(_act_g(act_bits)), x.device, relu=True)
    # stem: a plain quantized conv on the image; in stage_int8 mode its
    # output requantized onto stage 1's buffer grid
    mode = "requant" if stage_int8 else "f32"
    out = first_conv(x, ops["conv"], S_IMG, mode=mode)
    for entry, sops in zip(qparams["stages"], ops["stages"]):
        blocks = entry["blocks"]
        growth = blocks[0]["conv"].kernel_int8.shape[-1] if blocks else 0
        if stage_int8 or prealloc:
            out = _stage_prealloc(out, sops["blocks"], growth, act, mode)
        else:
            for bops in sops["blocks"]:  # the concat formulation
                out = torch.cat([out, _pre_act_conv(out, out.shape[-1], bops, act, 1, mode)], dim=-1)
        yield out
        if "trans" in sops:
            t = sops["trans"]
            v = _avg_pool2(_pre_act_conv(out, out.shape[-1], t, act, 0, "f32"))
            out = requant_int8(v, t["inv_out"]) if stage_int8 else v


def densenet40_int8_head(qparams: Dict[str, Any], out: torch.Tensor, act_bits: int = 8, act_impl: str = "erf",
                         operands: Optional[Dict[str, Any]] = None, stage_int8: bool = False) -> torch.Tensor:
    """bn -> act_q -> relu on the last buffer, mean-pooled act values, then
    the head in float64, rounded once."""
    g = _act_g(act_bits)
    site = (pack_densenet40_operands(qparams, stage_int8) if operands is None else operands)["bn"]
    codes = _site_codes(out, out.shape[-1], site, act_map(act_impl, int(g), out.device, relu=True))
    feat = torch.mean(codes.to(torch.float32) * (2.0 / g), dim=(1, 2))
    kern, bias = qparams["fc"]["kernel"], qparams["fc"]["bias"]
    return (feat.double() @ kern.double() + bias.double()).float()


def densenet40_int8_forward(
    qparams: Dict[str, Any], x: torch.Tensor, act_bits: int = 8, act_impl: str = "erf",
    prealloc: bool = True, stage_int8: bool = False, operands: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """INT forward: NHWC f32 images (B, 32, 32, 3) -> logits (B, classes).

    act_impl: 'erf' | 'poly' | 'bins' (A4/A2). prealloc: each stage's
    feature map in one buffer of its final width (default), else
    re-concatenated after every block (the reference formulation; integer
    ops identical, f32 ones too here). stage_int8: the int8 code buffer
    (needs convert_densenet40(stage_int8=True)). operands:
    pack_densenet40_operands(qparams, stage_int8), made once; None lays the
    weights out here. On CUDA 39 K1 and 39 BN-act launches a forward at
    depth 40: the arithmetic form over the f32 buffer, the table form over
    the int8 one (and, once per site and map, the table's build)."""
    ops = pack_densenet40_operands(qparams, stage_int8) if operands is None else operands
    for out in densenet40_int8_buffers(qparams, x, act_bits, act_impl, prealloc, stage_int8, ops):
        pass
    return densenet40_int8_head(qparams, out, act_bits, act_impl, ops, stage_int8)


def build_densenet40_int8(batch: int, device=None, seed: int = 0, stage_int8: bool = False, depth: int = 40):
    """(fn, args) pair: the int8 forward and (qparams, x) on fresh random
    params (torch generator seeds seed+1) and images (seed)."""
    dev = resolve_device(device)
    x = torch.randn((batch, 32, 32, 3), generator=torch.Generator().manual_seed(seed)).to(dev)
    params, stats = init_densenet_params(depth, torch.Generator().manual_seed(seed + 1), dev, stage_int8=stage_int8)
    return densenet40_int8_forward, (convert_densenet40(params, stats, stage_int8=stage_int8), x)
