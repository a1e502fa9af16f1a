"""Freeze conv+BN pairs into the INT8 inference form, and pack 4-bit codes
two to a byte (port of alignq_tpu/kernels/convert.py).

- weight: c = 2*Phi_{mean(w),std(w)}(w) - 1; q = round(c * g) int8;
- BatchNorm folds into a per-channel (scale, bias) epilogue on the int32
  accumulator:
      scale_c = act_scale * w_scale * gamma_c / sqrt(var_c + eps)
      bias_c  = beta_c - gamma_c * mu_c / sqrt(var_c + eps)
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from alignq_tpu_torch.quant.cdf import channel_stats, gaussian_cdf, tensor_stats

W_SCALE = 1.0 / 127.0


def grid_max(bits: int) -> int:
    """Symmetric code bound: 127 for int8, 7 for int4 (2^{b-1}-1)."""
    return 2 ** (bits - 1) - 1


class QConvInt8(NamedTuple):
    kernel_int8: torch.Tensor  # HWIO integer codes (int8 storage)
    scale: torch.Tensor  # (Cout,) f32 fused dequant * BN scale
    bias: torch.Tensor  # (Cout,) f32 fused BN shift


def quantize_weight_int8(w: torch.Tensor, bits: int = 8, channelwise: bool = False) -> torch.Tensor:
    """CDF-align then symmetric integer codes in [-g, g], stored int8."""
    mean, std = channel_stats(w) if channelwise else tensor_stats(w)
    c = 2.0 * gaussian_cdf(w, mean, std) - 1.0
    g = float(grid_max(bits))
    return torch.clamp(torch.round(c * g), -g, g).to(torch.int8)


def fold_conv_bn(
    kernel: torch.Tensor,
    bn_scale: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    act_scale: float,
    eps: float = 1e-5,
    bits: int = 8,
) -> QConvInt8:
    """Freeze one conv+bn pair into (integer kernel, per-channel scale/bias)."""
    k_int8 = quantize_weight_int8(kernel, bits)
    inv = bn_scale / torch.sqrt(bn_var + eps)
    scale = act_scale * (1.0 / grid_max(bits)) * inv
    bias = bn_bias - bn_mean * inv
    return QConvInt8(k_int8, scale.float(), bias.float())


# ---------------- INT4 on-wire packing ----------------
# Two 4-bit two's-complement codes per byte (even index -> low nibble),
# byte for byte the JAX package's format. The JAX graph keeps the weights
# packed in device memory and unpacks them in every forward; the port
# unpacks once, where a serving engine loads the artifact, and lays the
# codes out for its kernels from there (the results are the same).


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack int8-stored 4-bit codes pairwise along the last axis (even
    length) into uint8. Inverse of unpack_int4."""
    if codes.shape[-1] % 2:
        raise ValueError(f"last axis must be even, got {tuple(codes.shape)}")
    c = codes.to(torch.int32)
    return ((c[..., 0::2] & 0xF) | ((c[..., 1::2] & 0xF) << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 bytes -> int8 codes (sign-extended nibbles), doubling the last
    axis."""
    p = packed.to(torch.int32)
    lo, hi = p & 0xF, (p >> 4) & 0xF
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1).to(torch.int8)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """fn over the leaves of a tree of dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _is_kernel(leaf, dtype) -> bool:
    return torch.is_tensor(leaf) and leaf.dtype == dtype and leaf.ndim == 4


def pack_qparams_int4(qparams: Any) -> Any:
    """Pack every 4-D int8 kernel of a converted qparams tree (any family).
    For weight_bits=4 conversions: the codes must fit a nibble ([-7, 7])."""
    return tree_map(lambda leaf: pack_int4(leaf) if _is_kernel(leaf, torch.int8) else leaf, qparams)


def unpack_qparams_int4(qparams_packed: Any) -> Any:
    """Every 4-D uint8 leaf of a packed tree back to int8 codes."""
    return tree_map(lambda leaf: unpack_int4(leaf) if _is_kernel(leaf, torch.uint8) else leaf, qparams_packed)


def packed_int4_forward(forward: Callable, qparams_packed: Any, *args, **kwargs):
    """Run a forward on a packed-weight tree: the codes are unpacked first
    (a caller that serves many batches unpacks once, unpack_qparams_int4)."""
    return forward(unpack_qparams_int4(qparams_packed), *args, **kwargs)
