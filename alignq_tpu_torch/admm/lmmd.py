"""LMMD, the class-conditional MMD loss of DSAN (port of
alignq_tpu/admm/lmmd.py): the reference's per-class host loop as one masked
Gram product, S_norm diag(present in both domains) S_norm^T."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from alignq_tpu_torch.dist import collectives as C


def gaussian_kernel(source: torch.Tensor, target: torch.Tensor, kernel_mul: float = 2.0, kernel_num: int = 5,
                    fix_sigma: Optional[float] = None) -> torch.Tensor:
    """The multi-bandwidth RBF kernel matrix over [source; target]."""
    total = torch.cat([source, target], dim=0)
    n = total.shape[0]
    sq = torch.sum((total[:, None, :] - total[None, :, :]) ** 2, dim=-1)
    bandwidth = fix_sigma if fix_sigma is not None else torch.sum(sq.detach()) / (n**2 - n)
    bandwidth = bandwidth / kernel_mul ** (kernel_num // 2)
    kernels = 0
    for i in range(kernel_num):
        kernels = kernels + torch.exp(-sq / (bandwidth * kernel_mul**i))
    return kernels


def _class_weights(s_label: torch.Tensor, t_soft: torch.Tensor, num_classes: int):
    """(w_ss, w_tt, w_st), each (B, B): the source one-hots and the target
    soft predictions, each normalized by its class sums (100 where a sum is
    0), their Gram products over the classes present in both domains (the
    target's by argmax), over the count of those classes (0 where none)."""
    dtype = t_soft.dtype
    s_vec = F.one_hot(s_label.long(), num_classes).to(dtype)
    s_sum = torch.sum(s_vec, dim=0, keepdim=True)
    s_norm = s_vec / torch.where(s_sum == 0, torch.full_like(s_sum, 100.0), s_sum)
    t_sum = torch.sum(t_soft, dim=0, keepdim=True)
    t_norm = t_soft / torch.where(t_sum == 0, torch.full_like(t_sum, 100.0), t_sum)
    present_s = torch.sum(s_vec, dim=0) > 0
    present_t = torch.sum(F.one_hot(torch.argmax(t_soft, dim=-1), num_classes), dim=0) > 0
    common = (present_s & present_t).to(dtype)
    count = torch.sum(common)

    def masked_gram(a, b):
        return (a * common) @ b.t()

    scale = torch.where(count > 0, 1.0 / torch.clamp_min(count, 1.0), torch.zeros_like(count))
    return masked_gram(s_norm, s_norm) * scale, masked_gram(t_norm, t_norm) * scale, masked_gram(s_norm, t_norm) * scale


def lmmd(source: torch.Tensor, target: torch.Tensor, s_label: torch.Tensor, t_soft: torch.Tensor,
         num_classes: int = 31, kernel_mul: float = 2.0, kernel_num: int = 5,
         fix_sigma: Optional[float] = None) -> torch.Tensor:
    """The class-conditional MMD of source and target features; the weights
    carry no gradient, and a NaN loss is 0. Under a data-parallel step in
    gather mode (dist/collectives.py) every input is the global batch's
    (each rank's rows gathered), and every rank computes the same loss."""
    source, target, s_label, t_soft = (C.gather_rows(t) for t in (source, target, s_label, t_soft))
    b = source.shape[0]
    with torch.no_grad():
        w_ss, w_tt, w_st = _class_weights(s_label, t_soft.detach(), num_classes)
    kernels = gaussian_kernel(source, target, kernel_mul, kernel_num, fix_sigma)
    ss, tt, st = kernels[:b, :b], kernels[b:, b:], kernels[:b, b:]
    loss = torch.sum(w_ss * ss + w_tt * tt - 2.0 * w_st * st)
    return torch.where(torch.isnan(loss), torch.zeros_like(loss), loss)
