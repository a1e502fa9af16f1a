"""ADMM augmented-Lagrangian transformation loss (port of
alignq_tpu/admm/loss.py):

    loss = mu * mean|Z| + rho/2 * sqrt(mean((D - Z)^2)) + mean(gamma * |D - Z|)

Z (alter_d) and gamma are updated by closed-form assignment
(admm/state.py), not by gradients: the loss is differentiated in D only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ADMMConfig(NamedTuple):
    mu: float = 0.2
    rho: float = 0.3


def admm_loss(d: torch.Tensor, alter_d: torch.Tensor, gamma: torch.Tensor, cfg: ADMMConfig = ADMMConfig()) -> torch.Tensor:
    """The augmented-Lagrangian value of one site (batches are always full,
    so Z and gamma have D's shape)."""
    alter_d, gamma = alter_d.detach(), gamma.detach()
    loss_reg = cfg.mu * torch.mean(torch.abs(alter_d))
    loss_constraint = cfg.rho / 2.0 * torch.sqrt(torch.mean((d - alter_d) ** 2))
    loss_relax = torch.mean(gamma * torch.abs(d - alter_d))
    return loss_reg + loss_constraint + loss_relax
