"""ADMM dual state and its closed-form updates (port of
alignq_tpu/admm/state.py):

    V = D + gamma / rho
    Z = (1 - (mu/rho) / ||V||) * V  if ||V|| > mu/rho, else 0   (Frobenius norm)
    gamma <- gamma + rho * (D - Z)

both from the same fresh D and Z (the intended rule; batches are full, so
no padding).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from alignq_tpu_torch.admm.loss import ADMMConfig


class ADMMSiteState(NamedTuple):
    alter_d: torch.Tensor  # (B, B), the ADMM z variable
    gamma: torch.Tensor  # (B, B), the scaled dual


def init_site(generator: torch.Generator, dim: int, dtype=torch.float32, device=None) -> ADMMSiteState:
    """U[0, 1) matrices (torch.rand(dim, dim), as the reference), drawn on
    the CPU from `generator` and moved to `device`."""
    alter_d = torch.rand((dim, dim), generator=generator, dtype=dtype)
    gamma = torch.rand((dim, dim), generator=generator, dtype=dtype)
    return ADMMSiteState(alter_d.to(device), gamma.to(device))


@torch.no_grad()
def dual_update(state: ADMMSiteState, d: torch.Tensor, cfg: ADMMConfig = ADMMConfig()) -> ADMMSiteState:
    """One closed-form z + dual step of one site."""
    d = d.detach()
    v = d + state.gamma / cfg.rho
    v_norm = torch.linalg.norm(v)
    thresh = cfg.mu / cfg.rho
    shrink = 1.0 - thresh / torch.clamp_min(v_norm, 1e-12)
    alter_d = torch.where(v_norm > thresh, shrink * v, torch.zeros_like(v))
    gamma = state.gamma + cfg.rho * (d - alter_d)
    return ADMMSiteState(alter_d, gamma)


def dual_update_tree(
    states: Dict[str, ADMMSiteState], ds: Dict[str, torch.Tensor], cfg: ADMMConfig = ADMMConfig()
) -> Dict[str, ADMMSiteState]:
    """dual_update of every site in ds; the other sites unchanged."""
    return {name: dual_update(states[name], ds[name], cfg) if name in ds else s for name, s in states.items()}
