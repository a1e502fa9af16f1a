"""The ADMM correlation's two data-parallel modes (port of
alignq_tpu/dist/corr.py).

The B x B correlation matrix is AlignQ's one cross-batch computation.
- 'gather' (exact): D over the GLOBAL batch. Each rank gathers every
  rank's flattened rows at each site (dist/collectives.py gather_rows) and
  computes the same global D; the duals are (B, B) and alike on every
  rank. This is what the JAX package's GSPMD step does.
- 'local' (block-diagonal): each rank's D over its own B/N rows, no
  communication on the corr path; each rank holds and anneals its own
  (B/N, B/N) duals. Checkpoints gather them to JAX's (N, B/N, B/N) layout
  (train/checkpoint.py), so that a checkpoint describes itself.

`make_local_corr_train_step` is train/steps.py's step in local mode: the
per-shard D and duals, the compressed gradient mean (cfg.grad_compression)
and the statistics' combine (MAX for every `amax`, the mean otherwise).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch
from torch import nn

from alignq_tpu_torch.admm.state import ADMMSiteState, init_site
from alignq_tpu_torch.dist.mesh import Mesh
from alignq_tpu_torch.train.config import TrainConfig
from alignq_tpu_torch.train.steps import make_train_step


def create_local_duals(generator: torch.Generator, site_names: Sequence[str], cfg: TrainConfig, n_data: int,
                       rank: int, dtype=torch.float32, device=None) -> Dict[str, ADMMSiteState]:
    """This rank's (B/N, B/N) duals of every site. Every shard's are drawn
    (U[0, 1) from `generator`, site by site in sorted order, shard within
    site, JAX's order) and rank r keeps shard r's."""
    if cfg.train_batch_size % n_data:
        raise ValueError(f"train_batch_size {cfg.train_batch_size} not divisible by data-axis size {n_data}")
    b_local = cfg.train_batch_size // n_data
    duals = {}
    for name in sorted(site_names):
        for shard in range(n_data):
            site = init_site(generator, b_local, dtype, device)
            if shard == rank:
                duals[name] = site
    return duals


def make_local_corr_train_step(model: nn.Module, cfg: TrainConfig, mesh: Mesh):
    """The local-mode train step on this rank's rows; the state's duals
    are this rank's (create_local_duals)."""
    return make_train_step(model, dataclasses.replace(cfg, corr_mode="local"), mesh=mesh)
