"""Dropout as flax's nn.Dropout: each element (or, with broadcast_dims, each
slice) kept with probability 1 - rate, a kept value divided by 1 - rate,
the others 0; the identity outside training or at rate 0.

The mask is drawn from the `rng` the caller passes: a torch.Generator on
the CPU (the masks are then the same on every device, so that a card's
steps can be held to the CPU's), or an iterator of ready boolean masks,
taken in call order (the parity tests hand in JAX's masks this way).
JAX's masks come from jax.random, which the port does not reproduce.
Under a data-parallel step in gather mode (dist/collectives.py) each rank
draws the global batch's mask and keeps its own rows, so that the masks
are the 1-process run's.
"""

from __future__ import annotations

from typing import Iterator, Sequence, Union

import numpy as np
import torch
from torch import nn

from alignq_tpu_torch.dist import collectives as C

Rng = Union[torch.Generator, Iterator[torch.Tensor]]


def fold_in(seed: int, step: int) -> torch.Generator:
    """A CPU generator of (seed, step): the port's fold_in(PRNGKey(seed),
    step), one stream a train step."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) & (2**63 - 1))


class Dropout(nn.Module):
    """broadcast_dims: the axes the mask is shared over, in the input's own
    layout (an NCHW map's (2, 3): channel dropout, torch's Dropout2d)."""

    def __init__(self, rate: float, broadcast_dims: Sequence[int] = ()):
        super().__init__()
        self.rate, self.broadcast_dims = rate, tuple(broadcast_dims)

    def forward(self, x: torch.Tensor, train: bool = False, rng: Rng = None) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        shape = [1 if d in self.broadcast_dims else n for d, n in enumerate(x.shape)]
        per_row = 0 not in self.broadcast_dims
        if per_row:  # the global batch's mask under a data-parallel gather step; this rank keeps its rows
            shape[0] = C.global_rows(shape[0])
        if rng is None:
            raise ValueError("a train-mode dropout needs an rng")
        if isinstance(rng, torch.Generator):
            mask = torch.rand(shape, generator=rng, dtype=torch.float64) < keep
        else:
            mask = next(rng)
            if list(mask.shape) != shape:
                raise ValueError(f"a dropout mask of shape {tuple(mask.shape)}, the site takes {shape}")
        mask = C.local_rows(mask) if per_row else mask
        return torch.where(mask.to(x.device), x / keep, torch.zeros_like(x))
