"""The AlignQ SGD (port of alignq_tpu/optim/factory.py), in the JAX chain's
order:
  1. weight decay added to the gradient;
  2. momentum trace t <- g + momentum * t (torch SGD without dampening);
  3. the PDF correction on the masked leaves, from the pre-update weights
     (the trace itself stays uncorrected);
  4. a per-leaf multiplier where one is given (the domain-adaptation
     heads' 10x, train/da.py);
  5. p <- p + (-lr) * u, lr from the schedule at the step count.

And `adam`, a working Adam with optax's defaults.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from alignq_tpu_torch.dist.collectives import model_shard
from alignq_tpu_torch.optim.correction import correction_factor

Schedule = Callable[[int], float]


class AlignQSGD:
    """SGD(momentum, wd) with the optional AlignQ correction; without it
    (use_correction=False or w_bit 32) torch's SGD as the baselines use it.
    Updates a {name: parameter} dict in place from a {name: gradient}
    dict. State: the momentum traces and the step count."""

    def __init__(self, learning_rate: Union[float, Schedule], *, momentum: float = 0.9,
                 weight_decay: float = 1e-4, w_bit: int = 8, lam: float = 1.0, lam2: float = 4.0,
                 correction_mask: Optional[Dict[str, bool]] = None, use_correction: bool = True,
                 channelwise: bool = False, channel_axis: int = -1, lr_mult: Optional[Dict[str, float]] = None):
        self.schedule = learning_rate if callable(learning_rate) else (lambda step: learning_rate)
        self.momentum, self.weight_decay = momentum, weight_decay
        self.w_bit, self.lam, self.lam2 = w_bit, lam, lam2
        self.correction_mask = correction_mask
        self.use_correction = use_correction and w_bit < 32
        self.channelwise, self.channel_axis = channelwise, channel_axis
        self.lr_mult = lr_mult or {}
        # {name: (model axis, split dim)} of the leaves that are a rank's
        # slice of a column-parallel weight (dist/sharding.py
        # shard_model): their correction takes the whole tensor's statistics
        self.shards: Dict[str, tuple] = {}
        self.trace: Dict[str, torch.Tensor] = {}
        self.count = 0

    def _corrected(self, name: str, p: torch.Tensor) -> bool:
        if not self.use_correction:
            return False
        if self.correction_mask is None:
            return p.ndim >= 2  # weight-like leaves; a constant 1-D leaf has std 0
        return self.correction_mask[name]

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        lr = self.schedule(self.count)
        updates = {}
        for name, p in params.items():
            u = grads[name]
            if self.weight_decay:
                u = u + self.weight_decay * p
            if self.momentum:
                t = self.trace.get(name)
                u = u if t is None else u + self.momentum * t
                self.trace[name] = u
            if self._corrected(name, p):
                with model_shard(*self.shards.get(name, (None, 0))):
                    u = u * correction_factor(p, self.w_bit, self.lam, self.lam2, self.channelwise,
                                              self.channel_axis)
            if name in self.lr_mult:
                u = u * self.lr_mult[name]
            updates[name] = u
        for name, p in params.items():
            p.add_(updates[name] * (-lr))
        self.count += 1

    def state_dict(self) -> dict:
        return {"trace": dict(self.trace), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.trace = dict(state["trace"])
        self.count = int(state["count"])


# the JAX package's name for the chain
alignq_sgd = AlignQSGD


class Adam:
    """optax.adam: m <- b1 m + (1 - b1) g, v <- b2 v + (1 - b2) g^2, each
    divided by 1 - b^t (the power in the leaf's dtype), u = m_hat /
    (sqrt(v_hat + eps_root) + eps), p <- p + (-lr) u. Not the reference's
    Adam, whose step body is commented out (a silent no-op). Same
    interface as AlignQSGD."""

    def __init__(self, learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0):
        self.schedule = learning_rate if callable(learning_rate) else (lambda step: learning_rate)
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        lr = self.schedule(self.count)
        t = self.count + 1
        for name, p in params.items():
            g = grads[name]
            mu = (1 - self.b1) * g + self.b1 * self.mu.get(name, torch.zeros_like(g))
            nu = (1 - self.b2) * g**2 + self.b2 * self.nu.get(name, torch.zeros_like(g))
            self.mu[name], self.nu[name] = mu, nu

            def debias(m, b):
                return m / (1 - torch.tensor(b, dtype=m.dtype) ** torch.tensor(float(t), dtype=m.dtype)).to(m.device)

            u = debias(mu, self.b1) / (torch.sqrt(debias(nu, self.b2) + self.eps_root) + self.eps)
            p.add_(u * (-lr))
        self.count = t

    def state_dict(self) -> dict:
        return {"mu": dict(self.mu), "nu": dict(self.nu), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.mu, self.nu, self.count = dict(state["mu"]), dict(state["nu"]), int(state["count"])


adam = Adam  # the JAX package's name
