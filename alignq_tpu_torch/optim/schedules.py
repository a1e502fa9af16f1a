"""Learning-rate schedules (port of alignq_tpu/optim/schedules.py)."""

from __future__ import annotations

from typing import Callable, Sequence

import torch

MAX_STEP = 2**31 - 1  # the JAX step counter is int32; a later boundary is never reached


def multistep_schedule(base_lr: float, milestones_epochs: Sequence[int], gamma: float, steps_per_epoch: int,
                       warmup_epochs: float = 0.0) -> Callable[[int], float]:
    """MultiStepLR in train steps (milestones in epochs), as optax's
    piecewise_constant_schedule: the LR is multiplied by gamma from the
    step that equals a boundary on (a repeated boundary counts once).
    warmup_epochs > 0 scales it by min(1, (step + 1) / warmup_steps)."""
    boundaries = sorted({min(int(e) * steps_per_epoch, MAX_STEP) for e in milestones_epochs})
    warmup_steps = warmup_epochs * steps_per_epoch

    def schedule(step: int) -> float:
        v = 1.0
        for b in boundaries:
            if step >= b:
                v = gamma * v
        lr = base_lr * v
        if warmup_steps > 0:
            lr = lr * min(1.0, (step + 1) / warmup_steps)
        return lr

    return schedule


def dann_lr(base_lr: float, p, alpha: float = 10.0, beta: float = 0.75) -> float:
    """base_lr / (1 + alpha p)^beta: in Python's double for a host p (as
    the JAX function computes it), in p's dtype for a 0-d tensor p, with a
    true division (torch's `scalar / tensor` multiplies by a rounded
    reciprocal)."""
    den = (1.0 + alpha * p) ** beta
    return float(torch.tensor(base_lr, dtype=den.dtype) / den) if torch.is_tensor(den) else base_lr / den


def dann_schedule(base_lr: float, total_steps: int, alpha: float = 10.0, beta: float = 0.75) -> Callable[[int], float]:
    """dann_lr at p = step / total_steps, in f32 at any precision: JAX
    divides its int32 step count into an f32 p even under x64. The per-step
    form of the reference's per-epoch DANN schedule."""

    def schedule(step: int) -> float:
        return dann_lr(base_lr, torch.tensor(step, dtype=torch.float32) / max(total_steps, 1), alpha, beta)

    return schedule
