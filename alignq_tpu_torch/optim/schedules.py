"""Learning-rate schedules (port of alignq_tpu/optim/schedules.py;
dann_schedule waits for the domain-adaptation drivers, ROADMAP queue 1,
Domain adaptation)."""

from __future__ import annotations

from typing import Callable, Sequence

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
