"""Warm starts from another run (port of alignq_tpu/train/pretrained.py).

As the reference's partial state-dict merge (main.py:62-82): a leaf of the
target whose name and shape are both in the source takes the source's
value; every other leaf keeps its fresh init. So a 4-bit ADMM run starts
from an 8-bit run's weights, and a quantized net from an FP32 pretrain.
Parameters and statistics (BatchNorm's, StageRequant's `amax`) are merged;
the optimizer's traces and the ADMM duals stay fresh.
"""

from __future__ import annotations

import logging
from typing import Dict, Tuple

import torch

from alignq_tpu_torch.train.checkpoint import latest_payload
from alignq_tpu_torch.train.state import TrainState

log = logging.getLogger(__name__)


@torch.no_grad()
def merge_pretrained(target: Dict[str, torch.Tensor], source: Dict[str, torch.Tensor]) -> Tuple[int, int]:
    """Copy into each tensor of `target` ({name: tensor}, in place, in its
    dtype and device) the source's tensor of the same name and shape.
    Returns (merged, total)."""
    merged = 0
    for name, t in target.items():
        s = source.get(name)
        if s is not None and tuple(s.shape) == tuple(t.shape):
            t.copy_(s)
            merged += 1
    return merged, len(target)


def load_pretrained(state: TrainState, source_job_dir: str) -> TrainState:
    """Warm-start the state's model from the latest checkpoint of another
    run's job_dir (its config may differ: bit width, ADMM, the head). A
    job_dir without a checkpoint leaves the state as it is."""
    payload = latest_payload(source_job_dir)
    if payload is None:
        log.warning("no checkpoint under %s: keeping the fresh init", source_job_dir)
        return state
    n, total = merge_pretrained(state.params, payload["params"])
    nb, _ = merge_pretrained(state.batch_stats, payload.get("batch_stats", {}))
    log.info("pretrained merge: %d/%d parameters and %d statistics from %s", n, total, nb, source_job_dir)
    return state
