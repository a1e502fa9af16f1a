"""Device choice of the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; the CPU runs only where a caller asks
    for it (the tests do). Raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the plain "
                "PyTorch versions of the kernels"
            )
        if dev.index is None:  # a thread can only be pinned to an indexed card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
