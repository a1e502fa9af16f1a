"""Profiling, cost model and steady-state timing (port of
alignq_tpu/utils/profiling.py, which wraps the JAX profiler and XLA's
per-program cost analysis).

- `trace(log_dir)`: torch.profiler over a block, its Chrome trace written
  under log_dir (TensorBoard's and Perfetto's format).
- `cost_analysis(fn, *args)`: {flops, bytes_accessed,
  arithmetic_intensity} of one call, counted the same on the card and on
  the CPU. The port's kernels are counted at their entry points
  (utils/launches.py ENTRY_POINTS) by their own formulas (entry_work: a
  conv's 2*M*K*N, its bytes as conv_bound counts them), and what runs
  inside them is not counted again: on the CPU their plain versions are
  aten matmuls that a card never runs. The other dispatcher ops are
  counted as torch.utils.flop_counter.FlopCounterMode counts them, their
  bytes as each op's operand and result bytes (views and allocations move
  none). A product it has no formula for raises, as does a kernel launched
  from outside an entry point: the count is never short.
- `measure_steady_state(fn, *args, iters, warmup)`: seconds a call and the
  achieved flop rate: CUDA events on the card (utils/cuda_timing.py
  median_ms), the host clock on the CPU.
"""

from __future__ import annotations

import collections
import contextlib
import os
from typing import Callable, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_flatten

# products that FlopCounterMode does not count: met outside a kernel's
# entry point, cost_analysis raises rather than report a short count
_UNCOUNTED_PRODUCTS = ("_int_mm", "dot", "vdot", "mv", "addmv", "addbmm", "addr", "outer", "ger")
_NO_BYTES = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """torch.profiler over the block (the CPU, and CUDA where there is a
    card), its Chrome trace written into log_dir when the block ends:

        with profiling.trace("runs/trace"):
            for _ in range(5):
                state, m = train_step(state, x, y)
            torch.cuda.synchronize()
    """
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _tensor_bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))


class _Bytes(TorchDispatchMode):
    """Operand and result bytes of each dispatcher op; raises on a product
    that FlopCounterMode would leave uncounted."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in _UNCOUNTED_PRODUCTS:
            raise NotImplementedError(f"cost_analysis has no flop count for aten.{name}")
        out = func(*args, **kwargs)
        if not func.is_view and name not in _NO_BYTES:
            self.bytes += _tensor_bytes((args, kwargs, out))
        return out


def cost_analysis(fn: Callable, *args) -> dict:
    """{flops, bytes_accessed, arithmetic_intensity} of one call fn(*args)
    (module docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    from alignq_tpu_torch.kernels import _build
    from alignq_tpu_torch.utils.launches import at_entry_points, entry_work

    kernel = {"flops": 0, "bytes": 0}
    inside = collections.Counter()

    def counted(call):
        b, ops = entry_work(call)
        kernel["bytes"] += b
        kernel["flops"] += ops
        before = collections.Counter(_build.launches)
        with _disable_current_modes():
            out = call.fn(**call.args)
        inside.update(collections.Counter(_build.launches) - before)
        return out

    before = collections.Counter(_build.launches)
    flop_mode, byte_mode = FlopCounterMode(display=False), _Bytes()
    with at_entry_points(counted), flop_mode, byte_mode:
        fn(*args)
    outside = collections.Counter(_build.launches) - before - inside
    if outside:
        raise NotImplementedError(f"kernels launched outside their entry points, not counted: {dict(outside)}")
    flops = float(flop_mode.get_total_flops() + kernel["flops"])
    byts = float(byte_mode.bytes + kernel["bytes"])
    return {"flops": flops, "bytes_accessed": byts,
            "arithmetic_intensity": flops / byts if byts else float("inf")}


def measure_steady_state(fn, *args, iters: int = 20, warmup: int = 2) -> dict:
    """{seconds_per_iter, achieved_flops_per_sec} of fn(*args): on the card
    (any CUDA tensor among args) the median CUDA-event time of `iters`
    calls after `warmup`; else the host clock's, the device drained first
    (utils/cuda_timing.py time_forward_ms). The flops are cost_analysis's,
    and its errors are not swallowed."""
    from alignq_tpu_torch.utils.cuda_timing import time_forward_ms

    leaves, _ = tree_flatten(args)
    on_card = any(isinstance(t, torch.Tensor) and t.device.type == "cuda" for t in leaves)
    dev = torch.device("cuda" if on_card else "cpu")
    sec = time_forward_ms(lambda: fn(*args), dev, iters, warmup) / 1e3
    return {"seconds_per_iter": sec, "achieved_flops_per_sec": cost_analysis(fn, *args)["flops"] / sec}
