"""Times on the card from CUDA events.

`median_ms` times calls as the host makes them: back-to-back calls of a
function, so where a launch takes less device time than its host-side
cost (a ctypes call and PyTorch's stream lookup, ~20 us), it measures the
host. `graph_ms` times a function's launches on the device, from a cold
L2: the launches are captured once in a CUDA graph, each after a read that
evicts the L2, and replayed, so that neither the host's cost nor operands
left in the L2 by the launch before are in the time. `profile` splits a
call's wall time into the device's busy time and the host's issue time.
`time_forward_ms` is `median_ms` on the card and the host clock on the
CPU.
"""

from __future__ import annotations

import statistics
import time

RUNS, WARMUP = 20, 3
L2_FLUSH_BYTES = 128 << 20  # read before each timed call: over twice an H100's 50 MB L2


def _event_ms(fn, runs: int) -> list:
    import torch

    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def median_ms(fn, runs: int = RUNS, warmup: int = WARMUP, per_call: int = 1) -> float:
    """Median over `runs` of the CUDA-event time of `per_call` back-to-back
    calls of fn, divided by per_call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(per_call):
            fn()

    return statistics.median(_event_ms(calls, runs)) / per_call


def time_forward_ms(fn, device, runs: int = RUNS, warmup: int = WARMUP) -> float:
    """Median ms of one call of fn: CUDA events on the card (median_ms), the
    host clock on the CPU, after `warmup` calls and a drained device (no
    device metric)."""
    if device.type == "cuda":
        return median_ms(fn, runs=runs, warmup=warmup)
    import torch

    for _ in range(warmup):
        fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def graph_ms(fn, runs: int = RUNS, per_graph: int = 20) -> float:
    """Device time of one call of fn, a function that only launches work on
    the current stream (no synchronisation), from a cold L2. Two CUDA
    graphs are captured (capture mode 'relaxed', as launches query
    occupancy): per_graph times a read of L2_FLUSH_BYTES and then fn, and
    per_graph times the read alone. They are replayed in turns; the result
    is the difference of their medians over `runs` replays, divided by
    per_graph. So it holds fn's cold reads and the write-back of what fn
    wrote. What fn allocates comes from the graph's pool."""
    import torch

    fn()  # builds and loads the kernel, or picks the library's algorithm, outside the capture
    torch.cuda.synchronize()
    flush = torch.zeros(L2_FLUSH_BYTES // 4, device=torch.cuda.current_device())

    def capture(with_fn: bool):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(per_graph):
                flush.sum()
                if with_fn:
                    fn()
        return graph

    timed, reads = capture(True), capture(False)
    for _ in range(WARMUP):
        timed.replay()
        reads.replay()
    torch.cuda.synchronize()
    t_timed, t_reads = [], []
    for _ in range(runs):
        t_timed += _event_ms(timed.replay, 1)
        t_reads += _event_ms(reads.replay, 1)
    return (statistics.median(t_timed) - statistics.median(t_reads)) / per_graph


def profile(fn, iters: int = 5) -> dict:
    """Where a call of fn spends its time, per call, after warm-up: the
    host's issue time (the median time fn takes to return, the stream
    drained before each call), then under torch.profiler the wall time of
    `iters` calls, the device's busy time and idle share (1 - busy / wall),
    the kernel launches and the five largest kernels."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    issue = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        issue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / iters / 1e3
    if busy_ms == 0:
        raise AssertionError("the profiler recorded no device time")
    launches = sum(e.count for e in kernels) // iters
    host_ms = statistics.median(issue)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms, "host_ms": host_ms,
            "host_ms_per_launch": host_ms / max(launches, 1), "launches_per_step": launches,
            "top5": [{"kernel": e.key[:100], "device_ms": e.self_device_time_total / iters / 1e3,
                      "calls": e.count // iters} for e in kernels[:5]]}
