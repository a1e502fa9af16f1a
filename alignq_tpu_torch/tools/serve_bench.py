"""Serving-engine latency and throughput on the host clock (port of
tools/serve_bench.py): the whole path a user waits on, the engine's
batching, the copy up, the forward, the copy down.

Rows (one JSON line each):
- xfer_mbps: one engine batch (f32 images) up to the device and back,
  MB/s (median of --reps, no engine);
- lat_b{1,64,256}: submit -> result latency of a request of that many
  images (median and least of --reps; under 256 the engine pads);
- stream_b256: images/s over 16 full batches submitted before any result
  is read.

The engine is serve.build_int8_resnet20_engine at engine batch 256: W8A8
ResNet-20, random weights from a seed, the default erf route. Timed as
chip_smoke.py engine_times times an engine.

    python -m alignq_tpu_torch.tools.serve_bench [--engine_batch 256] [--reps 5] [--smoke] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

STREAM_REQUESTS = 16


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description="serving latency and throughput of the INT8 ResNet-20 engine")
    p.add_argument("--engine_batch", type=int, default=256)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--smoke", action="store_true", help="engine batch 8, one rep, 2 streamed batches")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)

    from alignq_tpu_torch.device import resolve_device
    from alignq_tpu_torch.interop import init_preact_resnet_params
    from alignq_tpu_torch.serve import build_int8_resnet20_engine
    from alignq_tpu_torch.utils.launches import device_line

    dev = resolve_device(a.device)
    print(json.dumps({"card": device_line(dev)}), flush=True)
    eb, reps, n_stream = (8, 1, 2) if a.smoke else (a.engine_batch, a.reps, STREAM_REQUESTS)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    xb = np.random.RandomState(0).rand(eb, 32, 32, 3).astype(np.float32)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def round_trip():
        t0 = time.perf_counter()
        (torch.from_numpy(xb).to(dev) + 1.0).cpu().numpy()
        sync()
        return time.perf_counter() - t0

    for _ in range(2):  # settle
        round_trip()
    dt = statistics.median(round_trip() for _ in range(reps))
    emit({"name": "xfer_mbps", "value": xb.nbytes * 2 / dt / 1e6, "batch_bytes": xb.nbytes})

    params, stats = init_preact_resnet_params(20, torch.Generator().manual_seed(1), "cpu")
    engine = build_int8_resnet20_engine(params, stats, batch_size=eb, device=dev)
    try:
        engine.submit(xb).result(timeout=600)  # the whole request path once
        for n in sorted({1, min(64, eb), eb}):
            lats = []
            for _ in range(reps):
                t0 = time.perf_counter()
                out = engine.submit(xb[:n]).result(timeout=600)
                lats.append((time.perf_counter() - t0) * 1e3)
                if out.shape != (n, 10):
                    raise AssertionError(f"a request of {n} images got logits of shape {out.shape}")
            emit({"name": f"lat_b{n}", "median_ms": statistics.median(lats), "min_ms": min(lats)})
        t0 = time.perf_counter()
        for f in [engine.submit(xb) for _ in range(n_stream)]:
            f.result(timeout=600)
        dt = time.perf_counter() - t0
        emit({"name": f"stream_b{eb}", "imgs_per_sec": n_stream * eb / dt, "total_s": dt})
    finally:
        engine.close()
    return rows


if __name__ == "__main__":
    main()
