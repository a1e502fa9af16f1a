"""Where the time of one INT8 ResNet-20 forward goes on the card.

    python -m alignq_tpu_torch.profile_forward [--batch 2048] [--act_impl poly] [--plain_route] [--stream int8]

Runs the forward (default: the stage kernel and K1 1x1 route, poly act
grid, int16 stream; `--plain_route --stream int8` is
alignq_tpu_torch/bench.py's graph) under torch.profiler after warm-up, and prints the
device time by PyTorch op and by kernel, the window's wall time and the
device's idle share, 1 - busy / wall (below 0 where kernels overlap). The
weights are laid out once before the window, as an engine does. Writes the
same to chiprun_out/profile_forward_<route>_<act_impl>_<stream>_<batch>.json.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--act_impl", default="poly")
    ap.add_argument("--plain_route", action="store_true", help="every conv through K1, no stage kernel")
    ap.add_argument("--stream", choices=("int16", "int8"), default="int16", help="the residual stream's storage")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_forward: CUDA is not available", file=sys.stderr)
        return 2

    from alignq_tpu_torch.kernels.infer import build_resnet20_int8, pack_int8_operands

    fwd, (qp, x) = build_resnet20_int8(args.batch)
    kw = {"act_impl": args.act_impl, "stream": args.stream, "operands": pack_int8_operands(qp)}
    if not args.plain_route:
        kw.update(use_stage_kernel=True, use_pallas_1x1=True)
    with torch.inference_mode():
        for _ in range(3):
            fwd(qp, x, **kw)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                fwd(qp, x, **kw)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters

    def dev_us(evt):
        return evt.self_device_time_total / args.iters

    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted((e for e in events if e.device_type == cuda and dev_us(e) > 0), key=dev_us, reverse=True)
    ops = sorted((e for e in events if e.key.startswith("aten::") and dev_us(e) > 0), key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    if busy_ms == 0:
        print("profile_forward: the profiler recorded no device time", file=sys.stderr)
        return 1
    card = torch.cuda.get_device_name(0)
    knobs = {k: v for k, v in kw.items() if k != "operands"}
    out = {
        "card": card, "batch": args.batch, "kwargs": knobs, "wall_ms_per_forward": wall_ms,
        "device_busy_ms_per_forward": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
        "ops": [{"op": e.key, "device_ms": dev_us(e) / 1e3, "calls": e.count // args.iters} for e in ops[:25]],
        "kernels": [{"kernel": e.key[:120], "device_ms": dev_us(e) / 1e3, "calls": e.count // args.iters}
                    for e in kernels[:25]],
    }
    print(f"{card}: batch {args.batch} {knobs}: wall {wall_ms:.3f} ms/forward, device busy {busy_ms:.3f} ms "
          f"(idle share {out['idle_share']:.3f})")
    for section in ("ops", "kernels"):
        print(f"-- device time by {section[:-1]} (ms per forward, calls per forward)")
        for row in out[section][:15]:
            name = row.get("op") or row.get("kernel")
            print(f"  {row['device_ms']:9.4f} {row['calls']:5d}  {name}")
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    route = "plain" if args.plain_route else "slice"
    (out_dir / f"profile_forward_{route}_{args.act_impl}_{args.stream}_{args.batch}.json").write_text(
        json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
