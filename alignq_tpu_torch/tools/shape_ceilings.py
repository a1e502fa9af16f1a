"""Per-shape conv ceilings of the served INT graphs, and the residual
account of the bench's graph (port of tools/shape_ceilings.py).

One yardstick, the kernel table's: each distinct conv of a served forward
is timed alone by utils/cuda_timing.py graph_ms (device time from a cold
L2, no host cost), and a family's conv ceiling is the sum over its
distinct convs of count x that time. What a perfect implementation of the
graph still pays beside the convs is mandatory work outside the ceiling,
so the fraction ceiling / e2e stays below 1 for it too.

- `conv_inventory(fn, *args)`: {Site: (count, call)} of the convs that one
  call of fn runs, recorded at the kernels' entry points (utils/launches.py
  ENTRY_POINTS: the K1 conv, the first-conv, depthwise, stem and digit
  kernels), which run on both devices, so the inventory is the same on the
  CPU; keyed by the Site that utils/launches.py launch_key keys a launch
  by, each with a call of it to time.
- `measure_shape(call)`: that conv's time alone.
- `preact_epilogue_inventory(depth, batch)`: the JAX tool's act-site, add
  and requant counts of the bench's PreActResNet graph.
- `epilogue_ops(depth, batch)`, `preact_graph_ceiling(...)`: every op that
  graph (kernels/infer.py resnet20_int8_stream, poly act sites, int8
  stream) runs outside its kernels, each priced alone by graph_ms: the
  stem's two casts, each block's relu of its conv0 codes, the widening of
  its conv1 (and skip) codes onto the int16 stream, an identity block's
  widened and scaled shortcut, the residual add and relu, the requant of
  each block's output at the next block's m, and the pool and head. The
  act sites are not priced: the port maps every one in K1's or the
  first-conv kernel's epilogue, so the conv ceiling holds them already.

    python -m alignq_tpu_torch.tools.shape_ceilings [--families resnet20,densenet40] [--e2e] [--graph]
        [--smoke] [--device cpu] [--out ceilings.json]

prints, per family, one JSON line {family, batch, ceiling_ms,
n_distinct_shapes[, e2e_ms, frac_of_achievable, imgs_per_sec][,
epilogue_isolated_ms, composition_bound_ms, epilogue_breakdown_ms,
residual_ms, residual_vs_mandatory, residual_accounted]} and one per conv
(count, ms a conv, int8 TOP/s, total ms), largest total first. On the CPU
(--device cpu) the times are the host clock's, not a device's. The JAX
tool's --qat rows (the QAT step's convs) have no counterpart: the port's
QAT convs are cuDNN's, not its kernels (qat_breakdown times the step).
"""

from __future__ import annotations

import argparse
import json

import torch

from alignq_tpu_torch.kernels.infer import _requant_codes, residual_multipliers, resnet20_int8_head
from alignq_tpu_torch.utils.launches import (
    CONV_KINDS,
    at_entry_points,
    conv_row,
    device_line,
    device_ms,
    entry_site,
    site_work,
)

BATCHES = {"resnet20": 1024, "resnet56": 1024, "densenet40": 1024, "mobilenetv2": 1024, "resnet50": 128}


def conv_inventory(fn, *args) -> dict:
    """{Site: (count, call)} of the convs of one call fn(*args): each
    distinct conv, how often it ran, and its last call (EntryCall)."""
    inv: dict = {}

    def hook(call):
        if call.kind in CONV_KINDS:
            site = entry_site(call)
            inv[site] = (inv.get(site, (0, None))[0] + 1, call)
        return call.fn(**call.args)

    with at_entry_points(hook):
        fn(*args)
    return inv


def conv_rows(inv: dict) -> list:
    """The inventory as sorted (count, cin, cout, hw, ksize, stride) rows,
    counts of one geometry summed (bench.py's RESNET20_CONVS form)."""
    rows: dict = {}
    for site, (count, _) in inv.items():
        geo = conv_row(site)
        rows[geo] = rows.get(geo, 0) + count
    return sorted((count, *geo) for geo, count in rows.items())


def measure_shape(call, runs: int = 10) -> float:
    """ms of one conv's call alone (utils/launches.py device_ms: graph_ms
    on the card)."""
    return device_ms(lambda: call.fn(**call.args), call.args["x"].device, runs)


def preact_epilogue_inventory(depth: int, batch: int):
    """(act, add, requant) {shape: count} of the bench's PreActResNet INT
    graph at depth and batch, as the JAX tool counts them: per stage of n
    = (depth-2)//6 blocks, the stem's act site (stage 1), 2 act sites a
    block and the skip's at a stage's first block; one residual add and
    relu a block at its output shape; one requant a block at its input
    shape (a stage's first block requantizes the larger map of the stage
    before, the first block the stem's codes). The act sites are in the
    kernels' epilogues; epilogue_ops lists what the port runs outside
    them."""
    n = (depth - 2) // 6
    s1, s2, s3 = (batch, 32, 32, 16), (batch, 16, 16, 32), (batch, 8, 8, 64)
    act = {s1: 1 + 2 * n, s2: 2 * n + 1, s3: 2 * n + 1}
    add = {s1: n, s2: n, s3: n}
    requant = {s1: n + 1, s2: n, s3: n - 1}
    return act, add, requant


def _head(out_c):
    gen = torch.Generator().manual_seed(2)
    c = out_c.shape[-1]
    qp = {"logit": {"kernel": (torch.randn((c, 10), generator=gen) * 0.1).to(out_c.device),
                    "bias": (torch.randn((10,), generator=gen) * 0.1).to(out_c.device)}}
    return lambda: resnet20_int8_head(qp, out_c)


# The ops resnet20_int8_stream (stream 'int8') runs outside its kernels:
# name -> (the dtypes of its tensor operands, a function of them and m
# that returns a call of the op as the graph makes it)
EPILOGUE_OPS = {
    "widen": ((torch.int8,), lambda c, m: lambda: c.to(torch.int16)),  # a conv's codes onto the int16 stream
    "narrow": ((torch.int16,), lambda c, m: lambda: c.to(torch.int8)),  # the stem's codes as the int8 stream
    "relu": ((torch.int8,), lambda a, m: lambda: torch.clamp_min(a, 0)),  # a block's conv0 codes
    "scale": ((torch.int8,), lambda c, m: lambda: m * c.to(torch.int16)),  # an identity block's shortcut
    "add_relu": ((torch.int16, torch.int16), lambda a, sc, m: lambda: torch.clamp_min(a + sc, 0)),
    # a block's output requantized at the next block's m
    "requant": ((torch.int16,), lambda k, m: lambda: _requant_codes(k, m, 127.0)),
    "head": ((torch.int16,), lambda c, m: _head(c)),  # the mean pool and the head
}


def epilogue_ops(depth: int, batch: int) -> dict:
    """{(op, shape, m): count} of what the bench's PreActResNet graph
    (int8 stream) runs outside its kernels at depth and batch (EPILOGUE_OPS;
    m the requant's and the scaled shortcut's multiplier, from
    kernels/infer.py residual_multipliers, else 0)."""
    n = (depth - 2) // 6
    stages = ((batch, 32, 32, 16), (batch, 16, 16, 32), (batch, 8, 8, 64))
    skips = [i > 0 and j == 0 for i in range(3) for j in range(n)]
    ms = residual_multipliers(skips)
    ops: dict = {}

    def add(op, shape, m=0):
        ops[(op, shape, m)] = ops.get((op, shape, m), 0) + 1

    add("widen", stages[0])
    add("narrow", stages[0])
    for i, skip in enumerate(skips):
        out = stages[i // n]
        if skip:
            add("widen", out)  # the skip conv's codes
        else:
            add("scale", out, ms[i])
        add("relu", out)
        add("widen", out)  # conv1's codes
        add("add_relu", out)
        if i + 1 < len(skips):
            add("requant", out, ms[i + 1])
    add("head", stages[-1])
    return ops


def epilogue_call(op: str, shape, m: int, dev):
    """A call of one EPILOGUE_OPS op on seeded operands of its shape."""
    dtypes, make = EPILOGUE_OPS[op]
    gen = torch.Generator().manual_seed(0)
    args = [torch.randint(0, 120, shape, generator=gen).to(dt).to(dev) for dt in dtypes]
    return make(*args, m)


_EPI_MS: dict = {}  # (op, shape, m, device) -> ms, one measurement a process


def measure_epilogue_op(op: str, shape, m: int, dev) -> float:
    """ms of one EPILOGUE_OPS op alone (device_ms)."""
    key = (op, tuple(shape), m, str(dev))
    if key not in _EPI_MS:
        _EPI_MS[key] = device_ms(epilogue_call(op, shape, m, dev), dev)
    return _EPI_MS[key]


def preact_graph_ceiling(depth: int, batch: int, conv_ceiling_ms: float, dev) -> dict:
    """The conv ceiling plus what the graph runs outside its kernels
    (epilogue_ops), each op timed alone (ms): {conv_ms, <op>_ms for each
    op, epilogue_ms, graph_ms}."""
    out = {"conv_ms": conv_ceiling_ms, **{f"{op}_ms": 0.0 for op in EPILOGUE_OPS}}
    for (op, shape, m), count in epilogue_ops(depth, batch).items():
        out[f"{op}_ms"] += count * measure_epilogue_op(op, shape, m, dev)
    out["epilogue_ms"] = sum(out[f"{op}_ms"] for op in EPILOGUE_OPS)
    out["graph_ms"] = conv_ceiling_ms + out["epilogue_ms"]
    return out


def served(family: str, batch: int, dev):
    """A call of `family`'s served forward at batch (poly act sites; the
    PreActResNets with the int8 stream, the bench's graph), operands laid
    out once."""
    from alignq_tpu_torch.tools.model_zoo_bench import forwards

    want = {"resnet20": f"resnet20_fast_b{batch}", "resnet56": f"resnet56_fast_b{batch}",
            "densenet40": f"densenet40_poly_b{batch}", "mobilenetv2": f"mobilenetv2_poly_b{batch}",
            "resnet50": f"resnet50_poly_b{batch}"}[family]
    for name, fwd in forwards(family, batch, dev):
        if name == want:
            return fwd
    raise ValueError(f"{family} has no row {want}")


def ceiling(inv: dict, runs: int = 10) -> tuple:
    """(ceiling ms, per-conv rows largest total first) of an inventory."""
    rows = []
    for site, (count, call) in inv.items():
        ms = measure_shape(call, runs)
        cin, cout, hw, k, stride = conv_row(site)
        rows.append({"kind": site.kind, "cin": cin, "cout": cout, "hw": hw, "k": k, "stride": stride,
                     "input": list(site.x), "mode": site.mode, "count": count, "ms_per_conv": ms,
                     "int8_tops": site_work(site)[1] / ms / 1e9, "total_ms": count * ms})
    rows.sort(key=lambda r: -r["total_ms"])
    return sum(r["total_ms"] for r in rows), rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="per-shape conv ceilings of the served INT graphs")
    p.add_argument("--families", default=",".join(BATCHES))
    p.add_argument("--e2e", action="store_true", help="also time each family's whole forward (same process)")
    p.add_argument("--graph", action="store_true",
                   help="the PreActResNets' residual account: what the graph runs outside its kernels")
    p.add_argument("--smoke", action="store_true", help="batch 8 (ResNet-50: 2), one run a time")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    p.add_argument("--out", default=None, help="also write the report as JSON here")
    a = p.parse_args(argv)

    from alignq_tpu_torch.device import resolve_device
    from alignq_tpu_torch.utils.cuda_timing import time_forward_ms

    dev = resolve_device(a.device)
    print(json.dumps({"card": device_line(dev)}), flush=True)
    runs = 1 if a.smoke else 10
    report = {"models": {}, "shapes": {}}
    for fam in filter(None, (f.strip() for f in a.families.split(","))):
        batch = (2 if fam == "resnet50" else 8) if a.smoke else BATCHES[fam]
        fwd = served(fam, batch, dev)

        def call(fwd=fwd):
            with torch.inference_mode():
                return fwd()

        inv = conv_inventory(call)
        ceiling_ms, rows = ceiling(inv, runs)
        model = {"family": fam, "batch": batch, "ceiling_ms": ceiling_ms, "n_distinct_shapes": len(inv)}
        if a.e2e:
            e2e = time_forward_ms(call, dev, runs, 0 if a.smoke else 3)
            model.update(e2e_ms=e2e, frac_of_achievable=ceiling_ms / e2e, imgs_per_sec=batch / e2e * 1e3)
        if a.graph and fam in ("resnet20", "resnet56"):
            gc = preact_graph_ceiling(20 if fam == "resnet20" else 56, batch, ceiling_ms, dev)
            model.update(epilogue_isolated_ms=gc["epilogue_ms"], composition_bound_ms=gc["graph_ms"],
                         epilogue_breakdown_ms={k[:-3]: v for k, v in gc.items() if k != "graph_ms"})
            if a.e2e:
                resid = model["e2e_ms"] - ceiling_ms
                model.update(residual_ms=resid, residual_vs_mandatory=resid / gc["epilogue_ms"],
                             residual_accounted=bool(resid <= gc["epilogue_ms"] * 1.1))
        report["models"][fam], report["shapes"][fam] = model, rows
        del inv, fwd, call  # the family's operands
        print(json.dumps(model), flush=True)
        for r in rows:
            print(json.dumps(r), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if a.out:
        with open(a.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
