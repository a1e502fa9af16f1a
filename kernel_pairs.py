#!/usr/bin/env python3
"""This tree's depthwise, BN-act and K2 kernels against a parent commit's,
on one CUDA card, in one process.

    python3 kernel_pairs.py --parent DIR [--batch 256] [--forwards]

DIR holds a parent commit's `alignq_tpu_torch/` (for example from `git
archive <commit> alignq_tpu_torch | tar -x -C DIR`). Its csrc/dwconv.cu and
csrc/quantize.cu are built with this tree's nvcc flags into DIR's own
build directory and bound through the C interface the parent's library
has. dw_conv_launch comes in two forms: with a launch plan (the library
exports dw_plan_ints, which must match this tree's DwPlan) or, before the
plan, (B, H, W, C, stride); a parent with a plan of another layout is
refused. bn_act_launch and cdf_quant_launch have one form.

On the launches of one forward of each graph at --batch, recorded by
chip_smoke.py's record_launches:
- every distinct depthwise launch of MobileNet-V2 (erf codes): the
  parent's kernel and this tree's give the same bytes, and their times
  are taken in turns (parent, new, new, parent; each
  utils/cuda_timing.py graph_ms, from a cold L2; each side's two times
  averaged);
- every BN-act launch of DenseNet-40 over the f32 buffer (the arithmetic
  form on both sides) and over the int8 buffer (the parent's arithmetic
  kernel on the buffer against this tree's table form), likewise;
- K2 at the act-site sizes of batches 2048 and 256 (this tree's in the
  form its entry point gives the size), likewise.
Each kernel's times are summed over a forward's launches. With
--forwards, in a fresh process of the parent tree and of this one, in
turns (parent, new, new, parent): the three graphs' forwards at batches
256 and 1024 and the ResNet-20 slice route at 2048 (CUDA events, median of
20), and each graph's batch-256 forward under cuda_timing.profile (wall,
device busy and host issue time). Prints the card's name and power limit
beside the numbers and writes them to chiprun_out/kernel_pairs.json.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
# this tree's timing helpers, loaded by path: time_forwards runs with the
# parent tree's package on the path
_spec = importlib.util.spec_from_file_location("cuda_timing", REPO / "alignq_tpu_torch" / "utils" / "cuda_timing.py")
cuda_timing = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cuda_timing)


def in_turns(parent_fn, new_fn):
    """(parent ms, new ms) of one launch on the device: parent, new, new,
    parent, each cuda_timing.graph_ms; each side's two times averaged."""
    p1 = cuda_timing.graph_ms(parent_fn)
    n1 = cuda_timing.graph_ms(new_fn)
    n2 = cuda_timing.graph_ms(new_fn)
    p2 = cuda_timing.graph_ms(parent_fn)
    return (p1 + p2) / 2, (n1 + n2) / 2


class ParentKernels:
    """The parent tree's dwconv.cu and quantize.cu, built and bound."""

    def __init__(self, parent: Path):
        from alignq_tpu_torch.kernels import _build
        from alignq_tpu_torch.kernels.dwconv import DwPlan

        csrc = parent / "alignq_tpu_torch" / "csrc"
        out_dir = parent / "alignq_tpu_torch" / "_kernels_build"
        out_dir.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in ("dwconv", "quantize"):
            lib = out_dir / f"lib{name}_parent.so"
            procs[name] = (lib, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                                                  str(csrc / f"{name}.cu")],
                                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        self.libs = {}
        for name, (lib, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n{log}")
            self.libs[name] = ctypes.CDLL(str(lib))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        dwlib = self.libs["dwconv"]
        self.dw_takes_plan = hasattr(dwlib, "dw_plan_ints")
        if self.dw_takes_plan:
            dwlib.dw_plan_ints.restype = i
            if dwlib.dw_plan_ints() != len(DwPlan._fields):
                raise RuntimeError("the parent's depthwise plan has another layout than this tree's DwPlan")
            dwlib.dw_conv_launch.argtypes = [p, p, p, p, p, ctypes.POINTER(i), i, p, i, i, p]
        else:
            dwlib.dw_conv_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p, i, i, p]
        dwlib.dw_conv_launch.restype = i
        q = self.libs["quantize"]
        q.bn_act_launch.argtypes, q.bn_act_launch.restype = [p, i, p, p, p, ll, i, i, i, i, p, i, i, p], i
        q.cdf_quant_launch.argtypes, q.cdf_quant_launch.restype = [p, p, ll, p], i

    @staticmethod
    def _stream(t):
        import torch

        return torch.cuda.current_stream(t.device).cuda_stream

    def dw(self, x, op, plan, impl, act, out):
        from alignq_tpu_torch.kernels import _build
        from alignq_tpu_torch.kernels.dwconv import _MODE, _plan_ints

        bnd = None if act is None or act.bnd is None else act.bnd.data_ptr()
        tail = (_MODE[impl], bnd, 0 if act is None else act.g, int(act is not None and act.relu), self._stream(x))
        ptrs = (x.data_ptr(), op.w.data_ptr(), op.scale.data_ptr(), op.bias.data_ptr(), out.data_ptr())
        if self.dw_takes_plan:
            err = self.libs["dwconv"].dw_conv_launch(*ptrs, _plan_ints(plan), *tail)
        else:
            err = self.libs["dwconv"].dw_conv_launch(*ptrs, *x.shape, plan.stride, *tail)
        _build.check(err, "the parent's dw_conv_kernel")

    def bn_act(self, x, c_live, s, b, act, out):
        import torch

        from alignq_tpu_torch.kernels import _build
        from alignq_tpu_torch.kernels.quantize import _BN_ACT_MODE

        err = self.libs["quantize"].bn_act_launch(
            x.data_ptr(), int(x.dtype == torch.int8), s.data_ptr(), b.data_ptr(), out.data_ptr(),
            x.numel() // x.shape[-1], x.shape[-1], c_live, out.shape[-1], _BN_ACT_MODE[act.impl],
            None if act.bnd is None else act.bnd.data_ptr(), act.g, int(act.relu), self._stream(x))
        _build.check(err, "the parent's bn_act_kernel")

    def cdf_quant(self, x, out):
        from alignq_tpu_torch.kernels import _build

        err = self.libs["quantize"].cdf_quant_launch(x.data_ptr(), out.data_ptr(), x.numel(), self._stream(x))
        _build.check(err, "the parent's cdf_quant_kernel")


def kernel_pairs(parent: Path, batch: int, card: str) -> dict:
    """Each kernel's launches over one forward (K2: its act-site sizes),
    the parent's against this tree's: equal outputs, times in turns."""
    import torch

    import chip_smoke
    from alignq_tpu_torch.kernels import _build
    from alignq_tpu_torch.kernels import dwconv as DWm
    from alignq_tpu_torch.kernels import infer_densenet as D
    from alignq_tpu_torch.kernels import infer_mobilenet as M
    from alignq_tpu_torch.kernels import quantize as K2

    _build.build_all()
    old = ParentKernels(parent)
    dev = torch.device("cuda")
    rows = []

    def pair(kernel, shape, launches, parent_fn, new_fn, parent_out, new_out):
        parent_fn()
        new_fn()
        torch.cuda.synchronize()
        if not torch.equal(parent_out, new_out):
            raise AssertionError(f"{kernel} {shape}: this tree's kernel differs from the parent's")
        p_ms, n_ms = in_turns(parent_fn, new_fn)
        rows.append({"kernel": kernel, "shape": shape, "launches": launches, "parent_ms": p_ms, "ms": n_ms})
        print(f"{kernel} {shape} x{launches}: parent {p_ms:.4f} ms, this tree {n_ms:.4f} ms, outputs identical "
              f"[{card}]", flush=True)

    def launches(fwd, kinds):
        rec = chip_smoke.record_launches(fwd)
        return [(kind, args, n) for (kind, args), n in chip_smoke.distinct_launches(rec).values() if kind in kinds]

    with torch.inference_mode():
        _, (qp, x) = M.build_mobilenetv2_int8(batch, device=dev)
        ops = M.pack_mobilenetv2_operands(qp)
        for _, (xi, op, plan, impl, act), n in launches(lambda: M.mobilenetv2_int8_forward(qp, x, operands=ops),
                                                         ("dw",)):
            dtype = {"int32": torch.int32, "f32": torch.float32}.get(impl, torch.int8)
            out = torch.empty((xi.shape[0], plan.Ho, plan.Wo, xi.shape[3]), dtype=dtype, device=dev)
            ref = torch.empty_like(out)
            pair("depthwise", str((tuple(xi.shape), plan.stride)), n,
                 functools.partial(old.dw, xi, op, plan, impl, act, ref),
                 functools.partial(DWm._dw_launch, xi, op, plan, impl, act, out), ref, out)
        del qp, x, ops
        for stage_int8 in (False, True):
            _, (qp, x) = D.build_densenet40_int8(batch, device=dev, stage_int8=stage_int8)
            ops = D.pack_densenet40_operands(qp, stage_int8)
            D.densenet40_int8_forward(qp, x, stage_int8=stage_int8, operands=ops)  # builds the code tables
            kernel = "bn_act int8 buffer" if stage_int8 else "bn_act f32 buffer"
            for kind, args, n in launches(lambda: D.densenet40_int8_forward(qp, x, stage_int8=stage_int8,
                                                                             operands=ops), ("bn", "bn_table")):
                xi, c_live, c_out = args[0], args[1], args[-1]
                out = torch.empty((*xi.shape[:-1], c_out), dtype=torch.int8, device=dev)
                ref = torch.empty_like(out)
                if kind == "bn":
                    _, _, s, b, act, _ = args
                    new_fn = functools.partial(K2._bn_act_launch, xi, c_live, s, b, act, out)
                else:
                    table, act = args[2], args[4]
                    s, b = table.s, table.b
                    new_fn = functools.partial(K2._bn_table_launch, xi, c_live, table, out)
                pair(kernel, str((tuple(xi.shape), c_live)), n,
                     functools.partial(old.bn_act, xi, c_live, s, b, act, ref), new_fn, ref, out)
            del qp, x, ops
        gen = torch.Generator(device=dev).manual_seed(0)
        for bt in (2048, batch):
            for name, size in (("stem sites", bt * 1024 * 16), ("stage2 sites", bt * 256 * 32),
                               ("stage3 sites", bt * 64 * 64)):
                xi = torch.randn(size, generator=gen, device=dev) * 1.5
                ref, out = (torch.empty(size, dtype=torch.int8, device=dev) for _ in range(2))
                pair(f"K2 batch {bt}", name, 1, functools.partial(old.cdf_quant, xi, ref),
                     functools.partial(K2._k2_device_launch, xi, out), ref, out)
    sums = {}
    for r in rows:
        s = sums.setdefault(r["kernel"], {"parent_ms": 0.0, "ms": 0.0, "launches": 0})
        s["parent_ms"] += r["parent_ms"] * r["launches"]
        s["ms"] += r["ms"] * r["launches"]
        s["launches"] += r["launches"]
    for k, v in sums.items():
        print(f"{k} summed over its launches ({v['launches']}): parent {v['parent_ms']:.4f} ms, this tree "
              f"{v['ms']:.4f} ms [{card}]", flush=True)
    return {"rows": rows, "sums": sums}


def time_forwards(out_json: str) -> None:
    """In a fresh process whose alignq_tpu_torch is the tree under test:
    the three graphs' forwards at batches 256 and 1024 and the ResNet-20
    slice route at 2048, CUDA events, median of 20; each graph's batch-256
    forward under cuda_timing.profile; to out_json."""
    import torch

    from alignq_tpu_torch.kernels import _build
    from alignq_tpu_torch.kernels import infer_densenet as D
    from alignq_tpu_torch.kernels import infer_mobilenet as M
    from alignq_tpu_torch.kernels.infer import build_resnet20_int8, pack_int8_operands, resnet20_int8_forward

    _build.build_all()
    dev = torch.device("cuda")
    out, profiles = {}, {}
    graphs = [("densenet40 f32", D.build_densenet40_int8, D.densenet40_int8_forward, D.pack_densenet40_operands,
               {"stage_int8": False}),
              ("densenet40 stage_int8", D.build_densenet40_int8, D.densenet40_int8_forward,
               D.pack_densenet40_operands, {"stage_int8": True}),
              ("mobilenetv2", M.build_mobilenetv2_int8, M.mobilenetv2_int8_forward, M.pack_mobilenetv2_operands, {})]
    with torch.inference_mode():
        for label, build, fwd, pack, kw in graphs:
            for batch in (256, 1024):
                _, (qp, x) = build(batch, device=dev, **kw)
                ops = pack(qp, **kw)
                out[f"{label} batch {batch}"] = cuda_timing.median_ms(lambda: fwd(qp, x, operands=ops, **kw))
                if batch == 256:
                    prof = cuda_timing.profile(lambda: fwd(qp, x, operands=ops, **kw))
                    profiles[f"{label} batch {batch}"] = {k: v for k, v in prof.items() if k != "top5"}
                del qp, x, ops
        _, (qp, x) = build_resnet20_int8(2048, device=dev)
        ops = pack_int8_operands(qp)
        out["resnet20 slice route batch 2048"] = cuda_timing.median_ms(lambda: resnet20_int8_forward(
            qp, x, operands=ops, act_impl="poly", stream="int16", use_stage_kernel=True, use_pallas_1x1=True))
    Path(out_json).write_text(json.dumps({"forwards": out, "profiles": profiles}))


def forwards_in_turns(parent: Path, card: str) -> dict:
    """time_forwards in a fresh process of each tree: parent, new, new,
    parent. Forward times: each side's two medians averaged; profiles:
    each side's two runs."""
    results = {"parent": [], "new": []}
    for side, root in (("parent", parent), ("new", REPO), ("new", REPO), ("parent", parent)):
        out_json = REPO / "chiprun_out" / f"kernel_pairs_forwards_{side}.json"
        code = ("import importlib.util, sys; sys.path.insert(0, sys.argv[1]); "
                "spec = importlib.util.spec_from_file_location('kernel_pairs', sys.argv[2]); "
                "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m); m.time_forwards(sys.argv[3])")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", code, str(root.resolve()), str(Path(__file__).resolve()),
                        str(out_json)], cwd=root, check=True, timeout=900)
        results[side].append(json.loads(out_json.read_text()))
        print(f"forwards of the {side} tree: {results[side][-1]} ({time.perf_counter() - t0:.0f} s) [{card}]",
              flush=True)
    return {side: {"forwards": {k: (runs[0]["forwards"][k] + runs[1]["forwards"][k]) / 2
                                for k in runs[0]["forwards"]},
                   "profiles": [r["profiles"] for r in runs]}
            for side, runs in results.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="a directory holding the parent's alignq_tpu_torch/")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--forwards", action="store_true", help="also time the forwards of both trees, in turns")
    args = ap.parse_args(argv)
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("kernel_pairs: CUDA is not available", file=sys.stderr)
        return 2
    parent = Path(args.parent).resolve()
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    result = {"card": card, "batch": args.batch, "kernels": kernel_pairs(parent, args.batch, card)}
    if args.forwards:
        result["forwards"] = forwards_in_turns(parent, card)
        fw = {side: r["forwards"] for side, r in result["forwards"].items()}
        for k in fw["new"]:
            print(f"forward {k}: parent {fw['parent'][k]:.4f} ms, this tree {fw['new'][k]:.4f} ms [{card}]",
                  flush=True)
        for side in ("parent", "new"):
            for i, run in enumerate(result["forwards"][side]["profiles"]):
                for k, p in run.items():
                    print(f"profile {k}, {side} tree run {i + 1}: wall {p['wall_ms']:.3f} ms, busy {p['busy_ms']:.3f}, "
                          f"host issue {p['host_ms']:.3f} ({p['host_ms_per_launch'] * 1e3:.1f} us a launch, "
                          f"{p['launches_per_step']} launches), idle share {p['idle_share']:.3f} [{card}]", flush=True)
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "kernel_pairs.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
