"""Bytes and costs of every weight format of ResNet-20 through the serving
stack (port of tools/artifact_bench.py).

Rows (one JSON line each):
- per format, raw in-memory bytes (`raw_bytes`, every leaf's) and on-disk
  npz bytes (`npz_bytes`, uncompressed, keyed as kernels/artifact.py keys
  an artifact) and their ratio to the f32 params (`vs_f32`): `f32_params`
  (the QAT model's params and BN statistics), `w8a8_int8` (the folded W8A8
  codes), `w4a4_int8_stored` (W4A4 codes one a byte), `w4a4_packed` (two a
  byte, kernels/convert.py pack_qparams_int4), the last with the pack and
  unpack times on the host clock (`pack_ms`, `unpack_ms`, the device
  drained; one-time costs of an export and a load);
- the serving check: the packed artifact and the unpacked one served by
  serve.engine_from_artifact answer the same requests with equal logits.

    python -m alignq_tpu_torch.tools.artifact_bench [--smoke] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch


def tree_bytes(tree) -> int:
    """Bytes of every leaf of a tree (tensors, arrays, host scalars as numpy
    holds them), as the JAX tool's tree_bytes counts them."""
    from alignq_tpu_torch.kernels.artifact import _leaves, _numpy

    return int(sum(_numpy(leaf).nbytes for _, leaf in _leaves(tree)))


def npz_bytes(tree, path: str) -> int:
    """Bytes on disk of the tree as an uncompressed npz under the artifact
    key scheme."""
    from alignq_tpu_torch.kernels.artifact import _leaves, _numpy

    np.savez(path, **{key: _numpy(leaf) for key, leaf in _leaves(tree)})
    return os.path.getsize(path)


def _ms(fn, dev) -> tuple:
    """(result, host ms) of fn, the device drained before and after."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, (time.perf_counter() - t0) * 1e3


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description="bytes and costs of ResNet-20's weight formats")
    p.add_argument("--smoke", action="store_true", help="engine batch 2")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)

    from alignq_tpu_torch.device import resolve_device
    from alignq_tpu_torch.interop import init_preact_resnet_params
    from alignq_tpu_torch.kernels.artifact import save_int8_artifact
    from alignq_tpu_torch.kernels.convert import pack_qparams_int4, unpack_qparams_int4
    from alignq_tpu_torch.kernels.infer import convert_resnet20
    from alignq_tpu_torch.serve import engine_from_artifact
    from alignq_tpu_torch.utils.launches import device_line

    dev = resolve_device(a.device)
    print(json.dumps({"card": device_line(dev)}), flush=True)
    params, stats = init_preact_resnet_params(20, torch.Generator().manual_seed(1), dev)
    qp8 = convert_resnet20(params, stats)
    qp4 = convert_resnet20(params, stats, weight_bits=4, act_bits=4)
    unpack_qparams_int4(pack_qparams_int4(qp4))  # once, so that the times are the codec's
    packed, pack_ms = _ms(lambda: pack_qparams_int4(qp4), dev)
    _, unpack_ms = _ms(lambda: unpack_qparams_int4(packed), dev)
    with tempfile.TemporaryDirectory(prefix="artifact_bench_") as tmp:  # the npz files, gone with the run
        rows = []
        for name, tree in (("f32_params", {"params": params, "batch_stats": stats}), ("w8a8_int8", qp8),
                           ("w4a4_int8_stored", qp4), ("w4a4_packed", packed)):
            rows.append({"format": name, "raw_bytes": tree_bytes(tree),
                         "npz_bytes": npz_bytes(tree, os.path.join(tmp, f"{name}.npz"))})
        rows[-1].update(pack_ms=pack_ms, unpack_ms=unpack_ms)
        for r in rows:
            r["vs_f32"] = r["raw_bytes"] / rows[0]["raw_bytes"]
            print(json.dumps(r), flush=True)

        meta = {"model": "resnet20", "act_bits": 4, "weight_bits": 4, "act_impl": "bins", "stream": "int16"}
        batch = 2 if a.smoke else 8
        xs = np.random.RandomState(0).randn(batch, 32, 32, 3).astype(np.float32)
        logits = {}
        for tag, tree, pk in (("packed", packed, 1), ("unpacked", qp4, 0)):
            path = os.path.join(tmp, f"art_w4_{tag}.npz")
            save_int8_artifact(path, tree, meta={**meta, "packed_int4": pk})
            engine = engine_from_artifact(path, batch_size=batch, device=dev)
            try:
                logits[tag] = engine.submit(xs).result(timeout=600)
            finally:
                engine.close()
        equal = bool(np.array_equal(logits["packed"], logits["unpacked"]))
        check = {"serve_packed_artifact": "ok" if equal else "differs",
                 "artifact_bytes": os.path.getsize(os.path.join(tmp, "art_w4_packed.npz")),
                 "logits_equal_unpacked": equal}
    print(json.dumps(check), flush=True)
    if not equal:
        raise AssertionError("the packed artifact's engine answers differently from the unpacked one's")
    return rows + [check]


if __name__ == "__main__":
    main()
