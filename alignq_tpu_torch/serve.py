"""Batched INT8 inference serving (port of alignq_tpu/serve.py).

- requests accumulate into fixed-size batches; a remainder is padded with
  zeros and the padding dropped on the way out;
- one executor thread owns the device work, under torch.inference_mode()
  on the engine's device, overlapping host batching with device compute;
- the model is a frozen INT8 graph: built from trained params
  (build_int8_resnet20_engine) or loaded from an artifact of any CIFAR
  deploy family (engine_from_artifact: resnet20, resnet56, densenet40,
  mobilenetv2), ImageNet-layout trunk (resnet18, resnet34, resnet50:
  the pooled feature) or domain-adaptation net (dann, dsan, mdd,
  digit_dann: class logits), with its weights laid out for the kernels
  once.

Serving over a ('data', 'model') mesh (dist/mesh.py), one process a
device: rank 0's engine owns the queue and the batcher and sends each
padded batch to every rank (a broadcast over the world); each data rank
runs its contiguous rows, and the logits come back to rank 0 over its
data group. build_int8_resnet20_engine and engine_from_artifact lay each
rank's K1 weights out as its slice of the output channels over the model
axis (dist/sharding.py shard_operands), and K1's entry points gather the
channels back, so the forwards run unchanged; a trunk's per-batch requant takes the global
batch's max (the forward runs under the data axis). The other ranks'
engines serve in a loop until rank 0's close() stops them. The answers
are the one-process engine's, bit for bit.
"""

from __future__ import annotations

import contextlib
import functools
import queue
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from alignq_tpu_torch.device import resolve_device
from alignq_tpu_torch.dist.collectives import batch_axis, gather_rows, local_rows
from alignq_tpu_torch.dist.sharding import shard_operands


class BatchedInferenceEngine:
    """Fixed-batch async inference with padding.

    engine = BatchedInferenceEngine(fwd, qparams, batch_size=256,
                                    input_shape=(32, 32, 3))
    fut = engine.submit(images)        # (n, 32, 32, 3), n <= batch_size
    logits = fut.result()
    """

    def __init__(
        self,
        forward: Callable,
        params: Any,
        batch_size: int,
        input_shape: Tuple[int, ...],
        max_delay_ms: float = 2.0,
        mesh: Optional[Any] = None,
        device=None,
    ):
        """forward(params, x) -> logits, with params already on `device`.
        mesh: a mesh of the world (dist/mesh.py make_mesh): batch_size
        must divide by its data axis, and every rank builds its engine;
        rank 0's takes the requests."""
        if mesh is not None and batch_size % mesh.n_data:
            raise ValueError(f"batch_size {batch_size} not divisible by data axis size {mesh.n_data}")
        if mesh is not None and mesh.group is None:
            mesh = None  # a mesh of one device: no process group to serve over
        self.device = resolve_device(device)
        self.forward = forward
        self.params = params
        self.batch_size = batch_size
        self.input_shape = tuple(input_shape)
        self.max_delay = max_delay_ms / 1e3
        self.mesh = mesh
        self.primary = mesh is None or dist.get_rank() == 0
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run if self.primary else self._follow, daemon=True)
        # one forward before serving: builds the kernels, so the first
        # request does not pay for it
        if self.primary:
            self._infer(np.zeros((batch_size, *self.input_shape), np.float32))
        else:
            self._serve_one()
        self._thread.start()

    def submit(self, images: np.ndarray) -> "Future":
        if not self.primary:
            raise RuntimeError("rank 0's engine takes the requests of a mesh")
        if tuple(images.shape[1:]) != self.input_shape:
            raise ValueError(f"images of shape {images.shape}, engine takes (n, *{self.input_shape})")
        if not 0 < images.shape[0] <= self.batch_size:
            raise ValueError(f"{images.shape[0]} images, engine batch is {self.batch_size}")
        fut = Future()
        self._q.put((images, fut))
        return fut

    def _pin(self):
        return torch.cuda.device(self.device) if self.device.type == "cuda" else contextlib.nullcontext()

    def _infer(self, x: np.ndarray) -> np.ndarray:
        with torch.inference_mode(), self._pin():
            xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)
            if self.mesh is None:
                return self.forward(self.params, xt).cpu().numpy()
            dist.broadcast(torch.ones((), dtype=torch.int64, device=self.device), src=0)
            return self._mesh_forward(xt).cpu().numpy()

    def _mesh_forward(self, xt: torch.Tensor) -> torch.Tensor:
        """The padded batch from rank 0 (xt there; a buffer elsewhere), this
        data rank's rows through the forward, the logits gathered over the
        data group (the whole batch's on rank 0)."""
        dist.broadcast(xt, src=0)
        axis = self.mesh.batch_axis()
        with batch_axis(axis):
            out = self.forward(self.params, local_rows(xt, axis))
        return gather_rows(out.contiguous(), axis)

    def _serve_one(self) -> bool:
        """A rank other than 0: one command from rank 0 (a batch follows,
        or stop); False at stop."""
        with torch.inference_mode(), self._pin():
            cmd = torch.zeros((), dtype=torch.int64, device=self.device)
            dist.broadcast(cmd, src=0)
            if not int(cmd):
                return False
            self._mesh_forward(torch.empty((self.batch_size, *self.input_shape), device=self.device))
            return True

    def _follow(self):
        try:
            while self._serve_one():
                pass
        except BaseException as e:  # kept for close(), which raises it
            self._error = e

    def _run(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch: List[Tuple[np.ndarray, "Future"]] = [first]
            count = first[0].shape[0]
            t0 = time.perf_counter()
            while count < self.batch_size:
                remaining = self.max_delay - (time.perf_counter() - t0)
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if count + nxt[0].shape[0] > self.batch_size:
                    self._q.put(nxt)  # it starts the next batch
                    break
                batch.append(nxt)
                count += nxt[0].shape[0]

            x = np.concatenate([b[0] for b in batch], axis=0)
            pad = self.batch_size - x.shape[0]
            if pad:
                x = np.concatenate([x, np.zeros((pad, *self.input_shape), x.dtype)], axis=0)
            try:
                out = self._infer(x)
            except Exception as e:  # propagate to the futures instead of hanging them
                for _, fut in batch:
                    fut.set_exception(e)
                continue
            off = 0
            for images, fut in batch:
                n = images.shape[0]
                fut.set_result(out[off : off + n])
                off += n

    def close(self):
        """Rank 0 (or one process): stop the batcher, then the other ranks'
        engines. Another rank: wait until rank 0 stops it; a failure of its
        serving loop is raised here."""
        if not self.primary:
            self._thread.join()
            if self._error is not None:
                raise self._error
            return
        self._stop.set()
        # over a mesh the batcher's collectives must end before the stop's
        self._thread.join(timeout=None if self.mesh is not None else 5)
        if self.mesh is not None:
            with self._pin():
                dist.broadcast(torch.zeros((), dtype=torch.int64, device=self.device), src=0)


class Future:
    def __init__(self):
        self._ev = threading.Event()
        self._val: Optional[np.ndarray] = None
        self._exc: Optional[BaseException] = None

    def set_result(self, val):
        self._val = val
        self._ev.set()

    def set_exception(self, exc: BaseException):
        self._exc = exc
        self._ev.set()

    def result(self, timeout: float = 60.0) -> np.ndarray:
        if not self._ev.wait(timeout):
            raise TimeoutError("inference result not ready")
        if self._exc is not None:
            raise self._exc
        return self._val


def build_int8_resnet20_engine(
    params: Any, batch_stats: Any, batch_size: int = 256, mesh: Any = None,
    act_impl: str = "erf", stream: str = "int16", use_stage_kernel: bool = False,
    use_pallas_1x1: bool = False, fuse_skip: bool = False, device=None,
) -> BatchedInferenceEngine:
    """Freeze a PreActResNet's params (trees of tensors, or numpy arrays)
    into the INT8 graph on `device` and wrap it in an engine. The knobs
    select the deploy graph (kernels/infer.py resnet20_int8_forward); pair
    act_impl/stream with the QAT options that trained the model. mesh: a
    mesh of the world to serve over (every rank calls this)."""
    from alignq_tpu_torch.interop import params_from_numpy
    from alignq_tpu_torch.kernels.infer import (
        convert_resnet20,
        pack_int8_operands,
        resnet20_int8_forward,
    )

    dev = resolve_device(device)
    qparams = convert_resnet20(*params_from_numpy(params, batch_stats, dev))
    # the kernels' weight layouts (this rank's slices over a model axis),
    # made once here rather than per request
    fwd = functools.partial(
        resnet20_int8_forward, act_impl=act_impl, stream=stream,
        use_stage_kernel=use_stage_kernel, use_pallas_1x1=use_pallas_1x1,
        fuse_skip=fuse_skip, operands=shard_operands(pack_int8_operands(qparams), mesh),
    )
    return BatchedInferenceEngine(fwd, qparams, batch_size, (32, 32, 3), mesh=mesh, device=dev)


def engine_from_artifact(
    path: str, batch_size: int = 256, mesh: Any = None, device=None
) -> BatchedInferenceEngine:
    """Serve a frozen INT artifact (alignq_tpu_torch/export_int8.py or
    export_da_int8.py --save, or the JAX package's tools/export_int8.py or
    tools/export_da_int8.py --save) on `device` (default the CUDA card).

    The artifact's meta records the family and the deploy graph its weights
    were trained for; the deploy registry (kernels/deploy_registry.py)
    turns that into a structure-matching template, the family's forward and
    its operand layout. An int4-packed artifact (meta packed_int4, families
    with supports_packed_int4) is unpacked once here, and its codes laid out
    for the kernels like any other. A bins_int artifact's cutpoints are
    derived from the loaded scales and biases (PreAct ResNets only).
    mesh: a mesh of the world to serve over (every rank calls this, on
    the same file)."""
    from alignq_tpu_torch.kernels.artifact import load_int8_artifact
    from alignq_tpu_torch.kernels.convert import pack_qparams_int4, unpack_qparams_int4
    from alignq_tpu_torch.kernels.deploy_registry import DEPLOY_FAMILIES

    dev = resolve_device(device)
    with np.load(path) as raw:  # the meta first: it picks the template
        meta0 = {k.split("/", 1)[1]: raw[k] for k in raw.files if k.startswith("__meta__/")}
    model_name = str(np.asarray(meta0.get("model", "resnet20")))
    packed = bool(int(np.asarray(meta0.get("packed_int4", 0))))
    if model_name not in DEPLOY_FAMILIES:
        raise ValueError(f"artifact model {model_name!r} not in the deploy registry; have {sorted(DEPLOY_FAMILIES)}")
    family = DEPLOY_FAMILIES[model_name]
    if packed and not family.supports_packed_int4:
        raise ValueError(f"{model_name!r} has no int4-packed deploy path")
    bins_int = str(np.asarray(meta0.get("act_impl", ""))) == "bins_int"
    if bins_int and packed:
        raise ValueError("bins_int + packed_int4 serving not supported")
    if bins_int and "act_bits" not in meta0:
        # the cutpoints and the forward must share one grid: refuse here,
        # not at the first request
        raise ValueError("a bins_int artifact must record act_bits in its meta")
    template = family.template(meta0, dev)
    fwd = family.forward(meta0)
    qparams, _ = load_int8_artifact(path, pack_qparams_int4(template) if packed else template)
    if packed:
        qparams = unpack_qparams_int4(qparams)
    if bins_int:
        if model_name not in ("resnet20", "resnet56"):
            raise ValueError(f"bins_int serves the PreAct ResNets only, not {model_name!r}")
        from alignq_tpu_torch.kernels.infer import augment_int_cutpoints

        # derived from the loaded scale and bias, so that the file's schema
        # stays the same for every family (export saves them unaugmented)
        qparams = augment_int_cutpoints(qparams, int(np.asarray(meta0["act_bits"])))
    fwd = functools.partial(fwd, operands=shard_operands(family.operands(qparams, meta0), mesh))
    return BatchedInferenceEngine(fwd, qparams, batch_size, family.input_shape(meta0), mesh=mesh, device=dev)
