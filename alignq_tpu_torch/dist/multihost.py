"""Multi-process execution (port of alignq_tpu/dist/multihost.py), over
`torch.distributed`, one process per device.

- `initialize()` joins the rendezvous. Its arguments default to the
  environment: ALIGNQ_COORDINATOR, ALIGNQ_NUM_PROCESSES and
  ALIGNQ_PROCESS_ID first, then torchrun's MASTER_ADDR:MASTER_PORT,
  WORLD_SIZE, RANK and LOCAL_RANK. The backend is NCCL on the card, each
  rank on `cuda:LOCAL_RANK`, and gloo on the CPU; gloo on the card is
  asked for explicitly (`backend='gloo'`), and is the only way two ranks
  can share one card: NCCL refuses a card twice.
  Every rendezvous has a timeout (ALIGNQ_DIST_TIMEOUT seconds, 300 by
  default), so that a rank that dies fails the others instead of hanging
  them.
- data: every process builds the same global batch from its seeded
  loader and keeps its contiguous rows [p*B/N, (p+1)*B/N)
  (`local_batch_slice`, which dist/sharding.py shard_batch applies on a
  mesh) and moves only those to its device (`place_batch_multihost`).
  The global batch, where one is wanted, is those rows all-gathered in
  global order (`global_batch_from_local`): the port's form of JAX's
  global array.
- observability: `is_primary()` gates the log file, the metric writers and
  the config dump; checkpoints are collective (every rank calls save and
  restore, rank 0 writes; train/checkpoint.py).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
_DEVICE: Optional[torch.device] = None


def _env_int(*names) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None, backend: Optional[str] = None,
               timeout_s: Optional[float] = None) -> torch.device:
    """Join the process group (idempotent); returns this rank's device.

    device: None for the card (this rank's `cuda:LOCAL_RANK`, or
    `cuda:LOCAL_RANK % count` under gloo), or 'cpu'. backend: 'nccl' or
    'gloo'; None: NCCL on the card, gloo on the CPU."""
    global _DEVICE
    if dist.is_initialized():
        return _DEVICE if _DEVICE is not None else torch.device("cpu")
    coordinator_address = coordinator_address or os.environ.get("ALIGNQ_COORDINATOR")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = _env_int("ALIGNQ_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("ALIGNQ_PROCESS_ID", "RANK")
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs a coordinator HOST:PORT, the number of processes and this "
                         "process's id (arguments, ALIGNQ_* or torchrun's environment)")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = process_id if local_rank is None else local_rank
    cpu = device is not None and torch.device(device).type == "cpu"
    backend = backend or ("gloo" if cpu else "nccl")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    if cpu:
        if backend != "gloo":
            raise ValueError("a CPU run takes the gloo backend")
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass device='cpu' for a gloo run on the CPU")
        count = torch.cuda.device_count()
        if backend == "nccl" and local_rank >= count:
            raise ValueError(f"local rank {local_rank} has no card of its own ({count} here): NCCL refuses two ranks "
                             f"on one card; take backend='gloo' to share it")
        dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
    if timeout_s is None:
        timeout_s = float(os.environ.get("ALIGNQ_DIST_TIMEOUT", "300"))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                            rank=int(process_id), timeout=datetime.timedelta(seconds=timeout_s))
    _DEVICE = dev
    return dev


def shutdown() -> None:
    """Leave the process group (after a barrier), where one was joined."""
    global _DEVICE
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    _DEVICE = None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def active() -> bool:
    """True when this run spans more than one process."""
    return process_count() > 1


def tree_map(f, tree):
    """f over the leaves of dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, dict):
        return {k: tree_map(f, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(f, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(f, v) for v in tree)
    return f(tree)


def local_batch_slice(batch: Any, num_processes: Optional[int] = None, process_id: Optional[int] = None) -> Any:
    """This process's contiguous rows [p*B/N, (p+1)*B/N) of a global batch
    that every process holds alike (numpy arrays or tensors, in tuples,
    lists or dicts). A batch that N does not divide raises ValueError."""
    n = process_count() if num_processes is None else num_processes
    p = process_index() if process_id is None else process_id

    def f(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"global batch {b} not divisible by {n} processes")
        bl = b // n
        return x[p * bl:(p + 1) * bl]

    return tree_map(f, batch)


def global_batch_from_local(local_batch: Any, mesh) -> Any:
    """The global batch from every data rank's local rows (tensors in
    tuples, lists or dicts), in global row order: an all-gather over the
    mesh's data group, so every rank holds it (the port's form of JAX's
    global array; a mesh of one device returns the rows). Each data rank's
    rows must be its contiguous slice, as local_batch_slice cuts them."""
    from alignq_tpu_torch.dist.collectives import gather_rows

    axis = mesh.batch_axis()
    return local_batch if axis is None else tree_map(lambda x: gather_rows(torch.as_tensor(x), axis), local_batch)


def place_batch_multihost(batch: Any, mesh, device=None) -> Any:
    """A host-identical global batch placed for a step over the mesh: this
    process's contiguous rows on its data axis moved to `device` (default
    this rank's, initialize's), as tensors; nothing else moves."""
    dev = torch.device(device) if device is not None else (_DEVICE or torch.device("cpu"))
    rows = local_batch_slice(batch, mesh.n_data, mesh.rank)
    return tree_map(lambda x: torch.as_tensor(x).to(dev), rows)
