"""Checkpoints of the full train state with torch.save (port of
alignq_tpu/train/checkpoint.py): parameters, BatchNorm statistics, the
optimizer's momentum traces and step count, the ADMM duals and the step,
so the duals survive a restart. One file per saved epoch under
job_dir/checkpoint; the max_to_keep best by eval top-1 are kept.

Over a mesh save and restore are collective: every rank calls them,
global rank 0 writes (after a barrier the others read). Local-mode duals
(each rank's (B/N, B/N) of every site) are gathered to the JAX package's
(N, B/N, B/N) layout, so that a checkpoint describes itself; it restores
on the same N, each rank taking its own. A column-parallel parameter and
its momentum trace are written whole, gathered over the model axis, and
restored as this rank's slice of the whole tensor: a tensor-parallel
checkpoint restores into one process, and the other way round."""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from alignq_tpu_torch.admm.state import ADMMSiteState
from alignq_tpu_torch.dist.sharding import local_slice, param_shards, whole
from alignq_tpu_torch.train.state import TrainState


class CheckpointManager:
    """mesh: the run's mesh (None: one process);
    local_duals: the duals are each rank's own (corr_mode 'local')."""

    def __init__(self, job_dir: str, max_to_keep: int = 3, mesh=None, local_duals: bool = False):
        self.dir = os.path.abspath(os.path.join(job_dir, "checkpoint"))
        os.makedirs(self.dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._index = os.path.join(self.dir, "index.json")
        self.axis = mesh.batch_axis() if mesh is not None else None
        self.local_duals = local_duals and self.axis is not None

    def _gather_duals(self, duals) -> dict:
        """Each site's (B/N, B/N) pair of every rank, as (N, B/N, B/N)."""
        out = {}
        for k in sorted(duals):
            pair = []
            for t in (duals[k].alter_d, duals[k].gamma):
                g = t.new_empty((self.axis.size * t.shape[0],) + tuple(t.shape[1:]))
                dist.all_gather_into_tensor(g, t.contiguous(), group=self.axis.group)
                pair.append(g.view((self.axis.size,) + tuple(t.shape)).cpu())
            out[k] = {"alter_d": pair[0], "gamma": pair[1]}
        return out

    def _path(self, epoch: int) -> str:
        return os.path.join(self.dir, f"epoch_{epoch}.pt")

    def _read_index(self) -> dict:
        if not os.path.isfile(self._index):
            return {}
        with open(self._index) as f:
            return {int(k): v for k, v in json.load(f).items()}

    def save(self, epoch: int, state: TrainState, metrics: Optional[dict] = None) -> None:
        duals = (self._gather_duals(state.admm_duals) if self.local_duals else
                 {k: {"alter_d": s.alter_d.cpu(), "gamma": s.gamma.cpu()} for k, s in state.admm_duals.items()})
        shards = param_shards(state.model)
        params = {k: whole(v, shards.get(k)).detach().cpu() for k, v in state.params.items()}
        trace = {k: whole(v, shards.get(k)).detach().cpu() for k, v in state.tx.trace.items()}
        if not dist.is_initialized() or dist.get_rank() == 0:
            self._write(epoch, state, params, trace, duals, metrics)
        if dist.is_initialized():
            dist.barrier()

    def _write(self, epoch: int, state: TrainState, params: dict, trace: dict, duals: dict,
               metrics: Optional[dict]) -> None:
        payload = {
            "params": params,
            "batch_stats": {k: v.detach().cpu() for k, v in state.batch_stats.items()},
            "opt_state": {"trace": trace, "count": state.tx.count},
            "admm_duals": duals,
            "step": state.step,
        }
        tmp = self._path(epoch) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(epoch))  # a crash mid-save leaves the last good file
        index = self._read_index()
        index[epoch] = float((metrics or {}).get("top1", 0.0))
        keep = sorted(index, key=lambda e: (index[e], e), reverse=True)[: self.max_to_keep]
        for e in set(index) - set(keep):
            if os.path.isfile(self._path(e)):
                os.remove(self._path(e))
            del index[e]
        with open(self._index + ".tmp", "w") as f:
            json.dump({str(k): v for k, v in index.items()}, f)
        os.replace(self._index + ".tmp", self._index)

    def latest_epoch(self) -> Optional[int]:
        index = self._read_index()
        return max(index) if index else None

    def load(self, epoch: int) -> dict:
        """A saved epoch's payload, its tensors on the CPU."""
        return torch.load(self._path(epoch), map_location="cpu", weights_only=True)

    def restore(self, state: TrainState, epoch: Optional[int] = None) -> Tuple[TrainState, int]:
        """Load a saved epoch (default: the latest kept) into state, in
        place, on the state's device; returns (state, start_epoch)."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            return state, 0
        payload = self.load(epoch)
        shards = param_shards(state.model)

        def mine(k, v):  # this rank's slice of a whole tensor it holds a slice of
            return local_slice(v, shards[k].dim, shards[k].axis) if k in shards else v

        with torch.no_grad():
            for table, saved in ((state.params, payload["params"]), (state.batch_stats, payload["batch_stats"])):
                if set(table) != set(saved):
                    raise ValueError(f"checkpoint {self._path(epoch)} holds another model")
                for k, v in table.items():
                    v.copy_(mine(k, saved[k]))
        dev = next(state.model.parameters()).device
        state.tx.load_state_dict({"trace": {k: mine(k, v).to(dev) for k, v in payload["opt_state"]["trace"].items()},
                                  "count": payload["opt_state"]["count"]})
        duals = payload["admm_duals"]
        if self.local_duals:
            n = {v["alter_d"].shape[0] for v in duals.values()}
            if duals and (n != {self.axis.size} or next(iter(duals.values()))["alter_d"].ndim != 3):
                raise ValueError(f"checkpoint {self._path(epoch)} holds no local duals of {self.axis.size} ranks")
            duals = {k: {"alter_d": v["alter_d"][self.axis.rank], "gamma": v["gamma"][self.axis.rank]}
                     for k, v in duals.items()}
        state.admm_duals = {k: ADMMSiteState(v["alter_d"].to(dev), v["gamma"].to(dev)) for k, v in duals.items()}
        state.step = int(payload["step"])
        return state, int(epoch)


def latest_payload(job_dir: str) -> Optional[dict]:
    """The payload of the latest epoch kept under another run's job_dir, or
    None where it holds no checkpoint (nothing is created there)."""
    if not os.path.isdir(os.path.join(job_dir, "checkpoint")):
        return None
    mgr = CheckpointManager(job_dir)
    epoch = mgr.latest_epoch()
    return None if epoch is None else mgr.load(epoch)
