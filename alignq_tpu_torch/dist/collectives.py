"""Cross-rank reductions of a data-parallel run (port of
alignq_tpu/dist/collectives.py), and the batch couplings that GSPMD
inserted by itself in the JAX package.

Compressed means of a gradient dict (`compressed_tree_pmean`), JAX's three
modes, each leaf's result as JAX's:
- 'f32': all-reduce, then / n.
- 'bf16': cast to bf16, all-reduce in bf16, cast back, / n.
- 'int8_gather': per-leaf symmetric int8 codes on a scale that every rank
  shares (the MAX all-reduce of |x|'s max, times 1/127 as XLA rewrites
  JAX's / 127, at least 1e-30); the
  codes all-gathered, summed over the ranks in f32 (exact: integers),
  times the scale, / n.
The transport is bucketed: one all-reduce per dtype ('f32', 'bf16'), or
one MAX all-reduce of the leaves' maxima and one flat int8 all-gather.
"/ n" is a multiply by 1/n, as XLA compiles JAX's division by the
constant (the same values for n = 2 and 4; at n = 3 the division would
differ by an ulp).

Batch couplings. The JAX package's gather mode jits the one-device step
over a sharded batch, and XLA makes every reduction over the batch
dimension global. The port runs one process per device and makes each of
them global here: `batch_sum` (a differentiable sum over the ranks),
`batch_max` (no gradient), `gather_rows` (a differentiable all-gather of
rows in rank order). Each is the identity unless a step has entered
`batch_axis(axis)`; the layers that couple the batch (BatchNorm,
StageRequant, QuantAct's D, LMMD, LSQ's gradient scale, LLSQ's octave,
dropout's masks) call them. The backward of a sum or a gather sums the
ranks' gradients (the gather's as a reduce-scatter: each rank receives
the sum of its own rows only), so that a loss term every rank computes
alike (the trans loss of a gathered D) comes back N times, and the
gradient mean's / N cancels it: the mean of the ranks' gradients is the
gradient of the 1-process loss.

The model axis (tensor parallelism). A column-parallel layer holds its
slice of the output channels; three helpers carry its values across the
axis: `enter_shard` (a replicated input: the identity forward, the ranks'
gradients summed backward, as each rank's is the part its slice
contributed), `gather_channels` (the slices' outputs concatenated in rank
order; backward this rank's slice, since every model rank computes the
same gradient after the gather) and, for the quantizer's statistics of a
sliced weight under `model_shard`, `whole_mean_std` and `shard_whole`
(the statistics of the gathered whole tensor, the bits one process
computes: at W8 the PDF correction's sawtooth turns a summation-order
difference into a different update; the gradient of the mean and std
summed over the ranks, as they feed every slice) and `shard_numel`.
Each is the identity without a model axis.

The active axis is read in a forward only. Autograd runs a backward on
threads of its own, where the step's axis is not set, so a custom
autograd Function keeps the axis its forward read in ctx (as the sum and
the gather here do); `current_axis()` called from a backward raises
rather than let such a Function reduce over its own shard silently.

Transport under gloo on the card: gloo takes CUDA tensors for every
operation used here (all-reduce SUM and MAX, all_gather_into_tensor,
reduce-scatter; f32, f64, bf16 and int8 in torch 2.11) and refuses only
alltoall, which torch.distributed.nn's all_gather takes in its backward;
the row gather here has its own backward, and nothing is staged through
the host.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

MODES = ("f32", "bf16", "int8_gather")


@dataclasses.dataclass(frozen=True)
class BatchAxis:
    """An axis of the mesh: its process group, this rank's coordinate and
    the axis size. The data axis a step's batch is split over, or the
    model axis a tensor's channels are split over."""

    group: Any
    rank: int
    size: int


_AXIS: contextvars.ContextVar = contextvars.ContextVar("alignq_batch_axis", default=None)
_SHARD: contextvars.ContextVar = contextvars.ContextVar("alignq_model_shard", default=None)


@contextlib.contextmanager
def batch_axis(axis: Optional[BatchAxis]):
    """Within the block, the batch couplings reduce over `axis` (None: the
    identity)."""
    token = _AXIS.set(axis)
    try:
        yield axis
    finally:
        _AXIS.reset(token)


def current_axis() -> Optional[BatchAxis]:
    """The axis the running step entered (None: none). A forward's read
    only: from a backward it raises, since autograd's threads do not see
    the step's axis (a custom Function keeps its forward's in ctx)."""
    if torch._C._current_autograd_node() is not None:
        raise RuntimeError("the batch axis was read in a backward, where the step's axis is not set: "
                           "keep the axis the forward read in ctx")
    return _AXIS.get()


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        y = x.contiguous().clone()
        dist.all_reduce(y, group=axis.group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.rows = axis, x.shape[0]
        out = x.new_empty((axis.size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=axis.group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.new_empty((ctx.rows,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous(), group=ctx.axis.group)
        return out, None


class _EnterShard(torch.autograd.Function):
    """A replicated value entering a computation split over the model axis:
    the identity forward; backward, the sum of the ranks' gradients (each
    rank's holds the part its slice contributed)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


class _GatherChannels(torch.autograd.Function):
    """Every model rank's slice of dimension `dim`, concatenated in rank
    order; backward, this rank's slice of the gradient (every model rank
    computes the same gradient downstream of the gather)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.width = axis, dim, x.shape[dim]
        return gather_slices(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        r = ctx.axis.rank * ctx.width
        return g.narrow(ctx.dim, r, ctx.width).contiguous(), None, None


def gather_slices(x: torch.Tensor, axis: BatchAxis, dim: int) -> torch.Tensor:
    """The ranks' slices of x along `dim`, concatenated in rank order (no
    gradient); the identity on an axis of one."""
    if axis.size == 1:
        return x
    dim %= x.ndim
    out = x.new_empty((axis.size * x.numel(),))
    dist.all_gather_into_tensor(out, x.contiguous().reshape(-1), group=axis.group)
    parts = out.view((axis.size,) + tuple(x.shape))
    return torch.cat(parts.unbind(0), dim=dim)


@contextlib.contextmanager
def model_shard(axis: Optional[BatchAxis], dim: int = 0):
    """Within the block the tensor being quantized is this rank's slice,
    along `dim`, of a tensor split over the model axis `axis` (None: a
    whole tensor): its per-tensor statistics (whole_mean_std,
    shard_whole, shard_numel) are the whole tensor's."""
    token = _SHARD.set(None if axis is None else (axis, dim))
    try:
        yield axis
    finally:
        _SHARD.reset(token)


def _shard():
    """(model axis, split dim) of the slice being quantized, or None. A
    forward's read only, as current_axis."""
    if torch._C._current_autograd_node() is not None:
        raise RuntimeError("the model shard was read in a backward: keep the axis the forward read in ctx")
    return _SHARD.get()


@torch.no_grad()
def shard_whole(x: torch.Tensor) -> torch.Tensor:
    """The whole tensor from every rank's slice x (no gradient); x itself
    for a whole tensor."""
    shard = _shard()
    return x if shard is None else gather_slices(x.detach(), shard[0], shard[1])


class _WholeMeanStd(torch.autograd.Function):
    """(mean, std) (ddof 1) of the whole tensor from this rank's slice:
    forward, torch's mean and std of the gathered whole tensor (the bits
    one process computes); backward, the ranks' gradients of the two
    (each the part its slice's computation contributed) summed in one
    all-reduce, then the slice's share: g_mean / n + g_std (x - mean) /
    ((n - 1) std)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        whole = gather_slices(x.detach(), axis, dim)
        mean, std = whole.mean(), whole.std(correction=1)
        ctx.save_for_backward(x, mean, std)
        ctx.axis, ctx.n = axis, whole.numel()
        return mean, std

    @staticmethod
    def backward(ctx, g_mean, g_std):
        x, mean, std = ctx.saved_tensors
        g = torch.stack([g_mean, g_std])
        dist.all_reduce(g, group=ctx.axis.group)
        return g[0] / ctx.n + g[1] * (x - mean) / ((ctx.n - 1) * std), None, None


def whole_mean_std(x: torch.Tensor):
    """The whole tensor's (mean, std) (ddof 1) from this rank's slice x
    under model_shard (differentiable); None for a whole tensor."""
    shard = _shard()
    return None if shard is None else _WholeMeanStd.apply(x, *shard)


def shard_numel(n: int) -> int:
    """The whole tensor's element count from a slice's."""
    shard = _shard()
    return n if shard is None else n * shard[0].size


def enter_shard(x: torch.Tensor, axis: Optional[BatchAxis]) -> torch.Tensor:
    """A replicated x taken into a computation on this rank's slice of the
    model axis (the input of a column-parallel layer, a scalar parameter
    of a sliced weight's quantizer); the identity without one."""
    return x if axis is None or axis.size == 1 else _EnterShard.apply(x, axis)


def gather_channels(x: torch.Tensor, axis: Optional[BatchAxis], dim: int = 1) -> torch.Tensor:
    """The whole output of a column-parallel layer from this rank's slice
    of dimension `dim` (differentiable); x without an axis."""
    return x if axis is None or axis.size == 1 else _GatherChannels.apply(x, axis, dim)


def batch_sum(x: torch.Tensor, axis: Optional[BatchAxis] = None) -> torch.Tensor:
    """x summed over the ranks of the axis (default: the active one)."""
    axis = axis or current_axis()
    return x if axis is None else _SumOverRanks.apply(x, axis)


@torch.no_grad()
def batch_max(x: torch.Tensor, axis: Optional[BatchAxis] = None) -> torch.Tensor:
    """The elementwise max over the ranks; no gradient."""
    axis = axis or current_axis()
    if axis is None:
        return x
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=axis.group)
    return y


def gather_rows(x: torch.Tensor, axis: Optional[BatchAxis] = None) -> torch.Tensor:
    """Every rank's rows of x, in rank order (the global batch)."""
    axis = axis or current_axis()
    return x if axis is None else _GatherRows.apply(x, axis)


def global_rows(n_local: int, axis: Optional[BatchAxis] = None) -> int:
    """The global batch's size from a rank's."""
    axis = axis or current_axis()
    return n_local if axis is None else n_local * axis.size


def local_rows(t: torch.Tensor, axis: Optional[BatchAxis] = None) -> torch.Tensor:
    """This rank's contiguous rows of a global-batch tensor."""
    axis = axis or current_axis()
    if axis is None:
        return t
    bl = t.shape[0] // axis.size
    return t[axis.rank * bl:(axis.rank + 1) * bl]


@torch.no_grad()
def mean_over(t: torch.Tensor, group) -> torch.Tensor:
    """The mean of t over the ranks of `group` (a new tensor)."""
    y = t.detach().contiguous().clone()
    dist.all_reduce(y, group=group)
    return y * (1.0 / dist.get_world_size(group))


def compressed_pmean(x: torch.Tensor, group=None, mode: str = "f32") -> torch.Tensor:
    """Mean of x over the ranks of `group` with the selected wire
    compression."""
    return compressed_tree_pmean({"x": x}, group, mode)["x"]


@torch.no_grad()
def compressed_tree_pmean(tree: Dict[str, torch.Tensor], group=None, mode: str = "f32") -> Dict[str, torch.Tensor]:
    """compressed_pmean of every leaf of a flat dict (a gradient dict)."""
    if mode not in MODES:
        raise ValueError(f"unknown compression mode {mode!r}")
    names = list(tree)
    xs = [tree[k].detach().contiguous() for k in names]
    n = dist.get_world_size(group)
    out: Dict[str, torch.Tensor] = {}
    by_dtype: Dict[torch.dtype, list] = {}
    for i, x in enumerate(xs):
        by_dtype.setdefault(x.dtype, []).append(i)
    if mode in ("f32", "bf16"):
        for dtype, idx in by_dtype.items():
            flat = torch.cat([xs[i].reshape(-1) for i in idx])
            if mode == "bf16":
                flat = flat.to(torch.bfloat16)
            dist.all_reduce(flat, group=group)
            flat = flat.to(dtype) * (1.0 / n)
            for i, part in zip(idx, torch.split(flat, [xs[i].numel() for i in idx])):
                out[names[i]] = part.reshape(xs[i].shape)
        return out
    # int8_gather: one scale a leaf, shared by every rank through a MAX
    scales = [None] * len(xs)
    for dtype, idx in by_dtype.items():
        amax = torch.stack([xs[i].abs().max() if xs[i].numel() else xs[i].new_zeros(()) for i in idx])
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp_min(amax * (1.0 / 127.0), 1e-30)  # XLA's rewrite of JAX's / 127
        for j, i in enumerate(idx):
            scales[i] = scale[j]
    codes = torch.cat([torch.clamp(torch.round(x / s), -127, 127).to(torch.int8).reshape(-1)
                       for x, s in zip(xs, scales)])
    gathered = codes.new_empty(n * codes.numel())  # gloo takes the concatenation's shape, not the stack's
    dist.all_gather_into_tensor(gathered, codes, group=group)
    gathered = gathered.view(n, -1)
    off = 0
    for name, x, s in zip(names, xs, scales):
        total = gathered[:, off:off + x.numel()].to(torch.float32).sum(0) * s
        out[name] = (total * (1.0 / n)).to(x.dtype).reshape(x.shape)
        off += x.numel()
    return out
