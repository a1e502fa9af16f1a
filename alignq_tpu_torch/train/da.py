"""Domain-adaptation training: DANN, DSAN, MDD and the digit DANN (port of
alignq_tpu/train/da.py), on one device: the CUDA card unless the caller
asks for the CPU.

- DANN (and the digit net): source pass, then target pass on the BatchNorm
  statistics the source pass left (the step keeps the target pass's);
  loss = source class CE + source and target domain CE + the ADMM trans
  terms of both passes; the duals update from the source pass's D. The
  GRL coefficient ramps as grl_alpha(step / total_steps).
- DSAN: one forward of both batches; loss = class CE + param * lambda *
  LMMD (+ trans), lambda = 2 / (1 + e^(-10 epoch / epochs)) - 1.
- MDD: DANN's two passes, the MDD objective on the concatenated outputs,
  the reversal annealed by mdd_grl_coeff.
- The optimizer (make_da_optimizer): weight decay, momentum, the AlignQ
  correction ('ours' with use_correction), the heads' 10x and the DANN
  schedule, in optax's chain order.
- Dropout (the digit net's, MDD's) draws from a CPU generator folded from
  (seed, step) (nn/dropout.py fold_in); a step's `rng` argument takes
  another generator, or an iterator of masks (the parity tests').

Host ramps are evaluated as jnp evaluates them: f32 (f64 for an f64 model,
as JAX under x64); the schedule in f32 always.

A mesh larger than one device trains data-parallel (one process per
device, dist/multihost.py initialize first) in gather mode only, as the
JAX package's DA placement: every batch coupling of the DA losses is
global (the ADMM corr's D over gathered rows, LMMD's kernel matrices over
both domains' gathered features, BatchNorm's statistics, dropout's masks
drawn for the global batch; dist/collectives.py), the gradients' f32 mean
follows, and each step equals the 1-process step over the global batch.
'local', a compressed gradient mean and a 'model' axis raise JAX's
ValueErrors; rank 0 alone writes the log file and the config.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from alignq_tpu_torch.admm.lmmd import lmmd
from alignq_tpu_torch.admm.loss import ADMMConfig, admm_loss
from alignq_tpu_torch.admm.state import dual_update, init_site
from alignq_tpu_torch.device import resolve_device
from alignq_tpu_torch.dist import multihost
from alignq_tpu_torch.dist.collectives import batch_axis, compressed_tree_pmean, mean_over
from alignq_tpu_torch.dist.sharding import replicated, shard_batch
from alignq_tpu_torch.models.mdd import mdd_grl_coeff, mdd_loss
from alignq_tpu_torch.nn.dropout import fold_in
from alignq_tpu_torch.optim.correction import build_correction_mask
from alignq_tpu_torch.optim.factory import AlignQSGD
from alignq_tpu_torch.optim.schedules import dann_lr, dann_schedule  # noqa: F401  (dann_lr: the JAX module's name)
from alignq_tpu_torch.train.config import TrainConfig
from alignq_tpu_torch.data.loader import to_tensor
from alignq_tpu_torch.train.loop import to_device, true_f32
from alignq_tpu_torch.train.state import TrainState, admm_sites
from alignq_tpu_torch.train.steps import cross_entropy_loss, mean_metrics
from alignq_tpu_torch.utils.logging_utils import dump_config, get_logger
from alignq_tpu_torch.utils.meters import AverageMeter

DANN_HEADS = ("class_classifier", "domain_classifier", "classifier", "discriminator")
DSAN_HEADS = ("cls_fc", "bottle")
MDD_HEADS = ("bottleneck_fc", "bottleneck_bn", "classifier", "classifier_adv")


@dataclasses.dataclass(frozen=True)
class DAConfig(TrainConfig):
    """The domain-adaptation flags (reference options_office.py and the
    digit driver's options)."""

    src_data: str = "dslr"
    tgt_data: str = "webcam"
    train_split: float = 0.8
    src_only_flag: bool = False
    alpha: float = 10.0  # the GRL and LR ramps' coefficient
    param: float = 0.3  # DSAN's LMMD weight
    bottle_neck: bool = True
    img_size: int = 28  # the digit models
    num_classes: int = 31
    # the digit driver's plain SGD has no PDF correction; the office drivers' does
    use_correction: bool = True
    # 'align': the FP32 CDF-only stage (the reference DSAN's default), seen at abitW == 32 only
    stage: str = "quant"
    srcweight: float = 3.0  # MDD's source-margin weight
    lr: float = 1e-3
    weight_decay: float = 5e-4
    head_lr_mult: float = 10.0


def grl_alpha(p, dtype=torch.float32) -> float:
    """alpha(p) = 2 / (1 + e^(-10 p) + 1e-6) - 1, in `dtype` (the exp's
    last place may differ from XLA's)."""
    e = torch.exp(torch.tensor(-10.0 * p, dtype=dtype))
    return float(torch.tensor(2.0, dtype=dtype) / (1.0 + e + 1e-6) - 1.0)


def make_da_optimizer(cfg: DAConfig, params: Dict[str, torch.Tensor], total_steps: int,
                      head_prefixes: Sequence[str]) -> AlignQSGD:
    """SGD with the DANN schedule at lr / head_lr_mult, the leaves under
    the head prefixes (top-level names) at head_lr_mult times it, and the
    AlignQ correction on the conv kernels for method 'ours'."""
    mask = build_correction_mask(params, exclude=tuple(cfg.correction_exclude))
    mults = {n: cfg.head_lr_mult for n in params if n.split(".")[0] in head_prefixes}
    return AlignQSGD(dann_schedule(cfg.lr / cfg.head_lr_mult, total_steps, cfg.alpha), momentum=cfg.momentum,
                     weight_decay=cfg.weight_decay, w_bit=cfg.bitW, lam=cfg.lam, lam2=cfg.lam2, correction_mask=mask,
                     use_correction=cfg.method == "ours" and cfg.use_correction, channel_axis=0, lr_mult=mults)


def _build_da_placement(cfg: TrainConfig):
    """The data-parallel mesh of a DA run: None for one device. JAX's
    refusals first, before any process group: 'local', a compressed
    gradient mean, a 'model' axis."""
    if math.prod(cfg.mesh_shape) <= 1:
        return None
    if cfg.corr_mode != "gather":
        raise ValueError("distributed DA training supports corr_mode='gather' only: the ADMM corr and LMMD losses "
                         "are global-batch-coupled, and the per-shard 'local' approximation is "
                         "classification-driver-only")
    if getattr(cfg, "grad_compression", "f32") != "f32":
        raise ValueError("grad_compression is a corr_mode='local' feature; the DA steps are the one-device steps over "
                         "the global batch, whose gradient mean is exact (f32)")
    if math.prod(tuple(cfg.mesh_shape)[1:]) > 1:
        raise ValueError("DA training distributes over the data axis only")
    from alignq_tpu_torch.dist import make_mesh

    return make_mesh(tuple(cfg.mesh_shape), tuple(cfg.mesh_axes))


def _da_observability(cfg: DAConfig):
    """The run's logger: rank 0 writes job_dir/logger.log and the config
    dump; rank p logs warnings and worse to job_dir/logger.p{p}.log."""
    import logging

    if multihost.is_primary():
        logger = get_logger(f"{cfg.job_dir}/logger.log")
        dump_config(cfg, cfg.job_dir)
    else:
        logger = get_logger(f"{cfg.job_dir}/logger.p{multihost.process_index()}.log")
        logger.setLevel(logging.WARNING)
    return logger


def create_da_state(generator: torch.Generator, model: nn.Module, cfg: DAConfig, input_shape, total_steps: int,
                    head_prefixes: Sequence[str]) -> TrainState:
    """The DA optimizer and the ADMM duals (U[0, 1) from `generator`, site
    after site in sorted order) for a model already on its device."""
    p = next(model.parameters())
    duals = {}
    if cfg.admm:
        for name in admm_sites(model, cfg.train_batch_size, input_shape, rng=torch.Generator()):
            duals[name] = init_site(generator, cfg.train_batch_size, p.dtype, p.device)
    tx = make_da_optimizer(cfg, dict(model.named_parameters()), total_steps, head_prefixes)
    return TrainState(step=0, model=model, tx=tx, admm_duals=duals)


def _trans(sink, duals, admm_cfg):
    total = 0.0
    for name in sorted(sink or {}):
        site = duals[name]
        total = total + admm_loss(sink[name], site.alter_d, site.gamma, admm_cfg)
    return total


def _apply(state: TrainState, loss: torch.Tensor, src_sink, admm_cfg, axis=None) -> None:
    """Gradients of every parameter (0 where the loss does not reach one,
    as JAX's; their f32 mean over the ranks of a data axis), the
    optimizer's update, the duals from the source pass's D, the step
    count."""
    params = state.params
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), grads)}
    if axis is not None:
        grads = compressed_tree_pmean(grads, axis.group, "f32")
    state.tx.step(params, grads)
    for name, d in (src_sink or {}).items():
        state.admm_duals[name] = dual_update(state.admm_duals[name], d, admm_cfg)
    state.step += 1


def _check(state: TrainState, model: nn.Module) -> None:
    if state.model is not model:
        raise ValueError("the state holds another model than this step trains")


def _dtype(model: nn.Module):
    return next(model.parameters()).dtype


def _axis(mesh):
    return mesh.batch_axis() if mesh is not None else None


def _finish(metrics: dict, axis) -> dict:
    return metrics if axis is None else mean_metrics(metrics, axis.group)


def make_dann_train_step(model: nn.Module, cfg: DAConfig, mesh=None):
    """train_step(state, xs, ys, xt, alpha, rng=None) -> (state, metrics)
    over a (source, target) batch pair, for DANN and the digit net. mesh:
    a data-parallel mesh (the batches this rank's rows), gather mode."""
    admm_cfg = ADMMConfig(cfg.admm_mu, cfg.admm_rho)
    axis = _axis(mesh)

    def train_step(state: TrainState, xs, ys, xt, alpha, rng=None):
        _check(state, model)
        rng = fold_in(cfg.seed, state.step) if rng is None else rng
        sink_s, sink_t = ({}, {}) if cfg.admm else (None, None)
        with batch_axis(axis):
            src_cls, src_dom = model(xs, alpha, train=True, sink=sink_s, rng=rng)
            _, tgt_dom = model(xt, alpha, train=True, sink=sink_t, rng=rng)
        src_class = cross_entropy_loss(src_cls, ys)
        src_domain = cross_entropy_loss(src_dom, torch.zeros(xs.shape[0], dtype=torch.long, device=xs.device))
        tgt_domain = cross_entropy_loss(tgt_dom, torch.ones(xt.shape[0], dtype=torch.long, device=xt.device))
        trans = _trans(sink_s, state.admm_duals, admm_cfg) + _trans(sink_t, state.admm_duals, admm_cfg) \
            if cfg.admm else 0.0
        loss = src_class if cfg.src_only_flag else src_class + src_domain + tgt_domain + trans
        _apply(state, loss, sink_s, admm_cfg, axis)
        with torch.no_grad():
            metrics = {"loss": loss.detach(), "src_class": src_class.detach(), "src_domain": src_domain.detach(),
                       "tgt_domain": tgt_domain.detach(), "trans": torch.as_tensor(trans).detach(),
                       "accuracy": (src_cls.argmax(-1) == ys).float().mean()}
        return state, _finish(metrics, axis)

    return train_step


def make_dann_eval_step(model: nn.Module, cfg: DAConfig):
    """eval_step(state, x, y, domain_label): loss, top-1, top-5 and the
    domain head's accuracy against domain_label."""

    @torch.no_grad()
    def eval_step(state: TrainState, x, y, domain_label: int):
        cls_out, dom_out = model(x, 0.0, train=False)
        y = y.long()
        top5 = torch.topk(cls_out, min(5, cls_out.shape[-1]), dim=-1).indices
        return {"loss": cross_entropy_loss(cls_out, y), "top1": (cls_out.argmax(-1) == y).float().mean(),
                "top5": (top5 == y[:, None]).any(-1).float().mean(),
                "domain_acc": (dom_out.argmax(-1) == domain_label).float().mean()}

    return eval_step


def make_dsan_train_step(model: nn.Module, cfg: DAConfig, mesh=None):
    """train_step(state, xs, ys, xt, lambd, rng=None) -> (state, metrics):
    one forward of both batches (the sink keeps the target pass's D, as
    JAX's flattened sow does), class CE + param * lambd * LMMD + trans.
    mesh: as make_dann_train_step's."""
    admm_cfg = ADMMConfig(cfg.admm_mu, cfg.admm_rho)
    axis = _axis(mesh)

    def train_step(state: TrainState, xs, ys, xt, lambd, rng=None):
        _check(state, model)
        sink = {} if cfg.admm else None
        with batch_axis(axis):
            s_pred, s_feat, t_pred, t_feat = model(xs, xt, train=True, sink=sink)
            loss_lmmd = lmmd(s_feat, t_feat, ys, torch.softmax(t_pred, dim=-1), cfg.num_classes)
        cls = cross_entropy_loss(s_pred, ys)
        trans = _trans(sink, state.admm_duals, admm_cfg) if cfg.admm else 0.0
        weight = torch.tensor(cfg.param, dtype=cls.dtype) * torch.tensor(lambd, dtype=cls.dtype)
        loss = cls + weight.to(cls.device) * loss_lmmd + trans
        _apply(state, loss, sink, admm_cfg, axis)
        with torch.no_grad():
            metrics = {"loss": loss.detach(), "cls": cls.detach(), "lmmd": loss_lmmd.detach(),
                       "trans": torch.as_tensor(trans).detach(), "accuracy": (s_pred.argmax(-1) == ys).float().mean()}
        return state, _finish(metrics, axis)

    return train_step


def make_mdd_train_step(model: nn.Module, cfg: DAConfig, mesh=None):
    """train_step(state, xs, ys, xt, coeff, rng=None) -> (state, metrics):
    DANN's two passes, mdd_loss over the concatenated outputs, + trans.
    mesh: as make_dann_train_step's (mdd_loss is a sum of batch means, so
    the ranks' mean is the global batch's)."""
    admm_cfg = ADMMConfig(cfg.admm_mu, cfg.admm_rho)
    axis = _axis(mesh)

    def train_step(state: TrainState, xs, ys, xt, coeff, rng=None):
        _check(state, model)
        rng = fold_in(cfg.seed, state.step) if rng is None else rng
        sink_s, sink_t = ({}, {}) if cfg.admm else (None, None)
        with batch_axis(axis):
            _, src_out, _, src_adv = model(xs, coeff, train=True, sink=sink_s, rng=rng)
            _, tgt_out, _, tgt_adv = model(xt, coeff, train=True, sink=sink_t, rng=rng)
        loss = mdd_loss(torch.cat([src_out, tgt_out]), torch.cat([src_adv, tgt_adv]), ys, srcweight=cfg.srcweight)
        trans = _trans(sink_s, state.admm_duals, admm_cfg) + _trans(sink_t, state.admm_duals, admm_cfg) \
            if cfg.admm else 0.0
        loss = loss + trans
        _apply(state, loss, sink_s, admm_cfg, axis)
        with torch.no_grad():
            metrics = {"loss": loss.detach(), "cls": cross_entropy_loss(src_out, ys).detach(),
                       "trans": torch.as_tensor(trans).detach(), "accuracy": (src_out.argmax(-1) == ys).float().mean()}
        return state, _finish(metrics, axis)

    return train_step


def _setup(cfg: DAConfig, loaders: dict, model: nn.Module, device, head_prefixes):
    """(device, state, total steps, logger, mesh) of a DA loop."""
    mesh = _build_da_placement(cfg)
    dev = resolve_device(device)
    true_f32()
    logger = _da_observability(cfg)
    total_steps = min(len(loaders["src_train"]), len(loaders["tgt_train"])) * cfg.num_epochs
    model = model.to(dev)
    state = create_da_state(torch.Generator().manual_seed(cfg.seed), model, cfg,
                            (1, *loaders["src_train"].x.shape[1:]), total_steps, head_prefixes)
    if mesh is not None:
        replicated({**state.params, **state.batch_stats}, mesh)
        logger.info(f"mesh {mesh.shape} rank {mesh.rank} corr_mode=gather")
    for key in ("src_train", "tgt_train", "src_test", "tgt_test"):
        if key in loaders:
            loaders[key].pin_memory = dev.type == "cuda"
    return dev, state, total_steps, logger, mesh


def _batches(loaders: dict, dev, mesh=None, dtype=None):
    """(xs, ys, xt) of each step: this rank's rows, on `dev`."""
    for (xs, ys), (xt, _) in zip(loaders["src_train"], loaders["tgt_train"]):
        if mesh is not None:
            for x in (xs, xt):
                if x.shape[0] % mesh.n_data:
                    raise ValueError(f"DA batch dim {x.shape[0]} not divisible by data-axis size {mesh.n_data}")
            xs, ys, xt = shard_batch((xs, ys, xt), mesh)
        xs, ys = to_device(xs, ys, dev, dtype)
        yield xs, ys, to_tensor(xt, dev, dtype)


def _top1(eval_fn, loader, dev, mesh=None, dtype=None) -> float:
    """Top-1 over the loader; over a mesh each rank evaluates its rows of
    a batch the ranks divide (and the whole of one they do not, counted
    once), and the ranks' means are averaged."""
    am = AverageMeter()
    for x, y in loader:
        n = len(y)
        if mesh is not None and n % mesh.n_data == 0:
            x, y = shard_batch((x, y), mesh)
            acc = mean_over(torch.as_tensor(eval_fn(*to_device(x, y, dev, dtype))).double(), mesh.group)
        else:
            acc = eval_fn(*to_device(x, y, dev, dtype))
        am.update(float(acc) * 100, n)
    return am.avg


def fit_dann(cfg: DAConfig, loaders: dict, model: nn.Module, max_steps: Optional[int] = None, device=None) -> dict:
    """DANN (or the digit net) over zipped source and target loaders
    ({'src_train', 'tgt_train', 'src_test', 'tgt_test'}); total_steps is
    min(len(src), len(tgt)) * epochs, the steps actually run, so the ramps
    complete. Each epoch evaluates tgt_test (domain 1) and src_test
    (domain 0). Returns {'best_tgt_top1', 'state'}."""
    dev, state, total_steps, logger, mesh = _setup(cfg, loaders, model, device, DANN_HEADS)
    train_step, eval_step = make_dann_train_step(state.model, cfg, mesh), make_dann_eval_step(state.model, cfg)
    dtype = _dtype(state.model)
    best, step = 0.0, 0
    for epoch in range(cfg.num_epochs):
        t0 = time.time()
        meters = {k: AverageMeter() for k in ("loss", "accuracy")}
        for xs, ys, xt in _batches(loaders, dev, mesh, dtype):
            alpha = grl_alpha(step / max(total_steps, 1), dtype)
            state, m = train_step(state, xs, ys, xt, alpha)
            for k in meters:
                meters[k].update(float(m[k]))
            step += 1
            if max_steps is not None and step >= max_steps:
                break
        accs = {split: _top1(lambda x, y, d=dom: eval_step(state, x, y, d)["top1"], loaders[split], dev, mesh, dtype)
                for split, dom in (("tgt_test", 1), ("src_test", 0))}
        best = max(best, accs["tgt_test"])
        logger.info(f"DANN[{epoch}] loss {meters['loss'].avg:.4f} src_acc {accs['src_test']:.2f} "
                    f"tgt_acc {accs['tgt_test']:.2f} (best {best:.2f}) [{time.time() - t0:.1f}s]")
        if max_steps is not None and step >= max_steps:
            break
    return {"best_tgt_top1": best, "state": state}


def fit_dsan(cfg: DAConfig, loaders: dict, model: nn.Module, max_steps: Optional[int] = None, device=None) -> dict:
    """DSAN over zipped source and target loaders, the LMMD weight ramped
    per epoch; evaluates tgt_test. Returns {'best_tgt_top1', 'state'}."""
    dev, state, _, logger, mesh = _setup(cfg, loaders, model, device, DSAN_HEADS)
    train_step = make_dsan_train_step(state.model, cfg, mesh)
    dtype = _dtype(state.model)
    best, step = 0.0, 0
    for epoch in range(cfg.num_epochs):
        t0 = time.time()
        lambd = 2.0 / (1.0 + math.exp(-10.0 * epoch / max(cfg.num_epochs, 1))) - 1.0
        lm = AverageMeter()
        for xs, ys, xt in _batches(loaders, dev, mesh, dtype):
            state, m = train_step(state, xs, ys, xt, lambd)
            lm.update(float(m["loss"]))
            step += 1
            if max_steps is not None and step >= max_steps:
                break
        with torch.no_grad():
            acc = _top1(lambda x, y: (state.model(x, train=False).argmax(-1) == y).float().mean(),
                        loaders["tgt_test"], dev, mesh, dtype)
        best = max(best, acc)
        logger.info(f"DSAN[{epoch}] loss {lm.avg:.4f} lambda {lambd:.3f} tgt_acc {acc:.2f} (best {best:.2f}) "
                    f"[{time.time() - t0:.1f}s]")
        if max_steps is not None and step >= max_steps:
            break
    return {"best_tgt_top1": best, "state": state}


def fit_mdd(cfg: DAConfig, loaders: dict, model: nn.Module, max_steps: Optional[int] = None, device=None) -> dict:
    """MDD over zipped source and target loaders, the reversal annealed by
    mdd_grl_coeff over total_steps; evaluates tgt_test on the class head.
    Returns {'best_tgt_top1', 'state'}."""
    dev, state, total_steps, logger, mesh = _setup(cfg, loaders, model, device, MDD_HEADS)
    train_step = make_mdd_train_step(state.model, cfg, mesh)
    dtype = _dtype(state.model)
    best, step = 0.0, 0
    for epoch in range(cfg.num_epochs):
        t0 = time.time()
        meters = {k: AverageMeter() for k in ("loss", "accuracy")}
        for xs, ys, xt in _batches(loaders, dev, mesh, dtype):
            coeff = mdd_grl_coeff(step, max_iter=max(total_steps, 1), dtype=dtype)
            state, m = train_step(state, xs, ys, xt, coeff)
            for k in meters:
                meters[k].update(float(m[k]))
            step += 1
            if max_steps is not None and step >= max_steps:
                break
        with torch.no_grad():
            acc = _top1(lambda x, y: (state.model(x, 0.0, train=False)[1].argmax(-1) == y).float().mean(),
                        loaders["tgt_test"], dev, mesh, dtype)
        best = max(best, acc)
        logger.info(f"MDD[{epoch}] loss {meters['loss'].avg:.4f} src_acc {100 * meters['accuracy'].avg:.2f} "
                    f"tgt_acc {acc:.2f} (best {best:.2f}) [{time.time() - t0:.1f}s]")
        if max_steps is not None and step >= max_steps:
            break
    return {"best_tgt_top1": best, "state": state}
