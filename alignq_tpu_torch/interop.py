"""Weights across the package boundary, and fresh random weights.

The JAX package keeps a PreActResNet as a flax tree (`conv0/kernel` HWIO,
`bn/{scale,bias}`, `layers_i/{conv0,conv1,skip_conv,bn0,bn1,skip_bn}`,
`logit/{kernel,bias}`; batch_stats `mean`/`var`) and converted INT weights
as a tree of QConvInt8 triples (DenseNet's of QConvPre and BNAffine).
Given either as numpy arrays, these functions return the port's tensors in
the same structure. `init_*_params` draw fresh random trees of each CIFAR
family, of the ImageNet ResNet trunks and of the domain-adaptation nets
(DANN, DSAN, MDD, the digit DANN) with the shapes and key names of the JAX
models' `init`.

Training state crosses too: a flax tree of any of the four CIFAR families,
of an ImageNet ResNet trunk or of a domain-adaptation net (its heads'
QDense kernels (in, out) and 1-D BatchNorms as they are) loads into the
port's QAT model
(`load_flax_tree`; conv kernels OIHW, MobileNet's depthwise HWIO (3, 3, 1,
C) as (C, 1, 3, 3), StageRequant's `amax` among the statistics), JAX's
ADMM duals become the port's, and `deploy_tree` gives a trained model back
as the flax-layout tree that the family's converter
(`convert_preact_resnet`, `convert_densenet40`, `convert_mobilenetv2`,
`convert_resnet_imagenet`, `convert_dann`, `convert_dsan`, `convert_mdd`,
`convert_mnist_dann`) folds.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from alignq_tpu_torch.kernels.convert import QConvInt8

_QCONV_FIELDS = ("kernel_int8", "scale", "bias")


def _tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.to(device)
    return torch.tensor(np.asarray(tree)).to(device)


def params_from_numpy(
    params: Dict[str, Any], batch_stats: Dict[str, Any], device
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A flax PreActResNet (params, batch_stats), numpy (or tensor) leaves
    -> tensors on `device`."""
    return _tensors(params, device), _tensors(batch_stats, device)


def _named_tuples():
    """The port's NamedTuples of converted trees, by their field names."""
    from alignq_tpu_torch.kernels.infer_densenet import BNAffine, QConvPre

    return {cls._fields: cls for cls in (QConvInt8, QConvPre, BNAffine)}


def _qparams(node, device, named):
    fields = getattr(node, "_fields", None)
    if fields in named or (isinstance(node, dict) and tuple(sorted(node)) == tuple(sorted(_QCONV_FIELDS))):
        cls = named[fields] if fields else QConvInt8
        get = (lambda f: getattr(node, f)) if fields else node.__getitem__
        return cls(*(_qparams(get(f), device, named) for f in cls._fields))
    if isinstance(node, dict):
        return {k: _qparams(v, device, named) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_qparams(v, device, named) for v in node]
    arr = np.asarray(node)
    if arr.ndim == 0 and arr.dtype != np.float32:
        return arr.item()  # in_scale / m: host scalars, as the port's converter keeps them
    return torch.tensor(arr).to(device)  # f32 0-d leaves (DenseNet's conv scales) stay tensors


def qparams_from_numpy(qparams: Dict[str, Any], device) -> Dict[str, Any]:
    """A qparams tree converted by the JAX package (QConvInt8 triples or
    dicts of their fields, QConvPre and BNAffine, `*_cut` cutpoint dicts,
    the head), numpy leaves -> the port's tree on `device`: NamedTuples as
    the port's, f32 leaves as tensors (0-d ones too), other 0-d leaves as
    host scalars."""
    return _qparams(qparams, device, _named_tuples())


def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen, dtype=torch.float64) * 2.0 - 1.0).mul(bound).float()


def init_preact_resnet_params(
    depth: int, generator: torch.Generator, device, num_classes: int = 10
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A deploy tree with the shapes and inits of the JAX package's
    `resnet20_quant(...).init` (PreActResNet, (depth-2)/6 blocks a stage):
    conv and head kernels U(-1/sqrt(fan_in), 1/sqrt(fan_in)) as torch's
    defaults, head bias likewise, BN scale 1, bias 0, mean 0, var 1.
    Drawn on the CPU from `generator`, then moved to `device`."""
    if (depth - 2) % 6:
        raise ValueError(f"PreActResNet depth must be 6n+2, got {depth}")
    n = (depth - 2) // 6

    def conv(k, cin, cout):
        return {"kernel": _uniform(generator, (k, k, cin, cout), 1.0 / math.sqrt(k * k * cin))}

    def bn(c):
        return {"scale": torch.ones(c), "bias": torch.zeros(c)}, {"mean": torch.zeros(c), "var": torch.ones(c)}

    params: Dict[str, Any] = {"conv0": conv(3, 3, 16)}
    stats: Dict[str, Any] = {}
    params["bn"], stats["bn"] = bn(16)
    cin = 16
    for i in range(3 * n):
        cout = (16, 32, 64)[i // n]
        stride = 2 if i % n == 0 and i > 0 else 1
        p: Dict[str, Any] = {"conv0": conv(3, cin, cout), "conv1": conv(3, cout, cout)}
        s: Dict[str, Any] = {}
        p["bn0"], s["bn0"] = bn(cout)
        p["bn1"], s["bn1"] = bn(cout)
        if stride != 1:
            p["skip_conv"] = conv(1, cin, cout)
            p["skip_bn"], s["skip_bn"] = bn(cout)
        params[f"layers_{i}"], stats[f"layers_{i}"] = p, s
        cin = cout
    bound = 1.0 / math.sqrt(64)
    params["logit"] = {
        "kernel": _uniform(generator, (64, num_classes), bound),
        "bias": _uniform(generator, (num_classes,), bound),
    }
    return params_from_numpy(params, stats, device)


def _he_fan_out(gen, shape):
    """normal(0, sqrt(2 / (kh * kw * cout))): the JAX models' conv init."""
    kh, kw, _, cout = shape
    return (torch.randn(shape, generator=gen, dtype=torch.float64) * math.sqrt(2.0 / (kh * kw * cout))).float()


def _bn(c):
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}, {"mean": torch.zeros(c), "var": torch.ones(c)}


def _dense_head(gen, fan_in, n):
    bound = 1.0 / math.sqrt(fan_in)
    return {"kernel": _uniform(gen, (fan_in, n), bound), "bias": _uniform(gen, (n,), bound)}


def init_densenet_params(
    depth: int, generator: torch.Generator, device, growth: int = 12, stage_int8: bool = False,
    num_classes: int = 10,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A deploy tree with the shapes and key names of the JAX package's
    `densenet_40_quant(...).init` at any depth 3n+4 (compression 1): `conv1`,
    `dense{s}_{i}/{bn1,conv1}`, `trans{1,2}/{bn1,conv1}`, `bn`, `fc`; conv
    kernels He fan-out normal, BN scale 1, bias 0, mean 0, var 1, the head
    uniform(+-1/sqrt(fan_in)). With stage_int8, the StageRequant
    statistics too (`requant_stem/amax`, `dense*/requant/amax`,
    `trans*/requant/amax`), drawn uniform in [2, 6] so that a random net's
    buffer scales are those of a calibrated one, not the init's zeros.
    Drawn on the CPU from `generator`, then moved to `device`."""
    if (depth - 4) % 3:
        raise ValueError(f"DenseNet depth must be 3n+4, got {depth}")
    n = (depth - 4) // 3

    def conv(k, cin, cout):
        return {"kernel": _he_fan_out(generator, (k, k, cin, cout))}

    def amax(c):
        return {"amax": (torch.rand(c, generator=generator, dtype=torch.float64) * 4 + 2).float()}

    c = 2 * growth
    params: Dict[str, Any] = {"conv1": conv(3, 3, c)}
    stats: Dict[str, Any] = {}
    if stage_int8:
        stats["requant_stem"] = amax(c)
    for stage in range(3):
        for i in range(n):
            name = f"dense{stage + 1}_{i}"
            p, s = {}, {}
            p["bn1"], s["bn1"] = _bn(c)
            p["conv1"] = conv(3, c, growth)
            if stage_int8:
                s["requant"] = amax(growth)
            params[name], stats[name] = p, s
            c += growth
        if stage < 2:
            name = f"trans{stage + 1}"
            p, s = {}, {}
            p["bn1"], s["bn1"] = _bn(c)
            p["conv1"] = conv(1, c, c)
            if stage_int8:
                s["requant"] = amax(c)
            params[name], stats[name] = p, s
    params["bn"], stats["bn"] = _bn(c)
    params["fc"] = _dense_head(generator, c, num_classes)
    return params_from_numpy(params, stats, device)


def init_mobilenetv2_params(
    generator: torch.Generator, device, num_classes: int = 10
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A deploy tree with the shapes and key names of the JAX package's
    `mobile_v2(...).init` (CIFAR/SVHN MobileNet-V2, infer_mobilenet.CFG):
    `conv1`, `bn1`, `layers_{i}/{conv1,bn1,conv2 (depthwise, HWIO (3, 3, 1,
    planes)),bn2,conv3,bn3}` plus `shortcut_conv`, `shortcut_bn` in the
    stride-1 blocks, `conv2` (1280), `bn2`, `linear`. Inits as
    init_densenet_params'. Drawn on the CPU from `generator`, then moved to
    `device`."""
    from alignq_tpu_torch.kernels.infer_mobilenet import CFG

    def conv(k, cin, cout):
        return {"kernel": _he_fan_out(generator, (k, k, cin, cout))}

    params: Dict[str, Any] = {"conv1": conv(3, 3, 32)}
    stats: Dict[str, Any] = {}
    params["bn1"], stats["bn1"] = _bn(32)
    cin, idx = 32, 0
    for expansion, out_planes, num_blocks, stride in CFG:
        for s in [stride] + [1] * (num_blocks - 1):
            planes = expansion * cin
            p: Dict[str, Any] = {"conv1": conv(1, cin, planes), "conv2": conv(3, 1, planes),
                                 "conv3": conv(1, planes, out_planes)}
            st: Dict[str, Any] = {}
            for bn, c in (("bn1", planes), ("bn2", planes), ("bn3", out_planes)):
                p[bn], st[bn] = _bn(c)
            if s == 1:
                p["shortcut_conv"] = conv(1, cin, out_planes)
                p["shortcut_bn"], st["shortcut_bn"] = _bn(out_planes)
            params[f"layers_{idx}"], stats[f"layers_{idx}"] = p, st
            cin, idx = out_planes, idx + 1
    params["conv2"] = conv(1, cin, 1280)
    params["bn2"], stats["bn2"] = _bn(1280)
    params["linear"] = _dense_head(generator, 1280, num_classes)
    return params_from_numpy(params, stats, device)


def init_resnet_imagenet_params(
    arch: str, generator: torch.Generator, device
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A deploy tree with the shapes and key names of the JAX package's
    `resnet{18,34,50}_quant(...).init` (models/resnet_imagenet.py
    ResNetFeature): `conv1`, `bn1`, `layer{s}_{b}/{conv1,bn1,conv2,bn2,
    conv3,bn3,downsample_conv,downsample_bn}`; conv kernels U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) as the JAX QConv's init, BN scale 1, bias 0, mean 0,
    var 1. The port's model of the arch, drawn on the CPU from `generator`,
    given as its flax tree (deploy_tree), then moved to `device`."""
    from alignq_tpu_torch.models import resnet_imagenet

    builders = {"resnet18": resnet_imagenet.resnet18_quant, "resnet34": resnet_imagenet.resnet34_quant,
                "resnet50": resnet_imagenet.resnet50_quant}
    if arch not in builders:
        raise ValueError(f"unknown ImageNet ResNet {arch!r}; have {sorted(builders)}")
    params, stats = deploy_tree(builders[arch](generator=generator))
    return params_from_numpy(params, stats, device)


def init_da_params(
    task: str, generator: torch.Generator, device, arch: str = "resnet50", num_classes: int = 31,
    bottle_neck: bool = True,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A deploy tree with the shapes and key names of the JAX package's
    DANN (`feature`, `class_classifier`, `domain_classifier`), DSAN
    (`feature_layers`, `bottle` with bottle_neck, `cls_fc`) or MDDNet
    (`base_network`, `bottleneck_fc`, `bottleneck_bn`, `classifier` and
    `classifier_adv` of `fc0`, `fc1`; 1024 wide) `init`, task 'dann' |
    'dsan' | 'mdd': the port's model, drawn on the CPU from `generator`,
    as its flax tree, moved to `device`."""
    from alignq_tpu_torch.models import DANN, DSAN, MDDNet

    if task == "dann":
        model = DANN(arch=arch, num_classes=num_classes, generator=generator)
    elif task == "dsan":
        model = DSAN(arch=arch, num_classes=num_classes, bottle_neck=bottle_neck, generator=generator)
    elif task == "mdd":
        model = MDDNet(arch=arch, num_classes=num_classes, generator=generator)
    else:
        raise ValueError(f"unknown domain-adaptation task {task!r}; have ['dann', 'dsan', 'mdd']")
    return params_from_numpy(*deploy_tree(model), device)


def init_mnist_dann_params(
    generator: torch.Generator, device, img_size: int = 28
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A deploy tree with the shapes and key names of the JAX package's
    `mnist_model_quant(...).init` (`conv1`, `conv1_bn`, `conv2`, `conv2_bn`,
    `classifier/{fc0,bn0,fc1,bn1,fc2}`, `discriminator/{fc0,bn0,fc1}`),
    drawn as init_da_params'."""
    from alignq_tpu_torch.models import MNISTModelQuant

    return params_from_numpy(*deploy_tree(MNISTModelQuant(img_size=img_size, generator=generator)), device)


def _flat(tree, prefix=""):
    """A nested dict -> {'a.b.c': leaf}."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        else:
            out[name] = v
    return out


def _is_conv_kernel(name: str, ndim: int) -> bool:
    """A 4-D leaf laid out HWIO in flax: a conv kernel, or LLSQ's per
    output channel `alpha_w` ((1, 1, 1, Cout); the port's (Cout, 1, 1, 1))."""
    return ndim == 4 and (name.endswith("kernel") or name.endswith("alpha_w"))


@torch.no_grad()
def load_flax_tree(model: torch.nn.Module, params: Dict[str, Any], batch_stats: Dict[str, Any]) -> None:
    """Copy a flax tree (numpy or tensor leaves; conv kernels HWIO, a
    depthwise one (k, k, 1, C)) into the port's model of the same
    structure, in the model's dtype and device (conv kernels OIHW, a
    depthwise one (C, 1, k, k)). Every parameter and statistic must be
    given, and nothing else. The baselines' parameters (`lsq_step_w`,
    `wgt_alpha`, LLSQ's `alpha_w` and `alpha`, ...) cross as the rest."""
    given = {**_flat(params), **_flat(batch_stats)}
    own = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    if set(given) != set(own):
        raise ValueError(f"trees differ: only in flax {sorted(set(given) - set(own))}, "
                         f"only in the model {sorted(set(own) - set(given))}")
    for name, t in own.items():
        v = torch.as_tensor(np.array(given[name]))
        if _is_conv_kernel(name, v.ndim):
            v = v.permute(3, 2, 0, 1)  # HWIO -> OIHW
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {tuple(v.shape)}, the model has {tuple(t.shape)}")
        t.copy_(v)


load_flax_preact = load_flax_tree  # the name of the PreActResNet-only version


def deploy_tree(model: torch.nn.Module) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A trained model's (params, batch_stats) in the flax layout (nested
    dicts, conv kernels HWIO), detached, on the model's device: what the
    family's converter folds and build_int8_resnet20_engine takes."""

    def nest(named):
        out: Dict[str, Any] = {}
        for name, t in named:
            t = t.detach()
            if _is_conv_kernel(name, t.ndim):
                t = t.permute(2, 3, 1, 0).contiguous()  # OIHW -> HWIO
            *path, leaf = name.split(".")
            node = out
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = t
        return out

    return nest(model.named_parameters()), nest(model.named_buffers())


def duals_from_jax(duals: Dict[str, Any], device, dtype=None) -> Dict[str, Any]:
    """JAX ADMMSiteState duals ({site: (alter_d, gamma)}, numpy or jax
    leaves) -> the port's ADMMSiteState dict on `device`."""
    from alignq_tpu_torch.admm.state import ADMMSiteState

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype).to(device)

    return {name: ADMMSiteState(t(s[0]), t(s[1])) for name, s in duals.items()}
