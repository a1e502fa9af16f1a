"""Deploy-family registry: artifact meta -> (template, forward, operands,
input shape) (port of alignq_tpu/kernels/deploy_registry.py).

Contract per family:
- `convert(params, batch_stats, meta)` folds a trained model's flax-layout
  tree (interop.deploy_tree) into the family's qparams, at the meta's bits
  and structure options (export_int8 uses it).
- `template(meta, device)` builds a qparams tree with the same structure as
  the exported artifact (kernels/artifact.py `load_int8_artifact` takes
  leaves from the npz, so only the structure and key paths matter). It
  converts a fresh random tree of the family (interop.init_*_params): the
  port has no flax `init`. Structure options live in the meta:
  `stage_int8` (DenseNet's buffer scales) and `depth` (DenseNet's, 40
  where the meta has none).
- `forward(meta)` returns `fwd(params, x, operands=...) -> logits` with the
  deploy-graph knobs the meta records (act_bits, act_impl, and the
  family's own).
- `operands(qparams, meta)` lays the weights out once for the forward's
  kernels.
- `input_shape(meta)` is the engine's fixed request shape.

The ImageNet-layout trunks (resnet18, resnet34, resnet50) serve the pooled
feature, as the JAX package's family does; their meta's `arch` (else its
`model`) picks the trunk, and `image_size` (224 where the meta has none)
the request shape.

The domain-adaptation families (dann, dsan, mdd) store {'trunk': the
trunk's qparams, 'heads': the f32 heads} and serve class logits; their
meta's `arch` (resnet50 where it has none) picks the trunk, `num_classes`
(31), `bottle_neck` (DSAN's, 1) and `image_size` (64) the rest. The digit
DANN (digit_dann) stores convert_mnist_dann's tree and serves class
logits at `img_size` (28).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch


def _meta_int(meta: Dict[str, Any], key: str, default: int) -> int:
    return int(np.asarray(meta[key])) if key in meta else default


def _meta_str(meta: Dict[str, Any], key: str, default: str) -> str:
    return str(np.asarray(meta[key])) if key in meta else default


def _act_kwargs(meta: Dict[str, Any]) -> Dict[str, Any]:
    from alignq_tpu_torch.kernels.artifact import forward_kwargs_from_meta

    return forward_kwargs_from_meta(meta)


def _bits(meta):
    return {"weight_bits": _meta_int(meta, "weight_bits", 8), "act_bits": _meta_int(meta, "act_bits", 8)}


@dataclasses.dataclass(frozen=True)
class DeployFamily:
    name: str
    convert: Callable[[Any, Any, Dict[str, Any]], Any]
    template: Callable[[Dict[str, Any], Any], Any]
    forward: Callable[[Dict[str, Any]], Callable]
    operands: Callable[[Any, Dict[str, Any]], Any]
    input_shape: Callable[[Dict[str, Any]], Tuple[int, ...]]
    supports_packed_int4: bool = False


def _seed():
    return torch.Generator().manual_seed(0)


# ---------------------------------------------------------------- CIFAR nets


def _preact_convert(params, batch_stats, meta):
    from alignq_tpu_torch.kernels.infer import convert_preact_resnet

    return convert_preact_resnet(params, batch_stats, **_bits(meta))


def _preact_template(depth: int):
    def template(meta, device):
        from alignq_tpu_torch.interop import init_preact_resnet_params

        return _preact_convert(*init_preact_resnet_params(depth, _seed(), device), meta)

    return template


def _preact_forward(meta):
    from alignq_tpu_torch.kernels.infer import resnet20_int8_forward

    kw = _act_kwargs(meta)
    if bool(_meta_int(meta, "use_stage_kernel", 0)):
        kw["use_stage_kernel"] = True  # pairs with the poly grid (export gate)
    return functools.partial(resnet20_int8_forward, **kw)


def _preact_operands(qparams, meta):
    from alignq_tpu_torch.kernels.infer import pack_int8_operands

    return pack_int8_operands(qparams)


def _stage_int8(meta) -> bool:
    return bool(_meta_int(meta, "stage_int8", 0))


def _densenet_convert(params, batch_stats, meta):
    from alignq_tpu_torch.kernels.infer_densenet import convert_densenet40

    return convert_densenet40(params, batch_stats, stage_int8=_stage_int8(meta), **_bits(meta))


def _densenet_template(meta, device):
    from alignq_tpu_torch.interop import init_densenet_params

    depth = _meta_int(meta, "depth", 40)  # any 3n+4; JAX's artifacts are all DenseNet-40
    return _densenet_convert(*init_densenet_params(depth, _seed(), device, stage_int8=_stage_int8(meta)), meta)


def _densenet_forward(meta):
    from alignq_tpu_torch.kernels.infer_densenet import densenet40_int8_forward

    kw = _act_kwargs(meta)
    kw.pop("stream", None)  # PreActResNet-only knob
    if _stage_int8(meta):
        kw["stage_int8"] = True
    return functools.partial(densenet40_int8_forward, **kw)


def _densenet_operands(qparams, meta):
    from alignq_tpu_torch.kernels.infer_densenet import pack_densenet40_operands

    return pack_densenet40_operands(qparams, _stage_int8(meta))


def _mobilenet_convert(params, batch_stats, meta):
    from alignq_tpu_torch.kernels.infer_mobilenet import convert_mobilenetv2

    return convert_mobilenetv2(params, batch_stats, **_bits(meta))


def _mobilenet_template(meta, device):
    from alignq_tpu_torch.interop import init_mobilenetv2_params

    return _mobilenet_convert(*init_mobilenetv2_params(_seed(), device), meta)


def _mobilenet_forward(meta):
    from alignq_tpu_torch.kernels.infer_mobilenet import mobilenetv2_int8_forward

    kw = _act_kwargs(meta)
    kw.pop("stream", None)
    return functools.partial(mobilenetv2_int8_forward, **kw)


def _mobilenet_operands(qparams, meta):
    from alignq_tpu_torch.kernels.infer_mobilenet import pack_mobilenetv2_operands

    return pack_mobilenetv2_operands(qparams)


def _cifar_shape(meta):
    return (32, 32, 3)


# ------------------------------------------------------------ ImageNet nets


def _imagenet_arch(meta) -> str:
    return _meta_str(meta, "arch", _meta_str(meta, "model", "resnet50"))


def _imagenet_convert(params, batch_stats, meta):
    from alignq_tpu_torch.kernels.infer_resnet_imagenet import convert_resnet_imagenet

    return convert_resnet_imagenet(params, batch_stats, **_bits(meta))


def _imagenet_template(meta, device):
    from alignq_tpu_torch.interop import init_resnet_imagenet_params

    return _imagenet_convert(*init_resnet_imagenet_params(_imagenet_arch(meta), _seed(), device), meta)


def _imagenet_forward(meta):
    from alignq_tpu_torch.kernels.infer_resnet_imagenet import resnet_imagenet_int8_forward

    kw = _act_kwargs(meta)
    kw.pop("stream", None)
    return functools.partial(resnet_imagenet_int8_forward, **kw)


def _imagenet_operands(qparams, meta):
    from alignq_tpu_torch.kernels.infer_resnet_imagenet import pack_resnet_imagenet_operands

    return pack_resnet_imagenet_operands(qparams)


def _imagenet_shape(meta):
    s = _meta_int(meta, "image_size", 224)
    return (s, s, 3)


# --------------------------------------------- domain-adaptation nets


def _da_convert(task: str):
    def convert(params, batch_stats, meta):
        from alignq_tpu_torch.kernels import infer_resnet_imagenet as RI

        fn = {"dann": RI.convert_dann, "dsan": RI.convert_dsan, "mdd": RI.convert_mdd}[task]
        trunk, heads = fn(params, batch_stats, **_bits(meta))
        return {"trunk": trunk, "heads": heads}

    return convert


def _da_template(task: str):
    def template(meta, device):
        from alignq_tpu_torch.interop import init_da_params

        tree = init_da_params(task, _seed(), device, arch=_meta_str(meta, "arch", "resnet50"),
                              num_classes=_meta_int(meta, "num_classes", 31),
                              bottle_neck=bool(_meta_int(meta, "bottle_neck", 1)))
        return _da_convert(task)(*tree, meta)

    return template


def _da_forward(task: str):
    def forward(meta):
        from alignq_tpu_torch.kernels import infer_resnet_imagenet as RI

        kw = _act_kwargs(meta)
        kw.pop("stream", None)
        raw = {"dann": RI.dann_int8_forward, "dsan": RI.dsan_int8_forward, "mdd": RI.mdd_int8_forward}[task]

        def fwd(params, x, operands=None):
            out = raw(params["trunk"], params["heads"], x, operands=operands, **kw)
            return out[0] if task == "dann" else out  # DANN's class logits

        return fwd

    return forward


def _da_operands(qparams, meta):
    from alignq_tpu_torch.kernels.infer_resnet_imagenet import pack_resnet_imagenet_operands

    return pack_resnet_imagenet_operands(qparams["trunk"])


def _da_shape(meta):
    s = _meta_int(meta, "image_size", 64)
    return (s, s, 3)


def _digit_convert(params, batch_stats, meta):
    from alignq_tpu_torch.kernels.infer_digit import convert_mnist_dann

    return convert_mnist_dann(params, batch_stats, **_bits(meta))


def _digit_template(meta, device):
    from alignq_tpu_torch.interop import init_mnist_dann_params

    return _digit_convert(*init_mnist_dann_params(_seed(), device, _meta_int(meta, "img_size", 28)), meta)


def _digit_forward(meta):
    from alignq_tpu_torch.kernels.infer_digit import mnist_dann_int8_forward

    kw = _act_kwargs(meta)
    kw.pop("stream", None)

    def fwd(params, x, operands=None):
        return mnist_dann_int8_forward(params, x, operands=operands, **kw)[0]  # class logits

    return fwd


def _digit_operands(qparams, meta):
    from alignq_tpu_torch.kernels.infer_digit import pack_mnist_dann_operands

    return pack_mnist_dann_operands(qparams)


def _digit_shape(meta):
    s = _meta_int(meta, "img_size", 28)
    return (s, s, 3)


DEPLOY_FAMILIES: Dict[str, DeployFamily] = {
    "resnet20": DeployFamily("resnet20", _preact_convert, _preact_template(20), _preact_forward, _preact_operands,
                             _cifar_shape, supports_packed_int4=True),
    "resnet56": DeployFamily("resnet56", _preact_convert, _preact_template(56), _preact_forward, _preact_operands,
                             _cifar_shape, supports_packed_int4=True),
    "densenet40": DeployFamily("densenet40", _densenet_convert, _densenet_template, _densenet_forward,
                               _densenet_operands, _cifar_shape),
    "mobilenetv2": DeployFamily("mobilenetv2", _mobilenet_convert, _mobilenet_template, _mobilenet_forward,
                                _mobilenet_operands, _cifar_shape),
    **{name: DeployFamily(name, _imagenet_convert, _imagenet_template, _imagenet_forward, _imagenet_operands,
                          _imagenet_shape) for name in ("resnet18", "resnet34", "resnet50")},
    **{task: DeployFamily(task, _da_convert(task), _da_template(task), _da_forward(task), _da_operands, _da_shape)
       for task in ("dann", "dsan", "mdd")},
    "digit_dann": DeployFamily("digit_dann", _digit_convert, _digit_template, _digit_forward, _digit_operands,
                               _digit_shape),
}
