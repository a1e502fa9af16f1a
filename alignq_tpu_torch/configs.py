"""Reference-reproduction presets of the classification drivers (port of
alignq_tpu/configs.py:19-102), each pinned to the reference's committed
hyperparameters:

    from alignq_tpu_torch import configs
    cfg = configs.resnet20_cifar10_w8a8(num_epochs=3)
    fit(cfg, get_data(cfg.dataset, cfg.data_dir, cfg.train_batch_size, cfg.eval_batch_size))

and of the domain-adaptation drivers (alignq_tpu/configs.py:105-148):
DANN and DSAN on Office-31 and DANN on the digits, as DAConfigs for
train/da.py's fit_dann and fit_dsan.
"""

from __future__ import annotations

import dataclasses

from alignq_tpu_torch.train.config import TrainConfig
from alignq_tpu_torch.train.da import DAConfig


def resnet20_cifar10_w8a8(**over) -> TrainConfig:
    """The flagship (reference README.md:30): lr .04, batch 128, 200
    epochs, MultiStep [80, 120] gamma .1, wd 1e-4, momentum .9, lam 1, lam2
    4, act_range 2 (cdf_alignment/resnet-20-cifar-10/utils/options.py:54-89)."""
    return dataclasses.replace(
        TrainConfig(target_model="resnet20_quant", method="ours", bitW=8, abitW=8, lr=0.04, train_batch_size=128,
                    num_epochs=200, lr_decay_steps=(80, 120), lr_gamma=0.1, weight_decay=1e-4, momentum=0.9,
                    lam=1.0, lam2=4.0, act_range=2.0, dataset="cifar10", correction_exclude=("conv0",)),
        **over,
    )


def resnet20_cifar10_w8a8_fast_deploy(**over) -> TrainConfig:
    """The flagship trained for the fastest deploy graph: the int8 grid,
    deploy_exact, the poly act grid and the int8 residual stream. Deploy
    with resnet20_int8_forward(act_impl='poly', stream='int8')."""
    return dataclasses.replace(resnet20_cifar10_w8a8(), variant="int8", deploy_exact=True, stream_int8=True,
                               cdf_impl="poly", **over)


def resnet20_cifar10_w4a4_admm(**over) -> TrainConfig:
    """4-bit with ADMM, warm-started from the 8-bit run (--pretrained); mu
    .2, rho .3 (cdf_alignment_admm/resnet-20-cifar-10/utils/options.py:55-56,
    utils/admm.py:19-20)."""
    return dataclasses.replace(resnet20_cifar10_w8a8(), bitW=4, abitW=4, admm=True, **over)


def resnet56_cifar10_w4a4_admm(**over) -> TrainConfig:
    """cdf_alignment_admm/resnet-56-cifar-10/utils/options.py:54-74."""
    return dataclasses.replace(resnet20_cifar10_w4a4_admm(), target_model="resnet56_quant", **over)


def densenet40_cifar10(**over) -> TrainConfig:
    """dense-cifar-10's defaults; its driver corrects every conv, the stem
    included (dense-cifar-10/main.py:295-322)."""
    return dataclasses.replace(resnet20_cifar10_w8a8(), target_model="densenet_40_quant", correction_exclude=(),
                               **over)


def resnet20_svhn_w8a8(**over) -> TrainConfig:
    """resnet-20-svhn's defaults: 8/8, lr 1e-3 (the reference warm-starts
    from a 32-bit pretrain, fit(pretrained_dir=...); from scratch use .01,
    as options.py:66 says), MultiStep [80, 150], best-only checkpoints
    (cdf_alignment/resnet-20-svhn/utils/options.py:51-83)."""
    return dataclasses.replace(resnet20_cifar10_w8a8(), dataset="svhn", lr=1e-3, lr_decay_steps=(80, 150),
                               best_only_checkpoint=True, **over)


def mobilenetv2_svhn_w8a8(**over) -> TrainConfig:
    """mobilenet-v2-svhn's defaults (8/8); every conv corrected, the stem,
    the head and the shortcuts included (mobilenet main.py:177-200).
    warmup_epochs=2: the reference warm-starts from a pretrained model, and
    its lr .04 diverges from scratch; the linear warmup lets the preset
    converge from scratch and does no harm to a warm start."""
    return dataclasses.replace(resnet20_cifar10_w8a8(), target_model="mobile_v2", dataset="svhn",
                               correction_exclude=(), warmup_epochs=2.0, **over)


def dann_office_d2w_w8a8_admm(**over) -> DAConfig:
    """ResNet-50 DANN on Office-31 dslr -> webcam with ADMM (reference
    README.md:48): lr .001, batch 28, 200 epochs, wd 5e-4
    (cdf_alignment_admm/dann_office/utils/options_office.py)."""
    return dataclasses.replace(
        DAConfig(target_model="resnet50_dann", method="ours", bitW=8, abitW=8, admm=True, lr=1e-3,
                 train_batch_size=28, eval_batch_size=28, num_epochs=200, weight_decay=5e-4, num_classes=31,
                 src_data="dslr", tgt_data="webcam", correction_exclude=("feature/conv1",)),
        **over,
    )


def dsan_office_a2w_w4a4(**over) -> DAConfig:
    """ResNet-50 DSAN on Office-31 amazon -> webcam, 4-bit: lr .01, batch
    32, param .3, the 256-wide bottleneck
    (cdf_alignment/dsan_office/utils/options_office.py:64-99)."""
    return dataclasses.replace(
        DAConfig(target_model="resnet50_dsan", method="ours", bitW=4, abitW=4, lr=0.01, train_batch_size=32,
                 eval_batch_size=32, num_epochs=200, weight_decay=5e-4, num_classes=31, param=0.3,
                 bottle_neck=True, src_data="amazon", tgt_data="webcam",
                 correction_exclude=("feature_layers/conv1",)),
        **over,
    )


def dann_digits_mnist2mnistm(**over) -> DAConfig:
    """The digit DANN's defaults: 28x28, plain SGD (the digit driver's
    torch SGD has no PDF correction)."""
    return dataclasses.replace(
        DAConfig(target_model="mnist_model_quant", method="ours", bitW=8, abitW=8, lr=0.01, train_batch_size=128,
                 eval_batch_size=128, num_epochs=100, num_classes=10, img_size=28, src_data="mnist",
                 tgt_data="mnistm", use_correction=False),
        **over,
    )


ALL = {
    "resnet20_cifar10_w8a8": resnet20_cifar10_w8a8,
    "resnet20_cifar10_w8a8_fast_deploy": resnet20_cifar10_w8a8_fast_deploy,
    "resnet20_cifar10_w4a4_admm": resnet20_cifar10_w4a4_admm,
    "resnet56_cifar10_w4a4_admm": resnet56_cifar10_w4a4_admm,
    "densenet40_cifar10": densenet40_cifar10,
    "resnet20_svhn_w8a8": resnet20_svhn_w8a8,
    "mobilenetv2_svhn_w8a8": mobilenetv2_svhn_w8a8,
    "dann_office_d2w_w8a8_admm": dann_office_d2w_w8a8_admm,
    "dsan_office_a2w_w4a4": dsan_office_a2w_w4a4,
    "dann_digits_mnist2mnistm": dann_digits_mnist2mnistm,
}
