"""Typed training configuration (port of alignq_tpu/train/config.py: the
same fields and defaults, but for the data and job directories, which the
port keeps under the working directory and the temporary directory).

mesh_shape larger than one device trains data-parallel over
torch.distributed (train/loop.py) in corr_mode 'gather' or 'local', the
latter with grad_compression; a 'model' axis splits the kernels' output
channels besides (tensor parallelism, gather mode only). `method` takes
every value of the JAX package's
(ours, uniform, dorefa, lsq, apot, llsq, bwn, bwnf, uniform_admm, fp); the
PDF correction runs for 'ours' only.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # model
    target_model: str = "resnet20_quant"
    method: str = "ours"  # ours | uniform | dorefa | lsq | apot | llsq | bwn | bwnf | uniform_admm | fp
    bitW: int = 8
    abitW: int = 8
    act_range: float = 2.0
    variant: str = "b"
    num_classes: int = 10

    # optimization
    lr: float = 0.04
    momentum: float = 0.9
    weight_decay: float = 1e-4
    num_epochs: int = 200
    train_batch_size: int = 128
    eval_batch_size: int = 100
    lr_decay_steps: Sequence[int] = (80, 120)
    lr_gamma: float = 0.1
    warmup_epochs: float = 0.0
    lam: float = 1.0
    lam2: float = 4.0

    # AlignQ specifics
    admm: bool = False
    deploy_exact: bool = False  # model the INT graph's stem/residual requant sites; pair with variant 'int8'
    stream_int8: bool = False  # with deploy_exact: the INT graph's int8 stream (stream='int8')
    stage_int8: bool = False  # with deploy_exact, DenseNet only: the INT graph's int8 stage buffer
    stage_calib: str = "ema"
    admm_mu: float = 0.2
    admm_rho: float = 0.3
    cdf_impl: str = "erf"  # act-site CDF: 'erf' or 'poly' (deploy with the same act_impl)
    correction_exclude: Sequence[str] = ("conv0",)  # the stem is not corrected (ResNet)
    use_correction: bool = True  # False: plain SGD(momentum, wd) for every parameter
    corr_mode: str = "gather"
    grad_compression: str = "f32"

    # data
    dataset: str = "cifar10"
    data_dir: str = "data"
    num_workers: int = 2

    # run control
    job_dir: str = os.path.join(tempfile.gettempdir(), "alignq_job")
    seed: int = 0
    print_freq: int = 100
    eval_freq_epochs: int = 1
    best_only_checkpoint: bool = False

    # execution
    mxu_bf16: bool = False  # bf16 conv operands in the train step; eval stays f32
    mesh_shape: Sequence[int] = (1,)
    mesh_axes: Sequence[str] = ("data",)
