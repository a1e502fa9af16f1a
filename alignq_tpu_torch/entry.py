"""Entry points of the port (the JAX package's __graft_entry__.py):
`entry` gives a forward and its arguments; `dryrun_multichip` waits for
the port's distribution."""

from __future__ import annotations

import torch


def entry(device=None):
    """(fn, example_args): the W8A8 eval forward of the port's
    resnet20_quant (ResNet-20 CIFAR-10, CDF alignment; random weights from
    seed 0) on 8 zero images, on `device` (default the CUDA card).
    fn(model, x) -> logits (8, 10)."""
    from alignq_tpu_torch.device import resolve_device
    from alignq_tpu_torch.models.resnet_cifar import resnet20_quant

    dev = resolve_device(device)
    model = resnet20_quant(bitW=8, abitW=8, method="ours", generator=torch.Generator().manual_seed(0)).to(dev)
    x = torch.zeros((8, 32, 32, 3), device=dev)

    def forward(model, x):
        with torch.no_grad():
            return model(x, train=False)

    return forward, (model, x)


def dryrun_multichip(n_devices: int) -> None:
    """The ADMM QAT train step over an n-device data- and tensor-parallel
    mesh: not ported until ROADMAP queue 1, Distribution, lands."""
    raise NotImplementedError(
        f"dryrun_multichip({n_devices}): the port has no multi-device training yet (ROADMAP queue 1, Distribution)"
    )
