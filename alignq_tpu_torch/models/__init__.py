from alignq_tpu_torch.models.resnet_cifar import PreActBlock, PreActResNet, resnet20_quant, resnet56_quant  # noqa: F401
