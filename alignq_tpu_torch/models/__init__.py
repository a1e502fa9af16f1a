from alignq_tpu_torch.models.densenet import DenseNet, densenet_40_quant  # noqa: F401
from alignq_tpu_torch.models.mobilenetv2 import MobileNetV2, mobile_v2  # noqa: F401
from alignq_tpu_torch.models.resnet_cifar import PreActBlock, PreActResNet, resnet20_quant, resnet56_quant  # noqa: F401
