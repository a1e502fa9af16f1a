from alignq_tpu_torch.models.densenet import DenseNet, densenet_40_quant  # noqa: F401
from alignq_tpu_torch.models.mobilenetv2 import MobileNetV2, mobile_v2  # noqa: F401
from alignq_tpu_torch.models.resnet_cifar import PreActBlock, PreActResNet, resnet20_quant, resnet56_quant  # noqa: F401
from alignq_tpu_torch.models.resnet_imagenet import (  # noqa: F401
    ResNetFeature,
    resnet18_quant,
    resnet34_quant,
    resnet50_quant,
)
from alignq_tpu_torch.models.mdd import MDDNet, mdd_grl_coeff, mdd_loss, mddnet  # noqa: F401
from alignq_tpu_torch.models.dann import (  # noqa: F401
    DANN,
    DSAN,
    MNISTModelQuant,
    mnist_model_quant,
    resnet18_dann,
    resnet34_dann,
    resnet50_dann,
    resnet50_dsan,
)
