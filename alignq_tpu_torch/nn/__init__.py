from alignq_tpu_torch.nn.dropout import Dropout  # noqa: F401
from alignq_tpu_torch.nn.grl import gradient_reversal  # noqa: F401
from alignq_tpu_torch.nn.layers import BatchNorm, QConv, QDense, QuantAct, StageRequant  # noqa: F401
