from alignq_tpu_torch.optim.correction import build_correction_mask, correction_factor  # noqa: F401
from alignq_tpu_torch.optim.factory import AlignQSGD, alignq_sgd  # noqa: F401
from alignq_tpu_torch.optim.schedules import multistep_schedule  # noqa: F401
