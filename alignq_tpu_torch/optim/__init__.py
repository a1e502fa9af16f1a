from alignq_tpu_torch.optim.correction import build_correction_mask, correction_factor  # noqa: F401
from alignq_tpu_torch.optim.factory import Adam, AlignQSGD, adam, alignq_sgd  # noqa: F401
from alignq_tpu_torch.optim.schedules import dann_lr, dann_schedule, multistep_schedule  # noqa: F401
