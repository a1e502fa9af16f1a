from alignq_tpu_torch.train.config import TrainConfig  # noqa: F401
from alignq_tpu_torch.train.state import TrainState, create_train_state  # noqa: F401
from alignq_tpu_torch.train.steps import cross_entropy_loss, make_eval_step, make_train_step  # noqa: F401
