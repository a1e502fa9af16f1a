from alignq_tpu_torch.data.loader import ArrayLoader, Data  # noqa: F401
from alignq_tpu_torch.data.registry import get_data  # noqa: F401
