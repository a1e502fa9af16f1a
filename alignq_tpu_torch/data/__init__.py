from alignq_tpu_torch.data.loader import ArrayLoader, Data  # noqa: F401
from alignq_tpu_torch.data.registry import get_data  # noqa: F401
from alignq_tpu_torch.data.digits import get_digit_domain  # noqa: F401
from alignq_tpu_torch.data.office import get_office_domain, get_office_pair  # noqa: F401
