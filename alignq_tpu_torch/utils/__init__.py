from alignq_tpu_torch.utils.logging_utils import MetricWriter, get_logger
from alignq_tpu_torch.utils.meters import AverageMeter, accuracy_topk

__all__ = ["AverageMeter", "accuracy_topk", "get_logger", "MetricWriter"]
