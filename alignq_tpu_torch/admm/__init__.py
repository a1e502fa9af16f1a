from alignq_tpu_torch.admm.correlation import corr, corr_discrepancy  # noqa: F401
from alignq_tpu_torch.admm.loss import ADMMConfig, admm_loss  # noqa: F401
from alignq_tpu_torch.admm.state import ADMMSiteState, dual_update, dual_update_tree, init_site  # noqa: F401
from alignq_tpu_torch.admm.lmmd import gaussian_kernel, lmmd  # noqa: F401
