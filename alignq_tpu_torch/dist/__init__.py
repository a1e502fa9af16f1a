"""Data- and tensor-parallel distribution over torch.distributed, one
process per device (port of alignq_tpu/dist/)."""

from alignq_tpu_torch.dist import multihost  # noqa: F401
from alignq_tpu_torch.dist.mesh import Mesh, make_mesh  # noqa: F401
from alignq_tpu_torch.dist.sharding import replicated, shard_batch  # noqa: F401
