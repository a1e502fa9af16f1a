"""The INT8 serving path's modules and its three hand-written CUDA
kernels: K1 `qmatmul.int8_matmul_dequant` (with the act-code epilogue
`qmatmul.int8_matmul_codes`), K2 `quantize.cdf_quantize_int8` and K3
`stage_kernel.stage_identity_blocks` (sources in `alignq_tpu_torch/csrc/`,
built by `_build`)."""

from alignq_tpu_torch.kernels.qmatmul import int8_matmul_dequant
from alignq_tpu_torch.kernels.quantize import cdf_quantize_int8

__all__ = ["cdf_quantize_int8", "int8_matmul_dequant"]
