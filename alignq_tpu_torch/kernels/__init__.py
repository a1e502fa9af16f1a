"""The INT8 serving graphs' modules (`infer`, `infer_densenet`,
`infer_mobilenet`, `infer_resnet_imagenet`, `infer_digit`, the artifacts
and the deploy registry) and their
hand-written CUDA kernels: K1, the implicit-GEMM int8 conv
`qmatmul.int8_conv_packed` (with the act-code epilogue
`qmatmul.int8_conv_codes`; `int8_matmul_dequant` is its GEMM form) and its
depthwise form `dwconv.dw_conv`, K2 `quantize.cdf_quantize_int8` and the
BN-act code kernel `quantize.bn_act_codes` beside it, and K3
`stage_kernel.stage_identity_blocks_nhwc` (sources in
`alignq_tpu_torch/csrc/`, built by `_build`)."""

from alignq_tpu_torch.kernels.qmatmul import int8_matmul_dequant
from alignq_tpu_torch.kernels.quantize import cdf_quantize_int8

__all__ = ["cdf_quantize_int8", "int8_matmul_dequant"]
