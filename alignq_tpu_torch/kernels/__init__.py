"""The INT8 serving path's modules and its two hand-written CUDA kernels:
K1 `qmatmul.int8_matmul_dequant` and K3 `stage_kernel.stage_identity_blocks`
(sources in `alignq_tpu_torch/csrc/`, built by `_build`)."""
