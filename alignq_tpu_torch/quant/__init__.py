from alignq_tpu_torch.quant.cdf import (  # noqa: F401
    ERF_SQRT2_POLY,
    channel_stats,
    erf_f32,
    erf_grid_boundaries,
    erf_sqrt2,
    fma_f32,
    gaussian_cdf,
    gaussian_pdf2,
    tensor_stats,
)
