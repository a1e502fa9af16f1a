from alignq_tpu_torch.quant.cdf import (  # noqa: F401
    ERF_SQRT2_POLY,
    cdf_transform,
    channel_stats,
    erf,
    erf_f32,
    erf_grid_boundaries,
    erf_sqrt2,
    fma_f32,
    gaussian_cdf,
    gaussian_pdf2,
    tensor_stats,
)
from alignq_tpu_torch.quant.fake_quant import (  # noqa: F401
    WeightQuantResult,
    act_cdf,
    quantize_act,
    quantize_weight,
)
from alignq_tpu_torch.quant.ste import (  # noqa: F401
    requant_grid_ste,
    requant_ste,
    round_ste,
    sign_ste,
    uniform_quantize,
)
