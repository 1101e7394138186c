from dladmm_tpu_torch.metrics.core import (  # noqa: F401
    nmse_db,
    constraint_residual,
    psnr,
    per_layer_nmse_db,
)
