from dladmm_tpu_torch.models.unroll import (  # noqa: F401
    DLADMM,
    DLADMMParams,
    dladmm_forward,
    init_dladmm_params,
    spectral_norm_sq,
)
