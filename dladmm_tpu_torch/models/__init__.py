from dladmm_tpu_torch.models.unroll import (  # noqa: F401
    DLADMM,
    DLADMMParams,
    dladmm_forward,
    init_dladmm_params,
    spectral_norm_sq,
)


def __getattr__(name):
    # DLADMMSolver is loaded on first use: models.solver reaches the ops
    # modules, which import models.unroll through this package.
    if name == "DLADMMSolver":
        from dladmm_tpu_torch.models.solver import DLADMMSolver

        return DLADMMSolver
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
