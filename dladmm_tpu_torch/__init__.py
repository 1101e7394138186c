"""dladmm_tpu_torch — the PyTorch / CUDA port of dladmm_tpu for NVIDIA Hopper.

A second package beside ``dladmm_tpu`` (the JAX reference, unchanged).
It imports torch, never jax, and nothing of ``dladmm_tpu``. Structure
and names follow the JAX package so each module's counterpart is easy
to find. Its entry points run on ``cuda`` unless the caller asks for the
CPU (``device="cpu"`` or ``DLADMM_PLATFORM=cpu``).

This slice ports the serving path: the unroll and its LADMM-exact init,
the proxes, the LADMM baseline and metrics, synthetic data, checkpoint
import, the bucketed servers and the serving CLI
(``python -m dladmm_tpu_torch.serve``), with the whole-unroll inference
kernel hand-written in CUDA C++ (ops/csrc/unroll.cu).
"""

__version__ = "0.1.0"

from dladmm_tpu_torch.ops.reference import shrink  # noqa: F401
from dladmm_tpu_torch.models.unroll import (  # noqa: F401
    DLADMM,
    DLADMMParams,
    dladmm_forward,
    init_dladmm_params,
)
