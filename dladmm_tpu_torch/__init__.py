"""dladmm_tpu_torch — the PyTorch / CUDA port of dladmm_tpu for NVIDIA Hopper.

A second package beside ``dladmm_tpu`` (the JAX reference, unchanged).
It imports torch, never jax, and nothing of ``dladmm_tpu``. Structure
and names follow the JAX package so each module's counterpart is easy
to find. Its entry points run on ``cuda`` unless the caller asks for the
CPU (``device="cpu"`` or ``DLADMM_PLATFORM=cpu``).

Ported so far: the serving path (the unroll and its LADMM-exact init,
the proxes, the LADMM baseline and metrics, synthetic data, checkpoint
import, the bucketed servers and ``python -m dladmm_tpu_torch.serve``)
and the single-device training path (the manual backward, the
backward kernel of the final-layer loss, the fused Adam sweeps with
int8, fp32, bf16 and SR-bf16 moments, the training loop, checkpoints
and ``python -m dladmm_tpu_torch.run``). Its kernels are hand-written
CUDA C++ under ops/csrc/: the whole-unroll and trajectory forwards
(unroll.cu), the reverse sweep (unroll_bwd.cu), and the int8 and dense
Adam sweeps (qadam_int8.cu, qadam_dense.cu).
"""

__version__ = "0.1.0"

from dladmm_tpu_torch.ops.reference import shrink  # noqa: F401
from dladmm_tpu_torch.models.unroll import (  # noqa: F401
    DLADMM,
    DLADMMParams,
    dladmm_forward,
    init_dladmm_params,
)
