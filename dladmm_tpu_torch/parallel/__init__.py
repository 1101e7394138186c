"""Data and tensor parallelism on torch.distributed (the port of
dladmm_tpu/parallel): the mesh, its model and data groups, the backend
rule and the TP parameter slices (mesh.py), starting the ranks and each
rank's batch (multihost.py), the memory audit and traffic model
(memory.py), and the data-parallel steps, ZeRO-1, the tensor-parallel
forward, step and evaluation (collectives.py)."""

from dladmm_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh  # noqa: F401
from dladmm_tpu_torch.parallel.memory import (  # noqa: F401
    audit_or_raise,
    per_chip_bytes,
    step_traffic_bytes,
)
