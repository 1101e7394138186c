"""Forward selection policy (the kernel={...} switch).

The port of ``dladmm_tpu/models/api.py``:

  * ``auto`` / ``megakernel`` / ``pallas`` (the JAX package's names; the
    same route here): the whole-unroll kernel
    (ops/cuda_unroll.make_unrolled_forward; with a gradient, the
    trajectory kernel and the backward kernel, ops/cuda_bwd.py), or with
    ``need_trajectory`` the trajectory kernel
    (ops/cuda_traj.make_unrolled_trajectory) whose backward is the
    manual reverse sweep. On CUDA tensors these are the hand-written
    CUDA kernels; on CPU tensors their plain versions. The TPU policy's
    VMEM tiers (whole batch, batch tiles, per-layer kernel, XLA scan)
    collapse into this one rung: the CUDA kernels have no fit gate.
  * ``reference``, or a general B: the plain loop (models.unroll).

bf16 inputs run the same rungs: the bf16-storage variants of the
whole-unroll and trajectory kernels (with a gradient, bf16 training:
the trajectory and backward kernels' bf16 variants), or the plain loop
in bf16 (the JAX package's scan); the route names say bf16
(``kernel_route``, ``plain_route``).

The per-layer fused kernel (ops/cuda_layer.py, the port of
pallas_layer.py) is no rung here. The JAX policy took it
("scan+fused-layer-kernel") only when the whole-unroll kernel fit VMEM
neither whole nor in batch tiles; the port's whole-unroll kernel runs at
every S, so that condition never holds. It is reached as a step_fn, as
scripts/verify_tpu.py reaches it: ``dladmm_forward(params, A, b,
step_fn=fused_layer_step)``, and for training through autograd
``train.loop.make_train_step(..., step_fn=fused_layer_step)``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch

from dladmm_tpu_torch.models.unroll import dladmm_forward
from dladmm_tpu_torch.ops.cuda_traj import make_unrolled_trajectory
from dladmm_tpu_torch.ops.cuda_unroll import make_unrolled_forward

ForwardFn = Callable  # (params, A, b) -> (x, z, lam)

KERNELS = ("auto", "megakernel", "pallas", "reference")


def select_forward(
    m: int,
    n: int,
    d: int,
    S: int,
    kernel: str = "auto",
    need_trajectory: bool = False,
    identity_B: bool = True,
    device="cuda",
    dtype=torch.float32,
) -> Tuple[Optional[ForwardFn], Optional[Callable], str]:
    """Returns (forward_fn, step_fn, description), as the JAX package's.

    forward_fn replaces the whole unroll; step_fn plugs into
    dladmm_forward's loop. (None, None) means the plain reference loop.
    With need_trajectory, forward_fn returns the stacked (K, S, .)
    trajectory (train/loop.loss_fn's deep-supervision contract).
    ``device`` and ``dtype`` (the served storage type, float32 or
    bfloat16) only name the route in the description: the kernels'
    wrappers dispatch on the tensors they are given. n and S are read by
    no rung; they keep the JAX package's signature.
    """
    if kernel not in KERNELS:
        raise ValueError(f"kernel={kernel!r}; the port offers {KERNELS}")
    if kernel == "reference" or not identity_B or d != m:
        return None, None, plain_route("reference", dtype)
    if need_trajectory:
        return make_unrolled_trajectory(), None, kernel_route(device, "trajectory", dtype)
    return make_unrolled_forward(), None, kernel_route(device, dtype=dtype)


def _bf16(dtype) -> bool:
    return dtype in (torch.bfloat16, "bfloat16")


def kernel_route(device, kind: str = "whole-unroll", dtype=torch.float32) -> str:
    """How a kernel route (``kind``: whole-unroll, trajectory,
    int8-unroll) runs on ``device``: the CUDA kernel on the card, its
    plain version on the CPU; bf16 storage says so
    (``cuda-whole-unroll-bf16-kernel``)."""
    kind = f"{kind}-bf16" if _bf16(dtype) else kind
    if torch.device(device).type == "cuda":
        return f"cuda-{kind}-kernel"
    return f"{kind}-plain-cpu"


def plain_route(kind: str, dtype=torch.float32) -> str:
    """The name of a plain-loop route (``kind``: reference, general-B,
    prox), with its dtype where it is bf16 (``plain-loop-bf16-reference``)."""
    return f"plain-loop-bf16-{kind}" if _bf16(dtype) else f"plain-loop-{kind}"


def resolve_forward(
    m: int,
    n: int,
    d: int,
    S: int,
    kernel: str = "auto",
    need_trajectory: bool = False,
    identity_B: bool = True,
    device="cuda",
    dtype=torch.float32,
) -> Tuple[ForwardFn, str]:
    """select_forward collapsed to ONE callable (params, A, b) ->
    (x, z, lam): the kernel when selected, else the plain loop with the
    selected (or default) step_fn."""
    forward_fn, step_fn, desc = select_forward(
        m, n, d, S, kernel, need_trajectory, identity_B, device, dtype
    )
    if forward_fn is None:
        forward_fn = functools.partial(dladmm_forward, step_fn=step_fn)
    return forward_fn, desc
