"""Forward selection policy for inference (the kernel={...} switch).

The port of ``dladmm_tpu/models/api.py`` for the serving slice:

  * ``auto`` / ``megakernel``: the whole-unroll kernel
    (ops/cuda_unroll.make_unrolled_forward). On CUDA tensors that is the
    hand-written CUDA kernel; on CPU tensors its plain version. The TPU
    policy's VMEM tiers (whole batch, batch tiles, per-layer kernel, XLA
    scan) collapse into this one rung: the CUDA kernel has no fit gate.
  * ``reference``, or a general B: the plain loop (models.unroll).

The trajectory forward (training, deep supervision) and the per-layer
fused kernel are later slices of the port (ROADMAP.md).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch

from dladmm_tpu_torch.models.unroll import dladmm_forward
from dladmm_tpu_torch.ops.cuda_unroll import make_unrolled_forward

ForwardFn = Callable  # (params, A, b) -> (x, z, lam)

KERNELS = ("auto", "megakernel", "reference")


def select_forward(
    m: int,
    n: int,
    d: int,
    S: int,
    kernel: str = "auto",
    need_trajectory: bool = False,
    identity_B: bool = True,
    device="cuda",
) -> Tuple[Optional[ForwardFn], Optional[Callable], str]:
    """Returns (forward_fn, step_fn, description), as the JAX package's.

    forward_fn replaces the whole unroll; step_fn plugs into
    dladmm_forward's loop. (None, None) means the plain reference loop.
    ``device`` only names the route in the description: the kernel's
    wrapper dispatches on the tensors it is given. n and S are read by
    no rung yet; they keep the JAX package's signature.
    """
    if need_trajectory:
        raise NotImplementedError(
            "trajectory forwards (the _unroll_traj_kernel port, training "
            "and deep supervision) are the port's next slice: ROADMAP.md "
            "queue 2, item 1"
        )
    if kernel not in KERNELS:
        raise ValueError(f"kernel={kernel!r}; the port offers {KERNELS}")
    if kernel == "reference" or not identity_B or d != m:
        return None, None, "plain-loop-reference"
    return make_unrolled_forward(), None, kernel_route(device)


def kernel_route(device) -> str:
    """How the whole-unroll forward runs on ``device``: the CUDA kernel
    on the card, its plain version on the CPU."""
    if torch.device(device).type == "cuda":
        return "cuda-whole-unroll-kernel"
    return "whole-unroll-plain-cpu"


def resolve_forward(
    m: int,
    n: int,
    d: int,
    S: int,
    kernel: str = "auto",
    need_trajectory: bool = False,
    identity_B: bool = True,
    device="cuda",
) -> Tuple[ForwardFn, str]:
    """select_forward collapsed to ONE callable (params, A, b) ->
    (x, z, lam): the kernel when selected, else the plain loop with the
    selected (or default) step_fn."""
    forward_fn, step_fn, desc = select_forward(
        m, n, d, S, kernel, need_trajectory, identity_B, device
    )
    if forward_fn is None:
        forward_fn = functools.partial(dladmm_forward, step_fn=step_fn)
    return forward_fn, desc
