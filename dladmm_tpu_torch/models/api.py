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

Serving's routes (``inference_forward``) are the one table every caller
that serves asks: serve.InferenceServer, models/solver's ``solve`` and
bench/serving. Beside the l1/l1 rung above they hold int8 (the int8
whole-unroll kernel, ops/cuda_int8.py, or the plain int8 scan,
ops/quantized.py), the trained elementwise proxes (the whole-unroll
kernel's prox variant, ops/cuda_unroll.make_unrolled_inference_prox,
where it has both proxes' variants), and the plain loop for general B
and opaque layer steps.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from dladmm_tpu_torch.models.unroll import dladmm_forward
from dladmm_tpu_torch.ops.cuda_int8 import dladmm_forward_int8_pallas, int8_unroll_forward
from dladmm_tpu_torch.ops.cuda_traj import make_unrolled_trajectory
from dladmm_tpu_torch.ops.cuda_unroll import (
    make_unrolled_forward,
    make_unrolled_inference_prox,
    prox_megakernel_available,
    unroll_forward,
)
from dladmm_tpu_torch.ops.quantized import dladmm_forward_int8
from dladmm_tpu_torch.ops.reference import make_cached_step

ForwardFn = Callable  # (params, A, b) -> (x, z, lam)

KERNELS = ("auto", "megakernel", "pallas", "reference")

# kernel= choices of int8 serving, as in the JAX package.
INT8_KERNELS = ("auto", "megakernel", "reference")

# kernel= choices where only the plain loop serves: a general B, or an
# opaque layer step without its prox callables.
PLAIN_KERNELS = ("auto", "reference")


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


class InferenceRoute(NamedTuple):
    """What ``inference_forward`` picked: ``forward`` (params, A, b) ->
    (x, z, lam), for int8 (QuantizedParams, QuantizedDict, b); its
    ``route`` name; and ``counter``, the kernel wrapper whose ``launches``
    count the route's launches, None where it launches no kernel (the
    plain loop, or a kernel's plain version on the CPU)."""

    forward: ForwardFn
    route: str
    counter: Optional[Callable]


def inference_forward(
    m: int,
    d: int,
    kernel: str = "auto",
    dtype=torch.float32,
    B=None,
    prox_pair=None,
    step_fn=None,
    device="cuda",
) -> InferenceRoute:
    """The inference forward of a served net, without a gradient or a
    trajectory: A (m, n), z in R^d; ``dtype`` the served type (float32,
    bfloat16 or "int8"); ``B`` a general z-dictionary or None for B = I;
    ``prox_pair`` the (prox_x, prox_z) callables of a trained prox, or
    ``step_fn`` an opaque cached layer step (ops/reference.
    make_cached_step), None for l1/l1. Raises ValueError where ``kernel``
    does not apply.

      * l1/l1, B = I: ``select_forward``'s rung, in fp32 or bf16 storage.
      * int8 (l1/l1, B = I): the int8 kernel for auto and megakernel, the
        plain int8 scan for reference.
      * a prox pair (B = I): the prox variant of the whole-unroll kernel
        for auto and megakernel where ``prox_megakernel_available`` says
        so, else the plain loop; megakernel raises where it has none.
      * a general B or an opaque step_fn: the plain loop.

    ``device`` names the route and says whether a kernel launches; the
    kernels' wrappers dispatch on the tensors they are given."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel={kernel!r}; the port offers {KERNELS}")
    on_card = torch.device(device).type == "cuda"
    if dtype == "int8":
        if B is not None:
            raise ValueError(
                "dtype='int8' requires identity B (the quantized forward "
                "specializes to B = I like the kernels)"
            )
        if step_fn is not None or prox_pair is not None:
            raise ValueError(
                "dtype='int8' serving is l1/l1-only (ops/quantized.py "
                "hard-codes the shrink); serve general-prox solvers in float32 "
                "or bfloat16"
            )
        if kernel not in INT8_KERNELS:
            raise ValueError(
                f"dtype='int8' serves via ops/quantized.py; kernel={kernel!r} "
                f"does not apply (use one of {INT8_KERNELS})"
            )
        if kernel == "reference":
            return InferenceRoute(dladmm_forward_int8, "plain-loop-int8-reference", None)
        return InferenceRoute(
            dladmm_forward_int8_pallas, kernel_route(device, "int8-unroll"), int8_unroll_forward if on_card else None
        )
    if prox_pair is not None and B is not None:
        raise ValueError(
            "prox_pair requires identity B (the kernel "
            "specializes B = I); pass step_fn for general B"
        )
    if step_fn is not None and prox_pair is None and kernel not in PLAIN_KERNELS:
        raise ValueError(
            f"kernel={kernel!r} does not apply to general-prox "
            f"serving (allowed here: {PLAIN_KERNELS}); the kernel "
            "path needs the prox CALLABLES (prox_pair)"
        )
    if B is not None:
        if kernel not in PLAIN_KERNELS:
            raise ValueError(
                f"kernel={kernel!r} requires identity B; general-B "
                "serving runs the plain loop"
            )
        forward_fn = functools.partial(dladmm_forward, B=B, step_fn=step_fn)
        return InferenceRoute(forward_fn, plain_route("general-B", dtype), None)
    if prox_pair is None and step_fn is None:
        forward_fn, _, route = select_forward(m, None, d, None, kernel, device=device, dtype=dtype)
        if forward_fn is None:
            return InferenceRoute(dladmm_forward, route, None)
        return InferenceRoute(forward_fn, route, unroll_forward if on_card else None)
    available, why = prox_megakernel_available(prox_pair, m, d)
    if available and kernel in ("auto", "megakernel"):
        return InferenceRoute(
            make_unrolled_inference_prox(*prox_pair),
            kernel_route(device, dtype=dtype) + "-prox",
            unroll_forward if on_card else None,
        )
    if kernel == "megakernel":
        raise ValueError(f"prox kernel unavailable (m={m}, d={d}): {why}; use kernel='auto'")
    if step_fn is None:
        step_fn = make_cached_step(*prox_pair)
    return InferenceRoute(functools.partial(dladmm_forward, step_fn=step_fn), plain_route("prox", dtype), None)
