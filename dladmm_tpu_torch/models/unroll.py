"""K-layer D-LADMM unroll over stacked per-layer params.

The port of ``dladmm_tpu/models/unroll.py``. Per-layer parameters are
stacked into ``[K, ...]`` tensors with the JAX package's field names;
the unroll is a plain loop over the K layers of the cached layer step
(PyTorch runs eagerly, so the JAX package's ``lax.scan`` becomes a
loop). The hot path for inference is the CUDA whole-unroll kernel
(ops/cuda_unroll.py); this loop is the reference it is held against.

Also implements the LADMM-exact initialization: an untrained net
reproduces classical LADMM iterations (tests/test_torch_unroll_kernel.py
holds it against baselines/ladmm.py).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import Tensor, nn

from dladmm_tpu_torch.ops.reference import (
    LayerParams,
    apply_B,
    apply_dict,
    dladmm_layer_step_cached,
    init_state,
)

StepFn = Callable[..., tuple]


class DLADMMParams(NamedTuple):
    """Stacked per-layer parameters: every leaf has a leading K axis."""

    W1: Tensor  # (K, n, m)
    W2: Tensor  # (K, d, m)
    theta1: Tensor  # (K, n) or (K, 1)
    theta2: Tensor  # (K, d) or (K, 1)
    beta: Tensor  # (K,)

    @property
    def K(self) -> int:
        return self.W1.shape[0]

    def layer(self, k) -> LayerParams:
        return LayerParams(*(leaf[k] for leaf in self))

    def to(self, *args, **kwargs) -> "DLADMMParams":
        """Every leaf through ``Tensor.to`` (device and/or dtype)."""
        return DLADMMParams(*(leaf.to(*args, **kwargs) for leaf in self))


def spectral_norm_sq(M: Tensor) -> Tensor:
    """L = ||M^T M||_2 = sigma_max(M)^2, the Lipschitz constant of the
    classical LADMM step sizes. Exact (SVD); init-time only."""
    return torch.linalg.matrix_norm(M, ord=2) ** 2


def init_dladmm_params(
    A: Tensor,
    B: Optional[Tensor] = None,
    K: int = 15,
    beta: float = 1.0,
    per_coordinate: bool = True,
    dtype=torch.float32,
) -> DLADMMParams:
    """LADMM-exact initialization on A's device.

    Factoring lam + beta*r = beta*u in the classical x-update gives
        x+ = shrink(x - (A^T / L_A) u, 1/(beta L_A)),
    so W1 = A^T / L_A, theta1 = 1/(beta L_A) (and likewise for B). With
    this init the K-layer net's trajectory equals K classical LADMM
    iterations.

    per_coordinate: thresholds as vectors (K, n) / (K, d); False keeps
    scalars (K, 1). Both broadcast identically.
    """
    m, n = A.shape
    d = m if B is None else B.shape[1]
    kw = dict(dtype=dtype, device=A.device)
    L_A = spectral_norm_sq(A).to(dtype)
    L_B = (
        torch.ones((), **kw) if B is None else spectral_norm_sq(B).to(dtype)
    )
    W1_0 = (A.T / L_A).to(dtype)  # (n, m)
    if B is None:
        W2_0 = torch.eye(m, **kw) / L_B  # (m, m)
    else:
        W2_0 = (B.T / L_B).to(dtype)  # (d, m)
    th1 = torch.ones((n,) if per_coordinate else (1,), **kw) * (1.0 / (beta * L_A))
    th2 = torch.ones((d,) if per_coordinate else (1,), **kw) * (1.0 / (beta * L_B))

    def tile(a):
        return a.expand((K,) + a.shape).contiguous()

    return DLADMMParams(
        W1=tile(W1_0),
        W2=tile(W2_0),
        theta1=tile(th1),
        theta2=tile(th2),
        beta=torch.full((K,), beta, **kw),
    )


def dladmm_forward(
    params: DLADMMParams,
    A: Tensor,
    b: Tensor,
    B: Optional[Tensor] = None,
    x0: Optional[Tensor] = None,
    z0: Optional[Tensor] = None,
    lam0: Optional[Tensor] = None,
    capture_trajectory: bool = False,
    step_fn: Optional[StepFn] = None,
):
    """Run the K-layer unroll: a loop of the cached layer step.

    Args:
      params: stacked (K, ...) parameters.
      A: (m, n) dictionary; b: (S, m) observations; B: (m, d) or None (=I).
      x0/z0/lam0: optional initial state; zeros by default.
      capture_trajectory: also return the per-layer (x_k, z_k, lam_k)
        stacked as (K, S, .).
      step_fn: layer step with the cached signature
        ``step(A, B, b, x, z, lam, Ax, Bz, p) -> (x1, z1, lam1, Ax1, Bz1)``
        (ops/reference.make_cached_step); l1/l1 by default.

    Returns:
      (x_K, z_K, lam_K) and, if capture_trajectory, the (K, S, .) stacks.
    """
    if step_fn is None:
        step_fn = dladmm_layer_step_cached
    n = params.W1.shape[1]
    d = params.W2.shape[1]
    m = A.shape[0]
    if A.shape[1] != n or params.W1.shape[2] != m:
        raise ValueError(
            f"A {tuple(A.shape)} inconsistent with W1 "
            f"{tuple(params.W1.shape[1:])} — expected A (m, n) and "
            "per-layer W1 (n, m)"
        )
    if b.ndim != 2 or b.shape[1] != m:
        raise ValueError(f"b must be (batch, m={m}); got {tuple(b.shape)}")
    if B is not None and tuple(B.shape) != (m, d):
        raise ValueError(f"B must be (m={m}, d={d}); got {tuple(B.shape)}")
    zx, zz, zl = init_state(b, n, d)
    x = zx if x0 is None else x0
    z = zz if z0 is None else z0
    lam = zl if lam0 is None else lam0
    # Matvec carries; for the default zero init they are zeros for free.
    Ax = torch.zeros_like(lam) if x0 is None else apply_dict(x, A)
    if z0 is None:
        Bz = z if B is None else torch.zeros_like(lam)
    else:
        Bz = apply_B(z, B)
    traj = []
    for k in range(params.K):
        x, z, lam, Ax, Bz = step_fn(A, B, b, x, z, lam, Ax, Bz, params.layer(k))
        if capture_trajectory:
            traj.append((x, z, lam))
    if capture_trajectory:
        stacks = tuple(torch.stack(s) for s in zip(*traj))
        return (x, z, lam), stacks
    return x, z, lam


class DLADMM(nn.Module):
    """The K-layer D-LADMM net as an ``nn.Module``: the five stacked
    parameter tensors as ``nn.Parameter``s, the forward the plain loop.

    >>> net = DLADMM(init_dladmm_params(A, K=15))
    >>> x, z, lam = net(A, b)
    """

    def __init__(self, params: DLADMMParams):
        super().__init__()
        for name, leaf in zip(DLADMMParams._fields, params):
            setattr(self, name, nn.Parameter(leaf.detach().clone()))

    @property
    def params(self) -> DLADMMParams:
        return DLADMMParams(*(getattr(self, f) for f in DLADMMParams._fields))

    def forward(self, A: Tensor, b: Tensor, B: Optional[Tensor] = None, **kw):
        return dladmm_forward(self.params, A, b, B=B, **kw)


__all__ = [
    "DLADMM",
    "DLADMMParams",
    "init_dladmm_params",
    "dladmm_forward",
    "spectral_norm_sq",
    "init_state",
]
