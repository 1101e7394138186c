"""Plain PyTorch golden ops for the D-LADMM recurrence.

The port of ``dladmm_tpu/ops/reference.py`` and the semantic reference
for everything else in the port: the CUDA whole-unroll kernel
(ops/cuda_unroll.py) and the classical LADMM baseline are tested against
these functions, and these against the JAX package
(tests/test_torch_ops.py).

Math (paper Eq. 8-10, l1/l1 robust sparse coding instantiation):

    u_k      = A x_k + B z_k - b + lam_k / beta_k
    x_{k+1}  = shrink( x_k - W1_k u_k ,  theta1_k )      W1_k in R^{n x m}
    v_k      = A x_{k+1} + B z_k - b + lam_k / beta_k    (Gauss-Seidel)
    z_{k+1}  = shrink( z_k - W2_k v_k ,  theta2_k )      W2_k in R^{d x m}
    lam_{k+1}= lam_k + beta_k (A x_{k+1} + B z_{k+1} - b)

Conventions (the JAX package's, so the tests compare like with like):
  * Everything is batch-first: x (S, n), z (S, d), lam/b (S, m).
  * Matrices are stored in math convention (A: (m, n), W1: (n, m),
    W2: (d, m), B: (m, d)); application is ``v @ M.T``.
  * ``B=None`` means B = I (the benchmark fast path, d == m).
  * Thresholds may be scalars, per-coordinate vectors (n,)/(d,), or any
    shape broadcastable against the state; they are clamped to >= 0 at
    use, and beta to >= _BETA_MIN.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor

_BETA_MIN = 1e-6


class LayerParams(NamedTuple):
    """Learnable parameters of one D-LADMM layer (or K stacked layers)."""

    W1: Tensor  # (n, m)    x-update weight
    W2: Tensor  # (d, m)    z-update weight
    theta1: Tensor  # broadcastable to (S, n); typically (n,) or (1,)
    theta2: Tensor  # broadcastable to (S, d)
    beta: Tensor  # scalar penalty / dual step size


def shrink(u: Tensor, theta) -> Tensor:
    """Soft-thresholding prox of the l1 norm: sign(u) * max(|u| - theta, 0),
    with theta clamped to >= 0.

    Every clamp on a learned quantity here and in ops/prox.py is
    ``torch.maximum`` against a tensor, never ``torch.clamp``: at a tie
    maximum splits the gradient 0.5/0.5 as ``jnp.maximum`` does (and as
    the manual backward's ``_max_grad`` does), where clamp passes it
    whole."""
    zero = u.new_zeros(())
    theta = torch.maximum(torch.as_tensor(theta, dtype=u.dtype, device=u.device), zero)
    return torch.sign(u) * torch.maximum(torch.abs(u) - theta, zero)


def apply_dict(v: Tensor, M: Tensor) -> Tensor:
    """Batched mat-vec (S, k) x (j, k)^T -> (S, j), i.e. ``v @ M.T``."""
    return v @ M.T


def apply_B(z: Tensor, B: Optional[Tensor]) -> Tensor:
    """B z with the B = I fast path (B=None)."""
    return z if B is None else apply_dict(z, B)


def make_layer_step(prox_x=shrink, prox_z=shrink):
    """Plain layer step for general proximal operators (ops/prox.py).

    Returned signature: ``step(A, B, b, x, z, lam, p) -> (x1, z1, lam1)``.
    """

    def step(A, B, b, x, z, lam, p: LayerParams):
        beta = torch.maximum(p.beta, p.beta.new_tensor(_BETA_MIN))
        inv_beta = 1.0 / beta
        Ax = apply_dict(x, A)
        base = apply_B(z, B) - b + lam * inv_beta
        u = Ax + base
        x_next = prox_x(x - apply_dict(u, p.W1), p.theta1)
        # Gauss-Seidel: v uses the fresh x_next.
        Ax_next = apply_dict(x_next, A)
        v = Ax_next + base
        z_next = prox_z(z - apply_dict(v, p.W2), p.theta2)
        lam_next = lam + beta * (Ax_next + apply_B(z_next, B) - b)
        return x_next, z_next, lam_next

    return step


def make_cached_step(prox_x=shrink, prox_z=shrink):
    """Cached-matvec layer step: the same recurrence carrying A x_k and
    B z_k across layers (one A-matvec per layer instead of two).

    Returned signature:
    ``step(A, B, b, x, z, lam, Ax, Bz, p) -> (x1, z1, lam1, Ax1, Bz1)``.
    """

    def step(A, B, b, x, z, lam, Ax, Bz, p: LayerParams):
        beta = torch.maximum(p.beta, p.beta.new_tensor(_BETA_MIN))
        inv_beta = 1.0 / beta
        base = Bz - b + lam * inv_beta
        u = Ax + base
        x_next = prox_x(x - apply_dict(u, p.W1), p.theta1)
        Ax_next = apply_dict(x_next, A)
        v = Ax_next + base
        z_next = prox_z(z - apply_dict(v, p.W2), p.theta2)
        Bz_next = apply_B(z_next, B)
        lam_next = lam + beta * (Ax_next + Bz_next - b)
        return x_next, z_next, lam_next, Ax_next, Bz_next

    return step


_l1_plain_step = make_layer_step()
_l1_cached_step = make_cached_step()


def dladmm_layer_step(A, B, b, x, z, lam, p: LayerParams):
    """One l1/l1 D-LADMM layer: (x, z, lam) -> (x1, z1, lam1)."""
    return _l1_plain_step(A, B, b, x, z, lam, p)


def dladmm_layer_step_cached(A, B, b, x, z, lam, Ax, Bz, p: LayerParams):
    """One l1/l1 layer carrying A x_k and B z_k; returns
    (x1, z1, lam1, Ax1, Bz1)."""
    return _l1_cached_step(A, B, b, x, z, lam, Ax, Bz, p)


def init_state(b: Tensor, n: int, d: int):
    """Zero initial (x, z, lam) for a batch b of shape (S, m)."""
    S = b.shape[0]
    kw = dict(dtype=b.dtype, device=b.device)
    return (
        torch.zeros((S, n), **kw),
        torch.zeros((S, d), **kw),
        torch.zeros((S, b.shape[1]), **kw),
    )
