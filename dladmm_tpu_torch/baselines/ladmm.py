"""Classical (fixed-parameter) linearized ADMM baseline.

The port of ``dladmm_tpu/baselines/ladmm.py``, and like it an
independent implementation written from the classical equations, not a
call into the D-LADMM layer step, so that the LADMM-exact init of the
learned model is genuinely cross-checked against it:

    x_{k+1} = shrink( x_k - (1/(beta L_A)) A^T (lam_k + beta (A x_k + B z_k - b)),
                      1/(beta L_A) )
    z_{k+1} = shrink( z_k - (1/(beta L_B)) B^T (lam_k + beta (A x_{k+1} + B z_k - b)),
                      1/(beta L_B) )
    lam_{k+1} = lam_k + beta (A x_{k+1} + B z_{k+1} - b)

with L_A >= ||A^T A||_2, L_B >= ||B^T B||_2.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor


def ladmm_run(
    A: Tensor,
    b: Tensor,
    B: Optional[Tensor] = None,
    iters: int = 15,
    beta: float = 1.0,
    L_A=None,
    L_B=None,
    capture_trajectory: bool = False,
    prox_x=None,
    prox_z=None,
):
    """Run ``iters`` classical LADMM iterations from zero state.

    Batch-first shapes (b: (S, m)). Returns the final (x, z, lam), plus
    the stacked per-iteration states when capture_trajectory. prox_x /
    prox_z replace the l1 soft-threshold (None = l1).
    """
    m, n = A.shape
    d = m if B is None else B.shape[1]
    S = b.shape[0]
    kw = dict(dtype=b.dtype, device=b.device)

    if L_A is None:
        L_A = torch.linalg.matrix_norm(A, ord=2) ** 2
    if L_B is None:
        L_B = 1.0 if B is None else torch.linalg.matrix_norm(B, ord=2) ** 2
    L_A = torch.as_tensor(L_A, **kw)
    L_B = torch.as_tensor(L_B, **kw)

    def Bz(z):
        return z if B is None else z @ B.T

    def BT(r):
        return r if B is None else r @ B

    def shrink(u, t):
        return torch.sign(u) * torch.clamp(torch.abs(u) - t, min=0.0)

    px = shrink if prox_x is None else prox_x
    pz = shrink if prox_z is None else prox_z

    x = torch.zeros((S, n), **kw)
    z = torch.zeros((S, d), **kw)
    lam = torch.zeros((S, m), **kw)
    sx = 1.0 / (beta * L_A)
    sz = 1.0 / (beta * L_B)
    traj = []
    for _ in range(iters):
        r = x @ A.T + Bz(z) - b
        x = px(x - sx * ((lam + beta * r) @ A), sx)
        r2 = x @ A.T + Bz(z) - b
        z = pz(z - sz * BT(lam + beta * r2), sz)
        lam = lam + beta * (x @ A.T + Bz(z) - b)
        if capture_trajectory:
            traj.append((x, z, lam))
    if capture_trajectory:
        return (x, z, lam), tuple(torch.stack(s) for s in zip(*traj))
    return x, z, lam
