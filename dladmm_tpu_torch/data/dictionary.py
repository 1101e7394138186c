"""Patch dictionaries for the image-denoising benchmark, the port of
``dladmm_tpu/data/dictionary.py``:

  * ``dct_dictionary``: the overcomplete 2-D DCT dictionary (closed form,
    built in float64 with numpy and cast, so both packages hold the same
    matrix);
  * ``learn_dictionary``: dictionary learning on clean training patches,
    batched FISTA sparse coding alternated with a MOD (least-squares)
    dictionary update, on the patches' device.

The JAX package runs both loops as ``lax.scan``s inside one jit; here
they are plain Python loops of tensor ops (batched matrix products, the
shrink, an (n, n) Cholesky solve per outer step).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor


def dct_dictionary(patch: int = 8, atoms_per_dim: int = 16, dtype=torch.float32, device=None) -> Tensor:
    """Overcomplete 2-D DCT dictionary (patch^2, atoms_per_dim^2), columns
    unit-norm. patch=8, atoms=16 -> 64 x 256 (4x overcomplete)."""
    k = np.arange(patch)[:, None]
    j = np.arange(atoms_per_dim)[None, :]
    D1 = np.cos(np.pi * (k + 0.5) * j / atoms_per_dim)  # (patch, atoms)
    D1 -= D1.mean(axis=0, keepdims=True) * (j > 0)  # zero-mean AC atoms
    D1 /= np.linalg.norm(D1, axis=0, keepdims=True)
    D = np.kron(D1, D1)  # (patch^2, atoms^2)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    return torch.as_tensor(D, dtype=dtype, device=device)


def _fista_code(D: Tensor, P: Tensor, lam: float, iters: int) -> Tensor:
    """Batched LASSO coding: argmin_X 0.5||P - X D^T||^2 + lam ||X||_1.

    P (S, m) patches, D (m, n); returns codes X (S, n). FISTA with the
    fixed step 1/L, L = ||D^T D||_2 from 16 steps of power iteration."""
    G = D.T @ D  # (n, n) Gram, reused every iteration
    v = torch.ones((G.shape[0],), dtype=D.dtype, device=D.device) / np.sqrt(G.shape[0])
    for _ in range(16):
        w = G @ v
        v = w / torch.linalg.vector_norm(w)
    L = v @ (G @ v)
    step = 1.0 / L
    thresh = lam * step
    PD = P @ D  # (S, n), constant across iterations

    def shrink(u):
        return torch.sign(u) * torch.clamp(torch.abs(u) - thresh, min=0.0)

    X = Y = shrink(step * PD)
    t = torch.ones((), dtype=D.dtype, device=D.device)
    for _ in range(iters):
        Xn = shrink(Y - step * (Y @ G - PD))
        tn = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        Y = Xn + ((t - 1.0) / tn) * (Xn - X)
        X, t = Xn, tn
    return X


@torch.no_grad()
def learn_dictionary(
    patches: Tensor,
    init: Tensor,
    *,
    n_atoms: int = 256,
    outer: int = 12,
    fista_iters: int = 40,
    lam: float = 0.05,
    eps: float = 1e-6,
) -> Tensor:
    """Learn an overcomplete patch dictionary by alternating minimization:
    min_{D, X} 0.5 ||P - X D^T||^2 + lam ||X||_1 with unit-norm columns;
    a FISTA coding step, then the MOD update D <- P^T X (X^T X + eps I)^-1
    (Cholesky). Atoms no code uses keep their previous direction.

    patches: (S, m) zero-DC training patches; init: (m, n_atoms) starting
    dictionary (``dct_dictionary``)."""
    if init.shape[1] != n_atoms:
        raise ValueError(f"init has {init.shape[1]} atoms, n_atoms={n_atoms}")
    P = patches
    eye = torch.eye(n_atoms, dtype=init.dtype, device=init.device)
    D = init
    for _ in range(outer):
        X = _fista_code(D, P, lam, fista_iters)  # (S, n)
        gram = X.T @ X + eps * eye
        Dn = torch.cholesky_solve(X.T @ P, torch.linalg.cholesky(gram)).T
        norms = torch.linalg.vector_norm(Dn, dim=0, keepdim=True)
        Dn = torch.where(norms > 1e-8, Dn / torch.clamp(norms, min=1e-8), D)
        D = Dn.to(init.dtype)
    return D


__all__ = ["dct_dictionary", "learn_dictionary"]
