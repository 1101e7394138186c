"""Evaluation metrics, ported from ``dladmm_tpu/metrics/core.py``.

  * NMSE(dB) = 10 log10( E_s[ ||x_hat_s - x*_s||^2 / ||x*_s||^2 ] ).
  * Relative constraint residual ||A x + B z - b|| / ||b||.
  * PSNR for the image-denoising benchmark.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

_EPS = 1e-12


def nmse_db(x_hat: Tensor, x_star: Tensor) -> Tensor:
    """Batch-mean normalized MSE in dB. Inputs (S, n).

    Samples whose ground truth has (numerically) zero support are left
    out of the mean; an all-degenerate batch gives NaN.
    """
    num = torch.sum((x_hat - x_star) ** 2, dim=-1)
    den = torch.sum(x_star**2, dim=-1)
    valid = den > _EPS
    n_valid = torch.sum(valid)
    ratio = torch.where(
        valid, num / torch.clamp(den, min=_EPS), torch.zeros_like(num)
    )
    mean = torch.sum(ratio) / torch.clamp(n_valid, min=1)
    return torch.where(
        n_valid > 0,
        10.0 * torch.log10(mean + _EPS),
        torch.full_like(mean, float("nan")),
    )


def per_layer_nmse_db(traj_x: Tensor, x_star: Tensor) -> Tensor:
    """NMSE(dB) at every layer: traj_x (K, S, n) -> (K,)."""
    return torch.stack([nmse_db(t, x_star) for t in traj_x])


def constraint_residual(
    A: Tensor, b: Tensor, x: Tensor, z: Tensor, B: Optional[Tensor] = None
) -> Tensor:
    """Batch-mean relative residual ||A x + B z - b||_2 / ||b||_2."""
    Bz = z if B is None else z @ B.T
    r = x @ A.T + Bz - b
    num = torch.linalg.vector_norm(r, dim=-1)
    den = torch.clamp(torch.linalg.vector_norm(b, dim=-1), min=_EPS)
    return torch.mean(num / den)


def psnr(x: Tensor, ref: Tensor, data_range: float = 1.0) -> Tensor:
    """Peak signal-to-noise ratio in dB over the full array."""
    mse = torch.mean((x - ref) ** 2)
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=_EPS))
