"""The image benchmark's training loss: overlapping patches of the
corrupted and the clean images, each less the median of its corrupted
pixels, and the final layer's reconstruction error.

For a corrupted image y and its clean image c, every patch x patch
window at stride ``stride`` (row-major over the windows, each window's
pixels row-major) gives a row; the DC of a row is the median of its
corrupted pixels (the mean of the two middle values of an even count).
Then b = y - DC, the clean residual c - DC and the corruption y - c, and
the loss is mean((x_K A^T - (c - DC))^2) + mean((z_K - (y - c))^2) with
(x_K, z_K) the unroll's final state on b (``solver.unroll``).
"""

from __future__ import annotations

import torch

from benchmark.reference.solver import unroll


def patches(img: torch.Tensor, patch: int, stride: int) -> torch.Tensor:
    """(H, W) -> (windows, patch * patch), one strided slice of the image
    a pixel of the window."""
    H, W = img.shape
    ny, nx = (H - patch) // stride + 1, (W - patch) // stride + 1
    cols = [img[i:i + stride * (ny - 1) + 1:stride, j:j + stride * (nx - 1) + 1:stride]
            for i in range(patch) for j in range(patch)]
    return torch.stack(cols, dim=-1).reshape(ny * nx, patch * patch)


def median_dc(rows: torch.Tensor) -> torch.Tensor:
    """Each row's median, (P, k) -> (P, 1)."""
    s = torch.sort(rows, dim=1).values
    k = s.shape[1]
    if k % 2:
        return s[:, k // 2:k // 2 + 1]
    return (s[:, k // 2 - 1:k // 2] + s[:, k // 2:k // 2 + 1]) / 2


def patch_batch(noisy, clean, patch: int, stride: int):
    """(b, clean residual, corruption), each (P, patch * patch), over the
    pairs of corrupted and clean images in order."""
    out = ([], [], [])
    for y, c in zip(noisy, clean):
        py, pc = patches(y, patch, stride), patches(c, patch, stride)
        dc = median_dc(py)
        for part, t in zip(out, (py - dc, pc - dc, py - pc)):
            part.append(t)
    return tuple(torch.cat(part) for part in out)


def loss(params, A, b, tgt_res, tgt_noise):
    x, z, _ = unroll(params, A, b)
    return torch.mean((x @ A.T - tgt_res) ** 2) + torch.mean((z - tgt_noise) ** 2)


def loss_and_grads(params, A, b, tgt_res, tgt_noise):
    leaves = [p.detach().clone().requires_grad_() for p in params]
    value = loss(leaves, A, b, tgt_res, tgt_noise)
    grads = torch.autograd.grad(value, leaves)
    return value.detach(), [g.detach() for g in grads]
