"""The image benchmark's data: its dictionary, its clean image and its
corruption.

Frozen copies of ``dladmm_tpu_torch/data/dictionary.py``'s
``dct_dictionary`` and of ``dladmm_tpu_torch/data/images.py``'s
``synthetic_image`` and ``salt_pepper`` at commit ac0957e: the reference
builds its own A and clean images with them, and draws a training
step's corruption again from the step's generator, and must get the
program's numbers bit for bit; a program whose dictionary, image or
draw drifts then reads apart from the reference.
"""

from __future__ import annotations

import numpy as np
import torch


def dct_dictionary(patch: int, atoms_per_dim: int, device=None) -> torch.Tensor:
    """The overcomplete 2-D DCT dictionary (patch^2, atoms_per_dim^2) in
    fp32: the 1-D cosines at atoms_per_dim frequencies, each AC atom less
    its mean, columns unit-norm; their Kronecker product, columns
    unit-norm again; built in float64 with numpy and cast."""
    k = np.arange(patch)[:, None]
    j = np.arange(atoms_per_dim)[None, :]
    D1 = np.cos(np.pi * (k + 0.5) * j / atoms_per_dim)
    D1 -= D1.mean(axis=0, keepdims=True) * (j > 0)
    D1 /= np.linalg.norm(D1, axis=0, keepdims=True)
    D = np.kron(D1, D1)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    return torch.as_tensor(D, dtype=torch.float32, device=device)


def _grid(size: int) -> np.ndarray:
    """size points from 0 to 1 in float32: the index times the float32
    reciprocal of size - 1, the last point 1."""
    if size == 1:
        return np.zeros(1, np.float32)
    g = np.arange(size, dtype=np.float32) * (np.float32(1) / np.float32(size - 1))
    g[-1] = 1.0
    return g


def synthetic_image(size: int, device=None) -> torch.Tensor:
    """The (size, size) fp32 test image in [0, 1]: a smooth ramp, a
    rectangle at 0.85, a circle at 0.15 and a sinusoidal strip at the
    bottom."""
    g = torch.from_numpy(_grid(size)).to(device)
    yy, xx = torch.meshgrid(g, g, indexing="ij")
    img = 0.3 + 0.4 * xx + 0.2 * yy
    img = torch.where((yy > 0.15) & (yy < 0.45) & (xx > 0.5) & (xx < 0.85), 0.85, img)
    img = torch.where((yy - 0.65) ** 2 + (xx - 0.3) ** 2 < 0.18 ** 2, 0.15, img)
    tex = 0.5 + 0.25 * torch.sin(2 * np.pi * 12 * xx) * torch.sin(2 * np.pi * 3 * yy)
    img = torch.where(yy > 0.8, tex, img)
    return torch.clamp(img, 0.0, 1.0).to(torch.float32)


def salt_pepper(gen: torch.Generator, img: torch.Tensor, density: float) -> torch.Tensor:
    """A fraction ``density`` of the pixels forced to 0 or 1: one uniform
    draw for the hits, then one for the values, from ``gen``."""
    hit = torch.rand(img.shape, generator=gen, device=img.device) < density
    val = (torch.rand(img.shape, generator=gen, device=img.device) < 0.5).to(img.dtype)
    return torch.where(hit, val, img)
