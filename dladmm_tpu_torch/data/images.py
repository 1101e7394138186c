"""Image patch pipeline for the denoising benchmark, the port of
``dladmm_tpu/data/images.py``: deterministic synthetic test images,
impulse (salt & pepper) and known-mask corruption, overlapping patch
extraction, overlap-average reconstruction and the robust per-patch DC.

Everything runs on the image's device with tensor ops (the JAX package
runs these in plain XLA, no kernel): extraction is ``Tensor.unfold``,
reconstruction ``nn.functional.fold`` of the patches and of a count. The
corruptions draw from an explicit ``torch.Generator`` on the image's
device; its stream is not ``jax.random``'s.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor


def _grid(size: int) -> np.ndarray:
    """jnp.linspace(0, 1, size) in float32 as XLA computes it: the index
    times the float32 reciprocal of size - 1, the last point 1 (a true
    division, or torch.linspace, differs in the last bit at some points,
    which can move a pixel across a shape's edge)."""
    if size == 1:
        return np.zeros(1, np.float32)
    g = np.arange(size, dtype=np.float32) * (np.float32(1) / np.float32(size - 1))
    g[-1] = 1.0
    return g


def synthetic_image(size: int = 128, dtype=torch.float32, device=None) -> Tensor:
    """Deterministic piecewise-smooth test image in [0, 1]: smooth
    gradients, a rectangle, a circle and a sinusoidal texture strip
    (the JAX package's, whose key is unused)."""
    g = torch.from_numpy(_grid(size)).to(device)
    yy, xx = torch.meshgrid(g, g, indexing="ij")
    img = 0.3 + 0.4 * xx + 0.2 * yy
    # rectangle
    r0, r1 = 0.15, 0.45
    img = torch.where((yy > r0) & (yy < r1) & (xx > 0.5) & (xx < 0.85), 0.85, img)
    # circle
    cy, cx, rad = 0.65, 0.3, 0.18
    img = torch.where((yy - cy) ** 2 + (xx - cx) ** 2 < rad**2, 0.15, img)
    # texture strip
    tex = 0.5 + 0.25 * torch.sin(2 * np.pi * 12 * xx) * torch.sin(2 * np.pi * 3 * yy)
    img = torch.where(yy > 0.8, tex, img)
    return torch.clamp(img, 0.0, 1.0).to(dtype)


def _uniform(gen: torch.Generator, like: Tensor) -> Tensor:
    return torch.rand(like.shape, generator=gen, device=like.device)


def salt_pepper(gen: torch.Generator, img: Tensor, density: float = 0.1) -> Tensor:
    """Impulse corruption: a fraction ``density`` of pixels forced to 0 or
    1 (two uniform draws from ``gen``, on the image's device)."""
    hit = _uniform(gen, img) < density
    val = (_uniform(gen, img) < 0.5).to(img.dtype)
    return torch.where(hit, val, img)


def dropout_mask(gen: torch.Generator, img: Tensor, density: float = 0.3):
    """Inpainting corruption: a fraction ``density`` of pixels MISSING (a
    known mask). Returns (corrupted, mask), mask 1 on observed pixels and
    the corrupted image 0 on missing ones."""
    mask = (~(_uniform(gen, img) < density)).to(img.dtype)
    return img * mask, mask


def extract_patches(img: Tensor, patch: int = 8, stride: int = 4) -> Tensor:
    """(H, W) -> (num_patches, patch*patch), row-major over the patch
    grid, each patch flattened row-major."""
    p = img.unfold(0, patch, stride).unfold(1, patch, stride)  # (ny, nx, patch, patch)
    return p.reshape(-1, patch * patch)


def reconstruct_from_patches(patches: Tensor, size: int, patch: int = 8, stride: int = 4) -> Tensor:
    """Overlap-average inverse of extract_patches on a (size, size) image:
    the sum of the patches covering each pixel over their count (pixels
    no patch covers are 0)."""
    cols = patches.T.unsqueeze(0)  # (1, patch*patch, L)
    kw = dict(output_size=(size, size), kernel_size=patch, stride=stride)
    acc = torch.nn.functional.fold(cols, **kw)[0, 0]
    cnt = torch.nn.functional.fold(torch.ones_like(cols), **kw)[0, 0]
    return acc / torch.clamp(cnt, min=1.0)


def patch_dc(patches: Tensor) -> Tensor:
    """Robust per-patch DC estimate, the median (immune to impulse
    noise) as ``jnp.median`` takes it: the mean of the two middle values
    of an even count (torch.median returns the lower one). (P, k) ->
    (P, 1)."""
    s = torch.sort(patches, dim=1).values
    k = s.shape[1]
    if k % 2:
        return s[:, k // 2:k // 2 + 1]
    return (s[:, k // 2 - 1:k // 2] + s[:, k // 2:k // 2 + 1]) / 2


__all__ = [
    "dropout_mask",
    "extract_patches",
    "patch_dc",
    "reconstruct_from_patches",
    "salt_pepper",
    "synthetic_image",
]
