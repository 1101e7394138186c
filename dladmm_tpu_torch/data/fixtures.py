""".mat fixture loading, the port of ``dladmm_tpu/data/fixtures.py``.

The reference ships its learned patch dictionary and test images as
MATLAB .mat files (scipy.io.loadmat). This loads them into the port's
conventions:

  * dictionaries -> (m, n) tensors, columns unit-normalized
    (init_dladmm_params assumes unit-norm atoms for its Lipschitz step);
  * images -> (H, W) tensors scaled to [0, 1].

No fixture file is in the repository; the tests write their own .mat
files with scipy.io.savemat.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch
from torch import Tensor


def _load_mat(path: str) -> dict:
    import scipy.io as sio

    return sio.loadmat(path)


def _pick_var(mat: dict, key: Optional[str], what: str) -> np.ndarray:
    if key is not None:
        if key not in mat:
            data_keys = [k for k in mat if not k.startswith("__")]
            raise KeyError(f"{what}: variable {key!r} not in .mat file; available: {data_keys}")
        return np.asarray(mat[key])
    data = {k: v for k, v in mat.items() if not k.startswith("__")}
    arrays = {k: np.asarray(v) for k, v in data.items() if np.asarray(v).ndim == 2 and np.asarray(v).size > 1}
    if len(arrays) != 1:
        raise ValueError(
            f"{what}: pass key= explicitly — found {sorted(data)} "
            "(need exactly one 2-D array to auto-pick)"
        )
    return next(iter(arrays.values()))


def load_mat_dictionary(
    path: str,
    key: Optional[str] = None,
    normalize: bool = True,
    dtype=torch.float32,
    transpose="auto",
    device=None,
) -> Tensor:
    """A (m, n) dictionary from a .mat file (the reference's learned
    patch dictionary format); key=None auto-picks the single 2-D array.

    normalize=True rescales columns to unit norm. transpose: "auto"
    transposes a tall (m > n) array, with a warning (an overcomplete
    dictionary is wide, so a tall one is taken as stored transposed);
    True always transposes; False never does."""
    D = _pick_var(_load_mat(path), key, "dictionary").astype(np.float64)
    if D.ndim != 2:
        raise ValueError(f"dictionary must be 2-D, got shape {D.shape}")
    if transpose is True:
        D = D.T
    elif transpose == "auto" and D.shape[0] > D.shape[1]:
        warnings.warn(
            f"{path}: tall {D.shape} array auto-transposed to "
            f"{D.shape[::-1]} (overcomplete dictionaries are wide); pass "
            "transpose=False if it is a genuinely undercomplete dictionary"
        )
        D = D.T
    if normalize:
        D = D / np.maximum(np.linalg.norm(D, axis=0, keepdims=True), 1e-12)
    return torch.as_tensor(D, dtype=dtype, device=device)


def load_mat_image(path: str, key: Optional[str] = None, dtype=torch.float32, device=None) -> Tensor:
    """A grayscale (H, W) test image from a .mat file, scaled to [0, 1]:
    integer fixtures (or values above 1.5) divide by 255, float fixtures
    pass through with a clip."""
    img = _pick_var(_load_mat(path), key, "image")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim != 2:
        raise ValueError(f"image must be 2-D grayscale, got {img.shape}")
    is_int = np.issubdtype(img.dtype, np.integer)
    img = img.astype(np.float64)
    if is_int or img.max() > 1.5:  # uint8-style range (by dtype: a dark integer image still divides)
        img = img / 255.0
    return torch.as_tensor(np.clip(img, 0.0, 1.0), dtype=dtype, device=device)


__all__ = ["load_mat_dictionary", "load_mat_image"]
