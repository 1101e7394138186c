"""Blockwise sqrt-companded int8 storage for Adam moments.

The port of the codec half of ``dladmm_tpu/train/qmoments.py``. Masters
stay fp32 and the update math runs in fp32; only the stored moments
shrink. The flat codec here:

  * the leaf is flattened and zero-padded to blocks of 256 values that
    share one fp32 absmax scale (1.0 for an all-zero block);
  * within a block, y = x / scale is companded with a signed square
    root, c = sign(y) * sqrt(|y|), and rounded half to even to int8
    codes round(127 c);
  * decode is sign(c) * c^2 * scale with c = code / 127 (a division,
    as the JAX package's ``dequantize_q8``; the per-row codec of
    train/qadam_cuda.py multiplies by 1/127 instead, as its TPU kernel).

The fused optimizer (train/qadam_cuda.QAdamFused) keeps this codec for
the leaves its per-row kernel does not take (θ and β stacks). The
XLA-side ``adam_qmoments`` optimizer (``moment_dtype`` int8, bfloat16,
bfloat16_sr without ``_pallas``) and the stochastic-rounding helper are
not ported yet (ROADMAP.md §1).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import Tensor

BLOCK = 256


class QTensor(NamedTuple):
    """Companded int8 tensor: int8 codes plus fp32 scales. The flat codec
    stores codes (nblocks, BLOCK) and scales (nblocks,); the per-row
    codec (train/qadam_cuda.quantize_rows) codes (R, L) and scales (R,).
    The logical shape is carried by the matching parameter leaf."""

    codes: Tensor
    scale: Tensor


class QMomentsState(NamedTuple):
    count: Tensor  # int32 scalar on the device: steps taken
    mu: Any  # QTensor per leaf (same structure as the params)
    nu: Any
    key: Any = None  # stochastic-rounding formats only; not ported


def _compand(blocks: Tensor):
    """(rows, width) fp32 -> (int8 codes, (rows,) scales), one absmax
    scale per row."""
    absmax = torch.amax(torch.abs(blocks), dim=1)
    scale = torch.where(absmax > 0.0, absmax, torch.ones_like(absmax))
    y = blocks / scale[:, None]
    c = torch.sign(y) * torch.sqrt(torch.abs(y))
    return torch.round(c * 127.0).to(torch.int8), scale


def quantize_q8(x: Tensor, block: int = BLOCK) -> QTensor:
    """fp32 tensor (any shape) -> QTensor (flattened, zero-padded)."""
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    codes, scale = _compand(flat.reshape(-1, block))
    return QTensor(codes, scale)


def dequantize_q8(q: QTensor, shape) -> Tensor:
    """QTensor -> fp32 tensor of ``shape`` (inverse of quantize_q8 up to
    the int8 rounding)."""
    c = q.codes.to(torch.float32) / 127.0
    y = torch.sign(c) * c * c * q.scale[:, None]
    size = 1
    for s in shape:
        size *= s
    return y.reshape(-1)[:size].reshape(tuple(shape))


__all__ = ["BLOCK", "QTensor", "QMomentsState", "quantize_q8", "dequantize_q8"]
