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
the leaves its per-row kernel does not take (θ and β stacks).

``sr_bfloat16`` is the JAX package's stochastic rounding to bf16 (add 16
random bits below the bf16 boundary, then truncate). Its bits come from
a counter-based hash of a device seed tensor and the element index,
computed with tensor ops (uint32 arithmetic emulated on int64), so no
step waits for the host; ``jax.random``'s threefry stream is not
reproduced. The XLA-side ``adam_qmoments`` optimizer (``moment_dtype``
int8, bfloat16, bfloat16_sr without ``_pallas``) is not ported yet
(ROADMAP.md §1).
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
    key: Any = None  # the XLA-side SR optimizer's PRNG key; not ported


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
    the int8 rounding). A true division by 127 on every device (PyTorch's
    CUDA division by a Python number multiplies by its reciprocal), as
    the int8 sweep's flat codec divides."""
    c = q.codes.to(torch.float32) / torch.full((), 127.0, device=q.codes.device)
    y = torch.sign(c) * c * c * q.scale[:, None]
    size = 1
    for s in shape:
        size *= s
    return y.reshape(-1)[:size].reshape(tuple(shape))


U32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def mul32(a: Tensor, c: int) -> Tensor:
    """(a * c) mod 2**32 for an int64 tensor ``a`` of uint32 values and a
    uint32 constant ``c``, in 16-bit halves so no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & U32


def fmix32(s: Tensor) -> Tensor:
    """The xor-shift / multiply finalizer of the JAX package's
    ``_mix_seed`` on uint32 values held in an int64 tensor: a bijection
    of [0, 2**32)."""
    s = s ^ (s >> 16)
    s = mul32(s, 0x7FEB352D)
    s = s ^ (s >> 15)
    s = mul32(s, 0x846CA68B)
    return s ^ (s >> 16)


def random_bits16(seed: Tensor, numel: int, stream: int = 0) -> Tensor:
    """(numel,) int64 tensor of 16 random bits each on ``seed``'s device:
    fmix32 of the element index xor a key mixed from (seed, stream).
    ``seed`` is an integer tensor of one element, read as uint32."""
    key = fmix32((seed.reshape(()).to(torch.int64) + (stream + 1) * GOLDEN) & U32)
    idx = torch.arange(numel, dtype=torch.int64, device=seed.device)
    return fmix32(idx ^ key) & 0xFFFF


def sr_bfloat16(x: Tensor, seed: Tensor, stream: int = 0) -> Tensor:
    """fp32 -> bf16 with stochastic rounding, as the JAX package's
    ``qmoments.sr_bfloat16``: add 16 random bits below the bf16 mantissa
    boundary (uint32 wrap-around), then truncate. Unbiased in
    expectation. The bits are ``random_bits16(seed, x.numel(), stream)``:
    ``stream`` keeps two moments rounded under one seed independent."""
    u = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & U32
    v = (u + random_bits16(seed, x.numel(), stream).view(x.shape)) & 0xFFFF0000
    v = torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)
    return v.view(torch.float32).to(torch.bfloat16)  # exact: the low 16 bits are 0


__all__ = [
    "BLOCK", "GOLDEN", "QTensor", "QMomentsState", "U32", "dequantize_q8", "fmix32", "mul32", "quantize_q8",
    "random_bits16", "sr_bfloat16",
]
