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
reproduced.

``scale_by_adam_qmoments`` / ``adam_qmoments`` are the XLA-side
optimizer of ``moment_dtype`` int8, bfloat16 and bfloat16_sr (without
``_pallas``): optax-style transformations in plain PyTorch whose update
math is fp32 and op for op the JAX package's; only the stored moments
shrink (the flat codec for int8, bf16 for the others). The JAX package
compiles them through XLA, so they have no kernel here either. The SR
format's PRNG key is a device int32 seed (17 at init), advanced once a
step (``_next_key``), as ``jax.random.split`` advances the JAX key; each
leaf's mu and nu take their own stream of it.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, NamedTuple, Optional

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
    key: Any = None  # bfloat16_sr (XLA-side): int32 seed tensor of the step's SR bits


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


def random_bits16(seed: Tensor, numel: int, stream: int = 0, index: Optional[Tensor] = None) -> Tensor:
    """(numel,) int64 tensor of 16 random bits each on ``seed``'s device:
    fmix32 of the element index xor a key mixed from (seed, stream).
    ``seed`` is an integer tensor of one element, read as uint32.
    ``index``: the elements' indices (default 0 .. numel - 1)."""
    key = fmix32((seed.reshape(()).to(torch.int64) + (stream + 1) * GOLDEN) & U32)
    idx = torch.arange(numel, dtype=torch.int64, device=seed.device) if index is None else index
    return fmix32(idx ^ key) & 0xFFFF


def sr_bfloat16(x: Tensor, seed: Tensor, stream: int = 0, index: Optional[Tensor] = None) -> Tensor:
    """fp32 -> bf16 with stochastic rounding, as the JAX package's
    ``qmoments.sr_bfloat16``: add 16 random bits below the bf16 mantissa
    boundary (uint32 wrap-around), then truncate. Unbiased in
    expectation. The bits are ``random_bits16(seed, x.numel(), stream,
    index)``: ``stream`` keeps two moments rounded under one seed
    independent; ``index`` places x's elements in a larger tensor whose
    draw they take (a tensor-parallel rank's slice)."""
    u = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & U32
    v = (u + random_bits16(seed, x.numel(), stream, index).view(x.shape)) & 0xFFFF0000
    v = torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)
    return v.view(torch.float32).to(torch.bfloat16)  # exact: the low 16 bits are 0


# -- the XLA-side optimizer (moment_dtype int8 / bfloat16 / bfloat16_sr) -------

FORMATS = ("bfloat16", "bfloat16_sr", "int8")
SR_KEY0 = 17  # the JAX package's jax.random.PRNGKey(17)


def _next_key(key: Tensor) -> Tensor:
    """The SR key of the next step: fmix32 of (key + GOLDEN) mod 2**32,
    as an int32 tensor on the key's device."""
    s = fmix32((key.to(torch.int64) + GOLDEN) & U32)
    return torch.where(s >= 1 << 31, s - (1 << 32), s).to(torch.int32)


_SR_INDEX = contextvars.ContextVar("sr_element_index", default=None)


@contextlib.contextmanager
def sr_element_index(index_fn):
    """Within the block, bfloat16_sr moments round leaf i's elements with
    the bits of ``index_fn(i, leaf)`` (their indices in the whole leaf)
    instead of 0 .. numel - 1: the tensor-parallel step updates one
    layer's slice of a rank's shard at a time and draws what the
    single-device step draws for those elements
    (train/loop.update_by_layer)."""
    token = _SR_INDEX.set(index_fn)
    try:
        yield
    finally:
        _SR_INDEX.reset(token)


def _encode(tree, moment_dtype: str, key: Optional[Tensor] = None, stream0: int = 0):
    """fp32 leaves -> the stored format: QTensors (int8), or bf16 leaves,
    rounded stochastically under ``key`` (bfloat16_sr; leaf i on stream
    stream0 + 2 i, at the indices sr_element_index gives) or to nearest
    (bfloat16, and bfloat16_sr without a key: zeros at init)."""
    kind = type(tree)
    if moment_dtype == "int8":
        return kind(*(quantize_q8(v) for v in tree))
    if moment_dtype == "bfloat16_sr" and key is not None:
        index_fn = _SR_INDEX.get()
        return kind(*(sr_bfloat16(v, key, stream0 + 2 * i, None if index_fn is None else index_fn(i, v))
                      for i, v in enumerate(tree)))
    return kind(*(v.to(torch.bfloat16) for v in tree))


def _decode(tree, like, moment_dtype: str):
    """The stored moments -> fp32 leaves of ``like``'s shapes."""
    kind = type(like)
    if moment_dtype == "int8":
        return kind(*(dequantize_q8(q, g.shape) for q, g in zip(tree, like)))
    return kind(*(v.to(torch.float32) for v in tree))


def scale_by_adam_qmoments(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, moment_dtype: str = "bfloat16"):
    """optax.scale_by_adam with reduced-precision stored moments, the
    JAX package's: the EMAs, bias corrections and mu_hat / (sqrt(nu_hat)
    + eps) in fp32 on gradients widened with ``.to(float32)`` (bf16
    gradients under ``compute_dtype`` too); only the state's storage
    differs. Chain it with scale_by_learning_rate as scale_by_adam.
    Returns a train/loop.GradientTransformation."""
    from dladmm_tpu_torch.train.loop import GradientTransformation

    if moment_dtype not in FORMATS:
        raise ValueError(
            "moment_dtype must be 'bfloat16', 'bfloat16_sr', or 'int8', "
            f"got {moment_dtype!r} (float32 is plain Adam)"
        )
    sr = moment_dtype == "bfloat16_sr"

    def init(params):
        device = params[0].device
        zeros = type(params)(*(torch.zeros(p.shape, dtype=torch.float32, device=device) for p in params))
        # Zeros are exact in every storage format: no SR key at init.
        fmt = "bfloat16" if sr else moment_dtype
        return QMomentsState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu=_encode(zeros, fmt),
            nu=_encode(zeros, fmt),
            key=torch.full((), SR_KEY0, dtype=torch.int32, device=device) if sr else None,
        )

    def update(updates, state, params=None):
        del params
        kind = type(updates)
        mu = _decode(state.mu, updates, moment_dtype)
        nu = _decode(state.nu, updates, moment_dtype)
        mu = kind(*(b1 * m + (1.0 - b1) * g.to(torch.float32) for m, g in zip(mu, updates)))
        nu = kind(*(b2 * v + (1.0 - b2) * torch.square(g.to(torch.float32)) for v, g in zip(nu, updates)))
        count = state.count + 1
        cf = count.to(torch.float32)
        c1, c2 = 1.0 - torch.pow(b1, cf), 1.0 - torch.pow(b2, cf)
        out = kind(*((m / c1) / (torch.sqrt(v / c2) + eps) for m, v in zip(mu, nu)))
        key = state.key
        return out, QMomentsState(
            count=count,
            mu=_encode(mu, moment_dtype, key, 0),
            nu=_encode(nu, moment_dtype, key, 1),
            key=_next_key(key) if sr else None,
        )

    return GradientTransformation(init, update)


def adam_qmoments(
    learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, moment_dtype: str = "bfloat16"
):
    """Adam(learning_rate) with reduced-precision moments: scale_by_adam_qmoments
    chained with scale_by_learning_rate (train/loop.py)."""
    from dladmm_tpu_torch.train.loop import chain, scale_by_learning_rate

    return chain(scale_by_adam_qmoments(b1, b2, eps, moment_dtype), scale_by_learning_rate(learning_rate))


__all__ = [
    "BLOCK", "FORMATS", "GOLDEN", "QTensor", "QMomentsState", "SR_KEY0", "U32", "adam_qmoments", "dequantize_q8",
    "fmix32", "mul32", "quantize_q8", "random_bits16", "scale_by_adam_qmoments", "sr_bfloat16", "sr_element_index",
]
