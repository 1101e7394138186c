"""int8 quantized inference (the serving-only ``dtype="int8"`` rung).

The port of ``dladmm_tpu/ops/quantized.py``'s plain half: the codec
(``quantize_rows``, ``quantize_params``), the quantized dot (``qdot``)
and the K-layer unroll through it (``dladmm_forward_int8``), with the
JAX package's names, shapes, layouts and operation order. The
whole-unroll kernel (``_int8_unroll_kernel``) is ops/cuda_int8.py.

Scheme (the JAX package's):
  * Weights W1, W2 and the dictionary A are quantized once, symmetric
    per output row: q[o, :] = round(w[o, :] / s[o]), s[o] = max|w[o, :]|
    / 127. All-zero rows get scale 0 and codes 0.
  * Activations are quantized per sample at each dot: s[i] =
    max|act[i, :]| / 127, rounded to int8.
  * The dot is exact in int32, then dequantized as
    (acc * s_act[i]) * s_w[o] in fp32.
  * Thresholding, residuals and the dual update stay in fp32.

Rounding is half to even (``torch.round``, as ``jnp.round``). The
scan's divisions by 127 divide by a tensor: PyTorch's CUDA division by
a Python number multiplies by its reciprocal instead, which is the
kernel's order and not the scan's. The int32 dot: ``int8 @ int8`` on
the CPU returns int8 and wraps, and CUDA has no integer matmul, so
``_int_dot`` multiplies the codes as float64, which is exact while
|sum| < 2^53 (127 * 127 * k is far below it), and casts the exact
integers to int32.

Identity B only, l1/l1 only, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import Tensor

from dladmm_tpu_torch.models.unroll import DLADMMParams
from dladmm_tpu_torch.ops.reference import _BETA_MIN, shrink

_TINY = 1e-12


class QuantizedParams(NamedTuple):
    """int8 weights with fp32 per-row scales for the stacked [K, ...]
    net; thresholds and beta stay fp32."""

    W1_q: Tensor  # (K, n, m) int8
    W1_s: Tensor  # (K, n) fp32
    W2_q: Tensor  # (K, d, m) int8
    W2_s: Tensor  # (K, d) fp32
    theta1: Tensor
    theta2: Tensor
    beta: Tensor


class QuantizedDict(NamedTuple):
    A_q: Tensor  # (m, n) int8, per-row scales over the n contraction
    A_s: Tensor  # (m,) fp32


def quantize_rows(w: Tensor) -> Tuple[Tensor, Tensor]:
    """Symmetric per-row int8 quantization over the LAST axis: (q int8 of
    w's shape, s fp32 of shape w.shape[:-1]) with w ~= q * s[..., None].
    An all-zero row gets scale 0 and codes 0."""
    w = w.to(torch.float32)
    s = w.abs().amax(dim=-1) / w.new_tensor(127.0)
    q = torch.round(w / torch.maximum(s, s.new_tensor(_TINY))[..., None])
    return q.to(torch.int8), s


def quantize_params(params: DLADMMParams, A: Tensor) -> Tuple[QuantizedParams, QuantizedDict]:
    """Quantize a trained net and its dictionary for int8 serving, on
    their device."""
    W1_q, W1_s = quantize_rows(params.W1)
    W2_q, W2_s = quantize_rows(params.W2)
    A_q, A_s = quantize_rows(A)
    f32 = lambda v: v.to(torch.float32)  # noqa: E731
    return (
        QuantizedParams(W1_q, W1_s, W2_q, W2_s, f32(params.theta1), f32(params.theta2), f32(params.beta)),
        QuantizedDict(A_q, A_s),
    )


def _int_dot(a_q: Tensor, w_q: Tensor) -> Tensor:
    """(S, k) int8 x (o, k) int8 -> (S, o) int32, exact (module docstring)."""
    return (a_q.to(torch.float64) @ w_q.to(torch.float64).T).to(torch.int32)


def _qdot(act: Tensor, w_q: Tensor, w_s: Tensor, kernel_order: bool) -> Tensor:
    amax = act.abs().amax(dim=-1, keepdim=True)
    # The scan divides by 127; the kernel multiplies by 1/127 (rounded to
    # fp32), quantized.py:114 against :231.
    s_act = amax * (1.0 / 127.0) if kernel_order else amax / amax.new_tensor(127.0)
    a_q = torch.round(act / torch.maximum(s_act, s_act.new_tensor(_TINY))).to(torch.int8)
    return _int_dot(a_q, w_q).to(torch.float32) * s_act * w_s[None, :]


def qdot(act: Tensor, w_q: Tensor, w_s: Tensor) -> Tensor:
    """act (S, in) fp32 x w_q (out, in) int8 -> (S, out) fp32: dynamic
    per-sample activation quantization, exact int32 dot, fp32
    dequantization (module docstring)."""
    return _qdot(act, w_q, w_s, kernel_order=False)


def int8_unroll(qp: QuantizedParams, qd: QuantizedDict, b: Tensor, kernel_order: bool = False):
    """K int8 layers from zero state (identity B) -> (x, z, lam), the
    cached-Ax recurrence with three quantized dots a layer. The scan's
    operation order by default; ``kernel_order`` takes the whole-unroll
    kernel's, which multiplies by 1/127 and by 1/beta where the scan
    divides (quantized.py:231, :245 against :114, :144)."""
    S = b.shape[0]
    n, d = qp.W1_q.shape[1], qp.W2_q.shape[1]
    b = b.to(torch.float32)
    kw = dict(dtype=torch.float32, device=b.device)
    x, z = torch.zeros((S, n), **kw), torch.zeros((S, d), **kw)
    lam, Ax = torch.zeros_like(b), torch.zeros_like(b)
    for k in range(qp.W1_q.shape[0]):
        beta = torch.maximum(qp.beta[k], qp.beta.new_tensor(_BETA_MIN))
        base = z - b + (lam * (1.0 / beta) if kernel_order else lam / beta)  # B = I: Bz is z
        u = Ax + base
        x = shrink(x - _qdot(u, qp.W1_q[k], qp.W1_s[k], kernel_order), qp.theta1[k])
        Ax1 = _qdot(x, qd.A_q, qd.A_s, kernel_order)
        v = Ax1 + base
        z1 = shrink(z - _qdot(v, qp.W2_q[k], qp.W2_s[k], kernel_order), qp.theta2[k])
        lam = lam + beta * (Ax1 + z1 - b)
        z, Ax = z1, Ax1
    return x, z, lam


def dladmm_forward_int8(qp: QuantizedParams, qd: QuantizedDict, b: Tensor):
    """The K-layer int8 unroll (identity B, zero init) in the scan's
    order -> (x, z, lam), as models.unroll.dladmm_forward returns."""
    return int8_unroll(qp, qd, b)


__all__ = [
    "QuantizedDict",
    "QuantizedParams",
    "dladmm_forward_int8",
    "int8_unroll",
    "qdot",
    "quantize_params",
    "quantize_rows",
]
