"""Peaks of the card and the least time of each kernel of the port.

Frozen copy of ``dladmm_tpu_torch/bench/roofline.py`` at commit 376d358
(``PEAK_*``, ``bound``, ``traj_bound``, ``int8_bound``, ``step_bounds``,
``bwd_bound``, ``dense_bound``, ``int8_serve_bound``), so a later change
to the program cannot move the yardstick. ``step_bounds`` takes the
per-row codec rule from ``leaf_eligible`` below (a copy of
``train/qadam_cuda.leaf_eligible``) instead of importing the program.
``solve_flops`` and ``train_step_flops`` are the model FLOPs the mfu
metrics divide by the peak.

Each bound is the larger of the operations over the card's peak for
their type and the bytes (each input read once, each output written
once) over the memory rate, in ms, with which of the two it is.
"""

from __future__ import annotations

import math

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
# 700 W): fp32 outside the tensor cores, bf16 and int8 on the tensor
# cores, and HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12


def _bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def solve_flops(S: int, m: int, n: int, K: int) -> float:
    """Operations of one K-layer solve of S rows (d = m): per layer the
    products with W1 (n x m), A (m x n) and W2 (m x m)."""
    return 2.0 * S * m * (2 * n + m) * K


def bwd_flops(S: int, m: int, n: int, K: int) -> float:
    """Operations of one reverse sweep (bwd_bound's count)."""
    return 2.0 * S * K * (2 * m * m + 3 * n * m)


def train_step_flops(S: int, m: int, n: int, K: int) -> float:
    """Model operations of one training step: the forward solve and the
    reverse sweep's five products a layer (the optimizer's few a
    parameter are left out)."""
    return solve_flops(S, m, n, K) + bwd_flops(S, m, n, K)


def bound(S: int, m: int, n: int, K: int):
    """One K-layer solve at batch S (d = m)."""
    d = m
    flops = 2 * S * m * (2 * n + d) * K
    nbytes = 4 * (K * (n * m + d * m + n + d + 1) + m * n + S * m + S * (n + d + m))
    return _bound(flops, nbytes)


def traj_bound(S: int, m: int, n: int, K: int, with_tax: bool, itemsize: int = 4):
    """One trajectory forward: the solve's flops; K layers of weights, A
    and b read once and the K-deep stacks written once."""
    flops = 2 * S * m * (2 * n + m) * K
    out = K * S * (n + 2 * m + (m if with_tax else 0))
    nbytes = itemsize * (K * (n * m + m * m + n + m + 1) + m * n + S * m + out)
    return _bound(flops, nbytes)


INT8_OPS_PER_ELEM = 38


def int8_bound(leaves):
    """One int8 sweep over (R, L) leaves."""
    elems = sum(R * L for R, L in leaves)
    rows = sum(R for R, _ in leaves)
    nbytes = 16 * elems + 16 * rows + 16
    return _bound(INT8_OPS_PER_ELEM * elems, nbytes)


SWEEP_BYTES = {"int8": 16, "float32": 28, "bfloat16": 20, "bfloat16_sr": 20, "bfloat16_sr_mu": 24}
DENSE_OPS_PER_ELEM = 14


def leaf_eligible(shape) -> bool:
    """The per-row codec rule: >= 2-D, >= 65536 elements, 128 <= L <=
    1638 and >= 128 rows of the (R, L) view, L the last dim."""
    n = math.prod(shape)
    L = shape[-1] if shape else 0
    return len(shape) >= 2 and n >= 1 << 16 and 128 <= L <= 1638 and n // L >= 128


def step_bounds(shapes, fmt: str) -> dict:
    """The optimizer step as a function and each of its launches."""
    elems = sum(math.prod(s) for s in shapes)
    rows = 0
    if fmt == "int8":
        for s in shapes:
            n = math.prod(s)
            rows += n // s[-1] if leaf_eligible(s) else -(-n // 256)
    ops = (INT8_OPS_PER_ELEM if fmt == "int8" else DENSE_OPS_PER_ELEM) * elems
    sweep_bytes = SWEEP_BYTES[fmt] * elems + 16 * rows + 16
    return {"elements": elems, "rows": rows,
            "step": _bound(ops + 2 * elems, sweep_bytes + 8),
            "sweep": _bound(ops, sweep_bytes),
            "prologue": _bound(2 * elems, 4 * elems + 16),
            "two_launches": _bound(ops + 2 * elems, sweep_bytes + 4 * elems + 32)}


def bwd_bound(S: int, m: int, n: int, K: int, data_grads: bool = False, itemsize: int = 4):
    """One reverse sweep: 2*S*K*(2m^2 + 3nm) flops; b, A, the params, the
    stacks and the cotangents read once, the gradients written once."""
    params = K * (n * m + m * m + n + m + 1)
    ins = S * m + m * n + params + K * S * (n + 3 * m) + S * (n + 2 * m)
    outs = params + ((K + 1) * S * m if data_grads else 0)
    t_bytes = itemsize * (ins + outs) / PEAK_BYTES_PER_S
    if itemsize == 4:
        t_ops = 2 * S * K * (2 * m * m + 3 * n * m) / PEAK_FP32_FLOPS
    else:
        t_ops = max(2 * S * K * (m * m + 2 * n * m) / PEAK_BF16_FLOPS, 2 * S * K * (m * m + n * m) / PEAK_FP32_FLOPS)
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def dense_bound(elems: int, fmt: str):
    """One dense sweep over ``elems`` elements."""
    mu_b, nu_b = {"float32": (4, 4), "bfloat16": (2, 2), "bfloat16_sr": (2, 2), "bfloat16_sr_mu": (2, 4)}[fmt]
    return _bound(DENSE_OPS_PER_ELEM * elems, elems * (12 + 2 * mu_b + 2 * nu_b))


def int8_serve_bound(S: int, m: int, n: int, K: int):
    """One int8 solve at batch S (d = m), at the int8 tensor-core peak."""
    d = m
    ops = 2 * S * m * (2 * n + d) * K
    nbytes = K * (n * m + d * m) + m * n + 4 * (K * (2 * (n + d) + 1) + m + S * m + S * (n + d + m))
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
