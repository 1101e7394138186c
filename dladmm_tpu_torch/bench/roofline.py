"""Roofline of the serving forward, and the bounds of the port's kernels.

``python -m dladmm_tpu_torch.bench.roofline [--out roofline.json]``

The port of ``dladmm_tpu/bench/roofline.py``. For each benchmark shape
and forward path it measures the time of one K-layer solve (chained on
the device, bench/timing.time_chained), computes the analytic operation
count and the least memory traffic, and reports the achieved TFLOP/s,
the fraction of the fp32 peak, of the memory bound and of the roofline,
and which wall bounds the solve. The paths: ``reference``, the plain
loop (models/unroll.dladmm_forward) on the card; ``megakernel``, the
whole-unroll kernel (row 1, ops/cuda_unroll.unroll_forward). The
kernel has no fit gate, so both run at all three shapes. ``time_from``
says what the time is: for the plain loop at a small batch it is the
host's enqueue time, not the card's, and its fractions are of that.

The rest of the module is the least time of each kernel of the port
(``bound``, ``traj_bound``, ``bwd_bound``, ...): the larger of the
operations over the card's peak for their type and the bytes (each
input read once, each output written once) over its memory rate. The
work counts are the functions', whatever implements them, so the
kernels' table and a benchmark read the same bounds.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
# 700 W): fp32 outside the tensor cores, bf16 and int8 on the tensor
# cores, and HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12

# The presets the bounds are quoted at (utils/config.py).
PRESET_SHAPES = {
    "synthetic_small": dict(m=250, n=500, K=15),
    "synthetic_large": dict(m=1000, n=2000, K=20),
}


def _bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of flops over the fp32 peak and
    bytes over the memory rate, and which of the two it is."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bound(S: int, m: int, n: int, K: int):
    """(bound_ms, bound_by) of one K-layer solve at batch S (d = m):
    2*S*m*(2n+d)*K flops against the fp32 peak, and K layers of W1, W2,
    thresholds and beta, A, b read once and x, z, lam written once
    against the memory rate."""
    d = m
    flops = 2 * S * m * (2 * n + d) * K
    nbytes = 4 * (K * (n * m + d * m + n + d + 1) + m * n + S * m + S * (n + d + m))
    return _bound(flops, nbytes)


def traj_bound(S: int, m: int, n: int, K: int, with_tax: bool, itemsize: int = 4):
    """(bound_ms, bound_by) of one trajectory forward: the solve's flops,
    and K layers of weights, A and b read once and the K-deep stacks
    written once, each ``itemsize`` bytes (2: bf16 storage)."""
    flops = 2 * S * m * (2 * n + m) * K
    out = K * S * (n + 2 * m + (m if with_tax else 0))
    nbytes = itemsize * (K * (n * m + m * m + n + m + 1) + m * n + S * m + out)
    return _bound(flops, nbytes)


# fp32 operations per element of the int8 sweep: two decodes (4 each),
# clip scale 1, two EMAs (3 + 4), the update 4, the master 2, two
# absmax 2 each, two encodes 6 each.
INT8_OPS_PER_ELEM = 38


def int8_bound(leaves):
    """(bound_ms, bound_by) of one int8 sweep over (R, L) leaves: per
    element g (4 B) and master (4 B) read, master written, two int8 codes
    read and written (16 B); per row two scales read and written (16 B);
    the 4 scalars."""
    elems = sum(R * L for R, L in leaves)
    rows = sum(R for R, _ in leaves)
    nbytes = 16 * elems + 16 * rows + 16
    return _bound(INT8_OPS_PER_ELEM * elems, nbytes)


# The five leaves of a preset: W1 (K, n, m), W2 (K, m, m), theta1 (K, n),
# theta2 (K, m), beta (K,).
STEP_SHAPES = {
    label: [(s["K"], s["n"], s["m"]), (s["K"], s["m"], s["m"]), (s["K"], s["n"]), (s["K"], s["m"]), (s["K"],)]
    for label, s in PRESET_SHAPES.items()
}
# Bytes an element of the sweep moves: g read, master read and written,
# mu and nu read and written in their stored width.
SWEEP_BYTES = {"int8": 16, "float32": 28, "bfloat16": 20, "bfloat16_sr": 20, "bfloat16_sr_mu": 24}
# fp32 operations per element of the dense sweep: clip scale 1, two EMAs
# (3 + 4), the update 4 (two divisions, a square root, an addition), the
# master 2.
DENSE_OPS_PER_ELEM = 14


def step_bounds(shapes, fmt: str) -> dict:
    """(bound_ms, bound_by) of the step as a function and of each of its
    launches. The step ("step") reads each input once and writes each
    output once: SWEEP_BYTES an element (g once: its sum of squares needs
    no second pass over it), int8 also 16 B a row of scales (per-row or
    flat-256), the count in and out and the 4 scalars; the sweep's fp32
    operations and the norm's 2 an element. The sweep ("sweep") moves the
    same bytes and reads the 4 scalars; the prologue ("prologue") reads
    g (4 B an element) for 2 operations an element (fp64). Its second
    read of g is the two launches' own cost: "two_launches" is both
    launches' bytes and operations together."""
    import torch

    from dladmm_tpu_torch.train.qadam_cuda import leaf_eligible

    elems = sum(int(np.prod(s)) for s in shapes)
    rows = 0
    if fmt == "int8":
        for s in shapes:
            n = int(np.prod(s))
            rows += n // s[-1] if leaf_eligible(torch.empty(s, device="meta")) else -(-n // 256)
    ops = (INT8_OPS_PER_ELEM if fmt == "int8" else DENSE_OPS_PER_ELEM) * elems
    sweep_bytes = SWEEP_BYTES[fmt] * elems + 16 * rows + 16
    return {"elements": elems, "rows": rows,
            "step": _bound(ops + 2 * elems, sweep_bytes + 8),
            "sweep": _bound(ops, sweep_bytes),
            "prologue": _bound(2 * elems, 4 * elems + 16),
            "two_launches": _bound(ops + 2 * elems, sweep_bytes + 4 * elems + 32)}


def bwd_bound(S: int, m: int, n: int, K: int, data_grads: bool = False, itemsize: int = 4):
    """(bound_ms, bound_by) of one reverse sweep: 2*S*K*(2m^2 + 3nm)
    flops (per layer gv, gAx1 A, gu, gW1, gW2), and b, A, the params,
    the trajectory stacks and the cotangents read once, the parameter
    gradients (and the gAx1 stack and gb) written once, each ``itemsize``
    bytes (2: bf16 storage). In bf16 three of the five products have
    bf16 operands only (gv = round(gp2) W2, round(gAx1) A, gu =
    round(gp1) W1: 2*S*K*(m^2 + 2nm)), which the bf16 tensor cores take
    exactly with fp32 sums; gW1 and gW2 (2*S*K*(m^2 + nm)) multiply fp32
    cotangents and stay at the fp32 peak. The two units can run at once,
    so the operations' time is the larger of the two."""
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
    """(bound_ms, bound_by) of one dense sweep over ``elems`` elements:
    g read, master read and written (12 B), mu and nu each read and
    written in their stored width."""
    mu_b, nu_b = {"float32": (4, 4), "bfloat16": (2, 2), "bfloat16_sr": (2, 2), "bfloat16_sr_mu": (2, 4)}[fmt]
    return _bound(DENSE_OPS_PER_ELEM * elems, elems * (12 + 2 * mu_b + 2 * nu_b))


def int8_serve_bound(S: int, m: int, n: int, K: int):
    """(bound_ms, bound_by) of one int8 solve at batch S (d = m):
    2*S*m*(2n+d)*K integer operations against the int8 tensor-core peak;
    bytes: K layers of int8 W1 and W2 and their scales, thresholds and
    beta, int8 A and its scales, b read once, x, z, lam written once."""
    d = m
    ops = 2 * S * m * (2 * n + d) * K
    nbytes = K * (n * m + d * m) + m * n + 4 * (K * (2 * (n + d) + 1) + m + S * m + S * (n + d + m))
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def layer_bound(S: int, m: int, n: int):
    """(bound_ms, bound_by) of one layer-step call (d = m): 2*S*m*(2n+m)
    fp32 flops; x, z, lam, b, Ax, A, W1, W2, thresholds and beta read
    once, x1, z1, lam1, Ax1 written once."""
    flops = 2 * S * m * (2 * n + m)
    nbytes = 4 * (S * (n + 4 * m) + m * n + n * m + m * m + n + m + 1 + S * (n + 3 * m))
    return _bound(flops, nbytes)


def bf16_bound(S: int, m: int, n: int, K: int):
    """(bound_ms, bound_by) of one bf16-storage solve (d = m): the fp32
    solve's flops (its arithmetic is fp32 FMA), and 2 bytes an element for
    K layers of W1, W2, thresholds and beta, A, b read once and x, z, lam
    written once."""
    d = m
    flops = 2 * S * m * (2 * n + d) * K
    nbytes = 2 * (K * (n * m + d * m + n + d + 1) + m * n + S * m + S * (n + d + m))
    return _bound(flops, nbytes)


def bf16_layer_bound(S: int, m: int, n: int):
    """(bound_ms, bound_by) of one layer step on bf16 state: layer_bound's
    flops, 2 bytes an element but beta's 4."""
    flops = 2 * S * m * (2 * n + m)
    nbytes = 2 * (S * (n + 4 * m) + m * n + n * m + m * m + n + m + S * (n + 3 * m)) + 4
    return _bound(flops, nbytes)


# -- the roofline of the serving forward ------------------------------------------


def _chained(f, init, iters):
    """Seconds per call of f, chained on its input with a real data
    dependency (bench/timing.time_chained)."""
    from dladmm_tpu_torch.bench.timing import time_chained

    return time_chained(lambda c: init + 1e-12 * f(c), init, iters=iters)


def analyze(m, n, K, S, paths=("reference", "megakernel"), iters=50, device=None):
    """The roofline of one K-layer solve of batch S at A (m, n) for each
    path: its time, achieved TFLOP/s and fractions of the fp32 peak, of
    the memory bound and of the roofline. The operation count and the
    least memory traffic are the JAX package's. ``device``: the card
    unless the caller or DLADMM_PLATFORM asks for the CPU; the
    megakernel's launches are counted from 0 over its measurement."""
    import torch

    from dladmm_tpu_torch.bench.timing import CHAIN_TIME_FROM
    from dladmm_tpu_torch.data.synthetic import make_batch, make_dictionary
    from dladmm_tpu_torch.models.api import kernel_route, plain_route
    from dladmm_tpu_torch.models.unroll import dladmm_forward, init_dladmm_params
    from dladmm_tpu_torch.ops.cuda_unroll import unroll_forward
    from dladmm_tpu_torch.utils.platform import resolve_device

    device = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    A = make_dictionary(gen, m, n)
    b = make_batch(gen, A, S).b.to(device)
    A = A.to(device)
    params = init_dladmm_params(A, K=K)

    flops = 2 * S * m * (2 * n + m) * K  # cached-matvec recurrence

    # One least-traffic model per shape, a lower bound on any
    # implementation, so every path's fractions stay <= 1 and read as
    # "fraction of the ideal": the per-layer weights (W1 n*m + W2 m*m)
    # once each, A once, the state (b in; x, z, lam out) once.
    min_bytes = K * (n * m + m * m) * 4 + m * n * 4 + S * (2 * n + 4 * m) * 4
    t_compute = flops / PEAK_FP32_FLOPS  # TF32 stays off: fp32 FMA
    t_memory = min_bytes / PEAK_BYTES_PER_S
    t_sol = max(t_compute, t_memory)

    rows = []
    for path in paths:
        if path == "megakernel":
            f = lambda v: unroll_forward(v, A, *params)[2]  # noqa: E731
            route = kernel_route(device)
        elif path == "reference":
            f = lambda v: dladmm_forward(params, A, v)[2]  # noqa: E731
            route = plain_route("reference")
        else:
            raise ValueError(f"path {path!r}: one of reference, megakernel")
        unroll_forward.launches = 0
        with torch.no_grad():
            t = _chained(f, b, iters)
        row = {
            "path": path,
            "route": route,
            "time_us": t * 1e6,
            "achieved_tflops": flops / t / 1e12,
            "frac_of_fp32_peak": t_compute / t,
            "frac_of_memory_bound": t_memory / t,
            "frac_of_roofline": t_sol / t,
            "bound": "compute" if t_compute > t_memory else "memory",
        }
        if path == "megakernel":
            row["launches"] = unroll_forward.launches
        rows.append(row)
    return {
        "shape": f"A {m}x{n}, K={K}, batch={S}",
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "flops_g": round(flops / 1e9, 2),
        "ideal_min_hbm_mb": round(min_bytes / 1e6, 1),
        "time_from": CHAIN_TIME_FROM if device.type == "cuda" else "time.perf_counter around a chain of calls",
        "paths": rows,
    }


# The three shapes of main and their chain lengths: the long chain of the
# kernel runs some 30 ms of device time, the plain loop's longer.
MAIN_SHAPES = ((dict(m=250, n=500, K=15, S=64), 64), (dict(m=250, n=500, K=15, S=1024), 32),
               (dict(m=1000, n=2000, K=20, S=1024), 8))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    results = [analyze(**shape, iters=iters) for shape, iters in MAIN_SHAPES]
    out = json.dumps(results, indent=2)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
