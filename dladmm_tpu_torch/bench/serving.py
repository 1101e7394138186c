"""Serving latency and throughput by batch bucket.

``python -m dladmm_tpu_torch.bench.serving [--dtype=float32|bfloat16|int8|both|all] [--prox NAME
[--prox-rho R]] [--shape=paper|flagship] [--smoke] [--out serving.json]``

The port of ``dladmm_tpu/bench/serving.py``: the latency of one solve
of each batch bucket, chained on the card (bench/timing.time_chained),
and the throughput it gives, for the serving forwards of serve.py, as
its route table (models/api.inference_forward) picks them: fp32 and
bf16 l1/l1 the route of ``kernel`` (the whole-unroll kernel, row 1, or
its bf16-storage variant); int8 both the plain quantized scan
(ops/quantized.dladmm_forward_int8) and the int8 whole-unroll kernel
(row 7, ops/cuda_int8.int8_unroll_forward) at every bucket; a general
prox (``--prox``: prox_x that prox, prox_z l1, the synthetic_nonneg
pairing) the plain loop with the prox step and row 1's prox variant
where it has one. Each row names the port's route and the launches its
kernel made over its measurement, counted from 0. ``latency_us``
is the card's time a solve where the card is slower than the host's
enqueue, and the host's enqueue time where it is not (the eager plain
paths at small buckets): ``latency_from`` says so in each table.
``dispatch_overhead_ms`` is the wall time of one tiny launch and its
synchronisation: the host's cost of a call, beside the latency.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

BUCKETS = (1, 8, 64, 256, 1024, 2048, 4096)


def _cal_latency(fn, b0, iters):
    """Seconds per call of fn (b -> (x, z), z of b's shape at B = I),
    chained on b with a real data dependency (bench/timing.time_chained)."""
    from dladmm_tpu_torch.bench.timing import time_chained

    return time_chained(lambda b: b0 + 1e-12 * fn(b)[1].to(b0.dtype), b0, iters=iters)


def measure(m=250, n=500, K=15, buckets=BUCKETS, kernel="auto", dtype=None, prox=None, prox_rho=0.0, iters=64,
            device=None):
    """The latency table of one serving configuration: A (m, n), K layers
    of LADMM-exact params; ``dtype`` None (fp32), torch.bfloat16 or
    "int8"; ``prox`` a general prox for x (fp32 only). ``iters``: the
    long chain's length. Runs on ``device`` (utils/platform.
    resolve_device: the card unless asked otherwise)."""
    from dladmm_tpu_torch.bench.timing import CHAIN_TIME_FROM
    from dladmm_tpu_torch.data.synthetic import make_batch, make_dictionary
    from dladmm_tpu_torch.models.api import inference_forward
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.ops.quantized import quantize_params
    from dladmm_tpu_torch.utils.platform import resolve_device

    device = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    A = make_dictionary(gen, m, n)
    params = init_dladmm_params(A, K=K)
    A, params = A.to(device), params.to(device)
    quantized = dtype == "int8"
    prox_pair = None
    if prox is not None:
        # What a trained synthetic_nonneg / elastic_net user pays: the
        # forward with the trained prox in the layer step.
        if quantized:
            raise ValueError("general prox rejects int8 (serve.py guard)")
        from dladmm_tpu_torch.ops.prox import get_prox, is_l1, prox_l1

        if is_l1(prox, "l1", prox_rho):
            # run.py's guard: elastic_net with rho = 0 is l1, and a row
            # labelled elastic_net that measures l1 would mislabel it.
            raise ValueError(
                f"prox {prox!r} with rho={prox_rho} reduces to l1 — pass --prox-rho > 0 (or pick a non-l1 prox)"
            )
        prox_pair = (get_prox(prox, prox_rho), prox_l1)
    if dtype is not None and not quantized:  # serve.py's bf16 serving mode
        params = params.to(dtype)
        A = A.to(dtype)
    # serve.py's operands: the int8 mode's quantized once.
    operands = quantize_params(params, A) if quantized else (params, A)
    # int8 and a prox: the plain route and, where it differs, the kernel
    # beside it; l1 in fp32 or bf16: the route ``kernel`` picks.
    variants = {}
    for k in ("reference", "auto") if quantized or prox_pair is not None else (kernel,):
        chosen = inference_forward(m, m, k, dtype, prox_pair=prox_pair, device=device)
        variants.setdefault(chosen.route, chosen)

    # The host's cost of one call: a tiny launch and its synchronisation.
    tiny = torch.zeros((), device=device)
    float(tiny + 1.0)
    t0 = time.perf_counter()
    float(tiny + 1.0)
    dispatch_ms = (time.perf_counter() - t0) * 1e3

    gen_b = torch.Generator().manual_seed(1)
    rows = []
    for S in buckets:
        b = make_batch(gen_b, A.to(torch.float32).cpu(), S).b.to(device, A.dtype)
        for route, (forward_fn, _, counter) in variants.items():
            print(f"bucket {S} ({route})...", file=sys.stderr, flush=True)
            if counter is not None:
                counter.launches = 0
            with torch.no_grad():
                t = _cal_latency(lambda b, f=forward_fn: f(*operands, b)[:2], b, iters)
            rows.append({
                "bucket": S,
                "path": route,
                "route": route,
                "latency_us": t * 1e6,
                "throughput_solves_per_s": S / t,
                "launches": None if counter is None else counter.launches,
            })
            print(f"  -> {t * 1e6:.1f} us", file=sys.stderr, flush=True)
    return {
        "shape": f"A {m}x{n}, K={K}",
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "dispatch_overhead_ms": dispatch_ms,
        "latency_from": CHAIN_TIME_FROM if device.type == "cuda" else "time.perf_counter around a chain of calls",
        "buckets": rows,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None)
    # "both" / "all" measure the dtypes back to back in one process, so
    # that the rows of one table share a card and a session.
    ap.add_argument("--dtype", choices=["float32", "bfloat16", "int8", "both", "all"], default="float32")
    ap.add_argument(
        "--prox",
        default=None,
        help="also measure the general-prox serving path (the plain loop and row 1's prox variant with this "
             "prox_x in the layer step, prox_z=l1: the synthetic_nonneg pairing) next to each dtype's l1 rows "
             "(fp32 only; bf16 and int8 refuse a general prox, as serve.py does)",
    )
    ap.add_argument("--prox-rho", type=float, default=0.0,
                    help="elastic_net curvature for --prox=elastic_net (rho=0 reduces to l1 and is refused)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes and buckets on the CPU, through the plain versions: validates the "
                         "control flow end to end; the numbers mean nothing")
    ap.add_argument(
        "--shape",
        choices=["paper", "flagship"],
        default="paper",
        help="paper = A 250x500 K=15 (the reference benchmark); flagship = A 1000x2000 K=20 (synthetic_large)",
    )
    ap.add_argument("--iters", type=int, default=None,
                    help="the long chain's length (calibrated timing; default 64, 8 with --smoke)")
    args = ap.parse_args(argv)
    shape = {"iters": args.iters or (8 if args.smoke else 64)}
    if args.shape == "flagship":
        shape.update(m=1000, n=2000, K=20, buckets=(1, 64, 256, 1024))
    if args.smoke:
        shape.update(m=32, n=64, K=4, buckets=(1, 8, 64), device="cpu")
    dtypes = {"both": ["float32", "bfloat16"], "all": ["float32", "bfloat16", "int8"]}.get(args.dtype, [args.dtype])
    results = []
    for name in dtypes:
        result = measure(dtype={"bfloat16": torch.bfloat16, "int8": "int8"}.get(name), **shape)
        result["dtype"] = name
        if args.smoke:
            result["SMOKE_MODE"] = "tiny shapes on the CPU; the numbers mean nothing"
        results.append(result)
    if args.prox:
        result = measure(prox=args.prox, prox_rho=args.prox_rho, **shape)
        result["dtype"] = "float32"
        result["prox_x"] = args.prox
        if args.smoke:
            result["SMOKE_MODE"] = "tiny shapes on the CPU; the numbers mean nothing"
        results.append(result)
    out = json.dumps(results[0] if len(results) == 1 else results, indent=2)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
