#!/usr/bin/env python3
"""Hardware smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``dladmm_tpu_torch``, no JAX) on the card and fails on
the first fault. Each phase prints one JSON line:

  1. device: the card, its power limit (nvidia-smi), TF32 switched off;
  2. build: nvcc builds ops/csrc/unroll.cu from the checkout (timed);
  3. kernel: the CUDA whole-unroll kernel against its plain PyTorch
     version on the same inputs (perturbed LADMM-exact params) at
     synthetic_small (S = 1, 13, 64, 256 for l1/l1; nonneg_l1, box and
     elastic_net(0.3) as prox_x at S = 64) and synthetic_large
     (S = 1024, K = 20); fails above 1e-4 * max(1, max|ref|);
  4. slice: the serving CLI (``serve.main --config=synthetic_small
     --import-torch <LADMM-exact .pt> --demo 256``), then an
     InferenceServer with buckets up to 256 on requests of 1, 7, 64 and
     200 rows and 8 concurrent BatchingServer submits. Each of the two
     paths (CLI; servers) counts its kernel launches from 0 and reads
     them just after it ran, before any check re-solves; both must be
     > 0. The served NMSE must equal the port's classical LADMM at
     K = 15 within 0.01 dB (the LADMM-exact init makes them the same
     function);
  5. timing: median CUDA-event time of one solve, kernel and plain
     version in turns, beside the bound from the shapes;
  6. profile: torch.profiler device time per kernel and the device's
     busy share, at the main path's shape (synthetic_small, S = 256);

then the kernels line and, last, the ok line. Exits non-zero, with no
ok line, on any failure, when CUDA is not available, or when run
without the rest of the repository.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

TOL = 1e-4  # kernel vs plain: max|diff| <= TOL * max(1, max|ref|)
NMSE_TOL_DB = 0.01
# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3. The bound of a call is the larger of the two times.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
SMALL = dict(m=250, n=500, K=15)  # synthetic_small (utils/config.py)
LARGE = dict(m=1000, n=2000, K=20)  # synthetic_large


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound(S: int, m: int, n: int, K: int):
    """(bound_ms, bound_by) of one K-layer solve at batch S (d = m):
    2*S*m*(2n+d)*K flops against the fp32 peak, and K layers of W1, W2,
    thresholds and beta, A, b read once and x, z, lam written once
    against the memory rate."""
    d = m
    flops = 2 * S * m * (2 * n + d) * K
    nbytes = 4 * (K * (n * m + d * m + n + d + 1) + m * n + S * m + S * (n + d + m))
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def problem(torch, m: int, n: int, K: int, S: int, seed: int, device):
    """A, b and perturbed LADMM-exact params on the card. The
    perturbation is 0.05 N(0,1) scaled by each leaf's RMS, so every
    weight moves off the init while the unroll stays as stable as
    LADMM's (an absolute 0.05 grows x by orders of magnitude at these
    widths)."""
    from dladmm_tpu_torch.data.synthetic import make_batch, make_dictionary
    from dladmm_tpu_torch.models.unroll import DLADMMParams, init_dladmm_params

    g = torch.Generator().manual_seed(seed)
    A = make_dictionary(g, m, n)
    b = make_batch(g, A, S).b
    p0 = init_dladmm_params(A, K=K)
    leaves = [
        leaf + 0.05 * torch.randn(leaf.shape, generator=g) * leaf.pow(2).mean().sqrt()
        for leaf in p0
    ]
    return A.to(device), b.to(device), DLADMMParams(*leaves).to(device)


def compare(torch, got, want, label: str) -> float:
    errs = {}
    for name, k, p in zip(("x", "z", "lam"), got, want):
        if not torch.isfinite(k).all():
            raise AssertionError(f"{label}: kernel {name} is not finite")
        err = float((k - p).abs().max())
        scale = max(1.0, float(p.abs().max()))
        errs[name] = err
        if not err <= TOL * scale:
            raise AssertionError(
                f"{label}: {name} max|diff| {err} > {TOL} * {scale}"
            )
    emit("kernel", case=label, max_abs_err=errs)
    return max(errs.values())


def median_ms(torch, fns, reps: int):
    """Median CUDA-event ms of each fn, called in turns (a, b, b, a, ...)
    so that both see the same clocks and the same warm L2."""
    times = [[] for _ in fns]
    order = list(range(len(fns)))
    for rep in range(reps):
        for i in (order if rep % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[i]()
            stop.record()
            stop.synchronize()
            times[i].append(start.elapsed_time(stop))
    return [float(np.median(t)) for t in times]


def profile_unroll(torch, unroll_forward, S: int, m: int, n: int, K: int, reps: int = 5):
    """torch.profiler over ``reps`` solves: device time per solve of
    each kernel (and memset) by name, and the device's busy share of the
    CUDA-event window around them (the rest is launch gaps)."""
    from torch.profiler import ProfilerActivity, profile

    A, b, p = problem(torch, m=m, n=n, K=K, S=S, seed=11, device=torch.device("cuda", 0))
    with torch.no_grad():
        unroll_forward(b, A, *p)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                unroll_forward(b, A, *p)
            stop.record()
            torch.cuda.synchronize()
    window_us = start.elapsed_time(stop) * 1e3
    per_solve = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = e.cuda_time_total
        if dev_us > 0 and not e.key.startswith("cuda"):
            name = e.key.replace("void ", "").replace("(anonymous namespace)::", "")
            name = name.split("(")[0].strip()
            per_solve[name] = {"us": dev_us / reps, "calls": e.count / reps}
    busy_us = sum(v["us"] for v in per_solve.values()) * reps
    if not per_solve:
        raise AssertionError("the profiler recorded no device time")
    return {"config": f"m={m} n={n} K={K} S={S}", "solves": reps,
            "window_ms_per_solve": window_us / reps / 1e3,
            "device_busy_share": busy_us / window_us, "per_solve": per_solve}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs the card",
              file=sys.stderr)
        return 2
    from dladmm_tpu_torch.baselines.ladmm import ladmm_run
    from dladmm_tpu_torch.data.synthetic import make_batch, problem_matrices, seed_keys
    from dladmm_tpu_torch.metrics.core import nmse_db
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.ops import cuda_unroll
    from dladmm_tpu_torch.ops.cuda_unroll import unroll_forward, unroll_forward_plain
    from dladmm_tpu_torch.serve import BatchingServer, InferenceServer
    from dladmm_tpu_torch.serve import main as serve_main
    from dladmm_tpu_torch.utils.config import get_config
    from dladmm_tpu_torch.utils.torch_compat import save_torch

    dev = torch.device("cuda", 0)
    # 1. device. The plain version's products must be full fp32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda, tf32=False)

    # 2. build, from the sources in this checkout.
    t0 = time.monotonic()
    lib_path, built = cuda_unroll.build()
    build_s = time.monotonic() - t0
    log = Path(str(lib_path) + ".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln] if log.exists() else []
    emit("build", seconds=build_s, built_now=built, library=lib_path.name, ptxas=ptxas)

    # 3. kernel against its plain version, on the card.
    max_err = 0.0
    with torch.no_grad():
        for S in (1, 13, 64, 256):
            A, b, p = problem(torch, S=S, seed=S, device=dev, **SMALL)
            got = unroll_forward(b, A, *p)
            want = unroll_forward_plain(b, A, *p)
            torch.cuda.synchronize()
            max_err = max(max_err, compare(torch, got, want, f"synthetic_small S={S} l1/l1"))
        A, b, p = problem(torch, S=64, seed=64, device=dev, **SMALL)
        for prox in ("nonneg_l1", "box", "elastic_net"):
            rho = 0.3 if prox == "elastic_net" else 0.0
            got = unroll_forward(b, A, *p, prox_x=prox, rho=rho)
            want = unroll_forward_plain(b, A, *p, prox_x=prox, rho=rho)
            torch.cuda.synchronize()
            max_err = max(max_err, compare(torch, got, want, f"synthetic_small S=64 {prox}(rho={rho})/l1"))
        A, b, p = problem(torch, S=1024, seed=1024, device=dev, **LARGE)
        got = unroll_forward(b, A, *p)
        want = unroll_forward_plain(b, A, *p)
        torch.cuda.synchronize()
        max_err = max(max_err, compare(torch, got, want, "synthetic_large S=1024 l1/l1"))
        del A, b, p, got, want

    # 4. the slice: the serving CLI and the servers, LADMM-exact params.
    cfg = get_config("synthetic_small")
    A_cfg, _ = problem_matrices(cfg, device=dev)
    params = init_dladmm_params(A_cfg, K=cfg.problem.K, beta=cfg.problem.beta)
    demo = make_batch(seed_keys(cfg)[1], A_cfg, 256)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "ladmm_exact.pt"
        save_torch(params, ckpt)
        unroll_forward.launches = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = serve_main([
                "--config=synthetic_small", "--import-torch", str(ckpt),
                "--demo", "256",
            ])
        cli_launches = unroll_forward.launches
    if rc != 0:
        raise AssertionError(f"serve.main returned {rc}")
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    with torch.no_grad():
        xl, _, _ = ladmm_run(A_cfg, demo.b, iters=cfg.problem.K, beta=cfg.problem.beta)
    ladmm_db = float(nmse_db(xl, demo.x_star))
    if summary["route"] != "cuda-whole-unroll-kernel" or cli_launches < 1:
        raise AssertionError(
            f"serving did not go through the CUDA kernel: route "
            f"{summary['route']!r}, {cli_launches} launches"
        )
    if not abs(summary["nmse_db"] - ladmm_db) <= NMSE_TOL_DB:
        raise AssertionError(
            f"served NMSE {summary['nmse_db']} dB != LADMM {ladmm_db} dB"
        )
    emit("slice_cli", serve=summary, ladmm_nmse_db=ladmm_db, launches=cli_launches)

    # The servers' path, counted from 0: 9 bucket warm-ups, 4 solves and
    # the batched dispatches (the plain version's checks do not count).
    unroll_forward.launches = 0
    server = InferenceServer(params, A_cfg, max_batch=256, device=dev)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for rows in (1, 7, 64, 200):
            req = torch.from_numpy(rng.normal(size=(rows, A_cfg.shape[0])).astype(np.float32)).to(dev)
            x, z = server.solve(req)
            xw, zw, _ = unroll_forward_plain(req, A_cfg, *server.params)
            torch.cuda.synchronize()
            for name, g_, w_ in (("x", x, xw), ("z", z, zw)):
                err = float((g_ - w_).abs().max())
                if not err <= TOL * max(1.0, float(w_.abs().max())):
                    raise AssertionError(f"InferenceServer rows={rows} {name}: {err}")
            emit("slice_server", rows=rows, bucket=server._bucket_for(rows),
                 route=server.routes[server._bucket_for(rows)],
                 max_abs_err=float((x - xw).abs().max()))
    reqs = [rng.normal(size=(s, A_cfg.shape[0])).astype(np.float32) for s in (1, 3, 5, 8, 13, 21, 34, 55)]
    front = BatchingServer(server, max_delay_ms=5.0)
    try:
        with ThreadPoolExecutor(len(reqs)) as clients:  # 8 concurrent submits
            futs = list(clients.map(front.submit, reqs))
        batched = [f.result(timeout=120) for f in futs]
    finally:
        front.close()
    server_launches = unroll_forward.launches
    if server_launches < 1:
        raise AssertionError("the servers' path launched the CUDA kernel no time")
    for r, (xb, zb) in zip(reqs, batched):  # re-solves: checks, not counted
        xs, zs = server.solve(r)
        if not (np.allclose(xb, xs.cpu().numpy(), rtol=1e-5, atol=1e-6)
                and np.allclose(zb, zs.cpu().numpy(), rtol=1e-5, atol=1e-6)):
            raise AssertionError(f"BatchingServer rows={len(r)} != per-request solve")
    emit("slice_servers", requests=len(reqs), launches=server_launches)

    # 5. timing at the main path's shape and the issue's others.
    timings = {}
    with torch.no_grad():
        for label, shape, S in (
            ("synthetic_small", SMALL, 64),
            ("synthetic_small", SMALL, 256),
            ("synthetic_large", LARGE, 1024),
        ):
            A, b, p = problem(torch, S=S, seed=7, device=dev, **shape)
            reps = 9 if label == "synthetic_large" else 31
            for _ in range(2):  # warm-up
                unroll_forward(b, A, *p)
                unroll_forward_plain(b, A, *p)
            ms, plain_ms = median_ms(
                torch,
                [lambda: unroll_forward(b, A, *p), lambda: unroll_forward_plain(b, A, *p)],
                reps,
            )
            bms, by = bound(S, **shape)
            timings[(label, S)] = (ms, plain_ms, bms, by)
            emit("timing", config=label, S=S, kernel_ms=ms, plain_ms=plain_ms,
                 bound_ms=bms, bound_by=by, reps=reps, card=card)
            del A, b, p
    # 6. where the kernel's time goes, at the main path's shape.
    emit("profile", **profile_unroll(torch, unroll_forward, S=256, **SMALL))

    ms, plain_ms, bms, by = timings[("synthetic_small", 256)]
    print(json.dumps({"kernels": [{
        "name": "unroll_forward",
        "route": "cuda",
        "source": "dladmm_tpu_torch/ops/csrc/unroll.cu",
        "replaces": "dladmm_tpu/ops/pallas_unroll.py:36",
        "launches": cli_launches,  # the main path: serve.main --demo 256
        "launches_by_path": {"serve_cli": cli_launches, "servers": server_launches},
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
