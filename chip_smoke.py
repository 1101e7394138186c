#!/usr/bin/env python3
"""Hardware smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``dladmm_tpu_torch``, no JAX) on the card and fails on
the first fault. Each phase prints one JSON line:

  1. device: the card, its power limit (nvidia-smi), TF32 switched off;
  2. build: nvcc builds every source of ops/csrc/ from the checkout, one
     nvcc per source, all started together (timed, ptxas report);
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
  7. kernel_traj: the trajectory kernel against its plain version at
     synthetic_small S = 64, 256 and synthetic_large S = 1024, with the
     Ax stack and without, same tolerance as phase 3;
  8. kernel_int8: the int8 Adam sweep against its plain version on the
     W1 and W2 leaves of both presets, 3 chained steps in place from a
     non-zero state: masters within rtol 1e-6, codes within one step,
     dequantized moments within one code step;
  9. grads: one deep-supervision loss at synthetic_small S = 64, the
     kernel path (trajectory kernel + manual backward) against autograd
     through the plain loop, within 2e-5 of each leaf's largest gradient;
 10. slice_train: the training CLI ``run.main(["--config=synthetic_small",
     "--steps=300", "--ckpt-dir", tmp])``, both training kernels' counts
     set to 0 just before and read just after (both must be > 0), route
     cuda-trajectory-kernel, finite loss, final NMSE below LADMM's at
     K = 15; then ``serve.main --ckpt-dir tmp --demo 256`` serves the
     checkpoint at the trained run's final eval NMSE within 0.01 dB;
 11. timing_train: median CUDA-event ms of one training step, kernel
     path and plain path in turns; each training kernel's ms beside its
     bound and its plain version's;
 12. profile_train: torch.profiler over training steps at synthetic_small:
     device time per kernel, per phase (forward, backward loop,
     optimizer) and the busy share;

then the kernels line and, last, the ok line. Exits non-zero, with no
ok line, on any failure, when CUDA is not available, or when run
without the rest of the repository.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
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


def compare(torch, got, want, label: str, names=("x", "z", "lam"), phase="kernel") -> float:
    if len(got) != len(want) or len(got) != len(names):
        raise AssertionError(f"{label}: {len(got)} outputs, plain version {len(want)}")
    errs = {}
    for name, k, p in zip(names, got, want):
        if not torch.isfinite(k).all():
            raise AssertionError(f"{label}: kernel {name} is not finite")
        err = float((k - p).abs().max())
        scale = max(1.0, float(p.abs().max()))
        errs[name] = err
        if not err <= TOL * scale:
            raise AssertionError(
                f"{label}: {name} max|diff| {err} > {TOL} * {scale}"
            )
    emit(phase, case=label, max_abs_err=errs)
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


def traj_bound(S: int, m: int, n: int, K: int, with_tax: bool):
    """(bound_ms, bound_by) of one trajectory forward: the solve's flops,
    and K layers of weights, A and b read once and the K-deep stacks
    written once."""
    flops = 2 * S * m * (2 * n + m) * K
    out = K * S * (n + 2 * m + (m if with_tax else 0))
    nbytes = 4 * (K * (n * m + m * m + n + m + 1) + m * n + S * m + out)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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
    t_ops, t_bytes = INT8_OPS_PER_ELEM * elems / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# The int8 sweep's leaves, (R, L) views: W1 (K, n, m) and W2 (K, m, m).
INT8_LEAVES = {
    "synthetic_small": [(15 * 500, 250), (15 * 250, 250)],
    "synthetic_large": [(20 * 2000, 1000), (20 * 1000, 1000)],
}


def int8_state(torch, tqa, R: int, L: int, seed: int, device):
    """A master, non-zero per-row int8 moments and 3 gradients."""
    g = torch.Generator(device=device).manual_seed(seed)
    rand = lambda scale: scale * torch.randn((R, L), generator=g, device=device)  # noqa: E731
    master = rand(0.05)
    mu = tqa.quantize_rows(rand(1e-2))
    nu = tqa.quantize_rows(rand(3e-2) ** 2)
    return master, mu, nu, [rand(1e-2) for _ in range(3)]


def check_int8(torch, tqa, device) -> float:
    """Phase 8: kernel and plain version, 3 chained in-place steps."""
    max_err = 0.0
    for config, leaves in INT8_LEAVES.items():
        for name, (R, L) in zip(("W1", "W2"), leaves):
            master, mu, nu, grads = int8_state(torch, tqa, R, L, seed=R + L, device=device)
            ref = (master.clone(), tqa.QTensor(mu.codes.clone(), mu.scale.clone()),
                   tqa.QTensor(nu.codes.clone(), nu.scale.clone()))
            for i, grad in enumerate(grads):
                cf = float(i + 2)
                scal = torch.tensor([1 - 0.9 ** cf, 1 - 0.999 ** cf, 1e-3, 0.8], device=device)
                tqa.adam_int8_rows(grad, master, mu, nu, scal)
                tqa.adam_int8_rows_plain(grad, *ref, scal)
            torch.cuda.synchronize()
            err = float((master - ref[0]).abs().max())
            if not (master - ref[0]).abs().le(1e-6 * ref[0].abs() + 1e-9).all():
                raise AssertionError(f"int8 sweep {config} {name}: master max|diff| {err}")
            detail = {"master_max_abs_err": err}
            for mname, got, want in (("mu", mu, ref[1]), ("nu", nu, ref[2])):
                code_diff = int((got.codes.int() - want.codes.int()).abs().max())
                if code_diff > 1:
                    raise AssertionError(f"int8 sweep {config} {name} {mname}: codes differ by {code_diff}")
                if not torch.allclose(got.scale, want.scale, rtol=1e-6, atol=0):
                    raise AssertionError(f"int8 sweep {config} {name} {mname}: scales differ")
                step = (2 * 127 + 1) / 127**2 * torch.maximum(got.scale, want.scale)[:, None]
                deq = (tqa.dequantize_rows(got) - tqa.dequantize_rows(want)).abs()
                if not deq.le(step * (1 + 1e-6)).all():
                    raise AssertionError(f"int8 sweep {config} {name} {mname}: more than one code step apart")
                detail[f"{mname}_max_code_diff"] = code_diff
                detail[f"{mname}_max_dequant_err"] = float(deq.max())
            emit("kernel_int8", case=f"{config} {name} R={R} L={L}", steps=3, **detail)
            max_err = max(max_err, err)
    return max_err


def check_grads(torch, device):
    """Phase 9: the deep-supervision gradient through the kernels against
    autograd through the plain loop, synthetic_small S = 64."""
    from dladmm_tpu_torch.data.synthetic import make_batch
    from dladmm_tpu_torch.models.unroll import DLADMMParams, dladmm_forward
    from dladmm_tpu_torch.ops.cuda_traj import make_unrolled_trajectory
    from dladmm_tpu_torch.train.loop import _layer_weights, weighted_trajectory_mse

    A, b, p = problem(torch, S=64, seed=9, device=device, **SMALL)
    data = make_batch(torch.Generator().manual_seed(9), A, 64)
    w = _layer_weights("uniform", SMALL["K"], device=device)
    grads = []
    for kernel in (True, False):
        leaves = [t.detach().clone().requires_grad_() for t in p]
        q = DLADMMParams(*leaves)
        if kernel:
            tx, tz, _ = make_unrolled_trajectory()(q, A, data.b)
        else:
            _, (tx, tz, _) = dladmm_forward(q, A, data.b, capture_trajectory=True)
        loss = weighted_trajectory_mse(tx, tz, data.x_star, data.e_star, w)
        grads.append(torch.autograd.grad(loss, leaves))
    torch.cuda.synchronize()
    errs = {}
    for name, g, want in zip(DLADMMParams._fields, *grads):
        scale = float(want.abs().max())
        err = float((g - want).abs().max())
        if not (g - want).abs().le(2e-5 * want.abs() + 2e-5 * scale).all():
            raise AssertionError(f"grad {name}: max|diff| {err}, scale {scale}")
        errs[name] = {"max_abs_err": err, "scale": scale}
    emit("grads", case="synthetic_small S=64 deep supervision", grads=errs)


def train_slice(torch, device, unroll_forward):
    """Phase 10: the training CLI on the card, then serving its
    checkpoint. Returns the launch counts of the training run."""
    from dladmm_tpu_torch.ops import cuda_traj
    from dladmm_tpu_torch.run import main as run_main
    from dladmm_tpu_torch.serve import main as serve_main
    from dladmm_tpu_torch.train import qadam_cuda

    with tempfile.TemporaryDirectory() as tmp:
        log = Path(tmp) / "log.jsonl"
        out = io.StringIO()
        cuda_traj.trajectory_forward.launches = 0
        qadam_cuda.adam_int8_rows.launches = 0
        t0 = time.monotonic()
        with contextlib.redirect_stdout(out):
            rc = run_main(["--config=synthetic_small", "--steps=300", "--ckpt-dir", tmp,
                           "--log-jsonl", str(log)])
        wall = time.monotonic() - t0
        launches = {"trajectory_forward": cuda_traj.trajectory_forward.launches,
                    "adam_int8_rows": qadam_cuda.adam_int8_rows.launches}
        if rc != 0:
            raise AssertionError(f"run.main returned {rc}")
        lines = out.getvalue().splitlines()
        summary = json.loads([ln for ln in lines if ln.startswith("{")][-1])
        record = json.loads(log.read_text().splitlines()[-1])
        if summary["route"] != "cuda-trajectory-kernel" or min(launches.values()) < 1:
            raise AssertionError(f"training did not go through both kernels: {summary['route']!r}, {launches}")
        if not (math.isfinite(record["loss"]) and math.isfinite(summary["final_nmse_db"])):
            raise AssertionError(f"training diverged: {record}")
        if not summary["final_nmse_db"] < summary["ladmm_nmse_db_at_K"]:
            raise AssertionError(f"trained NMSE {summary['final_nmse_db']} does not beat LADMM {summary['ladmm_nmse_db_at_K']}")
        emit("slice_train", summary=summary, last_record=record, launches=launches, wall_s=wall,
             table=[ln for ln in lines if ln[:5].strip().isdigit()])

        out = io.StringIO()
        unroll_forward.launches = 0
        with contextlib.redirect_stdout(out):
            rc = serve_main(["--config=synthetic_small", "--ckpt-dir", tmp, "--demo", "256"])
        serve_launches = unroll_forward.launches
    served = json.loads(out.getvalue().strip().splitlines()[-1])
    if rc != 0 or served["route"] != "cuda-whole-unroll-kernel" or serve_launches < 1:
        raise AssertionError(f"serving the checkpoint: rc {rc}, route {served['route']!r}, {serve_launches} launches")
    if not abs(served["nmse_db"] - summary["final_nmse_db"]) <= NMSE_TOL_DB:
        raise AssertionError(f"served NMSE {served['nmse_db']} dB != trained {summary['final_nmse_db']} dB")
    emit("slice_train_serve", serve=served, trained_nmse_db=summary["final_nmse_db"], launches=serve_launches)
    return launches, serve_launches


def train_setup(torch, device):
    """synthetic_small's training step pieces on the card, from the LADMM
    init: the dictionary, the deep-supervision weights, the kernel
    forward, the int8 optimizer and a fresh state."""
    from dladmm_tpu_torch.data.synthetic import problem_matrices
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.ops.cuda_traj import make_unrolled_trajectory
    from dladmm_tpu_torch.train.loop import _build_optimizer, _layer_weights, make_train_state
    from dladmm_tpu_torch.utils.config import get_config

    cfg = get_config("synthetic_small")
    A, _ = problem_matrices(cfg, device=device)
    opt = _build_optimizer(cfg.train)
    state = make_train_state(init_dladmm_params(A, K=cfg.problem.K), opt)
    return cfg, A, _layer_weights("uniform", cfg.problem.K, device=device), make_unrolled_trajectory(), opt, state


PHASES = ("data", "forward", "backward", "optimizer")


class ProfiledPhases:
    """phased_step's ``mark`` for a profile: each phase runs inside a
    ``phase.<name>`` record_function range that ends after a device sync,
    so every kernel of a phase, launched from any thread (the backward
    runs on autograd's device thread), starts inside its phase's range."""

    def __init__(self, torch):
        self.torch = torch
        self.open = None

    def __call__(self, k: int) -> None:
        from torch.profiler import record_function

        if self.open is not None:
            self.torch.cuda.synchronize()
            self.open.__exit__(None, None, None)
            self.open = None
        if k < len(PHASES):
            self.open = record_function(f"phase.{PHASES[k]}")
            self.open.__enter__()


def phased_step(torch, A, w, fwd, opt, state, i, plain=False, mark=None):
    """One training step of train/loop.make_train_step (batch 64 from
    step_generator(0, i), deep supervision, int8 optimizer), split into
    data, forward, backward and optimizer; ``mark(k)`` is called at the
    start of phase k and ``mark(4)`` at the end (CUDA events, or
    ProfiledPhases). plain=True runs the plain counterpart: autograd
    through the plain loop and the optimizer's functional plain path
    (QAdamFused.update)."""
    from dladmm_tpu_torch.data.synthetic import make_batch, step_generator
    from dladmm_tpu_torch.models.unroll import DLADMMParams, dladmm_forward
    from dladmm_tpu_torch.train.loop import TrainState, apply_updates, weighted_trajectory_mse

    mark = mark or (lambda k: None)
    mark(0)
    data = make_batch(step_generator(0, i), A, 64)
    leaves = [p.detach().requires_grad_() for p in state.params]
    q = DLADMMParams(*leaves)
    mark(1)
    if plain:
        _, (tx, tz, _) = dladmm_forward(q, A, data.b, capture_trajectory=True)
    else:
        tx, tz, _ = fwd(q, A, data.b)
    loss = weighted_trajectory_mse(tx, tz, data.x_star, data.e_star, w)
    mark(2)
    grads = DLADMMParams(*torch.autograd.grad(loss, leaves))
    mark(3)
    if plain:
        with torch.no_grad():
            updates, opt_state = opt.update(grads, state.opt_state)
            params = apply_updates(state.params, updates)
    else:
        params, opt_state = opt.fused_apply(grads, state.opt_state, state.params)
    mark(4)
    return TrainState(params, opt_state, state.step + 1), loss


def time_train(torch, device, card):
    """Phase 11: one training step, kernel and plain paths in turns, and
    each training kernel beside its bound and its plain version."""
    from dladmm_tpu_torch.ops.cuda_traj import trajectory_forward, trajectory_forward_plain
    from dladmm_tpu_torch.train import qadam_cuda as tqa

    cfg, A, w, fwd, opt, state = train_setup(torch, device)
    states = {"kernel": state, "plain": train_setup(torch, device)[-1]}
    phases = {k: [] for k in states}
    walls = {k: [] for k in states}
    for rep in range(24):
        for kind in (("kernel", "plain") if rep % 2 == 0 else ("plain", "kernel")):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[kind], _ = phased_step(torch, A, w, fwd, opt, states[kind], rep,
                                          plain=kind == "plain", mark=lambda k: ev[k].record())
            ev[4].synchronize()
            walls[kind].append((time.perf_counter() - t0) * 1e3)
            if rep >= 4:  # warm-up
                phases[kind].append([ev[j].elapsed_time(ev[j + 1]) for j in range(4)])
    step = {}
    for kind in states:
        arr = np.array(phases[kind])
        step[kind] = {
            "step_ms": float(np.median(arr.sum(axis=1))),
            "host_wall_ms": float(np.median(walls[kind][4:])),
            "data_ms": float(np.median(arr[:, 0])), "forward_ms": float(np.median(arr[:, 1])),
            "backward_ms": float(np.median(arr[:, 2])), "optimizer_ms": float(np.median(arr[:, 3])),
        }
    emit("timing_train", config="synthetic_small batch 64 deep supervision int8", step=step, steps=20, card=card)

    timings = {}
    with torch.no_grad():
        A_, b, p = problem(torch, S=64, seed=21, device=device, **SMALL)
        for _ in range(2):
            trajectory_forward(b, A_, *p, with_tax=True)
            trajectory_forward_plain(b, A_, *p, with_tax=True)
        ms, plain_ms = median_ms(torch, [lambda: trajectory_forward(b, A_, *p, with_tax=True),
                                         lambda: trajectory_forward_plain(b, A_, *p, with_tax=True)], 31)
    bms, by = traj_bound(64, with_tax=True, **SMALL)
    timings["trajectory_forward"] = (ms, plain_ms, bms, by)
    emit("timing_train_kernel", kernel="trajectory_forward", config="synthetic_small S=64 with_tax",
         kernel_ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, card=card)

    leaves = INT8_LEAVES["synthetic_small"]
    st = [int8_state(torch, tqa, R, L, seed=R, device=device) for R, L in leaves]
    pl = [(m_.clone(), tqa.QTensor(mu.codes.clone(), mu.scale.clone()),
           tqa.QTensor(nu.codes.clone(), nu.scale.clone()), g) for m_, mu, nu, g in st]
    scal = torch.tensor([0.5, 0.05, 1e-3, 0.9], device=device)

    def sweep(plain):
        for master, mu, nu, grads in (pl if plain else st):
            fn = tqa.adam_int8_rows_plain if plain else tqa.adam_int8_rows
            fn(grads[0], master, mu, nu, scal)

    ms, plain_ms = median_ms(torch, [lambda: sweep(False), lambda: sweep(True)], 31)
    bms, by = int8_bound(leaves)
    timings["adam_int8_rows"] = (ms, plain_ms, bms, by)
    emit("timing_train_kernel", kernel="adam_int8_rows", config="synthetic_small W1+W2 (2 launches)",
         kernel_ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, card=card)
    for R, L in INT8_LEAVES["synthetic_large"]:
        master, mu, nu, grads = int8_state(torch, tqa, R, L, seed=R, device=device)
        ms_l = median_ms(torch, [lambda: tqa.adam_int8_rows(grads[0], master, mu, nu, scal)], 11)[0]
        emit("timing_train_kernel", kernel="adam_int8_rows", config=f"synthetic_large R={R} L={L}",
             kernel_ms=ms_l, bound_ms=int8_bound([(R, L)])[0], bound_by="bytes", card=card)
    return step, timings


def device_us_by_phase(torch, prof, steps: int):
    """Device time per step of each phase of ProfiledPhases-marked steps:
    each kernel, memset or copy goes to the phase whose host range holds
    its start. The profiler also mirrors each range onto the device
    timeline as an annotation spanning its kernels; those spans are not
    device work and are left out, as are runtime API calls."""
    ranges = [(e.time_range.start, e.time_range.end, e.name[len("phase."):])
              for e in prof.events()
              if e.name.startswith("phase.") and e.device_type.name == "CPU"]
    per = {name: 0.0 for name in PHASES}
    for e in prof.events():
        if e.device_type.name != "CUDA" or e.name.startswith(("phase.", "cuda")):
            continue
        hit = [name for t0, t1, name in ranges if t0 <= e.time_range.start <= t1]
        per[hit[0] if hit else "data"] += e.time_range.elapsed_us() / steps
    return per


def profile_train(torch, device, steps: int = 5):
    """Phase 12: torch.profiler over kernel-path training steps: device
    time per kernel by name, grouped by kernel, and the busy share of the
    CUDA-event window; then 3 steps with a sync after each phase for the
    device time of each phase (data, forward, backward loop, optimizer)."""
    from torch.profiler import ProfilerActivity, profile

    cfg, A, w, fwd, opt, state = train_setup(torch, device)
    for i in range(3):
        state, _ = phased_step(torch, A, w, fwd, opt, state, i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(steps):
            state, _ = phased_step(torch, A, w, fwd, opt, state, 3 + i)
        stop.record()
        torch.cuda.synchronize()
    window_us = start.elapsed_time(stop) * 1e3
    kernels = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = e.cuda_time_total
        if e.device_type.name != "CUDA" or dev_us <= 0 or e.key.startswith("cuda"):
            continue  # host ops and runtime calls; kernels are device events
        name = e.key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0].strip()
        k = kernels.setdefault(name, {"us": 0.0, "calls": 0.0})
        k["us"] += dev_us / steps
        k["calls"] += e.count / steps
    if not kernels:
        raise AssertionError("the profiler recorded no device time")
    busy_us = sum(v["us"] for v in kernels.values()) * steps
    groups = {"trajectory kernel (unroll_phase)": 0.0, "int8 sweep (qadam_int8_rows)": 0.0,
              "other (backward loop, loss, small leaves, data)": 0.0}
    for name, v in kernels.items():
        key = ("trajectory kernel (unroll_phase)" if "unroll_phase" in name else
               "int8 sweep (qadam_int8_rows)" if "qadam_int8" in name else
               "other (backward loop, loss, small leaves, data)")
        groups[key] += v["us"]
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["us"])[:15])

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            state, _ = phased_step(torch, A, w, fwd, opt, state, 3 + steps + i, mark=ProfiledPhases(torch))
    by_phase = device_us_by_phase(torch, prof, 3)
    emit("profile_train", config="synthetic_small batch 64 deep supervision int8", steps=steps,
         window_ms_per_step=window_us / steps / 1e3, device_busy_share=busy_us / window_us,
         device_us_per_step_by_group=groups, device_us_per_step_by_phase=by_phase,
         top_kernels=top, distinct_kernels=len(kernels))


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
    from dladmm_tpu_torch.ops import cuda_build
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

    # 2. build, from the sources in this checkout: one nvcc per source.
    sources = sorted(cuda_build.CSRC.glob("*.cu"))
    t0 = time.monotonic()
    builds = cuda_build.build_all(sources)
    for name, (lib_path, built, secs) in builds.items():
        log = Path(str(lib_path) + ".log")
        ptxas = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln] if log.exists() else []
        emit("build", source=name, seconds=secs, built_now=built, library=lib_path.name, ptxas=ptxas)
    emit("build_all", seconds=time.monotonic() - t0, sources=len(builds))

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

    # 7-9. the training kernels against their plain versions; gradients.
    from dladmm_tpu_torch.ops.cuda_traj import trajectory_forward, trajectory_forward_plain
    from dladmm_tpu_torch.train import qadam_cuda

    traj_err = 0.0
    with torch.no_grad():
        for label, shape, S in (("synthetic_small", SMALL, 64), ("synthetic_small", SMALL, 256),
                                ("synthetic_large", LARGE, 1024)):
            A, b, p = problem(torch, S=S, seed=S + 3, device=dev, **shape)
            for with_tax in (True, False):
                got = trajectory_forward(b, A, *p, with_tax=with_tax)
                want = trajectory_forward_plain(b, A, *p, with_tax=with_tax)
                torch.cuda.synchronize()
                names = ("tx", "tz", "tlam", "tax")[: len(want)]
                traj_err = max(traj_err, compare(torch, got, want, f"{label} S={S} with_tax={with_tax}",
                                                 names=names, phase="kernel_traj"))
            del A, b, p, got, want
    int8_err = check_int8(torch, qadam_cuda, dev)
    check_grads(torch, dev)

    # 10. the training slice, counted from 0; then its checkpoint served.
    train_launches, ckpt_serve_launches = train_slice(torch, dev, unroll_forward)

    # 11-12. training step time and kernel times; profile.
    _, train_timings = time_train(torch, dev, card)
    profile_train(torch, dev)

    ms, plain_ms, bms, by = timings[("synthetic_small", 256)]
    entries = [{
        "name": "unroll_forward",
        "route": "cuda",
        "source": "dladmm_tpu_torch/ops/csrc/unroll.cu",
        "replaces": "dladmm_tpu/ops/pallas_unroll.py:36",
        "launches": cli_launches,  # its main path: serve.main --demo 256
        "launches_by_path": {"serve_cli": cli_launches, "servers": server_launches,
                             "serve_ckpt_dir": ckpt_serve_launches},
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": None,
    }]
    for name, source, replaces, err, shape in (
        ("trajectory_forward", "dladmm_tpu_torch/ops/csrc/unroll.cu",
         "dladmm_tpu/ops/pallas_unroll.py:266", traj_err, "synthetic_small S=64 with_tax"),
        ("adam_int8_rows", "dladmm_tpu_torch/ops/csrc/qadam_int8.cu",
         "dladmm_tpu/train/qadam_pallas.py:129", int8_err, "synthetic_small W1+W2, one step"),
    ):
        ms, plain_ms, bms, by = train_timings[name]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": train_launches[name],  # main path: run.main --steps=300
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": None, "shape": shape,
        })
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
