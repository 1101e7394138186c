"""Timing of a chained step, with the fixed cost of a chain cancelled.

The port of ``dladmm_tpu/bench/timing.py``. The recipe has two parts:

1. Chain ``iters`` applications of the step on its carry (a real data
   dependency from one to the next), with no host synchronisation inside
   the chain: on the card, between two CUDA events recorded on the
   current stream, the stop event then waited for; on a CPU carry, with
   ``time.perf_counter`` around the chain. The best of ``repeats`` runs
   is kept.
2. Two-point calibration: a chain still pays a fixed cost once (the
   launch of its first operation, the event and the synchronisation),
   so it is timed at two lengths and the slope taken, per_iter =
   (t_hi - t_lo) / (iters_hi - iters_lo), which cancels that cost.

The JAX package compiled one runner per step (a jitted fori_loop) and
kept it in a weak cache; PyTorch runs the step eagerly, so there is no
runner to compile and no cache. A step that updates its carry in place
(a training state) starts each chain from where the last one ended.

The events bracket the host's enqueue as well as the card's work: a step
that the card runs faster than the host enqueues it (an eager plain loop
of many small operations) is timed at the host's rate, not the card's
(CHAIN_TIME_FROM says so wherever a table reports such a time).
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

CHAIN_TIME_FROM = ("CUDA events around a chain of calls with no host synchronisation inside (time_chained): "
                   "the card's time a call where the card is slower than the host's enqueue, the host's "
                   "enqueue time a call where it is not (eager plain paths of many small operations)")


def _tensors(carry):
    """The tensors of a carry: a tensor, or tuples, lists and dicts of
    them (NamedTuples included), in order."""
    if isinstance(carry, torch.Tensor):
        return [carry]
    if isinstance(carry, dict):
        carry = list(carry.values())
    if isinstance(carry, (tuple, list)):
        return [t for c in carry for t in _tensors(c)]
    return []


def _carry_device(carry) -> torch.device:
    """The device of a carry's first tensor (the CPU for a carry with
    none)."""
    ts = _tensors(carry)
    return ts[0].device if ts else torch.device("cpu")


def _check_finite(carry) -> None:
    floats = [t for t in _tensors(carry) if t.is_floating_point() and t.numel()]
    if floats and not bool(torch.isfinite(floats[0].reshape(-1)[:8].float().sum())):
        raise FloatingPointError("NaN or inf in the timing chain")


def _run_chained(step: Callable, init_carry, iters: int, repeats: int) -> float:
    """Best-of-``repeats`` seconds of ``iters`` chained steps from
    ``init_carry``; one warm-up step first."""
    cuda = _carry_device(init_carry).type == "cuda"
    _check_finite(step(init_carry))
    if cuda:
        torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        carry = init_carry
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                carry = step(carry)
            stop.record()
            stop.synchronize()
            secs = start.elapsed_time(stop) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                carry = step(carry)
            _check_finite(carry)
            secs = time.perf_counter() - t0
        best = min(best, secs)
    _check_finite(carry)
    return best


def time_chained(
    step: Callable,
    init_carry,
    iters: int = 32,
    warmup: bool = True,  # kept for the JAX package's signature; a warm-up step always runs
    repeats: int = 3,
    calibrate: bool = True,
    strict: bool = False,
    agree: Optional[Callable[[float], float]] = None,
) -> float:
    """Seconds per iteration of ``carry -> step(carry)`` chained on the
    carry's device.

    ``step`` returns a carry of the same structure as ``init_carry``.
    With calibrate=True (default) the fixed cost of a chain is cancelled
    by timing two chain lengths (iters // 4 and iters) and taking the
    slope; calibrate=False returns the naive t / iters.

    If the slope stays non-positive after four chain doublings, the
    default strict=False falls back to the naive long-chain estimate with
    an "UNCALIBRATED" warning (an upper bound: it includes the fixed cost
    over iters) so that one noisy measurement cannot abort a sweep;
    strict=True raises RuntimeError instead.

    ``agree``: applied to each chain's time before it is used (the ranks
    of a distributed run pass the maximum over the ranks, so that every
    rank takes the same decisions and runs the same chains, whose steps
    hold collectives)."""
    del warmup
    run = _run_chained if agree is None else (lambda *a: agree(_run_chained(*a)))  # noqa: E731
    if not calibrate:
        return run(step, init_carry, iters, repeats) / iters
    iters = max(iters, 4)  # the slope needs lo < iters
    t_hi = None
    for _ in range(4):
        lo = max(1, iters // 4)
        t_lo = run(step, init_carry, lo, repeats)
        t_hi = run(step, init_carry, iters, repeats)
        slope = (t_hi - t_lo) / (iters - lo)
        if slope > 0:
            return slope
        iters *= 2
    if strict:
        raise RuntimeError("calibrated timing: no positive slope after lengthening chains (step too fast or too noisy)")
    naive = t_hi / (iters // 2)  # the last t_hi ran iters // 2 steps
    warnings.warn(
        "calibrated timing: no positive slope after lengthening chains; "
        f"falling back to UNCALIBRATED estimate {naive:.3e}s/iter "
        "(upper bound: includes the chain's fixed cost over iters)"
    )
    return naive


def median_ms(fns, reps: int):
    """Median CUDA-event ms of each fn, called in turns (a, b, b, a, ...)
    so that all see the same clocks and the same warm L2."""
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


__all__ = ["median_ms", "time_chained"]
