"""Tracing, the profiler's workarounds on the card, and NaN-debug hooks.

The port of ``dladmm_tpu/utils/profiling.py``: a torch.profiler trace
around a block (a Chrome trace that bench/profile_step.summarize reads),
a NaN-debug mode that raises at the first NaN an operation makes (as
``jax_debug_nans`` does), and a step timer that synchronises the device
it times.

The profiler on the card has been seen to leave a session's leading
device records out, late in a process, and to record no device activity
at all in a window. ``profile_marker`` opens every session with a short
kernel that is left out of every count, so that the records left out are
the marker's; ``retry_incomplete`` runs a session again when it still
missed records (``IncompleteProfile``), and is the one place that
retries. ``profile_fn`` and ``device_kernels``
read a session as device time a call by kernel.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

TRACE_FILE = "trace.json"

_NAN_DEBUG = {"on": False, "mode": None, "anomaly": None}


MARKER = "spin_kernel"
MARKER_CYCLES = 1000
PROFILE_ATTEMPTS = 3


def _log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


class IncompleteProfile(AssertionError):
    """A profiler session that missed device records it should hold."""


def profile_marker() -> None:
    """The kernel (``spin_kernel``, a short spin) enqueued first in every
    profiler session on the card: the records the profiler leaves out of
    a session's start (the first kernel, at times more) are then this
    marker's. Kernels of that name are left out of every count. A marker
    of about 0.1 s waited for was tried in its place and dropped: in a
    session after it a training step's device records no longer fell in
    the host ranges of their phases."""
    torch.cuda._sleep(MARKER_CYCLES)


def retry_incomplete(session, config: str):
    """(session(), sessions run): a session that raises IncompleteProfile
    is run again, each retry reported, up to PROFILE_ATTEMPTS sessions;
    the last one's IncompleteProfile propagates."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        try:
            return session(), attempt
        except IncompleteProfile as e:
            if attempt == PROFILE_ATTEMPTS:
                raise
            _log("profile_retry", config=config, attempt=attempt, missed=str(e)[:2000])


def kernel_name(key: str) -> str:
    return key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0].strip()


def device_kernels(prof, steps: int):
    """Device time per step and launches per step of each kernel (memset
    and copy) by name, from a profile over ``steps`` steps; raises
    IncompleteProfile where the session recorded no device time."""
    kernels = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = e.cuda_time_total
        if e.device_type.name != "CUDA" or dev_us <= 0 or e.key.startswith("cuda") or MARKER in e.key:
            continue  # host ops, runtime calls and the session's marker; kernels are device events
        k = kernels.setdefault(kernel_name(e.key), {"us": 0.0, "calls": 0.0})
        k["us"] += dev_us / steps
        k["calls"] += e.count / steps
    if not kernels:
        raise IncompleteProfile("the profiler recorded no device time")
    return kernels


def back_to_back_ms(fn, calls: int = 20, rounds: int = 3) -> float:
    """Median over ``rounds`` of the CUDA-event ms a call of ``calls``
    back-to-back calls take: the card's time a call wherever the host
    enqueues a call faster than the card runs it, whatever the profiler
    records."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return float(np.median(times))


def profile_fn(fn, config: str, reps: int = 5, events_fallback: bool = False):
    """torch.profiler over ``reps`` calls of fn: device time per call of
    each kernel (and memset) by name, and the device's busy share of the
    CUDA-event window around them. A window in which the profiler
    recorded no device activity (seen on the card with the kernels
    running and checked; three windows in a row late in a process) is
    profiled again (retry_incomplete); after the last it fails, or with
    ``events_fallback`` (where the device time is a figure to report,
    not a check of what ran) the device time a call is taken from
    back-to-back CUDA events instead, and ``device_time_from`` says so."""
    from torch.profiler import ProfilerActivity, profile

    def session():
        with torch.no_grad():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                profile_marker()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    fn()
                stop.record()
                torch.cuda.synchronize()
        return device_kernels(prof, reps), start.elapsed_time(stop) * 1e3

    try:
        (kernels, window_us), _ = retry_incomplete(session, config)
    except IncompleteProfile:
        if not events_fallback:
            raise
        ms = back_to_back_ms(fn, calls=reps)
        _log("profile_fallback", config=config, windows=PROFILE_ATTEMPTS, back_to_back_ms=ms)
        return {"config": config, "calls": reps, "device_us_per_call": ms * 1e3, "per_call": {},
                "device_time_from": "back-to-back CUDA events: the profiler recorded no device time"}
    busy_us = sum(v["us"] for v in kernels.values()) * reps
    return {"config": config, "calls": reps, "window_ms_per_call": window_us / reps / 1e3,
            "device_us_per_call": busy_us / reps, "device_busy_share": busy_us / window_us,
            "per_call": kernels}


@contextlib.contextmanager
def trace(log_dir: str, cuda=None):
    """A torch.profiler trace around a code block, exported as a Chrome
    trace to ``log_dir``/trace.json; yields ``log_dir``::

        with profiling.trace("tr"):
            state, loss = step(state, batch)

    The CPU activity is always on, the CUDA activity where the card is in
    use (``cuda``: default torch.cuda.is_initialized()); on the card the
    session opens with profile_marker."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    if cuda is None:
        cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        if cuda:
            profile_marker()
        yield log_dir
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class _NanCheck(TorchDispatchMode):
    """Checks the floating outputs of every aten operation for NaN.
    Factory operations whose output is uninitialised memory are left
    out."""

    _UNINITIALISED = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "resize_")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name not in self._UNINITIALISED:
            _raise_on_nan(f"aten.{name}", out)
        return out


def _raise_on_nan(what: str, out) -> None:
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for i, t in enumerate(outs):
        if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel() and bool(torch.isnan(t).any()):
            raise FloatingPointError(f"NaN in output {i} of {what} (enable_nan_debug)")


def enable_nan_debug(enable: bool = True) -> None:
    """Raise FloatingPointError at the first NaN an operation makes, as
    ``jax_debug_nans`` does. On: a dispatch mode, pushed here, checks the
    floating outputs of every aten operation (which synchronises the
    device at each); autograd's anomaly mode checks the backward; and
    the port's kernel wrappers, whose launches no dispatch mode sees
    (they go through ctypes), check their outputs where they count their
    launches (``check_kernel_outputs``). Off: the mode is popped and
    nothing is checked or synchronised."""
    state = _NAN_DEBUG
    if enable == state["on"]:
        return
    if enable:
        mode = _NanCheck()
        mode.__enter__()
        anomaly = torch.autograd.set_detect_anomaly(True)
        state.update(on=True, mode=mode, anomaly=anomaly)
    else:
        state["anomaly"].__exit__(None, None, None)
        state["mode"].__exit__(None, None, None)
        state.update(on=False, mode=None, anomaly=None)


def nan_debug_enabled() -> bool:
    return _NAN_DEBUG["on"]


def check_kernel_outputs(name: str, *outputs) -> None:
    """A kernel wrapper's NaN check, after its launch: raises
    FloatingPointError where an output holds a NaN and the NaN debug mode
    is on. Nothing at all when it is off."""
    if _NAN_DEBUG["on"]:
        _raise_on_nan(f"the kernel of {name}", tuple(outputs))


class StepTimer:
    """Step timer for training-loop logging: seconds since the last lap,
    after synchronising the device of ``sync_on``."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self, sync_on=None) -> float:
        if sync_on is not None:
            _synchronize(sync_on)
        t = time.perf_counter()
        dt = t - self.t0
        self.t0 = t
        return dt


def _synchronize(value) -> None:
    """Wait for the devices of every tensor in ``value`` (a tensor, or
    tuples, lists and dicts of them)."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            torch.cuda.synchronize(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _synchronize(v)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _synchronize(v)


__all__ = ["IncompleteProfile", "MARKER", "StepTimer", "TRACE_FILE", "back_to_back_ms", "check_kernel_outputs",
           "device_kernels", "enable_nan_debug", "kernel_name", "nan_debug_enabled", "profile_fn", "profile_marker",
           "retry_incomplete", "trace"]
