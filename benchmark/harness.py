"""What every driver shares: timing of set-up, the traced sub-window,
the wrappers' launch counters, and the look for JAX after the window.

The traced sub-window (``Tracer.capture``) is one torch.profiler session
over every thread of the process (CPU and CUDA activity), opened with a
short marker kernel that every count leaves out. Inside it the body runs
under the span ``bench.window``, which bounds the traced window. The
trace must hold every launch that the program's kernel wrappers counted
inside the window (their ``.launches`` counters); a session that misses
some is run once more, and a second miss raises ``IncompleteTrace``: a
number from a partial trace is never reported.
"""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import sys
import tempfile
import time

from benchmark.yardstick import trace as tr

WINDOW = "bench.window"
JAX_NAMES = ("jax", "jaxlib", "flax", "dladmm_tpu")


class IncompleteTrace(RuntimeError):
    pass


# Host threads of PyTorch's CPU operations: one, whatever the machine's
# cores. On an H100 machine with 8 cores large-train-final ran as fast at
# torch's default count while the host was fast, and no faster while it
# was slow (PERF.md); one thread keeps the load on the host small.
HOST_THREADS = 1


def host_threads() -> None:
    import torch

    torch.set_num_threads(HOST_THREADS)


def settle() -> None:
    """The end of set-up: collect, then move every object set-up made
    (the imported modules, the inputs, the program's state) to the
    collector's permanent generation, so that a full collection in the
    window walks only what the window allocates (one over torch's
    objects stalls every thread for ~0.1 s)."""
    gc.collect()
    gc.freeze()


class HostProbe:
    """How fast this host runs Python as the window opens and as it
    closes: ns an iteration of a fixed loop, the best of five. The card's
    machine shares its host's cores, and host-bound numbers move with
    this from run to run; it goes to stderr beside them."""

    def __init__(self):
        self.before = self._probe()

    @staticmethod
    def _probe() -> float:
        best = float("inf")
        for _ in range(5):
            t = time.perf_counter_ns()
            sum(i * i for i in range(100_000))
            best = min(best, (time.perf_counter_ns() - t) / 100_000)
        return best

    def close(self) -> str:
        return (f"host: {self.before:.2f} ns a loop iteration before the window, "
                f"{self._probe():.2f} ns after it")


class GcPauses:
    """Times the collector's full (generation 2) collections while on."""

    def __init__(self):
        self.pauses, self._t = [], None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t = time.monotonic()
        elif self._t is not None:
            self.pauses.append(time.monotonic() - self._t)

    def close(self) -> str:
        gc.callbacks.remove(self._cb)
        p = self.pauses
        return (f"gc: {len(p)} full collections in the window, {sum(p) * 1e3:.3f} ms in all, "
                f"longest {max(p, default=0.0) * 1e3:.3f} ms")


def jax_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (dladmm_tpu_torch is not dladmm_tpu)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(JAX_NAMES))


def launches() -> dict:
    """The program's kernel wrappers' launch counters, by wrapper (the
    keys of yardstick.trace.PORT_KERNELS)."""
    from dladmm_tpu_torch.ops import cuda_bwd, cuda_int8, cuda_layer, cuda_traj, cuda_unroll
    from dladmm_tpu_torch.train import qadam_cuda

    return {"unroll_forward": cuda_unroll.unroll_forward.launches + cuda_layer.layer_step.launches,
            "trajectory_forward": cuda_traj.trajectory_forward.launches + cuda_traj.trajectory_forward.launches_bf16,
            "unroll_bwd": sum(cuda_bwd.unroll_bwd.launches.values()) + sum(cuda_bwd.unroll_bwd.launches_bf16.values()),
            "int8_unroll_forward": cuda_int8.int8_unroll_forward.launches,
            "adam_step": qadam_cuda.adam_step.launches + qadam_cuda.adam_step.launches_bf16}


def synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Tracer:
    """Runs a body inside a traced sub-window; see the module docstring."""

    ATTEMPTS = 2

    def __init__(self, device):
        self.device = device
        self.sessions = 0

    def capture(self, body):
        """(ctx, body's result): ctx holds the trace's events, the window
        [lo, hi] in trace microseconds, and the launches counted inside."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        cuda = self.device.type == "cuda"
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        missed = None
        for _ in range(self.ATTEMPTS):
            self.sessions += 1
            synchronize(self.device)
            with profile(activities=acts, experimental_config=config) as prof:
                if cuda:
                    torch.cuda._sleep(1000)  # the marker: the session's first kernel
                with record_function(WINDOW):
                    before = launches()
                    t0 = time.monotonic()
                    result = body()
                    synchronize(self.device)
                    t1 = time.monotonic()
                    counted = {k: v - before[k] for k, v in launches().items()}
            events = self._events(prof)
            window = tr.spans(events, WINDOW)
            in_trace = tr.count_port_kernels(events) if cuda else counted
            missed = {k: (in_trace[k], n) for k, n in counted.items() if in_trace[k] < n}
            if len(window) == 1 and not missed:
                lo, hi = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
                return {"events": events, "lo": lo, "hi": hi, "host_s": t1 - t0, "launches": counted}, result
        raise IncompleteTrace(f"the trace missed launches (in trace, counted): {missed} after {self.ATTEMPTS} sessions")

    @staticmethod
    def _events(prof) -> list:
        tmp = tempfile.mkdtemp(prefix="bench_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            return tr.load(path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def span(name: str):
    """A benchmark span around a call into the program (a record_function
    range, which the trace keeps on the calling thread)."""
    from torch.profiler import record_function

    with record_function(name):
        yield


def device_summary(ctx: dict) -> dict:
    """busy_s, window_s and the breakdown of a traced window."""
    ev, lo, hi = ctx["events"], ctx["lo"], ctx["hi"]
    gaps = tr.idle_gaps(ev, lo, hi)
    return {"busy_s": tr.busy_us(ev, lo, hi) / 1e6, "window_s": (hi - lo) / 1e6,
            "breakdown": {"device_ops": tr.top_device_ops(ev, lo, hi),
                          "idle_gaps": tr.label_gaps(ev, gaps, skip=(WINDOW,))}}
