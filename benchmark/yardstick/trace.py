"""Reading a torch.profiler Chrome trace: device time, idle gaps, and the
kernels launched inside the benchmark's spans.

``kernel_name``, ``MARKER``, ``PORT_KERNELS`` and ``outermost`` are frozen
copies from ``dladmm_tpu_torch/utils/profiling.py`` and
``dladmm_tpu_torch/bench/profile_step.py`` at commit 376d358 (the
summary's trace reading); the rest is the benchmark's own.

A kernel event on the device lane carries the ``correlation`` of the
runtime call that launched it (``cuda_runtime`` or ``cuda_driver``),
which is recorded on the launching host thread. A kernel belongs to a
span when its launch lies inside that span on the span's thread.
"""

from __future__ import annotations

import bisect
import collections
import json

# The session's first kernel (utils/profiling.profile_marker): left out
# of every count.
MARKER = "spin_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

# The port's kernels by wrapper: each launch a wrapper counts is one
# device kernel whose name holds one of these (adam_step counts two a
# step: its prologue and its sweep).
PORT_KERNELS = {
    "unroll_forward": ("unroll_persistent",),
    "trajectory_forward": ("traj_persistent",),
    "unroll_bwd": ("bwd_chain",),
    "int8_unroll_forward": ("int8_persistent",),
    "adam_step": ("adam_prologue", "qadam_int8_sweep", "qadam_dense_sweep"),
}


def kernel_name(key: str) -> str:
    return key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0].strip()


def load(path: str) -> list:
    """The complete ('X') events of a Chrome trace file."""
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]


def outermost(events):
    """The events no other event of the same thread contains."""
    out, ends = [], {}
    for e in sorted(events, key=lambda e: (e.get("pid"), e.get("tid"), e["ts"], -e["dur"])):
        lane = (e.get("pid"), e.get("tid"))
        if e["ts"] >= ends.get(lane, float("-inf")):
            out.append(e)
            ends[lane] = e["ts"] + e["dur"]
    return out


def device_ops(events) -> list:
    """Kernels, copies and memsets on the device, the marker left out."""
    return [e for e in events if e.get("cat") in DEVICE_CATS and MARKER not in e.get("name", "")]


def kernels(events) -> list:
    return [e for e in device_ops(events) if e["cat"] == "kernel"]


def spans(events, name: str) -> list:
    """The host spans (record_function ranges) called ``name``."""
    return [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == name]


def merged(intervals, lo: float, hi: float) -> list:
    """The union of (start, end) intervals clipped to [lo, hi], sorted."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(events, lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] in which some operation ran on the device."""
    return sum(e - s for s, e in merged(((d["ts"], d["ts"] + d["dur"]) for d in device_ops(events)), lo, hi))


def idle_gaps(events, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] with nothing on the device."""
    busy = merged(((d["ts"], d["ts"] + d["dur"]) for d in device_ops(events)), lo, hi)
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def span_kind(name: str) -> str:
    """A benchmark span's name without what it carries after ':'
    (``bench.solve:37/64`` is a ``bench.solve``); other names whole."""
    return name.split(":")[0] if name.startswith("bench.") else name


def label_gaps(events, gaps, top: int = 10, labelled: int = 500, skip=()) -> list:
    """[[host operation, seconds], ...]: idle time summed by the innermost
    host operation (or benchmark span) that holds the whole gap, on any
    thread, "no host operation" where none does; the ``labelled``
    longest gaps are named, the rest summed as "shorter gaps". Spans
    named in ``skip`` (the window's own) are no label. The ``top``
    largest, longest first."""
    import numpy as np

    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("name") not in skip]
    starts = np.array([e["ts"] for e in host], dtype=np.float64)
    ends = starts + np.array([e["dur"] for e in host], dtype=np.float64)
    durs = ends - starts
    total = collections.Counter()
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    for s, e in gaps[:labelled]:
        hold = np.nonzero((starts <= s) & (ends >= e))[0]
        name = span_kind(host[hold[np.argmin(durs[hold])]]["name"]) if hold.size else "no host operation"
        total[name] += (e - s) / 1e6
    rest = sum(e - s for s, e in gaps[labelled:]) / 1e6
    if rest:
        total["shorter gaps"] += rest
    return [[name, sec] for name, sec in total.most_common(top)]


def top_device_ops(events, lo: float, hi: float, top: int = 10) -> list:
    """[[operation, seconds], ...]: device time inside [lo, hi] summed by
    kernel name, the ``top`` largest."""
    total = collections.Counter()
    for d in device_ops(events):
        s, e = max(d["ts"], lo), min(d["ts"] + d["dur"], hi)
        if e > s:
            total[kernel_name(d["name"])[:120]] += (e - s) / 1e6
    return [[name, sec] for name, sec in total.most_common(top)]


def launches_in_spans(events, name: str) -> list:
    """For each span called ``name``: (span, [device operations launched
    inside it on its thread])."""
    launch = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = e
    by_tid = collections.defaultdict(list)
    for sp in spans(events, name):
        by_tid[sp["tid"]].append(sp)
    starts = {}
    for tid, lst in by_tid.items():
        lst.sort(key=lambda e: e["ts"])
        starts[tid] = [sp["ts"] for sp in lst]
    found = {id(sp): [] for lst in by_tid.values() for sp in lst}
    for d in device_ops(events):
        lc = launch.get(d.get("args", {}).get("correlation"))
        if lc is None:
            continue
        lst = by_tid.get(lc["tid"])
        if not lst:
            continue
        i = bisect.bisect_right(starts[lc["tid"]], lc["ts"]) - 1
        if i >= 0 and lc["ts"] <= lst[i]["ts"] + lst[i]["dur"]:
            found[id(lst[i])].append(d)
    return [(sp, found[id(sp)]) for lst in by_tid.values() for sp in lst]


def count_port_kernels(events) -> dict:
    """Launches in the trace of each wrapper's kernels (PORT_KERNELS)."""
    names = collections.Counter(kernel_name(e["name"]) for e in kernels(events))
    return {w: sum(c for n, c in names.items() if any(p in n for p in pats)) for w, pats in PORT_KERNELS.items()}
