"""The traced window's idle device time put down to the program's spans.

The program opens its own ranges (``utils/profiling.span``) in the same
profiler session as the benchmark's: ``serve.*`` around a request's
parts, ``train.*`` around a step's. Each idle instant of the window
[lo, hi] (``trace.idle_gaps``: no kernel, copy or memset on the device)
goes to the innermost program span open at that instant on the thread
that holds the window's span (the range that opens at lo and closes at
hi), and to ``OUTSIDE`` where none is open. Every idle instant is
counted once, so the sums over the spans and ``OUTSIDE`` add up to the
idle time that ``idle_pct`` reads.
"""

from __future__ import annotations

import collections

from benchmark.yardstick import trace as tr

PROGRAM = ("serve.", "train.")
OUTSIDE = "outside"


def window_lane(ctx):
    """(pid, tid) of the window's span, the range that opens at lo and
    closes at hi, or None."""
    for e in ctx["events"]:
        if e.get("cat") == "user_annotation" and e["ts"] == ctx["lo"] and e["ts"] + e["dur"] == ctx["hi"]:
            return e.get("pid"), e.get("tid")
    return None


def program_spans(events, lane) -> list:
    """The program's spans on ``lane``."""
    return [e for e in events if e.get("cat") == "user_annotation" and e.get("name", "").startswith(PROGRAM)
            and (e.get("pid"), e.get("tid")) == lane]


def innermost(spans) -> list:
    """[(start, end, name), ...] sorted and disjoint: the stretches in
    which some span is open, each named by the innermost one. A span
    that outlasts the one it opened in (a rounding of the trace's
    clock) is cut at that one's end."""
    out, stack, t = [], [], None
    for sp in sorted(spans, key=lambda e: (e["ts"], -e["dur"])):
        s, e = sp["ts"], sp["ts"] + sp["dur"]
        while stack and stack[-1][0] <= s:
            end, name = stack.pop()
            if end > t:
                out.append((t, end, name))
                t = end
        if stack and s > t:
            out.append((t, s, stack[-1][1]))
        t = s if t is None else max(t, s)
        stack.append((min(e, stack[-1][0]) if stack else e, sp["name"]))
    while stack:
        end, name = stack.pop()
        if end > t:
            out.append((t, end, name))
            t = end
    return out


def idle_by_span(ctx, lane) -> dict:
    """{span name or OUTSIDE: idle microseconds} over the window, from
    the program's spans on ``lane``; empty where the window holds no
    device operation."""
    events, lo, hi = ctx["events"], ctx["lo"], ctx["hi"]
    if not tr.device_ops(events):
        return {}
    segs = innermost(program_spans(events, lane))
    total = collections.Counter()
    i = 0
    for gs, ge in tr.idle_gaps(events, lo, hi):
        covered = 0.0
        while i < len(segs) and segs[i][1] <= gs:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < ge:
            s, e = max(segs[j][0], gs), min(segs[j][1], ge)
            if e > s:
                total[segs[j][2]] += e - s
                covered += e - s
            j += 1
        total[OUTSIDE] += (ge - gs) - covered
    return dict(total)


def idle_pct(ctx, name: str):
    """The window's idle time whose innermost program span is ``name``,
    over the window, in %; None where the window's thread holds no such
    span in the window, or the window no device operation."""
    lo, hi = ctx["lo"], ctx["hi"]
    lane = window_lane(ctx)
    if lane is None or not any(e["name"] == name and e["ts"] < hi and e["ts"] + e["dur"] > lo
                               for e in program_spans(ctx["events"], lane)):
        return None
    idle = idle_by_span(ctx, lane)
    return 100.0 * idle.get(name, 0.0) / (hi - lo) if idle else None


def device_ms_per_span(ctx, name: str):
    """Mean device time, in ms, of the kernels launched inside each span
    called ``name`` that lies wholly in the window (on the span's
    thread); None where no such span launched a kernel."""
    lo, hi = ctx["lo"], ctx["hi"]
    found = [ops for sp, ops in tr.launches_in_spans(ctx["events"], name)
             if sp["ts"] >= lo and sp["ts"] + sp["dur"] <= hi]
    us = sum(d["dur"] for ops in found for d in ops if d["cat"] == "kernel")
    return us / 1e3 / len(found) if found and us > 0 else None
