"""Per-layer metrics: ``<name>.py`` holds ``read(ctx)``, which returns the
metric's value or None where the traced window holds nothing to read
(never 0 for a share of a roofline or a peak). ``ctx`` is the traced
window (harness.Tracer.capture: ``events``, ``lo``, ``hi``) with the
cell's ``cfg`` and ``mix`` and what its driver adds (``batch``). The
helpers here are what several readers share."""

from __future__ import annotations

from benchmark.yardstick import trace as tr


def inside(ctx, events):
    lo, hi = ctx["lo"], ctx["hi"]
    return [e for e in events if e["ts"] >= lo and e["ts"] + e["dur"] <= hi]


def solve_calls(ctx) -> list:
    """(rows, bucket, [device kernels launched inside]) of each solve span
    (``bench.solve:<rows>/<bucket>``) wholly inside the window."""
    spans = [e for e in ctx["events"] if e.get("cat") == "user_annotation" and e["name"].startswith("bench.solve:")]
    names = {e["name"] for e in inside(ctx, spans)}
    out = []
    for name in names:
        rows, bucket = (int(v) for v in name.split(":")[1].split("/"))
        for sp, ops in tr.launches_in_spans(ctx["events"], name):
            if sp["ts"] >= ctx["lo"] and sp["ts"] + sp["dur"] <= ctx["hi"]:
                out.append((rows, bucket, [d for d in ops if d["cat"] == "kernel"]))
    return out


def dispatch_rows(ctx):
    """Mean useful rows a solve call."""
    calls = solve_calls(ctx)
    return sum(r for r, _, _ in calls) / len(calls) if calls else None


def bucket_fill(ctx):
    """Useful rows over bucket rows of the solve calls, in %."""
    calls = solve_calls(ctx)
    return 100.0 * sum(r for r, _, _ in calls) / sum(b for _, b, _ in calls) if calls else None


def steps(ctx) -> int:
    return len(inside(ctx, tr.spans(ctx["events"], "bench.step")))


def window_s(ctx) -> float:
    return (ctx["hi"] - ctx["lo"]) / 1e6


def idle_pct(ctx):
    if not tr.device_ops(ctx["events"]):
        return None
    return 100.0 * (1.0 - tr.busy_us(ctx["events"], ctx["lo"], ctx["hi"]) / (ctx["hi"] - ctx["lo"]))


def kernel_us(ctx, match) -> float:
    """Device time inside the window of the kernels whose name ``match``es."""
    return sum(e["dur"] for e in inside(ctx, tr.kernels(ctx["events"])) if match(tr.kernel_name(e["name"])))


def solve_roofline(ctx):
    """Sum over the solve calls of the frozen bound at the bucket, over the
    device time of every kernel launched inside their spans, in %."""
    from benchmark.yardstick.roofline import bound

    calls = solve_calls(ctx)
    dev_us = sum(d["dur"] for _, _, ops in calls for d in ops)
    if not calls or dev_us <= 0:
        return None
    c = ctx["cfg"]
    return 100.0 * sum(bound(bucket, c["m"], c["n"], c["K"])[0] * 1e3 for _, bucket, _ in calls) / dev_us


def serve_mfu(ctx):
    """Model FLOPs of the rows the window's solves served (unpadded) over
    the traced window at the fp32 peak, in %."""
    from benchmark.yardstick.roofline import PEAK_FP32_FLOPS, solve_flops

    calls = solve_calls(ctx)
    if not calls or not tr.device_ops(ctx["events"]):
        return None
    c = ctx["cfg"]
    flops = sum(solve_flops(rows, c["m"], c["n"], c["K"]) for rows, _, _ in calls)
    return 100.0 * flops / (window_s(ctx) * PEAK_FP32_FLOPS)
