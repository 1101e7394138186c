"""Row 4, the backward kernel (bwd_chain, bwd_weights and finish): the
frozen bwd_bound of each reverse sweep inside the traced window (one
bwd_chain launch each), over the three kernels device time, in %."""

from benchmark.metrics import inside, kernel_us
from benchmark.yardstick import trace as tr
from benchmark.yardstick.roofline import bwd_bound


def match(name):
    return name.split("::")[-1].startswith(("bwd_chain", "bwd_weights", "finish<"))


def read(ctx):
    us = kernel_us(ctx, match)
    n = sum(tr.kernel_name(e["name"]).split("::")[-1].startswith("bwd_chain") for e in inside(ctx, tr.kernels(ctx["events"])))
    if not n or us <= 0:
        return None
    c = ctx["cfg"]
    return 100.0 * n * bwd_bound(ctx["batch"], c["m"], c["n"], c["K"])[0] * 1e3 / us
