"""Device kernel launches in the traced window over the steps in it."""

from benchmark.metrics import inside, steps
from benchmark.yardstick import trace as tr


def read(ctx):
    n = steps(ctx)
    k = len(inside(ctx, tr.kernels(ctx["events"])))
    return k / n if n and k else None
