"""Row 1, the serving forward: the frozen bound of each solve at its
bucket, over the device time of every kernel launched inside the solve
spans of the traced window, in %."""

from benchmark.metrics import solve_roofline


def read(ctx):
    return solve_roofline(ctx)
