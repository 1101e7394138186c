"""Row 2, the trajectory kernel (traj_persistent): the frozen
traj_bound(with_tax=True) of each launch inside the traced window, over
its device time, in %."""

from benchmark.metrics import inside, kernel_us
from benchmark.yardstick import trace as tr
from benchmark.yardstick.roofline import traj_bound


def match(name):
    return "traj_persistent" in name


def read(ctx):
    us = kernel_us(ctx, match)
    n = sum(match(tr.kernel_name(e["name"])) for e in inside(ctx, tr.kernels(ctx["events"])))
    if not n or us <= 0:
        return None
    c = ctx["cfg"]
    return 100.0 * n * traj_bound(ctx["batch"], c["m"], c["n"], c["K"], True)[0] * 1e3 / us
