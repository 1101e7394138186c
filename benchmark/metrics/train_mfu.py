"""The whole training step: model FLOPs of the steps inside the traced
window (the forward solve and the reverse sweep, yardstick
train_step_flops) over the window at the fp32 peak, in %."""

from benchmark.metrics import steps, window_s
from benchmark.yardstick import trace as tr
from benchmark.yardstick.roofline import PEAK_FP32_FLOPS, train_step_flops


def read(ctx):
    n = steps(ctx)
    if not n or not tr.device_ops(ctx["events"]):
        return None
    c = ctx["cfg"]
    return 100.0 * n * train_step_flops(ctx["batch"], c["m"], c["n"], c["K"]) / (window_s(ctx) * PEAK_FP32_FLOPS)
