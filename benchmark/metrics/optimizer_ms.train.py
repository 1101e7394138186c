"""Device time of the kernels launched inside each ``train.optimizer``
span wholly in the traced window (the fused Adam step's prologue and
sweep), the mean a span, in ms."""

from benchmark.yardstick import spans


def read(ctx):
    return spans.device_ms_per_span(ctx, "train.optimizer")
