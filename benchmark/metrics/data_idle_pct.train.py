"""The traced window's idle device time whose innermost program span is
``train.data`` (the step's batch drawn on the host, copied to the device
and multiplied by A), over the window, in %."""

from benchmark.yardstick import spans


def read(ctx):
    return spans.idle_pct(ctx, "train.data")
