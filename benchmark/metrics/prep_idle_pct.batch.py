"""The traced window's idle device time whose innermost program span is
``serve.prep`` (the request copied to the device from the caller's
memory, cast and padded), over the window, in %."""

from benchmark.yardstick import spans


def read(ctx):
    return spans.idle_pct(ctx, "serve.prep")
