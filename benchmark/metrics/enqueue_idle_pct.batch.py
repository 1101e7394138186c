"""The traced window's idle device time whose innermost program span is
``serve.forward`` (the forward kernel's wrapper, plan and launch), over
the window, in %."""

from benchmark.yardstick import spans


def read(ctx):
    return spans.idle_pct(ctx, "serve.forward")
