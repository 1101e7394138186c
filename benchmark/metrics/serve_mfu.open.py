"""The whole served request: model FLOPs of the rows served inside the
traced window, over the window at the fp32 peak, in %."""

from benchmark.metrics import serve_mfu


def read(ctx):
    return serve_mfu(ctx)
