"""Mean useful rows a device call: the rows of each solve the batching
front end dispatched inside the traced window (its spans)."""

from benchmark.metrics import dispatch_rows


def read(ctx):
    return dispatch_rows(ctx)
