"""Useful rows over bucket rows of the solves inside the traced window,
in %: what padding to the bucket wastes."""

from benchmark.metrics import bucket_fill


def read(ctx):
    return bucket_fill(ctx)
