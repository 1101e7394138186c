"""Device kernel launches in the traced window over the steps in it
(kernels_per_step's reading) at tp_large, where the fp32 Adam update runs
as eager elementwise kernels, one layer of each leaf at a time."""

from pathlib import Path

from benchmark import spec

_READER = spec.load_module(Path(__file__).with_name("kernels_per_step.py"), "kernels_per_step")


def read(ctx):
    return _READER.read(ctx)
