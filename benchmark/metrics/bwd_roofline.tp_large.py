"""Row 4 at tp_large (S = 256, its weights streamed from HBM):
bwd_roofline's reading, the frozen bwd_bound of each reverse sweep in the
traced window over the device time of bwd_chain, bwd_weights and
finish, in %."""

from pathlib import Path

from benchmark import spec

_READER = spec.load_module(Path(__file__).with_name("bwd_roofline.py"), "bwd_roofline")


def read(ctx):
    return _READER.read(ctx)
