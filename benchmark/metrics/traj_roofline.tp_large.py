"""Row 2 at tp_large (8192 x 16384, K = 20, S = 256, its weights streamed
from HBM): traj_roofline's reading, the frozen traj_bound(with_tax=True) of
each traj_persistent launch in the traced window over its device time,
in %."""

from pathlib import Path

from benchmark import spec

_READER = spec.load_module(Path(__file__).with_name("traj_roofline.py"), "traj_roofline")


def read(ctx):
    return _READER.read(ctx)
