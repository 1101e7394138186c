"""Share of the traced window with nothing running on the device, in %."""

from benchmark.metrics import idle_pct


def read(ctx):
    return idle_pct(ctx)
