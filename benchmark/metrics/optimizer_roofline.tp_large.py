"""The optimizer step at tp_large: the frozen dense_bound of one fp32 Adam
pass over every parameter (4.027e9 elements, 28 bytes each: 33.7 ms),
over the mean device time of the kernels launched inside each
``train.optimizer`` span wholly in the traced window, in %."""

from benchmark.yardstick import spans
from benchmark.yardstick.roofline import dense_bound


def parameters(m: int, n: int, K: int) -> int:
    """Elements of W1 (K, n, m), W2 (K, m, m), theta1 (K, n), theta2 (K, m)
    and beta (K,)."""
    return K * (n * m + m * m + n + m + 1)


def read(ctx):
    ms = spans.device_ms_per_span(ctx, "train.optimizer")
    if ms is None:
        return None
    c = ctx["cfg"]
    return 100.0 * dense_bound(parameters(c["m"], c["n"], c["K"]), "float32")[0] / ms
