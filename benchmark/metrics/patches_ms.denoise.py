"""The denoiser's patch pipeline (run_denoise._make_patch_batch: the
images' corruption, the windows' unfold and cat, the median DC): device
time of the kernels launched inside each ``train.data`` span wholly in
the traced window, the mean a span, in ms. The denoiser's step opens
``train.data`` around its patch batch alone."""

from benchmark.yardstick import spans


def read(ctx):
    return spans.device_ms_per_span(ctx, "train.data")
