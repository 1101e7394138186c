"""The plain reference: D-LADMM's unroll, its losses and gradients, the
global-norm clip and Adam with int8 moments, in plain PyTorch written
from the paper's recurrence. It imports nothing of the program, and
runs with TF32 off (``precision``), so its float32 is float32."""

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool = False):
    """fp32 products in fp32 (the reference) or in TF32 (the control,
    ``tf32=True``), restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
