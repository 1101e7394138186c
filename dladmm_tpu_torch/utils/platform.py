"""Device selection for the port's entry points.

The counterpart of ``dladmm_tpu/utils/platform.py``: every entry point
runs on ``cuda`` unless the caller asks for the CPU, with an explicit
``device=`` argument or with ``DLADMM_PLATFORM=cpu`` (the same escape
hatch the JAX package's CLIs honour). Asking for the card where CUDA is
absent raises; nothing quietly carries on on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(
    device: Optional[Union[str, torch.device]] = None,
) -> torch.device:
    """The device an entry point runs on.

    ``device`` wins when given; else ``DLADMM_PLATFORM`` (``cpu`` or
    ``cuda``/``gpu``); else ``cuda``. Raises RuntimeError when the
    answer is a CUDA device and CUDA is not available."""
    if device is None:
        platform = os.environ.get("DLADMM_PLATFORM", "").strip().lower()
        if platform in ("", "cuda", "gpu"):
            device = "cuda"
        elif platform == "cpu":
            device = "cpu"
        else:
            raise ValueError(
                f"DLADMM_PLATFORM={platform!r} is not one of cpu, cuda, gpu"
            )
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on CUDA by default, and CUDA is not available "
            "here; pass device='cpu' or set DLADMM_PLATFORM=cpu to run "
            "the plain PyTorch path on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}; use cuda or cpu")
    return device
