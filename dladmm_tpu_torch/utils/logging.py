"""Structured scalar logging: the port of ``dladmm_tpu/utils/logging.py``.

One JSON object per record, appended to a jsonl file and mirrored to
stderr. In a data-parallel run train/loop.fit_sharded calls it on rank 0
only (the JAX package's host-0 filter).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional


class JsonlLogger:
    """Appends one JSON object per record; also mirrors it to stderr."""

    def __init__(self, path: Optional[str] = None, mirror_stdout: bool = True):
        self.path = path
        self.mirror = mirror_stdout

    def __call__(self, record: dict) -> None:
        line = json.dumps({"t": time.time(), **record})
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.mirror:
            print(line, file=sys.stderr)
