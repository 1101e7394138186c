"""Checkpoint / resume for the port's training.

The port of ``dladmm_tpu/utils/checkpoint.py`` on ``torch.save`` and
``torch.load(weights_only=True)``: a checkpoint holds plain tensors,
ints, lists and dicts only, so loading it runs no pickled code. Each
``step_N.pt`` under a checkpoint directory holds the params, the
optimizer state, the step, and the dictionary A (and a general B) the
net was trained on: a checkpoint serves against the dictionary it was
trained with (``serve --ckpt-dir``), whatever generator drew it.

NamedTuples (DLADMMParams, optimizer states, QTensor) are written as
dicts of their fields; ``restore_checkpoint`` reads them back into the
structure, shapes, dtypes and devices of a template state.

A TrainState is saved as its three canonical fields (params, optimizer
state, step): bf16 training's compute copy (``compute_params``) is
derivable from the fp32 masters and is never written, so a checkpoint of
a bf16 run and an old 3-field one load alike, with ``compute_params``
None (train/loop.fit casts it again on resume).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

_STEP_FILE = "step_{}.pt"


def _plain(x):
    """A state -> nested dicts / lists of CPU tensors and Python scalars."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: _plain(v) for f, v in zip(x._fields, x)}
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    if x is None or isinstance(x, (int, float, bool, str)):
        return x
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def _restore(template, data, where: str = "state"):
    """``data`` (as written by _plain) into the structure of ``template``."""
    if isinstance(template, torch.Tensor):
        if not isinstance(data, torch.Tensor) or tuple(data.shape) != tuple(template.shape):
            got = tuple(data.shape) if isinstance(data, torch.Tensor) else type(data).__name__
            raise ValueError(f"{where}: checkpoint has {got}, expected {tuple(template.shape)}")
        return data.to(template.device, template.dtype)
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(
            _restore(v, data[f], f"{where}.{f}") for f, v in zip(template._fields, template)
        ))
    if isinstance(template, (tuple, list)):
        if len(data) != len(template):
            raise ValueError(f"{where}: checkpoint has {len(data)} entries, expected {len(template)}")
        return type(template)(_restore(t, d, f"{where}[{i}]") for i, (t, d) in enumerate(zip(template, data)))
    return data


def save_checkpoint(path: str, state, step: int, A=None, B=None) -> str:
    """Write ``state`` (a TrainState; its compute copy is left out) with
    the dictionary A (and B) to ``path/step_N.pt``, atomically. Returns
    the file written."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, _STEP_FILE.format(step))
    payload = {
        "params": _plain(state.params),
        "opt_state": _plain(state.opt_state),
        "step": int(state.step),
        "A": None if A is None else _plain(A),
        "B": None if B is None else _plain(B),
    }
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, target)
    return target


def _load(path: str) -> dict:
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, template) -> tuple:
    """Read a checkpoint file into the structure, dtypes and devices of
    ``template`` (a TrainState built for the same config). Returns
    (state, A, B) with A and B as CPU tensors (B None for B = I); the
    state's compute copy, where it has the field, is None."""
    data = _load(path)
    state = type(template)(
        _restore(template.params, data["params"], "params"),
        _restore(template.opt_state, data["opt_state"], "opt_state"),
        int(data["step"]),
    )
    return state, data["A"], data["B"]


def load_params(path: str, device=None) -> tuple:
    """(params, A, B) of a checkpoint file, on ``device``: what the
    serving CLI's --ckpt-dir restores. B is None for B = I."""
    from dladmm_tpu_torch.models.unroll import DLADMMParams

    data = _load(path)
    params = DLADMMParams(*(data["params"][f].to(device) for f in DLADMMParams._fields))
    put = lambda t: None if t is None else t.to(device)  # noqa: E731
    return params, put(data["A"]), put(data["B"])


def latest_step_dir(path: str) -> Optional[str]:
    """The most recent ``step_N`` checkpoint under ``path``, or None."""
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith("step_") and name.endswith(".pt"):
            try:
                steps.append((int(name[len("step_"):-len(".pt")]), name))
            except ValueError:
                continue
    if not steps:
        return None
    return os.path.join(path, max(steps)[1])


__all__ = ["latest_step_dir", "load_params", "restore_checkpoint", "save_checkpoint"]
