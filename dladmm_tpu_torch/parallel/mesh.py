"""The data axis on ``torch.distributed``.

The port of ``dladmm_tpu/parallel/mesh.py``. The JAX package lays its
devices out on a ('data', 'model') mesh; the port keeps the axis names
and the validation of ``make_mesh`` and holds the data axis in one of
two forms:

  * in a distributed run (``python -m torch.distributed.run``, one
    process a rank; parallel/multihost.initialize_distributed), the data
    axis is the process group of every rank: each process holds one data
    part on its own device and the ranks meet in collectives
    (parallel/collectives.py);
  * in one process, the data axis is a list of devices, one per data
    part, each part run by the same process: serving
    (serve.ShardedInferenceServer), which needs no collective. A list may
    name one card more than once (parts that share it).

The model axis (tensor parallelism) is a later slice of the port
(ROADMAP.md §1): ``make_mesh`` validates ``model`` as the JAX package
does and refuses model > 1.

``pick_backend`` is the one rule that picks the collective backend:
NCCL where every rank has a card of its own, gloo for CPU tensors and
for ranks that share a card (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

_TP_LATER = (
    "tensor parallelism (model_axis > 1: the sharded_w2 and replicated_w2 "
    "layouts) is not ported yet; it is the next item of ROADMAP.md §1"
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('data', 'model') mesh with model = 1.

    shape: {DATA_AXIS: D, MODEL_AXIS: 1}. devices: the devices of the data
    parts this process runs (one per rank's process in a distributed run,
    D of them in one process). group: the data axis's process group, None
    in one process. rank: this process's index on the data axis."""

    shape: dict
    devices: Tuple[torch.device, ...]
    group: Any = None
    backend: Optional[str] = None
    rank: int = 0

    @property
    def distributed(self) -> bool:
        return self.group is not None


def pick_backend(device: torch.device, ranks_per_host: int, cards: int) -> Tuple[str, str]:
    """(backend, why) for ranks on ``device``'s type: NCCL where each of
    the host's ranks has its own card, gloo for CPU tensors and for ranks
    that share a card."""
    if device.type != "cuda":
        return "gloo", "CPU tensors"
    if cards >= ranks_per_host:
        return "nccl", f"{ranks_per_host} rank(s), each on its own card of {cards}"
    return "gloo", (f"{ranks_per_host} ranks share {cards} card(s); NCCL refuses "
                    "two ranks on one device")


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence[torch.device]] = None, device=None) -> Mesh:
    """Build the ('data', 'model') mesh.

    In a distributed run the devices are the ranks (this process holds
    one: ``devices[0]``, else multihost.rank_device); ``data=None`` takes
    every rank, and the data axis must span them all. In one process, ``devices`` are the data parts' devices
    (default: every visible card, or the CPU where ``device`` or
    DLADMM_PLATFORM asks for it; utils/platform.resolve_device), and
    ``data`` the first so many of them. Validation follows the JAX
    package's; model > 1 raises NotImplementedError."""
    import torch.distributed as dist

    from dladmm_tpu_torch.parallel import multihost

    if dist.is_available() and dist.is_initialized():
        n = dist.get_world_size()
        local = (torch.device(devices[0]),) if devices else (multihost.rank_device(device),)
    else:
        if devices is None:
            from dladmm_tpu_torch.utils.platform import resolve_device

            dev = resolve_device(device)
            devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                       if dev.type == "cuda" else [dev])
        local = tuple(torch.device(d) for d in devices)
        n = len(local)
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data < 1 or model < 1:
        raise ValueError(f"mesh {data}x{model}: both axes must be >= 1")
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} exceeds {n} devices")
    if model != 1:
        raise NotImplementedError(_TP_LATER)
    shape = {DATA_AXIS: data, MODEL_AXIS: model}
    if dist.is_available() and dist.is_initialized():
        if data != n:
            raise ValueError(
                f"the data axis spans every rank: data={data} but the run has {n} ranks; "
                f"launch it with --nproc_per_node={data}"
            )
        return Mesh(shape, local, dist.group.WORLD, dist.get_backend(), dist.get_rank())
    return Mesh(shape, local[:data])


__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh", "pick_backend"]
