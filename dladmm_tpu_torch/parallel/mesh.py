"""The ('data', 'model') mesh on ``torch.distributed``.

The port of ``dladmm_tpu/parallel/mesh.py``. The JAX package lays its
devices out on a ('data', 'model') mesh; the port keeps the axis names
and the validation of ``make_mesh`` and holds the mesh in one of two
forms:

  * in a distributed run (``python -m torch.distributed.run``, one
    process a rank; parallel/multihost.initialize_distributed), every
    rank is one cell of the mesh: rank r sits at data index r // T and
    model index r % T (the JAX package's ``reshape(data, model)``, model
    innermost). ``Mesh.group`` is the world, ``model_group`` the T
    contiguous ranks of the rank's data index and ``data_group`` the D
    ranks of its model index (stride T); the ranks meet in collectives
    (parallel/collectives.py);
  * in one process, the data axis is a list of devices, one per data
    part, each part run by the same process: serving
    (serve.ShardedInferenceServer), which needs no collective. A list may
    name one card more than once (parts that share it). A model axis
    needs ranks, so a one-process mesh has model = 1.

``pick_backend`` is the one rule that picks the collective backend:
NCCL where every rank has a card of its own, gloo for CPU tensors and
for ranks that share a card (NCCL refuses two ranks on one device).

``shard_params_tp`` and ``gather_params_tp`` are the JAX package's
``param_shardings_tp``: a rank's slices of the parameters under a
tensor-parallel layout (parallel/collectives.param_specs: W1, theta1
and A split over n, W2 and theta2 over d in ``sharded_w2``), and the
whole leaves back from every rank's slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch
from torch import Tensor

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('data', 'model') mesh.

    shape: {DATA_AXIS: D, MODEL_AXIS: T}. devices: the devices of the
    cells this process runs (one per rank's process in a distributed run,
    D of them in one process, where T = 1). group: the process group of
    every rank (None in one process). rank: this process's rank.
    model_group: the T ranks of this rank's data index (None for T = 1);
    data_group: the D ranks of its model index (the world for T = 1, None
    for D = 1)."""

    shape: dict
    devices: Tuple[torch.device, ...]
    group: Any = None
    backend: Optional[str] = None
    rank: int = 0
    model_group: Any = None
    data_group: Any = None

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def data_index(self) -> int:
        return self.rank // self.shape[MODEL_AXIS]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape[MODEL_AXIS]


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


def _subgroups(D: int, T: int, rank: int):
    """(model_group, data_group) of ``rank`` on a D x T mesh. Every rank
    creates every subgroup, in the same order (torch.distributed.new_group
    is a collective over the world): the D model groups, then the T data
    groups."""
    import torch.distributed as dist

    if T == 1:
        return None, dist.group.WORLD
    model_groups = [dist.new_group([d * T + t for t in range(T)]) for d in range(D)]
    data_groups = [dist.new_group([d * T + t for d in range(D)]) for t in range(T)] if D > 1 else None
    return model_groups[rank // T], None if data_groups is None else data_groups[rank % T]


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence[torch.device]] = None, device=None) -> Mesh:
    """Build the ('data', 'model') mesh.

    In a distributed run the devices are the ranks (this process holds
    one: ``devices[0]``, else multihost.rank_device); ``data=None`` takes
    every rank over ``model``, and data * model must be the world size.
    In one process, ``devices`` are the data parts' devices (default:
    every visible card, or the CPU where ``device`` or DLADMM_PLATFORM asks
    for it; utils/platform.resolve_device), ``data`` the first so many of
    them, and model must be 1. Validation follows the JAX package's."""
    import torch.distributed as dist

    from dladmm_tpu_torch.parallel import multihost

    distributed = dist.is_available() and dist.is_initialized()
    if distributed:
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
    shape = {DATA_AXIS: data, MODEL_AXIS: model}
    if distributed:
        if data * model != n:
            raise ValueError(
                f"the mesh spans every rank: {data}x{model} but the run has {n} ranks; "
                f"launch it with --nproc_per_node={data * model}"
            )
        rank = dist.get_rank()
        model_group, data_group = _subgroups(data, model, rank)
        return Mesh(shape, local, dist.group.WORLD, dist.get_backend(), rank, model_group, data_group)
    if model != 1:
        raise ValueError(
            f"a {data}x{model} mesh needs {data * model} ranks in a process group, one process a rank "
            "(python -m torch.distributed.run); a one-process mesh has model=1"
        )
    return Mesh(shape, local[:data])


# -- tensor-parallel parameter slices ---------------------------------------------


def model_slice(v: Tensor, mesh: Mesh, dim: int = 1) -> Tensor:
    """This rank's contiguous model-axis slice of ``v`` along ``dim`` (a
    view)."""
    T = mesh.shape[MODEL_AXIS]
    if v.shape[dim] % T:
        raise ValueError(f"dimension {dim} of {tuple(v.shape)} does not split over model={T}")
    w = v.shape[dim] // T
    return v.narrow(dim, mesh.model_index * w, w)


def all_gather_model(v: Tensor, mesh: Mesh, dim: int = 1) -> Tensor:
    """Every model rank's ``v``, concatenated along ``dim`` in model order
    (a collective over the model group)."""
    import torch.distributed as dist

    T = mesh.shape[MODEL_AXIS]
    if T == 1:
        return v
    v = v.contiguous()
    parts = [torch.empty_like(v) for _ in range(T)]
    dist.all_gather(parts, v, group=mesh.model_group)
    return torch.cat(parts, dim=dim)


def shard_params_tp(params, mesh: Mesh, layout: str = "sharded_w2"):
    """This rank's slices of whole DLADMMParams under ``layout``: the
    leaves parallel/collectives.param_specs splits over the model axis
    sliced along dim 1 (copies), the replicated ones whole."""
    from dladmm_tpu_torch.parallel.collectives import param_specs

    return type(params)(*(model_slice(v, mesh).contiguous() if ax else v
                          for v, ax in zip(params, param_specs(layout))))


def gather_params_tp(params, mesh: Mesh, layout: str = "sharded_w2"):
    """The whole DLADMMParams from every model rank's slices (a collective
    over the model group; inverse of shard_params_tp)."""
    from dladmm_tpu_torch.parallel.collectives import param_specs

    return type(params)(*(all_gather_model(v, mesh) if ax else v
                          for v, ax in zip(params, param_specs(layout))))


__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "all_gather_model", "gather_params_tp", "make_mesh", "model_slice",
    "pick_backend", "shard_params_tp",
]
