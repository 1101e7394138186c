"""Starting the ranks of a sharded run, its mesh, and each rank's batch.

The port of ``dladmm_tpu/parallel/multihost.py``. A sharded run is one
process a rank, launched by

    python -m torch.distributed.run --standalone --nproc_per_node=D*T \\
        -m dladmm_tpu_torch.run --config=general_b_dp

(or across hosts with --nnodes and a rendezvous address), which sets
the ``env://`` variables. ``initialize_distributed`` reads them, picks
each rank's device and the backend (parallel/mesh.pick_backend) and
joins the process group; in a process that no launcher started it does
nothing. ``make_multihost_mesh`` keeps each model group on one host.
``host_local_batch`` draws this rank's rows of a step's global batch,
with no data moving between ranks.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from dladmm_tpu_torch.data.synthetic import SyntheticBatch, draw_batch, step_generator

_RANK_DEVICE: Optional[torch.device] = None


def initialize_distributed(device=None) -> Optional[torch.device]:
    """Join the process group described by the ``env://`` variables
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK,
    LOCAL_WORLD_SIZE, as torch.distributed.run sets them) and return this
    rank's device (rank_device). Prints the backend and why (rank 0).

    No-op, returning None, when no launcher set the variables; returns
    the rank's device when the group is already up."""
    import torch.distributed as dist

    global _RANK_DEVICE
    if dist.is_initialized():
        return rank_device(device)
    if "WORLD_SIZE" not in os.environ or "MASTER_ADDR" not in os.environ:
        return None
    from dladmm_tpu_torch.parallel.mesh import pick_backend

    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ.get("RANK", "0"))
    dev = rank_device(device)
    cards = 0
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        torch.cuda.set_device(dev)
    backend, why = pick_backend(dev, int(os.environ.get("LOCAL_WORLD_SIZE", world)), cards)
    dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank)
    _RANK_DEVICE = dev
    if rank == 0:
        print(f"torch.distributed: {world} rank(s), backend {backend} ({why}); rank 0 on {dev}", flush=True)
    return dev


def rank_device(device=None) -> torch.device:
    """This rank's device, whatever the backend: ``device`` or the one
    initialize_distributed gave the rank, else utils/platform.
    resolve_device (cuda unless the caller or DLADMM_PLATFORM asks for
    the CPU), with a bare ``cuda`` mapped to the card ``LOCAL_RANK %
    cards`` (a card a rank where the host has one, the cards shared
    otherwise)."""
    from dladmm_tpu_torch.utils.platform import resolve_device

    if device is None and _RANK_DEVICE is not None:
        return _RANK_DEVICE
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local_rank = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def ranks_per_card(device, local_world: Optional[int] = None) -> int:
    """How many of the host's ranks share ``device``'s card: the host's
    ranks (``local_world``, default LOCAL_WORLD_SIZE, else the world
    size) over its cards, rounded up; 1 on the CPU. fit_sharded audits
    each rank against its card's memory divided by this."""
    device = torch.device(device)
    if device.type != "cuda":
        return 1
    if local_world is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))
    return max(1, -(-local_world // torch.cuda.device_count()))


def world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def make_multihost_mesh(model: int = 1, device=None):
    """The ('data', 'model') mesh over every rank of the run, data
    outermost: model groups are T contiguous ranks, which the launcher
    places on one host (ranks are numbered host by host), so only the
    data group's gradient sum crosses hosts. T must divide the ranks of a
    host (LOCAL_WORLD_SIZE)."""
    from dladmm_tpu_torch.parallel.mesh import make_mesh

    n = world_size()
    if n % model:
        raise ValueError(f"{n} global ranks not divisible by model={model}")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if local % model:
        raise ValueError(f"model={model} does not divide the {local} ranks of a host: a model group would "
                         "span two hosts")
    return make_mesh(data=n // model, model=model, device=device)


def rank_batch(mesh, x_star, e_star, A_cols, B=None) -> SyntheticBatch:
    """This rank's batch from its rows of a draw (data/synthetic.
    draw_batch, on the CPU), on A_cols' device: x* cut to the rank's
    n-slice, and b = A x* + e* (+ B z* for a general B) from A_cols, the
    rank's columns of A. With model = 1 that is make_batch's product;
    under tensor parallelism b is the partial products x*_t A_t^T summed
    over the model group (one all-reduce), as the JAX package's GSPMD
    forms it with A split over its columns, and no rank holds the whole
    A."""
    from dladmm_tpu_torch.data.synthetic import _to_device
    from dladmm_tpu_torch.parallel.mesh import MODEL_AXIS, model_slice

    dev = A_cols.device
    x_star = _to_device(model_slice(x_star, mesh).contiguous(), dev)
    e_star = _to_device(e_star.contiguous(), dev)
    Ax = x_star @ A_cols.T
    if mesh.shape[MODEL_AXIS] > 1:
        import torch.distributed as dist

        dist.all_reduce(Ax, group=mesh.model_group)
    return SyntheticBatch(Ax + (e_star if B is None else e_star @ B.T), x_star, e_star)


def host_local_batch(seed: int, step: int, A_cols, global_batch: int, mesh, sparsity_x: float = 0.1,
                     sparsity_e: float = 0.1, dtype=torch.float32, B=None) -> SyntheticBatch:
    """This rank's part of step ``step``'s batch, on A_cols' device: its
    data index's global_batch / D rows, x* its n-slice (rank_batch; A_cols
    the rank's columns of A, the whole A where model = 1). Every data index
    draws only its own rows, and together they are a deterministic global
    batch: data index d of D draws from ``step_generator(seed, step, D,
    d)`` (the JAX package's ``fold_in(key, pid)``), a spawn key no
    single-device step or microbatch shares; the model ranks of one data
    index draw the same rows. B: the general z-dictionary, as make_batch
    takes it."""
    from dladmm_tpu_torch.parallel.mesh import MODEL_AXIS

    D, d = mesh.shape["data"], mesh.data_index
    if global_batch % D:
        raise ValueError(f"global_batch {global_batch} % {D} != 0")
    m, n = A_cols.shape[0], A_cols.shape[1] * mesh.shape[MODEL_AXIS]
    x_star, e_star = draw_batch(step_generator(seed, step, D, d), m, n, global_batch // D, sparsity_x, sparsity_e,
                                dtype, None if B is None else B.shape[1])
    return rank_batch(mesh, x_star, e_star, A_cols, B)


def spawn_ranks(argv, world: int, timeout: float = 600.0, env=None, cwd=None) -> list:
    """Run ``argv`` (a command, e.g. [sys.executable, "-m", module, ...])
    as ``world`` ranks on this host, one process each, with the env://
    variables python -m torch.distributed.run sets, and wait for all;
    returns each rank's output (stdout and stderr together), in rank
    order.

    The rendezvous store is a TCPStore this process holds, on a port the
    OS picked and that stays bound until the ranks end; every rank joins
    it as a client (TORCHELASTIC_USE_AGENT_STORE, as under
    torch.distributed.run's agent), so no other process can take the port
    between its choice and the ranks' start. A spawn that has not ended
    within ``timeout`` seconds is killed and raises TimeoutError; a rank
    that exits non-zero raises RuntimeError with the ranks' output. Every
    rank is killed and waited for before this returns or raises.
    ``env``: variables added to this process's for every rank (e.g.
    DLADMM_PLATFORM=cpu)."""
    import subprocess
    import time

    import torch.distributed as dist

    store = dist.TCPStore("localhost", 0, is_master=True, wait_for_workers=False)
    procs = []
    try:
        for r in range(world):
            rank_env = dict(os.environ, **(env or {}), MASTER_ADDR="localhost", MASTER_PORT=str(store.port),
                            TORCHELASTIC_USE_AGENT_STORE="True", WORLD_SIZE=str(world), RANK=str(r),
                            LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world))
            rank_env.setdefault("OMP_NUM_THREADS", "1")
            procs.append(subprocess.Popen(list(argv), env=rank_env, cwd=cwd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"{world} ranks of {argv} did not end within {timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        del store
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"{world} ranks of {argv}: exit codes {[p.returncode for p in procs]}\n"
                           + "\n".join(f"-- rank {r} --\n{log[-4000:]}" for r, log in enumerate(logs)))
    return logs


__all__ = [
    "host_local_batch",
    "initialize_distributed",
    "make_multihost_mesh",
    "process_index",
    "rank_batch",
    "rank_device",
    "ranks_per_card",
    "spawn_ranks",
    "world_size",
]
