"""Data- and tensor-parallel training steps and evaluation on
``torch.distributed``.

The port of ``dladmm_tpu/parallel/collectives.py``.

Data parallelism (model_axis = 1): each rank holds the whole model and
its optimizer (ZeRO-1 aside) and one batch shard of global_batch / D
rows, and runs the port's single-device stack on it:
``train/loop.loss_fn`` through the forward the policy selected at the
per-rank batch (models/api.select_forward: the trajectory kernel, with
the backward kernel for the final-layer loss, on the card) or the fused
step's body (train/fused_adam). The collectives are explicit:

  * ``make_dp_train_step``: one all-reduce (SUM, then / D) of the loss
    and every gradient, packed in one fp32 buffer; then every rank
    applies the same update (the fused CUDA sweep for ``*_pallas``
    moments);
  * ``make_dp_fused_adam_step``: one all-reduce of each layer's five
    gradients inside the reverse sweep, as the sweep produces them;
  * ``make_dp_zero1_train_step`` (ZeRO-1): a reduce-scatter of the flat
    gradient gives each rank the summed gradients of its 1/D slice; the
    exact global clip is one all-reduce of the slices' squares; each rank
    updates its slice against its moment shard (the fused CUDA sweep on a
    (rows, 256) view for ``*_pallas`` moments, else the optimizer chain)
    and an all-gather rebuilds the parameters;
  * ``make_dp_eval``: local sums, one all-reduce.

Tensor parallelism (model_axis = T > 1, B = I, two layouts,
``param_specs``): ``sharded_w2`` splits W1, theta1 and A's columns over
n and W2, theta2 over m, so every weight and moment is 1/T a rank;
``replicated_w2`` keeps W2 and theta2 whole (the z-side product runs on
every rank; one collective a layer). Per layer (``_tp_layer_step``):

    u    = Ax + (z - b + lam / beta)              whole on every rank
    x1_t = shrink(x_t - u @ W1_t^T, theta1_t)     local
    Ax1  = sum over the model ranks of x1_t @ A_t^T
    v    = Ax1 + (z - b + lam / beta)
    z1_t = shrink(z_t - v @ W2_t^T, theta2_t)     local; z1 = gather(z1_t)
    lam1 = lam + beta (Ax1 + z1 - b)

JAX's shard_map derives the backward's collectives from its replication
types; here they are three autograd Functions (Megatron's operators):
``_CopyToModel`` (a whole value entering rank-local work: identity,
backward all-reduce), ``_ReduceFromModel`` (all-reduce, identity
backward) and ``_GatherFromModel`` (all-gather, backward this rank's
block). The loss is the same on every rank, so replicated leaves get
their whole gradient on every model rank, and the data group sums the
gradients. ``sharded_forward``, ``make_sharded_eval`` (gather-free) and
``make_sharded_train_step`` (final-layer loss, deep supervision, bf16 on
a sharded compute copy, freeze; the optimizer layer by layer in place,
its clip on the whole gradient's norm) are the JAX package's; there is
no kernel on this path (the JAX package's TP products are XLA dots).

The mean of D half-batch means is the global mean up to the order of
summation: tests/test_torch_distributed.py and tests/test_torch_tp.py
hold the steps to the single-process global-batch step and to the JAX
package at its tolerances.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import torch
from torch import Tensor

from dladmm_tpu_torch.models.unroll import DLADMMParams
from dladmm_tpu_torch.ops.reference import _BETA_MIN, shrink
from dladmm_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    all_gather_model,
    gather_params_tp,
    model_slice,
    shard_params_tp,
)
from dladmm_tpu_torch.train.loop import _eval_trajectory, map_params_nodes, update_by_layer
from dladmm_tpu_torch.train.qmoments import BLOCK, QTensor
from dladmm_tpu_torch.utils import profiling

_EPS = 1e-12


def _dist():
    import torch.distributed as dist

    return dist


def _check_mesh(mesh) -> int:
    """D of a mesh the training steps can run on: its ranks in a process
    group, or one data part in one process."""
    D = mesh.shape[DATA_AXIS]
    if D > 1 and not mesh.distributed:
        raise ValueError(
            f"a data-parallel step over {D} parts needs {D} ranks in a process group "
            "(parallel/multihost.initialize_distributed); a one-process mesh serves only"
        )
    return D


def _all_reduce_mean(mesh, buf: Tensor) -> Tensor:
    """SUM over the data ranks, then / D (in place on ``buf``)."""
    if mesh.distributed:
        _dist().all_reduce(buf, group=mesh.group)
    return buf.div_(mesh.shape[DATA_AXIS])


def _flat(tensors) -> Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: Tensor, like) -> list:
    out, off = [], 0
    for t in like:
        out.append(flat[off: off + t.numel()].reshape(t.shape))
        off += t.numel()
    return out


# -- evaluation ---------------------------------------------------------------


def make_dp_eval(mesh, B: Optional[Tensor] = None, use_kernel: bool = True):
    """(params, A, local batch) -> metrics dict (nmse_db, nmse_db_z,
    residual, nmse_curve_db), the exact metrics.core values of the global
    batch: each rank sums its samples' NMSE ratios (degenerate supports
    left out), valid counts and relative residuals, and one all-reduce
    adds the ranks' sums. The net runs through the trajectory the policy
    selects for B = I (train/loop._eval_trajectory: the trajectory kernel,
    its plain version on CPU tensors; use_kernel=False: the plain loop),
    through the plain loop for a general B."""
    from dladmm_tpu_torch.models.unroll import dladmm_forward

    @torch.no_grad()
    def evaluate(params: DLADMMParams, A: Tensor, batch):
        b, x_star, z_star = batch
        traj = _eval_trajectory(A, b, B, use_kernel)
        if traj is not None:
            tx, tz, _ = traj(params, A, b)
        else:
            _, (tx, tz, _) = dladmm_forward(params, A, b, B=B, capture_trajectory=True)
        f32 = lambda v: v.to(torch.float32)  # noqa: E731
        x, z = tx[-1], tz[-1]
        num_x = torch.sum((f32(tx) - f32(x_star)) ** 2, dim=-1)  # (K, S)
        den_x = torch.sum(f32(x_star) ** 2, dim=-1)
        valid = den_x > _EPS
        ratio = torch.where(valid, num_x / torch.clamp(den_x, min=_EPS), torch.zeros_like(num_x))
        num_z = torch.sum((f32(z) - f32(z_star)) ** 2, dim=-1)
        den_z = torch.sum(f32(z_star) ** 2, dim=-1)
        valid_z = den_z > _EPS
        ratio_z = torch.where(valid_z, num_z / torch.clamp(den_z, min=_EPS), torch.zeros_like(num_z))
        Bz = f32(z) if B is None else f32(z) @ f32(B).T
        r = torch.linalg.vector_norm(f32(x) @ f32(A).T + Bz - f32(b), dim=-1)
        rel = r / torch.clamp(torch.linalg.vector_norm(f32(b), dim=-1), min=_EPS)
        sums = torch.cat([
            torch.sum(ratio, dim=-1),
            torch.stack([torch.sum(valid).to(torch.float32), torch.sum(ratio_z),
                         torch.sum(valid_z).to(torch.float32), torch.sum(rel),
                         torch.tensor(float(b.shape[0]), device=b.device)]),
        ]).to(torch.float64)
        if mesh.distributed:
            _dist().all_reduce(sums, group=mesh.group)
        return _metrics(sums, tx.shape[0])

    return evaluate


def _metrics(sums: Tensor, K: int) -> dict:
    """The metrics dict from the mesh's summed (float64) per-layer NMSE
    ratios (K), valid count, z ratios, valid z count, relative residuals
    and sample count: metrics.core's batch means."""
    sum_ratio, (n_valid, sum_rz, n_valid_z, sum_rel, S_total) = sums[:K], sums[K:]

    def db(total, count):
        return (10.0 * torch.log10(total / torch.clamp(count, min=1) + _EPS)
                if count > 0 else torch.full_like(total, float("nan")))

    curve = db(sum_ratio, n_valid).to(torch.float32)
    return {
        "nmse_db": float(curve[-1]),
        "nmse_db_z": float(db(sum_rz, n_valid_z)),
        "residual": float(sum_rel / S_total),
        "nmse_curve_db": [float(v) for v in curve],
    }


# -- the replicated-optimizer step ----------------------------------------------


def _mixed_precision_inputs(state, batch, compute_dtype):
    """(loss params, observations): the persistent compute copy and the
    cast batch under mixed precision, the fp32 masters otherwise."""
    if compute_dtype is not None:
        return state.compute_params, batch.b.to(compute_dtype)
    return state.params, batch.b


def _apply_update(state, loss, grads, optimizer, compute_dtype, freeze):
    """The steps' optimizer tail: the (possibly bf16) gradients cast to
    the fp32 masters' type, then the loop's update (train/loop._apply:
    frozen fields zeroed, the fused sweep or the chain, the compute copy
    rewritten)."""
    from dladmm_tpu_torch.train.loop import _apply

    grads = DLADMMParams(*(g.to(p.dtype) for g, p in zip(grads, state.params)))
    return _apply(optimizer, state, grads, freeze, compute_dtype), loss


def _local_value_and_grad(params, A, b, x_star, e_star, B, layer_weights, step_fn, forward_fn, vjp):
    """The single-device loss (train/loop.loss_fn) of the rank's batch
    shard and its gradients."""
    from dladmm_tpu_torch.train.loop import _value_and_grad

    return _value_and_grad(params, (A, b, x_star, e_star, B, layer_weights),
                           dict(step_fn=step_fn, forward_fn=forward_fn, vjp=vjp))


def make_dp_train_step(
    optimizer,
    mesh,
    compute_dtype=None,
    freeze: tuple = (),
    layer_weights=None,
    step_fn=None,
    forward_fn=None,
    vjp: str = "auto",
    B=None,
):
    """Data-parallel step (model_axis == 1): (state, A, local batch) ->
    (state, loss). Each rank runs train/loop.loss_fn on its batch shard
    (through ``forward_fn``, the policy's kernels at the per-rank batch,
    or the manual backward), then ONE all-reduce of the loss and every
    gradient in an fp32 buffer (SUM / D: the global batch's mean loss and
    gradients), then the same optimizer update on every rank. A and B
    arrive in the compute type; B is the general z-dictionary or None."""
    _check_mesh(mesh)

    def step(state, A, batch):
        loss_params, b = _mixed_precision_inputs(state, batch, compute_dtype)
        loss, grads = _local_value_and_grad(loss_params, A, b, batch.x_star, batch.e_star, B,
                                            layer_weights, step_fn, forward_fn, vjp)
        buf = _all_reduce_mean(mesh, torch.cat([loss.reshape(1).to(torch.float32),
                                                _flat(g.to(torch.float32) for g in grads)]))
        loss = buf[0]
        grads = DLADMMParams(*(g.to(gl.dtype) for g, gl in zip(_unflat(buf[1:], grads), grads)))
        return _apply_update(state, loss, grads, optimizer, compute_dtype, freeze)

    return step


def make_dp_fused_adam_step(
    mesh,
    layer_weights=None,
    lr=1e-3,
    clip_norm=None,
    compute_dtype=None,
    freeze: tuple = (),
    B=None,
):
    """Data-parallel fused-Adam step: (state, A, local batch) -> (state,
    loss), the state from train/fused_adam.make_fused_adam_state. Each
    rank runs the single-device fused body (train/fused_adam.
    make_fused_update_core) on its shard, and each layer's five
    gradients are all-reduced (SUM / D, one buffer a layer) inside the
    reverse sweep, before that layer's update; the loss likewise. A and
    B (the general z-dictionary, or None for B = I) arrive in the compute
    type."""
    from dladmm_tpu_torch.train.fused_adam import apply_fused, make_fused_update_core

    _check_mesh(mesh)

    def grad_reduce(gs):
        buf = _all_reduce_mean(mesh, _flat(g.to(torch.float32) for g in gs))
        return [g.to(gl.dtype) for g, gl in zip(_unflat(buf, gs), gs)]

    def loss_reduce(loss):
        return _all_reduce_mean(mesh, loss.reshape(1).to(torch.float32).clone())[0]

    core = make_fused_update_core(layer_weights, lr, clip_norm=clip_norm, compute_dtype=compute_dtype,
                                  freeze=freeze, grad_reduce=grad_reduce, loss_reduce=loss_reduce, B=B)

    def step(state, A, batch):
        return apply_fused(core, state, A, batch, compute_dtype)

    return step


# -- ZeRO-1 --------------------------------------------------------------------


class Flat(NamedTuple):
    """The one leaf of a ZeRO-1 optimizer state: this rank's slice of the
    flat parameter vector ((L,), or (rows, 256) for the fused sweep)."""

    v: Tensor


def _zero1_block_align(optimizer) -> bool:
    """True when the (non-fused) optimizer's flat state holds QTensor
    leaves (moment_dtype='int8'), whose (nblocks, 256) codes need the
    padded vector to be a multiple of D * BLOCK so that no block straddles
    two ranks' slices."""
    probe = optimizer.init(Flat(torch.zeros((BLOCK,), dtype=torch.float32)))
    return any(isinstance(leaf, QTensor) for leaf in _leaves(probe, keep_q=True))


def _zero1_padded(total: int, D: int, fused: bool, block_align: bool = False) -> int:
    """The flat vector's padded length: a multiple of D (of D * BLOCK with
    int8 QTensor moments); for the fused sweep D slices of (rows, BLOCK)
    with rows a multiple of 128 and >= 256, so that the view takes the
    per-row int8 codec (train/qadam_cuda.leaf_eligible). The JAX
    package's lengths, so the states have its shapes."""
    if not fused:
        unit = D * BLOCK if block_align else D
        return -(-total // unit) * unit
    per_shard_rows = -(-total // (BLOCK * D))
    rows = max(256, -(-per_shard_rows // 128) * 128)
    return D * rows * BLOCK


def _leaves(tree, keep_q: bool = False):
    if isinstance(tree, Tensor):
        yield tree
    elif isinstance(tree, QTensor) and keep_q:
        yield tree
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v, keep_q)


def _tree_map(fn, tree):
    if isinstance(tree, Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


class Zero1Layout(NamedTuple):
    """Where a rank's slice sits: total params, padded length, D, and
    which leading lengths mark a state leaf as sliced over the ranks."""

    total: int
    padded: int
    D: int
    fused: bool

    @property
    def shard(self) -> int:
        return self.padded // self.D

    def sliced(self, v: Tensor, whole: bool) -> Optional[int]:
        """The leading length of leaf ``v`` on one rank if the leaf is
        sliced over the ranks (moments, int8 codes and scales), else None
        (the count, the SR key: 0-d)."""
        n = self.padded if whole else self.shard
        lengths = (n // BLOCK,) if self.fused else (n, n // BLOCK)
        if v.ndim >= 1 and v.shape[0] in lengths:
            return v.shape[0] // (self.D if whole else 1)
        return None


def zero1_layout(params: DLADMMParams, optimizer, D: int) -> Zero1Layout:
    fused = hasattr(optimizer, "fused_apply")
    block_align = False if fused else _zero1_block_align(optimizer)
    total = sum(p.numel() for p in params)
    return Zero1Layout(total, _zero1_padded(total, D, fused, block_align), D, fused)


def zero1_global_state(optimizer, layout: Zero1Layout, device):
    """A fresh optimizer state over the WHOLE padded vector (the JAX
    package's global state; what a checkpoint holds)."""
    shape = (layout.padded // BLOCK, BLOCK) if layout.fused else (layout.padded,)
    return optimizer.init(Flat(torch.zeros(shape, dtype=torch.float32, device=device)))


def zero1_slice(opt_global, layout: Zero1Layout, rank: int):
    """This rank's slice of a whole-vector optimizer state."""
    def cut(v):
        n = layout.sliced(v, whole=True)
        return v if n is None else v[rank * n: (rank + 1) * n].clone()

    return _tree_map(cut, opt_global)


def zero1_gather(opt_shard, layout: Zero1Layout, mesh):
    """Every rank's slices, all-gathered into the whole-vector state (a
    collective: every rank calls it)."""
    def gather(v):
        n = layout.sliced(v, whole=False)
        if n is None or not mesh.distributed:
            return v.clone()
        out = torch.empty((layout.D * n, *v.shape[1:]), dtype=v.dtype, device=v.device)
        _dist().all_gather_into_tensor(out, v.contiguous(), group=mesh.group)
        return out

    return _tree_map(gather, opt_shard)


def make_dp_zero1_state(params: DLADMMParams, optimizer, mesh, compute_dtype=None):
    """TrainState for the ZeRO-1 step: the params whole on every rank, the
    optimizer state over this rank's slice of the flat padded vector
    (Flat leaves: (L,) for the chain, (rows, 256) for the fused sweep),
    each rank 1/D of the moments."""
    from dladmm_tpu_torch.train.loop import TrainState, _cast

    layout = zero1_layout(params, optimizer, mesh.shape[DATA_AXIS])
    opt = zero1_slice(zero1_global_state(optimizer, layout, params[0].device), layout, mesh.rank)
    params = DLADMMParams(*(p.detach().clone().contiguous() for p in params))
    cp = None if compute_dtype is None else _cast(params, compute_dtype)
    return TrainState(params, opt, 0, cp)


def make_dp_zero1_train_step(
    optimizer,
    mesh,
    clip_norm=None,
    compute_dtype=None,
    freeze: tuple = (),
    layer_weights=None,
    step_fn=None,
    forward_fn=None,
    vjp: str = "auto",
    B=None,
):
    """Data-parallel step with the weight update split over the ranks
    (ZeRO-1): (state, A, local batch) -> (state, loss).

    The local loss and gradients as in make_dp_train_step; the fp32
    gradients flattened and padded, then reduce-scattered (SUM / D): each
    rank receives the global gradient of its slice. ``clip_norm`` is the
    EXACT global-norm clip, from one all-reduce of the slices' sums of
    squares. The rank updates its slice of the masters against its moment
    slice (the fused sweep on the (rows, 256) view for an optimizer with
    ``fused_apply``, built without a clip of its own; else the chain, built
    without a clip transform), and an all-gather rebuilds the params."""
    D = _check_mesh(mesh)
    fused = hasattr(optimizer, "fused_apply")
    if fused and getattr(optimizer, "clip_norm", None):
        raise ValueError(
            "ZeRO-1 owns the global-norm clip; build the fused optimizer with "
            "clip_norm=None and pass clip_norm to make_dp_zero1_train_step"
        )
    dist = _dist()

    def step(state, A, batch):
        from dladmm_tpu_torch.train.loop import TrainState, _cast

        masters = state.params
        layout = zero1_layout(masters, optimizer, D)
        loss_params, b = _mixed_precision_inputs(state, batch, compute_dtype)
        loss, g = _local_value_and_grad(loss_params, A, b, batch.x_star, batch.e_star, B,
                                        layer_weights, step_fn, forward_fn, vjp)
        loss = _all_reduce_mean(mesh, loss.reshape(1).to(torch.float32).clone())[0]
        g = [gv.to(pv.dtype) for gv, pv in zip(g, masters)]
        if freeze:
            g = [torch.zeros_like(gv) if name in freeze else gv for name, gv in zip(DLADMMParams._fields, g)]
        pad = layout.padded - layout.total
        flat_g = torch.nn.functional.pad(_flat(g), (0, pad))
        flat_p = torch.nn.functional.pad(_flat(masters), (0, pad))
        L = layout.shard
        if mesh.distributed:
            g_shard = torch.empty(L, dtype=flat_g.dtype, device=flat_g.device)
            dist.reduce_scatter_tensor(g_shard, flat_g, group=mesh.group)
        else:
            g_shard = flat_g.clone()
        g_shard.div_(D)
        if clip_norm:
            sq = torch.sum(g_shard * g_shard).reshape(1)
            if mesh.distributed:
                dist.all_reduce(sq, group=mesh.group)
            gn = torch.sqrt(sq[0])
            g_shard = g_shard * torch.clamp(clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
        p_shard = flat_p[mesh.rank * L: (mesh.rank + 1) * L]
        with torch.no_grad():
            if fused:
                rows = L // BLOCK
                new_p2, new_opt, _ = optimizer.fused_apply(
                    Flat(g_shard.reshape(rows, BLOCK)), state.opt_state, Flat(p_shard.reshape(rows, BLOCK)), None)
                new_shard = new_p2.v.reshape(-1)
            else:
                updates, new_opt = optimizer.update(Flat(g_shard), state.opt_state, Flat(p_shard))
                new_shard = p_shard + updates.v
        if mesh.distributed:
            flat_new = torch.empty(layout.padded, dtype=new_shard.dtype, device=new_shard.device)
            dist.all_gather_into_tensor(flat_new, new_shard.contiguous(), group=mesh.group)
        else:
            flat_new = new_shard
        params = DLADMMParams(*(t.contiguous() for t in _unflat(flat_new[: layout.total], masters)))
        cp = None if compute_dtype is None else _cast(params, compute_dtype)
        return TrainState(params, new_opt, state.step + 1, cp), loss

    return step


# -- tensor parallelism (model_axis > 1) -----------------------------------------

LAYOUTS = ("sharded_w2", "replicated_w2")


def param_specs(layout: str = "sharded_w2") -> DLADMMParams:
    """The mesh axis each leaf's dim 1 is split over, or None where the
    leaf is whole on every model rank (the JAX package's param_specs):
    W1 (K, n, m) and theta1 (K, n) over n; W2 (K, d, m) and theta2 (K, d)
    over d in ``sharded_w2``, whole in ``replicated_w2``; beta whole. The
    dictionary A (m, n) is split over its columns (mesh.model_slice)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    w2 = MODEL_AXIS if layout == "sharded_w2" else None
    return DLADMMParams(W1=MODEL_AXIS, W2=w2, theta1=MODEL_AXIS, theta2=w2, beta=None)


class CollectiveTimer:
    """Host seconds spent in the tensor-parallel collectives, and their
    count. Each collective is timed between two device synchronisations,
    so its time holds the transfer and the wait for the other ranks, not
    the compute queued before it."""

    def __init__(self):
        self.seconds, self.calls = 0.0, 0

    def run(self, device: torch.device, fn):
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda d: None)
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out


@dataclasses.dataclass(frozen=True)
class _TP:
    """The model axis's collectives of one mesh (and an optional timer)."""

    mesh: Mesh
    timer: Optional[CollectiveTimer] = None

    def _run(self, v: Tensor, fn):
        return fn() if self.timer is None else self.timer.run(v.device, fn)

    def reduce(self, v: Tensor, group) -> Tensor:
        """SUM of ``v`` over ``group`` (None: one rank) into a new tensor.
        bf16 is summed in fp32 and rounded once (the same on every
        backend)."""
        buf = v.to(torch.float32, copy=True)
        if group is not None:
            self._run(v, lambda: _dist().all_reduce(buf, group=group))
        return buf.to(v.dtype)

    def gather(self, v: Tensor) -> Tensor:
        return self._run(v, lambda: all_gather_model(v, self.mesh))


class _CopyToModel(torch.autograd.Function):
    """A model-replicated value entering rank-local work: identity
    forward; the backward sums the ranks' cotangents over the model
    group."""

    @staticmethod
    def forward(ctx, v, tp):
        ctx.tp = tp
        return v.view_as(v)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.reduce(g, ctx.tp.mesh.model_group), None


class _ReduceFromModel(torch.autograd.Function):
    """The model ranks' partial sums added (all-reduce SUM); identity
    backward, since every rank holds the sum's whole cotangent."""

    @staticmethod
    def forward(ctx, v, tp):
        return tp.reduce(v, tp.mesh.model_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The ranks' column blocks gathered along dim 1; the backward keeps
    this rank's block of the (whole, replicated) cotangent."""

    @staticmethod
    def forward(ctx, v, tp):
        ctx.tp = tp
        return tp.gather(v)

    @staticmethod
    def backward(ctx, g):
        return model_slice(g, ctx.tp.mesh).contiguous(), None


def _tp_layer_step(tp: _TP, A_t, b, x_t, z, lam, Ax, p, layout: str):
    """One l1/l1 D-LADMM layer (B = I) on this rank's shards. Names ending
    in _t are this rank's model slice; the rest are whole on every model
    rank (and this data index's rows)."""
    W1, W2, theta1, theta2, beta = p
    beta = torch.maximum(beta, beta.new_tensor(_BETA_MIN))
    base = z - b + lam / beta
    u = Ax + base
    x1_t = shrink(x_t - _CopyToModel.apply(u, tp) @ W1.T, theta1)
    Ax1 = _ReduceFromModel.apply(x1_t @ A_t.T, tp)
    v = Ax1 + base
    if layout == "sharded_w2":
        z_t = model_slice(_CopyToModel.apply(z, tp), tp.mesh)
        z1_t = shrink(z_t - _CopyToModel.apply(v, tp) @ W2.T, theta2)
        z1 = _GatherFromModel.apply(z1_t, tp)
    else:
        z1 = shrink(z - v @ W2.T, theta2)
    lam1 = lam + beta * (Ax1 + z1 - b)
    return x1_t, z1, lam1, Ax1


def _layers(params):
    """The K per-layer (W1, W2, theta1, theta2, beta) of stacked params."""
    return [tuple(v[k] for v in params) for k in range(params[0].shape[0])]


def _tp_forward_local(tp: _TP, layers, A_t, b, layout: str = "sharded_w2", x_star_t=None, e_star=None,
                      capture: bool = False):
    """The unroll from zero state on this rank's shards: (x_t, z, lam, ys).
    ys is empty unless ``capture``: then, per layer, this rank's (S,)
    squared errors (num_x over its n-slice: sum over the model ranks to
    globalize; num_z over the whole m). Nothing (K, S, n) is kept."""
    S, m = b.shape
    x = b.new_zeros((S, A_t.shape[1]))
    z, lam, Ax = (b.new_zeros((S, m)) for _ in range(3))
    ys = []
    for p in layers:
        x, z, lam, Ax = _tp_layer_step(tp, A_t, b, x, z, lam, Ax, p, layout)
        if capture:
            ys.append((torch.sum((x.float() - x_star_t) ** 2, dim=-1), torch.sum((z.float() - e_star) ** 2, dim=-1)))
    return x, z, lam, ys


def _check_tp(mesh) -> None:
    if mesh.shape[MODEL_AXIS] > 1 and not mesh.distributed:
        raise ValueError("a tensor-parallel mesh needs its ranks in a process group")


def init_params_tp(A: Tensor, K: int, mesh, layout: str = "sharded_w2", beta: float = 1.0,
                   dtype=torch.float32) -> DLADMMParams:
    """This rank's slices of the LADMM-exact init (models/unroll.
    init_dladmm_params, B = I), built from its own columns of A without
    the whole W1 or W2: L_A is computed once, on rank 0, and broadcast."""
    from dladmm_tpu_torch.models.unroll import spectral_norm_sq

    if mesh.rank == 0:
        L_A = spectral_norm_sq(A).to(dtype).reshape(1)
    else:
        L_A = torch.empty((1,), dtype=dtype, device=A.device)
    if mesh.distributed:
        _dist().broadcast(L_A, src=0, group=mesh.group)
    L_A = L_A[0]
    m = A.shape[0]
    kw = dict(dtype=dtype, device=A.device)
    A_t = model_slice(A, mesh)
    eye = torch.eye(m, **kw)
    W2_0 = model_slice(eye.T, mesh).T if layout == "sharded_w2" else eye  # rows of I / L_B, L_B = 1
    W2_0 = W2_0 / torch.ones((), **kw)

    def tile(a):
        return a.expand((K,) + a.shape).contiguous()

    return DLADMMParams(
        W1=tile((A_t.T / L_A).to(dtype)),
        W2=tile(W2_0),
        theta1=tile(torch.ones((A_t.shape[1],), **kw) * (1.0 / (beta * L_A))),
        theta2=tile(torch.ones((W2_0.shape[0],), **kw) * (1.0 / (beta * torch.ones((), **kw)))),
        beta=torch.full((K,), beta, **kw),
    )


def sharded_forward(mesh, params: DLADMMParams, A_t: Tensor, b: Tensor, layout: str = "sharded_w2"):
    """Tensor-parallel inference on this rank's shards: (x, z, lam) as
    this rank's blocks of the global arrays: x (rows of its data index,
    its n-slice); z and lam the same rows and, in ``sharded_w2``, its
    m-slice (whole in ``replicated_w2``), as the JAX package's out specs.
    gather_blocks assembles the global arrays."""
    _check_tp(mesh)
    tp = _TP(mesh)
    with torch.no_grad():
        x, z, lam, _ = _tp_forward_local(tp, _layers(params), A_t, b, layout)
    if layout == "sharded_w2":
        return x, model_slice(z, mesh).contiguous(), model_slice(lam, mesh).contiguous()
    return x, z, lam


def gather_blocks(mesh, v: Tensor, split_over_model: bool = True) -> Tensor:
    """The global array from every rank's block (a collective over every
    rank): rows by data index and, where ``split_over_model``, columns by
    model index (else each model rank's block is whole and rank (d, 0)'s
    is taken)."""
    D, T = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    if not mesh.distributed:
        return v
    v = v.contiguous()
    parts = [torch.empty_like(v) for _ in range(D * T)]
    _dist().all_gather(parts, v, group=mesh.group)
    rows = [torch.cat(parts[d * T:(d + 1) * T], dim=1) if split_over_model else parts[d * T] for d in range(D)]
    return torch.cat(rows, dim=0)


def make_sharded_eval(mesh, layout: str = "sharded_w2"):
    """(params, A_t, local batch) -> the metrics dict of make_dp_eval
    (nmse_db, nmse_db_z, residual, nmse_curve_db) for a tensor-parallel
    mesh, with nothing gathered: each layer's squared errors of this
    rank's n-slice, its x* norms and its partial A x are summed over the
    model group (one all-reduce); then model rank 0's per-sample sums
    alone enter one all-reduce over every rank, so the z-side sums (each
    model rank holds the same whole z) count once, exactly for any T.
    The local batch is this data index's rows, x* its n-slice."""
    _check_tp(mesh)
    tp = _TP(mesh)

    @torch.no_grad()
    def evaluate(params: DLADMMParams, A_t: Tensor, batch):
        b, x_star_t, e_star = batch
        f32 = lambda v: v.to(torch.float32)  # noqa: E731
        x_t, z, _, ys = _tp_forward_local(tp, _layers(params), A_t, b, layout, f32(x_star_t), f32(e_star),
                                          capture=True)
        num_x = torch.stack([y[0] for y in ys])  # (K, S)
        K, S = num_x.shape
        part = torch.cat([num_x.reshape(-1), torch.sum(f32(x_star_t) ** 2, dim=-1),
                          f32(x_t @ A_t.T).reshape(-1)])
        part = tp.reduce(part, mesh.model_group)
        num_x, den_x, Ax = part[:K * S].reshape(K, S), part[K * S:(K + 1) * S], part[(K + 1) * S:].reshape(S, -1)
        valid = den_x > _EPS
        ratio = torch.where(valid, num_x / torch.clamp(den_x, min=_EPS), torch.zeros_like(num_x))
        den_z = torch.sum(f32(e_star) ** 2, dim=-1)
        valid_z = den_z > _EPS
        ratio_z = torch.where(valid_z, ys[-1][1] / torch.clamp(den_z, min=_EPS), torch.zeros_like(den_z))
        r = torch.linalg.vector_norm(Ax + f32(z) - f32(b), dim=-1)
        rel = r / torch.clamp(torch.linalg.vector_norm(f32(b), dim=-1), min=_EPS)
        sums = torch.cat([
            torch.sum(ratio, dim=-1),
            torch.stack([torch.sum(valid).to(torch.float32), torch.sum(ratio_z),
                         torch.sum(valid_z).to(torch.float32), torch.sum(rel),
                         torch.tensor(float(S), device=b.device)]),
        ]).to(torch.float64)
        if mesh.model_index != 0:
            sums.zero_()
        if mesh.distributed:
            _dist().all_reduce(sums, group=mesh.group)
        return _metrics(sums, K)

    return evaluate


def gather_state_tp(state, mesh, layout: str = "sharded_w2"):
    """A TP TrainState with every parameter-shaped leaf (params, moments)
    gathered whole (a collective over the model group; ranks of data
    index 0 only need to call it: the other data indices hold the same
    slices). What a checkpoint holds."""
    gather = lambda node: gather_params_tp(node, mesh, layout)  # noqa: E731
    return state._replace(params=gather(state.params), opt_state=map_params_nodes(gather, state.opt_state),
                          compute_params=None)


def shard_state_tp(state, mesh, layout: str = "sharded_w2", device=None):
    """This rank's slices of a whole TrainState (inverse of
    gather_state_tp), on ``device``."""
    def cut(node):
        return DLADMMParams(*(v.to(device) for v in shard_params_tp(node, mesh, layout)))

    opt = map_params_nodes(cut, state.opt_state)
    opt = _tree_map(lambda v: v.to(device), opt)
    return state._replace(params=cut(state.params), opt_state=opt)


def whole_state_template(state, mesh, layout: str = "sharded_w2"):
    """CPU tensors of the whole shapes of a TP TrainState's leaves (a
    checkpoint's template)."""
    T = mesh.shape[MODEL_AXIS]

    def whole(node):
        return DLADMMParams(*(torch.empty((v.shape[0], v.shape[1] * T, *v.shape[2:]) if ax else v.shape,
                                          dtype=v.dtype) for v, ax in zip(node, param_specs(layout))))

    return state._replace(params=whole(state.params), opt_state=_tree_map(
        lambda v: v.cpu(), map_params_nodes(whole, state.opt_state)), compute_params=None)


def _element_index(mesh, layout: str, k: int):
    """For bfloat16_sr moments (train/qmoments.sr_element_index): the
    index, in the whole stacked leaf, of each element of layer k's slice
    of leaf i on this rank, so that the stochastic rounding of a sharded
    moment draws the bits the single-device step draws for those
    elements (and a replicated one, beta, the same bits on every model
    rank)."""
    specs = param_specs(layout)

    def index(i: int, v: Tensor) -> Tensor:
        if v.dim() == 0:
            return torch.full((1,), k, dtype=torch.int64, device=v.device)
        T, t = (mesh.shape[MODEL_AXIS], mesh.model_index) if specs[i] else (1, 0)
        rows, inner = v.shape[0], v[0].numel()
        local = torch.arange(v.numel(), dtype=torch.int64, device=v.device)
        return local + (k * T * rows + t * rows) * inner

    return index


def _tp_grad_norm(tp: _TP, layer_grads, layout: str, freeze) -> Tensor:
    """The global norm of the whole (fp32) gradient: the sharded leaves'
    sums of squares added over the model group, the replicated leaves'
    counted once; frozen fields are left out (the update zeroes them)."""
    specs = param_specs(layout)
    sq = [torch.zeros((), dtype=torch.float32, device=layer_grads[0][0].device) for _ in range(2)]
    for grads in layer_grads:
        for name, g, ax in zip(DLADMMParams._fields, grads, specs):
            if name not in freeze:
                g = g.to(torch.float32)
                sq[ax is None] = sq[ax is None] + torch.sum(g * g)
    return torch.sqrt(tp.reduce(sq[0], tp.mesh.model_group) + sq[1])


def _tp_value_and_grad(tp: _TP, params: DLADMMParams, A_t, b, x_star_t, e_star, layout: str, layer_weights=None):
    """(loss, per-layer gradients) on this rank's shards. The loss is the
    global batch's, the same on every rank: the x-side squared errors
    summed over the model group (_ReduceFromModel), the z-side ones
    computed once per model rank (each holds the whole z), each divided
    by the global batch's element count, then summed over the data group.
    Autograd runs on per-layer leaves (views of the stacks), so each
    layer's gradient is its own tensor and no stacked gradient is
    assembled; the data group's sum follows, one all-reduce a layer."""
    mesh = tp.mesh
    D, T = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    S, m = b.shape[0] * D, b.shape[1]
    n = A_t.shape[1] * T
    layers = [[v.detach().requires_grad_() for v in layer] for layer in _layers(params)]
    x_t, z, _, ys = _tp_forward_local(tp, layers, A_t, b, layout, x_star_t, e_star, layer_weights is not None)
    if layer_weights is None:
        sse_x = torch.sum((x_t.float() - x_star_t) ** 2).reshape(1)
        sse_z = torch.sum((z.float() - e_star) ** 2)
        loss = _ReduceFromModel.apply(sse_x, tp)[0] / (S * n) + sse_z / (S * m)
    else:
        num_x = torch.stack([torch.sum(y[0]) for y in ys])
        num_z = torch.stack([torch.sum(y[1]) for y in ys])
        loss = torch.sum(layer_weights * (_ReduceFromModel.apply(num_x, tp) / (S * n) + num_z / (S * m)))
    flat = torch.autograd.grad(loss, [v for layer in layers for v in layer])
    grads = [DLADMMParams(*flat[5 * k: 5 * k + 5]) for k in range(len(layers))]
    loss = loss.detach()
    if D > 1:
        for k, g in enumerate(grads):
            head = [loss.reshape(1)] if k == 0 else []
            buf = tp.reduce(_flat([*head, *(v.to(torch.float32) for v in g)]), mesh.data_group)
            if k == 0:
                loss, buf = buf[0], buf[1:]
            grads[k] = DLADMMParams(*(u.to(v.dtype) for u, v in zip(_unflat(buf, g), g)))
    return loss, grads


def make_sharded_train_step(
    optimizer,
    mesh,
    layout: str = "sharded_w2",
    compute_dtype=None,
    freeze: tuple = (),
    layer_weights=None,
    timer: Optional[CollectiveTimer] = None,
):
    """Tensor-parallel step over the D x T mesh: (state, A_t, local batch)
    -> (state, loss); the state holds this rank's slices
    (shard_params_tp / init_params_tp; the moments shaped like them), A_t
    its columns of A in the compute type, the batch its data index's rows
    and x* its n-slice.

    Per layer three products, each on 1/T of the weights (sharded_w2),
    and the collectives of the JAX package's _tp_layer_step: the partial
    A x all-reduced over the model group, z gathered, and in the
    backward the sums that copying u, v and z into rank-local work needs
    (_CopyToModel). Replicated leaves (beta; W2 and theta2 in
    replicated_w2) so get the whole gradient on every model rank, sharded
    ones their slice's; the data group sums them (_tp_value_and_grad).
    The update is the optimizer's, layer by layer and in place
    (train/loop.update_by_layer), its clip on the whole gradient's norm. The
    products are fp32 torch.matmul (no kernel: the JAX package's TP step
    is XLA dots too), bf16 under ``compute_dtype`` on the state's
    persistent bf16 copy, with fp32 masters and an fp32 loss.
    ``layer_weights``: deep supervision; ``freeze``: fields held fixed;
    ``timer``: a CollectiveTimer that times every collective. The update
    is in place: the state passed in is the state returned."""
    _check_tp(mesh)
    tp = _TP(mesh, timer)
    freeze = tuple(freeze)

    def step(state, A_t, batch):
        loss_params, b = _mixed_precision_inputs(state, batch, compute_dtype)
        loss, grads = _tp_value_and_grad(tp, loss_params, A_t, b, batch.x_star, batch.e_star, layout,
                                         layer_weights)
        norm = _tp_grad_norm(tp, grads, layout, freeze)
        with profiling.span("train.optimizer"):
            state = update_by_layer(optimizer, state, grads, lambda: norm, freeze, compute_dtype,
                                    lambda k: _element_index(mesh, layout, k))
        return state, loss

    return step


__all__ = [
    "CollectiveTimer",
    "Flat",
    "LAYOUTS",
    "Zero1Layout",
    "gather_blocks",
    "gather_state_tp",
    "init_params_tp",
    "make_dp_eval",
    "make_dp_fused_adam_step",
    "make_dp_train_step",
    "make_dp_zero1_state",
    "make_dp_zero1_train_step",
    "make_sharded_eval",
    "make_sharded_train_step",
    "param_specs",
    "shard_state_tp",
    "sharded_forward",
    "whole_state_template",
    "zero1_gather",
    "zero1_global_state",
    "zero1_layout",
    "zero1_slice",
]
