"""Data-parallel training steps and evaluation on ``torch.distributed``.

The port of the data-parallel half of
``dladmm_tpu/parallel/collectives.py`` (model_axis = 1). Each rank holds
the whole model and its optimizer (ZeRO-1 aside) and one batch shard of
global_batch / D rows, and runs the port's single-device stack on it:
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

The mean of D half-batch means is the global mean up to the order of
summation: tests/test_torch_distributed.py holds the steps to the
single-process global-batch step at the JAX package's tolerances.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor

from dladmm_tpu_torch.models.unroll import DLADMMParams
from dladmm_tpu_torch.parallel.mesh import DATA_AXIS
from dladmm_tpu_torch.train.qmoments import BLOCK, QTensor

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
    adds the ranks' sums. The net runs through the trajectory kernel for
    B = I (its plain version on CPU tensors; use_kernel=False: the plain
    loop), through the plain loop for a general B."""
    from dladmm_tpu_torch.models.unroll import dladmm_forward

    @torch.no_grad()
    def evaluate(params: DLADMMParams, A: Tensor, batch):
        b, x_star, z_star = batch
        if B is None and use_kernel:
            from dladmm_tpu_torch.ops.cuda_traj import trajectory_forward

            tx, tz, _ = trajectory_forward(b, A, *params)
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
        K = tx.shape[0]
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

    return evaluate


# -- the replicated-optimizer step ----------------------------------------------


def _mixed_precision_inputs(state, batch, compute_dtype):
    """(loss params, observations): the persistent compute copy and the
    cast batch under mixed precision, the fp32 masters otherwise."""
    if compute_dtype is not None:
        return state.compute_params, batch.b.to(compute_dtype)
    return state.params, batch.b


def _apply_update(state, loss, grads, optimizer, compute_dtype, freeze):
    """The steps' optimizer tail: the (possibly bf16) gradients cast to
    the fp32 masters' type, frozen fields zeroed, the update (the fused
    sweep where the optimizer has ``fused_apply``, which rewrites the
    compute copy in its pass; else the chain, after which the copy is
    cast again)."""
    from dladmm_tpu_torch.train.loop import TrainState, _cast, apply_updates

    grads = DLADMMParams(*(g.to(p.dtype) for g, p in zip(grads, state.params)))
    if freeze:
        grads = DLADMMParams(*(
            torch.zeros_like(g) if name in freeze else g for name, g in zip(grads._fields, grads)
        ))
    cp = state.compute_params
    if hasattr(optimizer, "fused_apply"):
        params, opt_state, cp = optimizer.fused_apply(grads, state.opt_state, state.params, compute_dtype, cp)
    else:
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
            params = apply_updates(state.params, updates)
        cp = None if compute_dtype is None else _cast(params, compute_dtype)
    return TrainState(params, opt_state, state.step + 1, cp), loss


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


__all__ = [
    "Flat",
    "Zero1Layout",
    "make_dp_eval",
    "make_dp_fused_adam_step",
    "make_dp_train_step",
    "make_dp_zero1_state",
    "make_dp_zero1_train_step",
    "zero1_gather",
    "zero1_global_state",
    "zero1_layout",
    "zero1_slice",
]
