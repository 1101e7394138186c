"""Adam fused into the manual reverse sweep.

The port of ``dladmm_tpu/train/fused_adam.py``. With the delayed clip
(train/loop.delayed_clip_by_global_norm) the clip scale of step i is
step i-1's gradient norm, known before the backward runs, so the Adam
update of layer k can run inside the reverse sweep, right where layer
k's gradients are produced: the (K, .)-stacked gradients are never held
whole. The per-layer backward algebra is ops/unroll_vjp.bwd_layer, the
function bwd_from_carries loops over, called with ``acc=None`` so that
no data cotangents (gA, gb) are formed; the forward is
ops/unroll_vjp._fwd_scan, the plain loop that also returns the
per-layer residuals (B = I or a general z-dictionary B).

This module is plain PyTorch, as the JAX module is plain XLA: no kernel
is behind it. The optimizer replicates chain(delayed_clip_by_global_norm
(c), adam(lr)) of train/loop.py expression for expression, with the JAX
module's one deliberate deviation: the norm that feeds the NEXT step's
scale is summed in fp32 even under bf16 compute (the chain's bf16 norm
rounds each leaf's sum). While the clip does not bind, both scale by
exactly 1.0 and agree to the last few bits
(tests/test_torch_fused_adam.py). The learning rate is the chain's
(train/loop._lr_of), evaluated at the step count before its increment.

``make_fused_update_core`` is the step's body without state packing, so
that the data-parallel step (parallel/collectives.make_dp_fused_adam_step)
runs the same body on each rank with ``grad_reduce`` averaging each
layer's gradients over the data ranks as the sweep produces them.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import torch
from torch import Tensor

from dladmm_tpu_torch.data.synthetic import make_batch, step_generator
from dladmm_tpu_torch.models.unroll import DLADMMParams
from dladmm_tpu_torch.ops.unroll_vjp import _fwd_scan, bwd_layer
from dladmm_tpu_torch.train.loop import TrainState, _cast, weighted_trajectory_mse


class FusedAdamState(NamedTuple):
    """Adam moments (the params' (K, .) stacks, fp32) and the delayed
    clip's carry (the last step's global gradient norm)."""

    mu: Any  # DLADMMParams of fp32 tensors
    nu: Any
    count: Tensor  # int32 scalar: updates applied
    prev_norm: Tensor  # fp32 scalar; clip_norm before the first step


def make_fused_adam_state(params: DLADMMParams, clip_norm: Optional[float] = None,
                          compute_dtype=None) -> TrainState:
    """TrainState whose opt_state is a FusedAdamState, on copies of
    ``params`` (make_train_state + optimizer.init for the fused step).
    clip_norm 0 or None: no clipping (the package's convention)."""
    clip_norm = clip_norm or None
    params = DLADMMParams(*(p.detach().clone().contiguous() for p in params))
    device = params[0].device
    opt = FusedAdamState(
        mu=DLADMMParams(*(torch.zeros_like(p) for p in params)),
        nu=DLADMMParams(*(torch.zeros_like(p) for p in params)),
        count=torch.zeros((), dtype=torch.int32, device=device),
        # The delayed clip's init: step 0's scale is exactly 1.
        prev_norm=torch.full((), clip_norm if clip_norm is not None else 0.0,
                             dtype=torch.float32, device=device),
    )
    cp = None if compute_dtype is None else _cast(params, compute_dtype)
    return TrainState(params, opt, 0, cp)


def make_fused_update_core(
    layer_weights: Optional[Tensor] = None,
    lr: Union[float, Callable] = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    clip_norm: Optional[float] = None,
    compute_dtype=None,
    freeze: tuple = (),
    grad_reduce: Optional[Callable] = None,
    loss_reduce: Optional[Callable] = None,
    B: Optional[Tensor] = None,
):
    """The fused step's body: core(params32, params_c, mu, nu, count,
    prev_norm, A_c, b_c, x_star, e_star) -> (loss, new_p, new_mu, new_nu,
    new_cp, new_norm), new_cp None without compute_dtype. All results
    are new tensors; the inputs are left as they are.

    grad_reduce(gs) -> gs takes the list of a layer's five gradients
    before their update and returns the list to apply, loss_reduce(loss)
    -> loss the loss (the data-parallel step's averages over the ranks).
    B: the general z-dictionary, already in the compute type, or None for
    B = I."""
    clip_norm = clip_norm or None
    frozen = tuple(i for i, name in enumerate(DLADMMParams._fields) if name in freeze)

    def out_cotangents(xK, zK, resid, x_star, e_star):
        """The loss and its cotangents on the final state (gx, gz) or on
        the per-layer x and z stacks (traj_ct), through autograd of the
        small output -> loss function (the JAX module's jax.vjp). The
        targets stay fp32, so under bf16 compute the differences widen."""
        with torch.enable_grad():
            if layer_weights is None:
                xs = (xK.detach().requires_grad_(), zK.detach().requires_grad_())
                loss = torch.mean((xs[0] - x_star) ** 2) + torch.mean((xs[1] - e_star) ** 2)
            else:
                tx, tz = (resid[3], resid[4]) if B is None else (resid[4], resid[5])
                xs = (tx.detach().requires_grad_(), tz.detach().requires_grad_())
                loss = weighted_trajectory_mse(xs[0], xs[1], x_star, e_star, layer_weights)
            cts = torch.autograd.grad(loss, xs)
        return loss.detach(), cts

    @torch.no_grad()
    def core(params32, params_c, mu, nu, count, prev_norm, A_c, b_c, x_star, e_star):
        (xK, zK, _), resid, _ = _fwd_scan(params_c, A_c, b_c, B)
        loss, cts = out_cotangents(xK, zK, resid, x_star, e_star)
        if layer_weights is None:
            gx, gz = cts
            traj_ct = None
        else:
            traj_ct = cts
            gx, gz = torch.zeros_like(xK), torch.zeros_like(zK)
        if loss_reduce is not None:
            loss = loss_reduce(loss)

        # The chain's expressions: scale_by_adam's bias corrections at the
        # incremented count, scale_by_learning_rate's -lr(count), the
        # delayed clip's scale.
        cf = (count + 1).to(torch.float32)
        bc1, bc2 = 1 - torch.pow(b1, cf), 1 - torch.pow(b2, cf)
        lr_t = lr(count) if callable(lr) else lr
        if clip_norm is None:
            scale = torch.ones((), dtype=torch.float32, device=cf.device)
        else:
            scale = torch.clamp(clip_norm / torch.clamp(prev_norm, min=1e-16), max=1.0)

        new_p = DLADMMParams(*(torch.empty_like(p) for p in params32))
        new_mu = DLADMMParams(*(torch.empty_like(p) for p in mu))
        new_nu = DLADMMParams(*(torch.empty_like(p) for p in nu))
        new_cp = None if compute_dtype is None else DLADMMParams(
            *(torch.empty_like(p, dtype=compute_dtype) for p in params32))
        sumsq = []
        carry = (gx, gz, torch.zeros_like(b_c), torch.zeros_like(b_c))
        for k in range(params32.W1.shape[0] - 1, -1, -1):
            gx, gz, glam, gAx = carry
            if traj_ct is not None:
                gx, gz = gx + traj_ct[0][k], gz + traj_ct[1][k]
            r = tuple(t[k] for t in resid)
            carry, gp, _ = bwd_layer(params_c.layer(k), r, (gx, gz, glam, gAx), A_c, b_c, B, None)
            gp = [torch.zeros_like(g) if i in frozen else g for i, g in enumerate(gp)]
            if grad_reduce is not None:
                gp = list(grad_reduce(gp))
            for i, g in enumerate(gp):
                # optax's order: clip scale, moments, bias-corrected
                # update, -lr, apply.
                g = g.reshape(params32[i][k].shape) * scale.to(g.dtype)
                m1 = (1 - b1) * g + b1 * mu[i][k]
                v1 = (1 - b2) * (g * g) + b2 * nu[i][k]
                u = (m1 / bc1) / (torch.sqrt(v1 / bc2) + eps)
                p = params32[i][k]
                new_p[i][k] = p + (u * -lr_t).to(p.dtype)
                new_mu[i][k] = m1
                new_nu[i][k] = v1
                if new_cp is not None:
                    new_cp[i][k] = new_p[i][k].to(compute_dtype)
            if clip_norm is not None:
                # fp32 sum of squares of this layer's (reduced) gradients,
                # for the next step's scale.
                sumsq.append(sum(torch.sum(torch.square(g.to(torch.float32))) for g in gp))
        new_norm = torch.sqrt(torch.sum(torch.stack(sumsq[::-1]))) if clip_norm is not None else prev_norm
        return loss, new_p, new_mu, new_nu, new_cp, new_norm

    return core


def make_fused_adam_step(
    A: Tensor,
    batch: Optional[int] = None,
    sparsity_x: float = 0.1,
    sparsity_e: float = 0.1,
    layer_weights: Optional[Tensor] = None,
    lr: Union[float, Callable] = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    clip_norm: Optional[float] = None,
    compute_dtype=None,
    freeze: tuple = (),
    from_batch: bool = False,
    B: Optional[Tensor] = None,
    seed: int = 0,
):
    """The fused train step: batch -> forward loop -> reverse sweep with
    each layer's (gradients -> delayed clip -> Adam) in the sweep.

    step(state, i) -> (state, loss) draws its batch from
    ``step_generator(seed, i)`` on A's device, as train/loop.
    make_train_step does; with from_batch=True it is step(state,
    SyntheticBatch). lr: a float or a schedule of the update count.
    clip_norm None or 0: no clipping. B: the general z-dictionary, or None
    for B = I. The state comes from make_fused_adam_state."""
    A_c = A if compute_dtype is None else A.to(compute_dtype)
    B_c = B if B is None or compute_dtype is None else B.to(compute_dtype)
    core = make_fused_update_core(layer_weights, lr, b1, b2, eps, clip_norm, compute_dtype, freeze, B=B_c)

    def step(state: TrainState, i_or_data):
        if from_batch:
            data = i_or_data
        else:
            data = make_batch(step_generator(seed, i_or_data), A, batch, sparsity_x, sparsity_e, A.dtype, B)
        return apply_fused(core, state, A_c, data, compute_dtype)

    return step


def apply_fused(core, state: TrainState, A_c: Tensor, data, compute_dtype) -> tuple:
    """One step of ``core`` on ``state`` and a batch: (new state, loss).
    The loss runs on the state's compute copy where it has one."""
    params_c = state.compute_params if state.compute_params is not None else state.params
    b_c = data.b if compute_dtype is None else data.b.to(compute_dtype)
    opt = state.opt_state
    loss, new_p, new_mu, new_nu, new_cp, new_norm = core(
        state.params, params_c, opt.mu, opt.nu, opt.count, opt.prev_norm, A_c, b_c, data.x_star, data.e_star)
    new_opt = FusedAdamState(new_mu, new_nu, opt.count + 1, new_norm)
    return TrainState(new_p, new_opt, state.step + 1, new_cp), loss


__all__ = [
    "FusedAdamState",
    "apply_fused",
    "make_fused_adam_state",
    "make_fused_adam_step",
    "make_fused_update_core",
]
