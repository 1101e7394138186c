"""Training loop: data -> loss -> backward -> fused optimizer.

The port of ``dladmm_tpu/train/loop.py`` for single-device training.
One step draws its batch from a generator derived from (seed, step),
runs the forward the policy selected (models/api.select_forward: the
trajectory kernel on the card, for either loss), backpropagates
through the autograd Functions of ops/cuda_traj.py and ops/unroll_vjp.py
(the backward kernel for the final-layer loss, the manual reverse sweep
for deep supervision), and applies the optimizer: the fused sweep
(train/qadam_cuda.QAdamFused) for ``moment_dtype="*_pallas"`` (int8,
float32, bfloat16, bfloat16_sr, bfloat16_sr_mu moments), or
optax-equivalent Adam with global or delayed norm clipping: fp32 moments,
or the XLA-side int8, bfloat16 and bfloat16_sr moments
(train/qmoments.adam_qmoments).

Nothing in a step waits for the host: the batch is copied through
pinned memory without a sync, the optimizer's step count, learning rate,
bias corrections and clip scale are device tensors, and ``float(loss)``
is read only at an eval. PyTorch runs eagerly, so the JAX step's ``jit``
and buffer donation have no counterpart: the fused optimizer updates the
masters in place instead, and so does fp32 Adam where the whole-leaf
update's new tensors would not fit beside the state: one sweep over every
leaf in the chain's own roundings (``_adam_in_place``, the kernel
``train/qadam_cuda.adam_inplace``), so that a step's peak stays near the
params, moments and gradients (tp_large's 4.0B parameters on one card).
The tensor-parallel step updates its shards in place one layer at a time
(``update_by_layer``).

Loss: MSE to the ground truth, final layer only, or deep supervision
sum_k gamma_k (||x_k - x*||^2 + ||z_k - e*||^2) (``layer_loss``).

bf16 training (``compute_dtype="bfloat16"``), as the JAX package runs
it: the state keeps a persistent bf16 copy of the fp32 masters
(``TrainState.compute_params``); the loss and its gradient run on that
copy with A cast once and b each step (the targets stay fp32), through
the bf16 kernels on the card; the bf16 gradients go to the optimizer,
whose fused sweep updates the fp32 masters and rewrites the copy in the
same pass (a plain optimizer re-casts it). Checkpoints hold the masters
only; a resume casts the copy again. Evals run on the fp32 masters.

``optimizer="fused_adam"`` applies Adam per layer inside the reverse
sweep (train/fused_adam.py), with the delayed clip. ``fit_greedy``
trains the k-layer prefixes in stages, then fine-tunes end to end.
``fit_sharded`` trains data-parallel over the ranks of a
``torch.distributed`` run (parallel/), one process a rank, data-parallel
and tensor-parallel (model_axis > 1).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import os
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch import Tensor

from dladmm_tpu_torch.baselines.ladmm import ladmm_run
from dladmm_tpu_torch.data.synthetic import make_batch, step_generator
from dladmm_tpu_torch.metrics.core import constraint_residual, nmse_db, per_layer_nmse_db
from dladmm_tpu_torch.models.unroll import DLADMMParams, dladmm_forward
from dladmm_tpu_torch.ops.prox import resolve_prox
from dladmm_tpu_torch.train.qadam_cuda import QAdamFused, WarmupCosine, adam_inplace, global_norm
from dladmm_tpu_torch.utils import profiling


class TrainState(NamedTuple):
    """The JAX package's TrainState."""

    params: DLADMMParams  # fp32 master parameters
    opt_state: Any
    step: int  # steps taken, on the host (the optimizer keeps its own device count)
    # bf16 training: the persistent compute-precision copy of params, which
    # the loss runs on and the fused optimizer rewrites in its sweep. None
    # in fp32 runs (and in checkpoints, which hold the three fields above).
    compute_params: Optional[DLADMMParams] = None


def _cast(params: DLADMMParams, dtype) -> DLADMMParams:
    return DLADMMParams(*(p.to(dtype) for p in params))


def make_train_state(params: DLADMMParams, optimizer, compute_dtype=None) -> TrainState:
    """Fresh TrainState on copies of ``params`` (the fused optimizer
    updates its masters in place); with ``compute_dtype`` (torch.bfloat16)
    also the compute-precision copy (TrainState.compute_params)."""
    params = DLADMMParams(*(p.detach().clone().contiguous() for p in params))
    cp = None if compute_dtype is None else _cast(params, compute_dtype)
    return TrainState(params, optimizer.init(params), 0, cp)


def weighted_trajectory_mse(tx, tz, x_tgt, z_tgt, layer_weights):
    """The deep-supervision objective on stacked (K, S, .) trajectories:
    per-layer MSE of both streams, gamma_k-weighted sum. Targets of
    shape (S, .) broadcast over the K axis."""
    per_layer = torch.mean((tx - x_tgt) ** 2, dim=(1, 2)) + torch.mean((tz - z_tgt) ** 2, dim=(1, 2))
    return torch.sum(layer_weights * per_layer)


def loss_fn(
    params: DLADMMParams,
    A: Tensor,
    b: Tensor,
    x_star: Tensor,
    z_star: Tensor,
    B: Optional[Tensor] = None,
    layer_weights: Optional[Tensor] = None,
    step_fn=None,
    forward_fn=None,
    compute_dtype=None,
    vjp: str = "auto",
) -> Tensor:
    """MSE to ground truth; final layer only, or gamma-weighted per layer.

    compute_dtype (torch.bfloat16) runs the whole unroll in bf16: params,
    A, b (and B) are cast to it; the targets and the loss stay fp32.

    forward_fn (from models.api.select_forward) replaces the plain loop;
    for the final-layer loss it returns the final (x, z, lam), with
    layer_weights the stacked (K, S, .) trajectory. Without one, the
    l1/l1 losses take the manual backward (ops/unroll_vjp.py) when
    vjp="auto"/"manual"; vjp="xla" (the JAX package's name) and custom
    step_fns take autograd through the plain loop."""
    if compute_dtype is not None:
        params = _cast(params, compute_dtype)
        A, b = A.to(compute_dtype), b.to(compute_dtype)
        B = None if B is None else B.to(compute_dtype)
    manual_ok = forward_fn is None and step_fn is None and layer_weights is None
    if vjp == "manual" and not manual_ok:
        raise ValueError(
            "vjp='manual' needs the default step, no forward_fn, and the "
            "final-layer loss (no layer_weights)"
        )
    if vjp == "xla" and (forward_fn is not None or step_fn is not None):
        raise ValueError(
            "vjp='xla' (autograd through the plain loop) with a custom "
            "forward_fn/step_fn would not be autograd: pass forward_fn=step_fn=None"
        )
    if layer_weights is None:
        if forward_fn is not None:
            x, z, _ = forward_fn(params, A, b)
        elif manual_ok and vjp in ("auto", "manual"):
            from dladmm_tpu_torch.ops.unroll_vjp import (
                dladmm_unroll_manual,
                dladmm_unroll_manual_general,
            )

            if B is None:
                x, z, _ = dladmm_unroll_manual(params, A, b)
            else:
                x, z, _ = dladmm_unroll_manual_general(params, A, B, b)
        else:
            x, z, _ = dladmm_forward(params, A, b, B=B, step_fn=step_fn)
        return torch.mean((x - x_star) ** 2) + torch.mean((z - z_star) ** 2)
    if forward_fn is not None:
        tx, tz, _ = forward_fn(params, A, b)
    elif B is not None and step_fn is None and vjp == "auto":
        from dladmm_tpu_torch.ops.unroll_vjp import dladmm_traj_manual_general

        tx, tz, _ = dladmm_traj_manual_general(params, A, B, b)
    else:
        _, (tx, tz, _) = dladmm_forward(params, A, b, B=B, capture_trajectory=True, step_fn=step_fn)
    return weighted_trajectory_mse(tx, tz, x_star, z_star, layer_weights)


# -- optimizers: optax's math on tensors, all state on the device ---------


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable  # (updates, state, params) -> (updates, state)
    # adam()'s AdamHyper, a clip's ClipHyper, a chain's tuple of its
    # transforms' (None elsewhere): what _apply's in-place sweep reads.
    hyper: Any = None


class AdamHyper(NamedTuple):
    learning_rate: Any  # a float, or a schedule: count tensor -> lr tensor
    b1: float
    b2: float
    eps: float


class ClipHyper(NamedTuple):
    max_norm: float
    mode: str  # "global" (clip_by_global_norm) or "delayed"


class AdamState(NamedTuple):
    count: Tensor
    mu: DLADMMParams
    nu: DLADMMParams


class DelayedClipState(NamedTuple):
    prev_norm: Tensor  # fp32 scalar; = max_norm before the first step


def _count0(params) -> Tensor:
    return torch.zeros((), dtype=torch.int32, device=params[0].device)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    """optax.scale_by_adam (eps_root 0, no Nesterov), fp32 moments."""

    def init(params):
        zeros = lambda: type(params)(*(torch.zeros_like(p) for p in params))  # noqa: E731
        return AdamState(_count0(params), zeros(), zeros())

    def update(grads, state, params=None):
        kind = type(grads)
        mu = kind(*((1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)))
        nu = kind(*((1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)))
        count, c1, c2 = _bias_corrections(state.count, b1, b2)
        out = kind(*((m / c1) / (torch.sqrt(v / c2) + eps) for m, v in zip(mu, nu)))
        return out, AdamState(count, mu, nu)

    return GradientTransformation(init, update)


def _bias_corrections(count: Tensor, b1: float, b2: float):
    """(count + 1, 1 - b1^(count + 1), 1 - b2^(count + 1)), on the device."""
    count = count + 1
    cf = count.to(torch.float32)
    return count, 1 - torch.pow(b1, cf), 1 - torch.pow(b2, cf)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    """optax.adam: scale_by_adam then scale_by_learning_rate, fp32 moments;
    it carries its hyperparameters (``hyper``) for _apply's in-place
    sweep."""
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(learning_rate))._replace(
        hyper=AdamHyper(learning_rate, b1, b2, eps))


def _rate(learning_rate, count: Tensor):
    """The rate at the step's own (pre-increment) count: a float, or the
    schedule's device tensor."""
    return learning_rate(count) if callable(learning_rate) else learning_rate


def scale_by_learning_rate(learning_rate) -> GradientTransformation:
    """optax.scale_by_learning_rate: updates * -lr(count), the count the
    step's own (pre-increment)."""

    def init(params):
        return _count0(params)

    def update(grads, count, params=None):
        lr = _rate(learning_rate, count)
        return type(grads)(*(g * -lr for g in grads)), count + 1

    return GradientTransformation(init, update)


_WHOLE_NORM = contextvars.ContextVar("whole_gradient_norm", default=None)


@contextlib.contextmanager
def whole_gradient_norm(norm: Callable[[], Tensor]):
    """Within the block, the clip transforms take ``norm()`` as the global
    norm of the gradients they see: the optimizer is applied to one
    layer's slice at a time (update_by_layer), and the clip is the whole
    gradient's."""
    token = _WHOLE_NORM.set(norm)
    try:
        yield
    finally:
        _WHOLE_NORM.reset(token)


def _norm_of(grads) -> Tensor:
    norm = _WHOLE_NORM.get()
    return global_norm(grads) if norm is None else norm()


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax.clip_by_global_norm: t, or t / norm * max_norm above the
    limit (the norm cast to t's dtype first, as optax does: bf16 gradients
    stay bf16)."""

    def update(grads, state, params=None):
        norm = _norm_of(grads)
        trigger = norm < max_norm
        return type(grads)(*(torch.where(trigger, g, (g / norm.to(g.dtype)) * max_norm) for g in grads)), state

    return GradientTransformation(lambda params: (), update, ClipHyper(max_norm, "global"))


def delayed_clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Global-norm clipping with a one-step-delayed norm: step i is
    scaled by step i-1's norm (step 0 unclipped), so the norm reduction
    and the scaled update touch each gradient once (the JAX package's
    single-pass variant)."""

    def init(params):
        return DelayedClipState(torch.full((), max_norm, dtype=torch.float32, device=params[0].device))

    def update(grads, state, params=None):
        cur = _norm_of(grads).to(torch.float32)
        scale = _delayed_scale(state.prev_norm, max_norm)
        return type(grads)(*(g * scale.to(g.dtype) for g in grads)), DelayedClipState(cur)

    return GradientTransformation(init, update, ClipHyper(max_norm, "delayed"))


def _delayed_scale(prev_norm: Tensor, max_norm: float) -> Tensor:
    """The delayed clip's factor: min(1, max_norm / max(prev_norm, 1e-16))."""
    return torch.clamp(max_norm / torch.clamp(prev_norm, min=1e-16), max=1.0)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new.append(s)
        return grads, tuple(new)

    return GradientTransformation(init, update, tuple(getattr(t, "hyper", None) for t in transforms))


def apply_updates(params: DLADMMParams, updates: DLADMMParams) -> DLADMMParams:
    return type(params)(*(p + u for p, u in zip(params, updates)))


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int, end_value: float = 0.0
):
    """optax.warmup_cosine_decay_schedule, exactly: linear warmup from
    init_value to peak_value over warmup_steps, then cosine decay to
    end_value at decay_steps, in float32 on the count's device. A
    ``WarmupCosine``, which the fused step's prologue evaluates on the
    card from its fields."""
    return WarmupCosine(init_value, peak_value, warmup_steps, decay_steps, end_value)


def _lr_of(t):
    """The TrainConfig's learning rate: a float, or the warmup + cosine
    schedule optax.warmup_cosine_decay_schedule(0, lr, max(1,
    steps // 20), steps), evaluated on the device at the step count
    before its increment."""
    if t.lr_schedule == "cosine":
        return warmup_cosine_decay_schedule(0.0, t.lr, max(1, t.steps // 20), t.steps)
    return t.lr


def _build_optimizer(t):
    """Adam with the TrainConfig's lr schedule and clipping: the fused
    sweep for moment_dtype="<fmt>_pallas" (it owns its exact global
    clip), else fp32 Adam (float32) or the XLA-side reduced-precision
    moments (int8, bfloat16, bfloat16_sr: train/qmoments.adam_qmoments),
    chained after clip_by_global_norm or the delayed clip."""
    md = getattr(t, "moment_dtype", "float32")
    clip = getattr(t, "clip_norm", None)
    if md.endswith("_pallas"):
        if clip and getattr(t, "clip_mode", "global") != "global":
            raise ValueError(
                "moment_dtype='*_pallas' implements exact global clipping "
                "inside the fused sweep; clip_mode must be 'global'"
            )
        return QAdamFused(_lr_of(t), moment_fmt=md[: -len("_pallas")], clip_norm=clip)
    if md == "float32":
        optimizer = adam(_lr_of(t))
    else:
        from dladmm_tpu_torch.train.qmoments import adam_qmoments

        optimizer = adam_qmoments(_lr_of(t), moment_dtype=md)
    if clip:
        mode = getattr(t, "clip_mode", "global")
        if mode == "delayed":
            clipper = delayed_clip_by_global_norm(clip)
        elif mode == "global":
            clipper = clip_by_global_norm(clip)
        else:
            raise ValueError(f"clip_mode must be 'global' or 'delayed', got {mode!r}")
        optimizer = chain(clipper, optimizer)
    return optimizer


# -- steps ----------------------------------------------------------------


def _value_and_grad(params: DLADMMParams, loss_args: tuple, loss_kw: dict):
    leaves = [p.detach().requires_grad_() for p in params]
    loss = loss_fn(DLADMMParams(*leaves), *loss_args, **loss_kw)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), DLADMMParams(*grads)


def _frozen(grads: DLADMMParams, freeze) -> DLADMMParams:
    """``grads`` with the fields named in ``freeze`` zeroed."""
    if not freeze:
        return grads
    return DLADMMParams(*(torch.zeros_like(g) if name in freeze else g for name, g in zip(grads._fields, grads)))


def _apply(optimizer, state: TrainState, grads: DLADMMParams, freeze=(), compute_dtype=None) -> TrainState:
    """The optimizer step on the masters; with a compute copy in the state
    the copy too: the fused sweep writes it in its pass, a plain
    optimizer's new masters are cast again. fp32 Adam as adam() builds
    it (_fp32_adam: alone or after a clip), with the gradients and
    moments of the masters' types (_elementwise_state), whose whole-leaf
    update would not fit in the memory left (_whole_update_fits:
    tp_large on one card), updates the state in place in one sweep over
    every leaf (_adam_in_place) with the values of the whole-leaf update;
    otherwise a plain optimizer returns a new state. Traced as
    ``train.optimizer``."""
    with profiling.span("train.optimizer"):
        if hasattr(optimizer, "fused_apply"):
            cp = state.compute_params
            params, opt_state, cp = optimizer.fused_apply(
                _frozen(grads, freeze), state.opt_state, state.params, compute_dtype if cp is not None else None, cp)
            return TrainState(params, opt_state, state.step + 1, cp)
        with torch.no_grad():
            hyper = _fp32_adam(optimizer)
            if hyper is not None and _elementwise_state(state, grads) and not _whole_update_fits(state):
                return _adam_in_place(*hyper, state, grads, lambda: global_norm(_frozen(grads, freeze)), freeze)
            return _update(optimizer, state, grads, freeze, compute_dtype)


def _fp32_adam(optimizer):
    """(clip, adam): the hyperparameters of fp32 Adam as _build_optimizer
    builds it, adam() alone (clip None) or chained after
    clip_by_global_norm or delayed_clip_by_global_norm; None for any other
    optimizer."""
    hyper = getattr(optimizer, "hyper", None)
    if isinstance(hyper, AdamHyper):
        return None, hyper
    if (isinstance(hyper, tuple) and len(hyper) == 2 and isinstance(hyper[0], ClipHyper)
            and isinstance(hyper[1], AdamHyper)):
        return hyper
    return None


def _adam_in_place(clip: Optional[ClipHyper], adam: AdamHyper, state: TrainState, grads: DLADMMParams,
                   whole_norm: Callable[[], Tensor], freeze=()) -> TrainState:
    """fp32 Adam's step as one sweep over every leaf, in place
    (train/qadam_cuda.adam_inplace: one launch on the card), with the
    values of the chain's whole-leaf update: the count, bias corrections,
    rate and clip scalars by the chain's own operations, once, on the
    device; a frozen leaf's gradient 0. The state keeps the chain's
    structure, (AdamState, rate count) after the clip's state, and its
    storage; the compute copy, if any, is cast again in place."""
    clip_state, (adam_state, rate_count) = state.opt_state if clip else ((), state.opt_state)
    count, c1, c2 = _bias_corrections(adam_state.count, adam.b1, adam.b2)
    lr = _rate(adam.learning_rate, rate_count)
    neg_lr = (-lr).to(torch.float32) if isinstance(lr, Tensor) else torch.full((), -lr, dtype=torch.float32,
                                                                            device=count.device)
    kw = {}
    if clip is not None and clip.mode == "global":
        norm = whole_norm()
        kw = dict(clip="global", clip_value=norm, trigger=norm < clip.max_norm, max_norm=clip.max_norm)
    elif clip is not None:
        kw = dict(clip="delayed", clip_value=_delayed_scale(clip_state.prev_norm, clip.max_norm))
        clip_state = DelayedClipState(whole_norm().to(torch.float32))
    adam_inplace([None if f in freeze else g for f, g in zip(grads._fields, grads)], state.params, adam_state.mu,
                 adam_state.nu, c1, c2, neg_lr, b1=adam.b1, b2=adam.b2, eps=adam.eps, **kw)
    if state.compute_params is not None:
        _copy_into(state.compute_params, state.params)
    opt_state = (AdamState(count, adam_state.mu, adam_state.nu), rate_count + 1)
    return TrainState(state.params, (clip_state, opt_state) if clip else opt_state, state.step + 1,
                      state.compute_params)


def _update(optimizer, state: TrainState, grads: DLADMMParams, freeze=(), compute_dtype=None) -> TrainState:
    """A plain optimizer's step as a function of ``state``: the frozen
    fields zeroed, the chain's update added, the compute copy cast again."""
    updates, opt_state = optimizer.update(_frozen(grads, freeze), state.opt_state, state.params)
    params = apply_updates(state.params, updates)
    cp = None if state.compute_params is None else _cast(params, compute_dtype)
    return TrainState(params, opt_state, state.step + 1, cp)


def _total_bytes(device: torch.device) -> int:
    """The memory of ``device``: the card's, or the host's."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _free_bytes(device: torch.device) -> int:
    """Bytes a new allocation on ``device`` can take: the card's free
    memory and what the caching allocator holds unused; the host's free
    pages."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _whole_update_fits(state: TrainState) -> bool:
    """Whether fp32 Adam's whole-leaf update fits in the memory left: its
    new moments, the updates before and after the rate and the new params
    are held at once beside the state (four times the params' bytes),
    with one more for the elementwise temporaries and the compute copy's
    cast on top. An update that needs a tenth of the device's memory or
    less fits without asking: the query (the card's free memory and the
    allocator's statistics) costs a host-bound small step about half a
    millisecond. Every configuration but tp_large on one card fits."""
    size = lambda node: sum(v.nbytes for v in node)  # noqa: E731
    need = 5 * size(state.params) + (0 if state.compute_params is None else size(state.compute_params))
    device = state.params[0].device
    return need <= _total_bytes(device) // 10 or need <= _free_bytes(device)


def zip_nodes(full, new, on_node, on_leaf):
    """Walk two trees of one structure: on_node(a, b) at DLADMMParams
    nodes, on_leaf(a, b) at the other leaves; returns the mapped tree."""
    if isinstance(full, DLADMMParams):
        return on_node(full, new)
    if isinstance(full, tuple) and hasattr(full, "_fields"):
        return type(full)(*(zip_nodes(a, b, on_node, on_leaf) for a, b in zip(full, new)))
    if isinstance(full, (tuple, list)):
        return type(full)(zip_nodes(a, b, on_node, on_leaf) for a, b in zip(full, new))
    return on_leaf(full, new)


def map_params_nodes(fn, tree):
    """``tree`` with every DLADMMParams node (the params, the moments)
    replaced by fn(node); other leaves (counts, keys, norms) kept."""
    return zip_nodes(tree, tree, lambda a, _: fn(a), lambda a, _: a)


def _copy_into(dst: DLADMMParams, src: DLADMMParams) -> DLADMMParams:
    for a, b in zip(dst, src):
        a.copy_(b)
    return dst


def _like(node, params: DLADMMParams) -> bool:
    return all(isinstance(v, Tensor) and v.shape == p.shape and v.dtype == p.dtype for v, p in zip(node, params))


def _elementwise(tree, params: DLADMMParams) -> bool:
    """Every DLADMMParams node of ``tree`` shaped and typed as ``params``,
    every other leaf a scalar."""
    if isinstance(tree, DLADMMParams):
        return _like(tree, params)
    if isinstance(tree, tuple):
        return all(_elementwise(v, params) for v in tree)
    return not isinstance(tree, Tensor) or tree.dim() == 0


def _has_adam(tree) -> bool:
    return isinstance(tree, AdamState) or (
        isinstance(tree, tuple) and not isinstance(tree, DLADMMParams) and any(_has_adam(v) for v in tree))


def _elementwise_state(state: TrainState, grads: DLADMMParams) -> bool:
    """Whether the step is fp32 Adam's (with or without a clip): gradients
    of the masters' types, an AdamState in the chain, every moment node
    shaped and typed as the params and every other leaf a scalar (counts,
    clip norms). The reduced-precision moments (int8 codes and scales,
    bf16 leaves, the SR key) and other optimizers keep the whole-leaf
    update."""
    return (_like(grads, state.params) and _has_adam(state.opt_state)
            and _elementwise(state.opt_state, state.params))


def update_by_layer(optimizer, state: TrainState, layer_grads: list, whole_norm: Callable[[], Tensor], freeze=(),
                    compute_dtype=None, element_index=None) -> TrainState:
    """A plain optimizer applied one layer at a time, in place: layer k's
    slice of the params, of every moment node and of the compute copy
    goes through _update (the optimizer's own elementwise arithmetic) with
    the layer's gradients cast to the masters' types (the tensor-parallel
    step's bf16 ones), its new values are copied back into the state's
    storage, and ``layer_grads[k]`` (that layer's gradients) is dropped
    before layer k + 1. The clip transforms read ``whole_norm()``, the whole
    gradient's global norm, called once at the first clip that asks;
    bfloat16_sr moments draw at ``element_index(k)``'s indices
    (train/qmoments.sr_element_index). Counts, keys and clip norms come
    out of every layer alike; the last layer's are kept. The update
    allocates one layer's temporaries, so the peak stays near the params,
    moments and gradients (tp_large: 4.0B parameters on one card). The
    tensor-parallel step (parallel/collectives.make_sharded_train_step)
    runs through it; the state passed in is the state returned."""
    from dladmm_tpu_torch.train.qmoments import sr_element_index

    norm = functools.cache(whole_norm)
    scalars = None
    for k in range(len(layer_grads)):
        at_k = lambda node: DLADMMParams(*(v[k] for v in node))  # noqa: E731
        cp = None if state.compute_params is None else at_k(state.compute_params)
        sub = TrainState(at_k(state.params), map_params_nodes(at_k, state.opt_state), state.step, cp)
        index = contextlib.nullcontext() if element_index is None else sr_element_index(element_index(k))
        with torch.no_grad(), whole_gradient_norm(norm), index:
            grads = DLADMMParams(*(g.to(p.dtype) for g, p in zip(layer_grads[k], sub.params)))
            new = _update(optimizer, sub, grads, freeze, compute_dtype)
            _copy_into(sub.params, new.params)
            if cp is not None:
                _copy_into(cp, new.compute_params)
            zip_nodes(sub.opt_state, new.opt_state, _copy_into, lambda a, b: None)
            scalars = map_params_nodes(lambda node: None, new.opt_state)
        del new, grads
        layer_grads[k] = None
    opt = zip_nodes(state.opt_state, scalars, lambda a, b: a, lambda a, b: b)
    return TrainState(state.params, opt, state.step + 1, state.compute_params)


def _mean_of(parts):
    """Mean (loss, grads) over microbatches; one part is returned as is.
    The sums run in fp32 (bf16 microbatch gradients widen, as the JAX
    package's fp32 accumulators make them)."""
    if len(parts) == 1:
        return parts[0]
    n = len(parts)
    loss = sum(p[0] for p in parts) / n
    return loss, DLADMMParams(*(sum(g.float() for g in gs) / n for gs in zip(*(p[1] for p in parts))))


def _check_state(state: TrainState, compute_dtype) -> None:
    if compute_dtype is None and state.compute_params is not None:
        raise ValueError(
            "state carries compute_params but the step was built without "
            "compute_dtype: build both from the same config "
            "(make_train_state(..., compute_dtype=...) pairs with "
            "make_train_step(..., compute_dtype=...))"
        )


def _grad_fn(A, B, layer_weights, kw, compute_dtype):
    """(state, b, x_star, e_star) -> (loss, grads): on the state's compute
    copy with A (and B) cast once here and b each call where the state
    carries one, else on the masters (with compute_dtype, cast inside the
    loss)."""
    A_c = A if compute_dtype is None else A.to(compute_dtype)
    B_c = B if B is None or compute_dtype is None else B.to(compute_dtype)

    def grad(state: TrainState, b, x_star, e_star):
        if compute_dtype is not None and state.compute_params is not None:
            return _value_and_grad(state.compute_params,
                                   (A_c, b.to(compute_dtype), x_star, e_star, B_c, layer_weights), kw)
        return _value_and_grad(state.params, (A, b, x_star, e_star, B, layer_weights),
                               {**kw, "compute_dtype": compute_dtype})

    return grad


def make_train_step(
    optimizer,
    A: Tensor,
    batch: int,
    sparsity_x: float = 0.1,
    sparsity_e: float = 0.1,
    B: Optional[Tensor] = None,
    layer_weights: Optional[Tensor] = None,
    step_fn=None,
    forward_fn=None,
    freeze: tuple = (),
    vjp: str = "auto",
    accum_steps: int = 1,
    nonneg_x: bool = False,
    seed: int = 0,
    compute_dtype=None,
):
    """The training step: (state, i) -> (state, loss), i the step index.
    It draws its batch from ``step_generator(seed, i)`` on A's device,
    takes the gradient and applies the optimizer.

    compute_dtype (torch.bfloat16): bf16 training; build the state with
    make_train_state(..., compute_dtype=...) so that the loss runs on its
    persistent bf16 copy (A cast once, b each step, targets fp32) and the
    optimizer rewrites that copy. A state with a copy and a step without
    compute_dtype raise ValueError.

    freeze: DLADMMParams field names kept at their value (their
    gradients are zeroed). accum_steps > 1: ``batch`` stays the
    effective batch; the step sums the gradients of accum_steps
    microbatches of batch / accum_steps rows (generator
    ``step_generator(seed, i, j)`` each) and applies their mean.

    Traced as ``train.step``, holding ``train.data`` (make_batch, once a
    microbatch) and then ``train.optimizer`` (utils/profiling.span)."""
    if accum_steps < 1 or batch % accum_steps:
        raise ValueError(f"accum_steps={accum_steps} must divide batch={batch}")
    micro = batch // accum_steps
    freeze = tuple(freeze)
    grad = _grad_fn(A, B, layer_weights, dict(step_fn=step_fn, forward_fn=forward_fn, vjp=vjp), compute_dtype)

    def grad_of(state, gen):
        with profiling.span("train.data"):
            data = make_batch(gen, A, micro, sparsity_x, sparsity_e, A.dtype, B, nonneg_x)
        return grad(state, data.b, data.x_star, data.e_star)

    def train_step(state: TrainState, i: int):
        with profiling.span("train.step"):
            _check_state(state, compute_dtype)
            if accum_steps == 1:
                loss, grads = grad_of(state, step_generator(seed, i))
            else:
                loss, grads = _mean_of([
                    grad_of(state, step_generator(seed, i, j)) for j in range(accum_steps)
                ])
            return _apply(optimizer, state, grads, freeze, compute_dtype), loss

    return train_step


def make_train_step_from_batch(
    optimizer,
    A: Tensor,
    B: Optional[Tensor] = None,
    layer_weights: Optional[Tensor] = None,
    step_fn=None,
    forward_fn=None,
    vjp: str = "auto",
    accum_steps: int = 1,
    compute_dtype=None,
):
    """Training step fed an explicit SyntheticBatch: (state, data) ->
    (state, loss). accum_steps > 1 splits the batch's rows into equal
    microbatches and applies the mean gradient: the exact global-mean
    gradient of the full batch. compute_dtype as make_train_step's."""
    grad = _grad_fn(A, B, layer_weights, dict(step_fn=step_fn, forward_fn=forward_fn, vjp=vjp), compute_dtype)

    def step(state: TrainState, data):
        _check_state(state, compute_dtype)
        S = data.b.shape[0]
        if S % accum_steps:
            raise ValueError(f"accum_steps={accum_steps} must divide the batch rows ({S})")
        loss, grads = _mean_of([
            grad(state, b, x_star, e_star)
            for b, x_star, e_star in zip(*(torch.chunk(v, accum_steps) for v in data))
        ])
        return _apply(optimizer, state, grads, compute_dtype=compute_dtype), loss

    return step


# -- evaluation -----------------------------------------------------------


def _eval_trajectory(A: Tensor, b: Tensor, B: Optional[Tensor], use_kernel: bool):
    """The trajectory forward (params, A, b) -> (tx, tz, tlam) that the
    policy selects for an eval, or None for the plain loop."""
    from dladmm_tpu_torch.models.api import select_forward

    m, n = A.shape
    return select_forward(
        m, n, m if B is None else B.shape[1], b.shape[0], kernel="auto" if use_kernel else "reference",
        need_trajectory=True, identity_B=B is None, device=A.device, dtype=A.dtype,
    )[0]


@torch.no_grad()
def evaluate(
    params: DLADMMParams,
    A: Tensor,
    data,
    B: Optional[Tensor] = None,
    ladmm_iters: Optional[int] = None,
    step_fn=None,
    prox_x=None,
    prox_z=None,
    use_kernel: bool = True,
):
    """NMSE(dB) and residual at the final layer, and the NMSE-vs-layer
    curves of the net and of classical LADMM with the same prox pair.

    The l1/l1, B = I net runs through the trajectory the policy selects
    (models/api.select_forward: the trajectory kernel without its Ax
    stack; its plain version on the CPU) unless use_kernel=False; other
    configs run the plain loop. The JAX package's eval uses its scan: the
    two compute the same function. Returns plain Python floats and
    lists."""
    K = params.W1.shape[0]
    traj = _eval_trajectory(A, data.b, B, use_kernel and step_fn is None)
    if traj is not None:
        tx, tz, _ = traj(params, A, data.b)
    else:
        _, (tx, tz, _) = dladmm_forward(params, A, data.b, B=B, capture_trajectory=True, step_fn=step_fn)
    x, z = tx[-1], tz[-1]
    _, (lx, _, _) = ladmm_run(
        A, data.b, B=B, iters=ladmm_iters or K, capture_trajectory=True, prox_x=prox_x, prox_z=prox_z
    )
    return {
        "nmse_db": float(nmse_db(x, data.x_star)),
        "nmse_db_z": float(nmse_db(z, data.e_star)),
        "residual": float(constraint_residual(A, data.b, x, z, B)),
        "nmse_curve_db": per_layer_nmse_db(tx, data.x_star).tolist(),
        "ladmm_curve_db": per_layer_nmse_db(lx, data.x_star).tolist(),
    }


def _layer_weights(layer_loss, K: int, dtype=torch.float32, device=None):
    """Deep-supervision weights: "uniform" = 1/K each; "linear" = gamma_k
    proportional to k; None = final-layer loss only."""
    if layer_loss is None:
        return None
    if layer_loss == "uniform":
        return torch.full((K,), 1.0 / K, dtype=dtype, device=device)
    if layer_loss == "linear":
        w = torch.arange(1, K + 1, dtype=dtype, device=device)
        return w / torch.sum(w)
    raise ValueError(f"layer_loss must be None|'uniform'|'linear', got {layer_loss!r}")


def fit(
    config,
    A: Optional[Tensor] = None,
    log_fn=None,
    step_fn=None,
    forward_fn=None,
    ckpt_dir: Optional[str] = None,
    resume: bool = False,
    init_params: Optional[DLADMMParams] = None,
    device=None,
):
    """Train a D-LADMM net per config; returns (params, history).

    Evaluates every ``eval_every`` steps and at the end on the eval
    batch of ``seed_keys(config)[1]`` (the serving CLI's --demo batch).
    With ckpt_dir, checkpoints params, optimizer state, step and the
    dictionary at every eval; resume=True continues from the latest
    step_N there. Runs on ``device`` (utils/platform.resolve_device:
    cuda unless asked otherwise). ``compute_dtype="bfloat16"`` trains in
    bf16 on a persistent copy of the fp32 masters (module docstring); the
    checkpoints hold the masters, and a resume casts the copy again."""
    from dladmm_tpu_torch.data.synthetic import problem_matrices, seed_keys
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.utils.platform import resolve_device

    p, t = config.problem, config.train
    device = resolve_device(device)
    compute_dtype = torch.bfloat16 if t.compute_dtype == "bfloat16" else None
    fused = getattr(t, "optimizer", "adam") == "fused_adam"
    _, g_eval, _ = seed_keys(config)
    dtype = getattr(torch, t.dtype)
    if A is not None:
        A = torch.as_tensor(A).to(device, dtype)
    A, B = problem_matrices(config, A, device=device)
    if init_params is not None:
        params = DLADMMParams(*(torch.as_tensor(v).to(device, dtype) for v in init_params))
    else:
        params = init_dladmm_params(A, B, K=p.K, beta=p.beta, dtype=dtype)
    layer_weights = _layer_weights(t.layer_loss, p.K, dtype, device)

    prox = resolve_prox(p)
    nonneg_x = getattr(p, "nonneg_x", False)
    prox_x_fn = prox_z_fn = None
    if prox is not None:
        if step_fn is not None or forward_fn is not None:
            raise ValueError(
                "general-prox configs own the layer step (ops/reference."
                "make_cached_step); pass step_fn=forward_fn=None"
            )
        if fused:
            raise ValueError(
                "optimizer='fused_adam' hand-writes the l1 backward; "
                "general-prox configs use optimizer='adam'"
            )
        if getattr(t, "vjp", "auto") != "auto":
            raise ValueError("general-prox configs route through autograd automatically; leave vjp='auto'")
        from dladmm_tpu_torch.ops.reference import make_cached_step

        prox_x_fn, prox_z_fn = prox
        step_fn = make_cached_step(prox_x_fn, prox_z_fn)

    if fused:
        # Adam per layer inside the reverse sweep (train/fused_adam.py),
        # with the chain's lr schedule and the delayed clip.
        from dladmm_tpu_torch.train.fused_adam import make_fused_adam_state, make_fused_adam_step

        check_fused_adam(t, step_fn, forward_fn, nonneg_x)
        train_step = make_fused_adam_step(
            A, t.batch, p.sparsity_x, p.sparsity_e, layer_weights, _lr_of(t), clip_norm=t.clip_norm,
            compute_dtype=compute_dtype, freeze=tuple(t.freeze), B=B, seed=t.seed,
        )
        state = make_fused_adam_state(params, t.clip_norm, compute_dtype)
    else:
        optimizer = _build_optimizer(t)
        train_step = make_train_step(
            optimizer, A, t.batch, p.sparsity_x, p.sparsity_e, B, layer_weights, step_fn,
            forward_fn, freeze=tuple(t.freeze), vjp=getattr(t, "vjp", "auto"),
            accum_steps=getattr(t, "accum_steps", 1), nonneg_x=nonneg_x, seed=t.seed,
            compute_dtype=compute_dtype,
        )
        state = make_train_state(params, optimizer, compute_dtype)
    eval_data = make_batch(g_eval, A, t.eval_batch, p.sparsity_x, p.sparsity_e, dtype, B, nonneg_x)

    def run_eval(st):
        return evaluate(
            st.params, A, eval_data, B, step_fn=step_fn, prox_x=prox_x_fn, prox_z=prox_z_fn,
            use_kernel=t.kernel != "reference",
        )

    if ckpt_dir:
        from dladmm_tpu_torch.utils.checkpoint import latest_step_dir, restore_checkpoint, save_checkpoint

        if resume:
            latest = latest_step_dir(ckpt_dir)
            if latest is not None:
                # Checkpoints hold the three canonical fields; the copy is
                # cast again from the restored masters.
                state = restore_checkpoint(latest, state._replace(compute_params=None))[0]
                if compute_dtype is not None:
                    state = state._replace(compute_params=_cast(state.params, compute_dtype))

    history = []

    def record(step, loss, ev):
        rec = {"step": step, "loss": loss, "nmse_db": ev["nmse_db"], "residual": ev["residual"]}
        history.append({**rec, "curves": ev})
        if log_fn:
            log_fn(rec)

    for i in range(state.step, t.steps):
        state, loss = train_step(state, i)
        if (i + 1) % t.eval_every == 0 or i + 1 == t.steps:
            record(i + 1, float(loss), run_eval(state))
            if ckpt_dir:
                save_checkpoint(ckpt_dir, state._replace(compute_params=None), step=i + 1, A=A, B=B)
    if not history:
        # Resumed at (or past) the final step: report the restored model.
        record(state.step, float("nan"), run_eval(state))
    return state.params, history


def check_fused_adam(t, step_fn=None, forward_fn=None, nonneg_x: bool = False, *, sharded: bool = False,
                     check_kernel: Optional[bool] = None) -> None:
    """The one home of the JAX package's conditions on
    optimizer='fused_adam', raising ValueError. fit's (sharded=False): it
    owns the forward and the manual backward, the delayed clip, one batch
    a step and fp32 moments, l1/l1 only. fit_sharded's (sharded=True):
    the delayed clip, kernel='auto', a manual backward.
    ``check_kernel`` (default: sharded) adds the kernel rule, as run.py
    does for identity B."""
    if step_fn is not None or forward_fn is not None:
        raise ValueError(
            "optimizer='fused_adam' owns the forward (the plain loop) - "
            "pass step_fn=forward_fn=None"
        )
    if t.clip_norm and getattr(t, "clip_mode", "global") != "delayed":
        raise ValueError(
            "optimizer='fused_adam' needs clip_mode='delayed' (or "
            "clip_norm=None): exact global clipping is two-pass and "
            "cannot run inside the backward sweep"
        )
    if (sharded if check_kernel is None else check_kernel) and t.kernel != "auto":
        raise ValueError(
            "optimizer='fused_adam' uses the plain-loop forward; "
            f"kernel={t.kernel!r} does not apply (leave it 'auto')"
        )
    if getattr(t, "vjp", "auto") == "xla":
        raise ValueError(
            "optimizer='fused_adam' IS a manual-backward step; "
            "vjp='xla' contradicts it (use optimizer='adam')"
        )
    if sharded:
        return
    if getattr(t, "accum_steps", 1) != 1:
        raise ValueError(
            "optimizer='fused_adam' applies the update INSIDE the "
            "backward of one batch - gradient accumulation does not "
            "compose; use optimizer='adam' with accum_steps"
        )
    if getattr(t, "moment_dtype", "float32") != "float32":
        raise ValueError(
            "optimizer='fused_adam' owns its (fp32) moment buffers; "
            "moment_dtype applies to optimizer='adam'"
        )
    if nonneg_x:
        raise ValueError(
            "nonneg_x pairs with prox_x='nonneg_l1', which "
            "optimizer='fused_adam' does not cover (l1-only manual "
            "backward); use optimizer='adam'"
        )


GREEDY_STAGE_STRIDE = 1_000_000  # step index of stage k's step i: k * stride + i


def fit_greedy(
    config,
    A: Optional[Tensor] = None,
    log_fn=None,
    steps_per_stage: Optional[int] = None,
    finetune_steps: Optional[int] = None,
    device=None,
):
    """Greedy layer-wise training; returns (params, history).

    Stage k = 1..K trains the k-layer PREFIX with the loss at layer k,
    from stage k-1's trained prefix; layers after k keep their LADMM init
    (the layers' params are untied, so a prefix is the first k rows of
    each stack). Stages use a constant lr and the config's clip, and the
    final-state forward the policy selects (the trajectory and backward
    kernels on the card). Stage k's step i draws its batch from
    ``step_generator(seed, k * GREEDY_STAGE_STRIDE + i)`` (the JAX
    package's ``fold_in(k_train, k * 1_000_000 + i)``). Then ``fit``
    fine-tunes end to end from the stacked result (init_params). By
    default half the step budget goes to the K stages and half to the
    fine-tune. Runs on ``device`` (cuda unless asked otherwise)."""
    import dataclasses

    from dladmm_tpu_torch.data.synthetic import problem_matrices, seed_keys
    from dladmm_tpu_torch.models.api import select_forward
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.utils.platform import resolve_device

    p, t = config.problem, config.train
    if not getattr(p, "identity_B", True):
        raise ValueError(
            "fit_greedy supports the identity-B benchmarks only; train "
            "general-B configs end-to-end via fit() (run.py without "
            "--greedy)"
        )
    if getattr(t, "accum_steps", 1) != 1:
        raise ValueError(
            "fit_greedy does not support gradient accumulation; use the "
            "end-to-end fit()"
        )
    if resolve_prox(p) is not None or getattr(p, "nonneg_x", False):
        raise ValueError(
            "fit_greedy supports the l1/l1 reference instantiation only "
            "(its stage losses use the l1 fast paths); train general-prox "
            "configs end-to-end via fit()"
        )
    device = resolve_device(device)
    _, g_eval, _ = seed_keys(config)
    dtype = getattr(torch, t.dtype)
    if A is not None:
        A = torch.as_tensor(A).to(device, dtype)
    A, _ = problem_matrices(config, A, device=device)
    params = init_dladmm_params(A, K=p.K, beta=p.beta, dtype=dtype)
    per_stage = steps_per_stage or max(1, t.steps // (2 * p.K))
    ft_steps = finetune_steps if finetune_steps is not None else max(0, t.steps - per_stage * p.K)
    # A constant lr for the short stages (a cosine horizon means nothing
    # per stage); the clip stays.
    optimizer = _build_optimizer(dataclasses.replace(t, lr_schedule=None))
    vjp = getattr(t, "vjp", "auto")
    compute_dtype = torch.bfloat16 if t.compute_dtype == "bfloat16" else None
    stage_fwd = None
    if vjp not in ("manual", "xla"):
        stage_fwd = select_forward(p.m, p.n, p.m, t.batch, kernel=t.kernel, device=device,
                                   dtype=t.compute_dtype)[0]

    history = []
    for k in range(1, p.K + 1):
        step = make_train_step(
            optimizer, A, t.batch, p.sparsity_x, p.sparsity_e, forward_fn=stage_fwd,
            freeze=tuple(t.freeze), vjp=vjp, seed=t.seed, compute_dtype=compute_dtype,
        )
        # make_train_state copies the prefix: at k = K the prefix is the
        # whole stack, which the CUDA sweep would otherwise update in place.
        state = make_train_state(DLADMMParams(*(v[:k] for v in params)), optimizer, compute_dtype)
        for i in range(per_stage):
            state, loss = step(state, k * GREEDY_STAGE_STRIDE + i)
        params = DLADMMParams(*(torch.cat([pre, full[k:]]) for full, pre in zip(params, state.params)))
        rec = {"stage": k, "loss": float(loss), "steps": per_stage}
        history.append(rec)
        if log_fn:
            log_fn(rec)

    if ft_steps:
        ft_fwd = None
        if vjp not in ("manual", "xla"):
            ft_fwd = select_forward(p.m, p.n, p.m, t.batch, kernel=t.kernel,
                                    need_trajectory=t.layer_loss is not None, device=device,
                                    dtype=t.compute_dtype)[0]
        ft_cfg = dataclasses.replace(config, train=dataclasses.replace(t, steps=ft_steps))
        params, ft_hist = fit(ft_cfg, A=A, log_fn=log_fn, forward_fn=ft_fwd, init_params=params, device=device)
        history.extend(ft_hist)
    else:
        eval_data = make_batch(g_eval, A, t.eval_batch, p.sparsity_x, p.sparsity_e, dtype)
        ev = evaluate(params, A, eval_data, use_kernel=t.kernel != "reference")
        rec = {"step": per_stage * p.K, "loss": float("nan"), "nmse_db": ev["nmse_db"],
               "residual": ev["residual"], "curves": ev}
        history.append(rec)
        if log_fn:
            log_fn({k_: v for k_, v in rec.items() if k_ != "curves"})
    return params, history


_MOMENT_BYTES = {"float32": 4.0, "bfloat16": 2.0, "bfloat16_sr": 2.0, "bfloat16_sr_mu": 3.0, "int8": 1.02}
LAUNCH = "python -m torch.distributed.run --standalone --nproc_per_node={D} -m dladmm_tpu_torch.run --config={name}"


def check_sharded(config) -> None:
    """fit_sharded's conditions on a config, before anything starts (the
    JAX package's, in its order), raising ValueError."""
    p, t, s = config.problem, config.train, config.sharding
    if resolve_prox(p) is not None or getattr(p, "nonneg_x", False):
        raise ValueError(
            "fit_sharded covers the l1/l1 instantiation only (the per-shard "
            "fast paths and TP collective algebra are l1-specialized); train "
            "general-prox configs single-device via fit()"
        )
    general_b = not getattr(p, "identity_B", True)
    if general_b and s.model_axis > 1:
        raise ValueError(
            "general-B configs shard over 'data' only (the TP collective "
            "layouts assume the z stream lives in R^m - "
            "parallel/collectives.py); use model_axis=1, or identity_B "
            "for tensor parallelism"
        )
    if general_b and t.kernel != "auto":
        raise ValueError(
            "general-B training runs the plain loop + manual general-B "
            f"reverse sweep; kernel={t.kernel!r} does not apply (the kernels "
            "specialize to B = I). Leave kernel='auto'."
        )
    fused = getattr(t, "optimizer", "adam") == "fused_adam"
    if fused:
        if s.model_axis > 1:
            raise ValueError(
                "optimizer='fused_adam' shards over 'data' only: the TP "
                "step's weights live sharded over 'model', but the fused "
                "reverse sweep applies Adam to the full layer slice. Use "
                "optimizer='adam' with model_axis > 1."
            )
        check_fused_adam(t, sharded=True)
    if getattr(t, "accum_steps", 1) != 1:
        raise ValueError(
            "accum_steps > 1 is the single-device fit()'s memory lever; on "
            "a mesh, raise data_axis (more batch shards) instead"
        )
    if getattr(s, "zero1", False):
        if s.model_axis > 1:
            raise ValueError(
                "zero1 (cross-replica weight-update sharding) shards the "
                "optimizer over 'data'; with model_axis > 1 the TP layout "
                "already shards weights AND moments over 'model' "
                "(layout='sharded_w2') - use that instead"
            )
        if fused:
            raise ValueError(
                "zero1 and optimizer='fused_adam' both restructure the "
                "update and do not compose: fused applies Adam inside "
                "the reverse sweep (replicated moments), zero1 shards the "
                "post-backward update. Pick one."
            )
        if t.clip_norm and getattr(t, "clip_mode", "global") == "delayed":
            raise ValueError(
                "zero1's reduce-scatter makes the EXACT global-norm clip "
                "single-pass - clip_mode='delayed' would be a strictly "
                "worse approximation here; use clip_mode='global'"
            )
    if s.model_axis > 1:
        bad = {k: v for k, v in {"kernel": t.kernel, "vjp": getattr(t, "vjp", "auto")}.items() if v != "auto"}
        if bad:
            raise ValueError(
                f"TrainConfig fields {sorted(bad)} have no effect with "
                f"model_axis={s.model_axis}: the TP forward is the "
                "explicit-collective loop (parallel/collectives.py), not "
                "a kernel/vjp-selectable single-device path. Leave them "
                '"auto" (they apply on DP-only meshes).'
            )
        md = getattr(t, "moment_dtype", "float32")
        if md.endswith("_pallas") or md == "int8":
            raise ValueError(
                f"moment_dtype={md!r} does not compose with "
                f"model_axis={s.model_axis}: int8 moment state is not "
                "param-shaped (it cannot be split along the model axis) and "
                "the fused sweep cannot partition across model shards. Use "
                "moment_dtype in {'float32', 'bfloat16', 'bfloat16_sr'} with TP."
            )
        for what, width in (("n", p.n), ("m", p.m if getattr(s, "layout", "sharded_w2") == "sharded_w2" else 0)):
            if width % s.model_axis:
                raise ValueError(f"{what}={width} does not split over model_axis={s.model_axis} ranks")
    for what, rows in (("batch", t.batch), ("eval_batch", t.eval_batch)):
        if rows % s.data_axis:
            raise ValueError(f"{what}={rows} does not split over data_axis={s.data_axis} ranks")


def sharded_audit(config, hbm_bytes: float, print_fn=None):
    """fit_sharded's per-device memory audit of a config
    (parallel/memory.audit_or_raise against ``hbm_bytes``): the breakdown,
    or MemoryError."""
    from dladmm_tpu_torch.parallel.memory import audit_or_raise

    p, t, s = config.problem, config.train, config.sharding
    md = getattr(t, "moment_dtype", "float32")
    return audit_or_raise(
        p.m, p.n, p.K, t.batch, s.data_axis, s.model_axis, getattr(s, "layout", "sharded_w2"),
        dtype_bytes=torch.empty((), dtype=getattr(torch, t.dtype)).element_size(),
        compute_dtype_bytes=2 if t.compute_dtype == "bfloat16" else None,
        hbm_bytes=hbm_bytes,
        print_fn=print_fn,
        d=(p.d or p.m) if not getattr(p, "identity_B", True) else None,
        opt_shard_degree=s.data_axis if getattr(s, "zero1", False) else 1,
        moment_bytes=_MOMENT_BYTES[md.removesuffix("_pallas")],
    )


def fit_sharded(
    config,
    A: Optional[Tensor] = None,
    log_fn=None,
    ckpt_dir: Optional[str] = None,
    resume: bool = False,
    hbm_bytes: Optional[float] = None,
    init_params: Optional[DLADMMParams] = None,
    device=None,
):
    """Sharded training per config.sharding over the ranks of a
    torch.distributed run, on a data_axis x model_axis mesh; returns
    (params, history) on every rank (a rank's slices under tensor
    parallelism).

    One process a rank, launched as
    ``python -m torch.distributed.run --standalone --nproc_per_node=D*T -m
    dladmm_tpu_torch.run --config=...`` (parallel/multihost.
    initialize_distributed reads the launcher's env:// variables); the
    run's world size must equal data_axis * model_axis. The per-device
    memory audit (parallel/memory.audit_or_raise) runs before anything is
    allocated, against ``hbm_bytes`` or the card's memory shared by the
    ranks on it (parallel/multihost.ranks_per_card).

    model_axis == 1: each rank runs the single-device stack on its
    global_batch / D rows: the forward the policy selects at that batch
    (the trajectory kernel and, for the final-layer loss, the backward
    kernel on the card; the plain loop and the manual general-B sweep for
    a general B), then

      * optimizer='fused_adam': parallel/collectives.
        make_dp_fused_adam_step (per-layer all-reduces in the sweep);
      * sharding.zero1: make_dp_zero1_train_step (reduce-scatter, the
        exact clip, the rank's slice of the update, all-gather);
      * else make_dp_train_step (one all-reduce, the same update on
        every rank; the fused CUDA sweep for ``*_pallas`` moments).

    model_axis > 1: the tensor-parallel step (parallel/collectives.
    make_sharded_train_step, layout config.sharding.layout) on the rank's
    slices, built from its own columns of A (init_params_tp), and the
    gather-free make_sharded_eval.

    The step's global batch is drawn as the single-device fit draws it
    (``step_generator(seed, i)``) and each rank keeps its data index's
    rows (and its n-slice of x*), so the run sees the single-device run's
    data; with sharding.multihost each data index draws only its own rows
    (multihost.host_local_batch). The eval batch is fit's, split the same
    way; evaluation adds the ranks' sums. Training starts from
    ``init_params`` where given (as fit's does), else the LADMM init; the
    LADMM curve is the LADMM-init net's.

    With ckpt_dir, rank 0 writes the whole params, the optimizer state
    (ZeRO-1 slices and TP slices gathered: the single-device layout, so
    ``serve --ckpt-dir`` serves it), the step and A (and B) at every eval;
    resume=True restores the latest on every rank, each taking its
    slice."""
    import dataclasses

    from dladmm_tpu_torch.data.synthetic import SyntheticBatch, draw_batch, problem_matrices, seed_keys
    from dladmm_tpu_torch.models.api import select_forward
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.parallel import collectives as coll
    from dladmm_tpu_torch.parallel.memory import detect_hbm_bytes
    from dladmm_tpu_torch.parallel.mesh import make_mesh, model_slice, shard_params_tp
    from dladmm_tpu_torch.parallel.multihost import (
        host_local_batch,
        initialize_distributed,
        make_multihost_mesh,
        rank_batch,
        rank_device,
        ranks_per_card,
        world_size,
    )
    from dladmm_tpu_torch.train.fused_adam import make_fused_adam_state

    check_sharded(config)
    p, t, s = config.problem, config.train, config.sharding
    D, T = s.data_axis, s.model_axis
    rank_dev = initialize_distributed(device) or rank_device(device)  # one rank, no launcher: its device
    if world_size() != D * T:
        raise RuntimeError(
            f"config {config.name!r} is sharded over a {D}x{T} mesh, {D * T} ranks, and this run has "
            f"{world_size()}: launch one process a rank, "
            + LAUNCH.format(D=D * T, name=config.name)
        )
    mesh = make_multihost_mesh(T, rank_dev) if s.multihost else make_mesh(data=D, model=T, devices=[rank_dev])
    is_primary = mesh.rank == 0
    general_b = not getattr(p, "identity_B", True)
    zero1 = getattr(s, "zero1", False)
    fused = getattr(t, "optimizer", "adam") == "fused_adam"
    vjp = getattr(t, "vjp", "auto")
    layout = getattr(s, "layout", "sharded_w2")
    compute_dtype = torch.bfloat16 if t.compute_dtype == "bfloat16" else None
    sharded_audit(config, hbm_bytes or detect_hbm_bytes(rank_dev) / ranks_per_card(rank_dev),
                  print if is_primary else None)

    _, g_eval, _ = seed_keys(config)
    dtype = getattr(torch, t.dtype)
    if A is not None:
        A = torch.as_tensor(A).to(rank_dev, dtype)
    A, B = problem_matrices(config, A, device=rank_dev)
    layer_weights = _layer_weights(t.layer_loss, p.K, torch.float32, rank_dev)

    A_cols = model_slice(A, mesh).contiguous() if T > 1 else A  # the rank's columns of A

    def part(gen, rows):
        """This rank's part of a global batch of ``rows`` drawn from
        ``gen``: its data index's rows, x* its n-slice. Data-parallel
        ranks slice make_batch's batch; a TP rank forms b from its columns
        of A (multihost.rank_batch)."""
        k = rows // D
        r = slice(mesh.data_index * k, (mesh.data_index + 1) * k)
        if T == 1:
            data = make_batch(gen, A, rows, p.sparsity_x, p.sparsity_e, dtype, B)
            return SyntheticBatch(*(v[r] for v in data))
        x_star, e_star = draw_batch(gen, p.m, p.n, rows, p.sparsity_x, p.sparsity_e, dtype)
        return rank_batch(mesh, x_star[r], e_star[r], A_cols)

    def batch_of(i):
        if s.multihost and D > 1:
            return host_local_batch(t.seed, i, A_cols, t.batch, mesh, p.sparsity_x, p.sparsity_e, dtype, B)
        return part(step_generator(t.seed, i), t.batch)

    eval_data = part(g_eval, t.eval_batch)
    optimizer = None
    if T > 1:
        # Each rank's slices, built from its own columns of A; the LADMM
        # curve is read off the init before the state takes its memory,
        # and only rank 0 keeps the whole A (on the host, for checkpoints).
        A_eval = A_cols
        A_c = A_eval if compute_dtype is None else A_eval.to(compute_dtype)
        ladmm = coll.init_params_tp(A, p.K, mesh, layout, p.beta, dtype)
        A = A.cpu() if is_primary else None
        eval_fn = coll.make_sharded_eval(mesh, layout)
        ladmm_curve = eval_fn(ladmm, A_eval, eval_data)["nmse_curve_db"]
        params = ladmm if init_params is None else shard_params_tp(
            DLADMMParams(*(torch.as_tensor(v).to(rank_dev, dtype) for v in init_params)), mesh, layout)
        del ladmm
        optimizer = _build_optimizer(t)
        state = TrainState(params, optimizer.init(params), 0,
                           None if compute_dtype is None else _cast(params, compute_dtype))
        del params
        train_step = coll.make_sharded_train_step(optimizer, mesh, layout, compute_dtype, tuple(t.freeze),
                                                  layer_weights)
    else:
        A_eval = A
        A_c = A if compute_dtype is None else A.to(compute_dtype)
        B_c = B if B is None or compute_dtype is None else B.to(compute_dtype)
        ladmm = init_dladmm_params(A, B, K=p.K, beta=p.beta, dtype=dtype)
        params = ladmm
        if init_params is not None:
            params = DLADMMParams(*(torch.as_tensor(v).to(rank_dev, dtype) for v in init_params))
        eval_fn = coll.make_dp_eval(mesh, B, use_kernel=t.kernel != "reference")
        ladmm_curve = eval_fn(ladmm, A, eval_data)["nmse_curve_db"]
        if fused:
            state = make_fused_adam_state(params, t.clip_norm, compute_dtype)
            train_step = coll.make_dp_fused_adam_step(
                mesh, layer_weights, _lr_of(t), clip_norm=t.clip_norm, compute_dtype=compute_dtype,
                freeze=tuple(t.freeze), B=B_c)
        else:
            forward_fn = None
            if not general_b and vjp not in ("manual", "xla"):
                forward_fn = select_forward(p.m, p.n, p.m, max(1, t.batch // D), kernel=t.kernel,
                                            need_trajectory=t.layer_loss is not None, device=rank_dev,
                                            dtype=t.compute_dtype)[0]
            if zero1:
                # The step owns the exact clip: the optimizer has none.
                optimizer = _build_optimizer(dataclasses.replace(t, clip_norm=None))
                state = coll.make_dp_zero1_state(params, optimizer, mesh, compute_dtype)
                train_step = coll.make_dp_zero1_train_step(
                    optimizer, mesh, clip_norm=t.clip_norm, compute_dtype=compute_dtype,
                    freeze=tuple(t.freeze), layer_weights=layer_weights, forward_fn=forward_fn, vjp=vjp, B=B_c)
            else:
                optimizer = _build_optimizer(t)
                state = make_train_state(params, optimizer, compute_dtype)
                train_step = coll.make_dp_train_step(
                    optimizer, mesh, compute_dtype, tuple(t.freeze), layer_weights, None, forward_fn, vjp,
                    B=B_c)

    z1_layout = coll.zero1_layout(state.params, optimizer, D) if zero1 else None
    if ckpt_dir:
        from dladmm_tpu_torch.utils.checkpoint import latest_step_dir, restore_checkpoint, save_checkpoint

        if resume:
            latest = latest_step_dir(ckpt_dir)
            if latest is not None:
                template = state._replace(compute_params=None)
                if zero1:
                    template = template._replace(opt_state=coll.zero1_global_state(optimizer, z1_layout, rank_dev))
                elif T > 1:
                    template = coll.whole_state_template(template, mesh, layout)
                state = restore_checkpoint(latest, template)[0]
                if zero1:
                    state = state._replace(opt_state=coll.zero1_slice(state.opt_state, z1_layout, mesh.rank))
                elif T > 1:
                    state = coll.shard_state_tp(state, mesh, layout, rank_dev)
                if compute_dtype is not None:
                    state = state._replace(compute_params=_cast(state.params, compute_dtype))

    mesh_desc = f"{D}x{T}"
    history = []

    def record(step, loss):
        ev = eval_fn(state.params, A_eval, eval_data)
        rec = {"step": step, "loss": loss, "nmse_db": ev["nmse_db"], "residual": ev["residual"],
               "mesh": mesh_desc}
        history.append({**rec, "curves": {"nmse_curve_db": ev["nmse_curve_db"], "ladmm_curve_db": ladmm_curve}})
        if log_fn and is_primary:
            log_fn(rec)

    def save(step):
        st = state._replace(compute_params=None)
        if zero1:
            st = st._replace(opt_state=coll.zero1_gather(st.opt_state, z1_layout, mesh))
        elif T > 1 and mesh.data_index == 0:
            st = coll.gather_state_tp(st, mesh, layout)
        if is_primary:
            save_checkpoint(ckpt_dir, st, step=step, A=A, B=B)
        if mesh.distributed:
            import torch.distributed as dist

            dist.barrier(group=mesh.group)

    for i in range(state.step, t.steps):
        state, loss = train_step(state, A_c, batch_of(i))
        if (i + 1) % t.eval_every == 0 or i + 1 == t.steps:
            record(i + 1, float(loss))
            if ckpt_dir:
                save(i + 1)
    if not history:
        # Resumed at (or past) the final step: report the restored model.
        record(state.step, float("nan"))
    return state.params, history


__all__ = [
    "TrainState",
    "adam",
    "apply_updates",
    "chain",
    "clip_by_global_norm",
    "delayed_clip_by_global_norm",
    "evaluate",
    "fit",
    "fit_greedy",
    "fit_sharded",
    "loss_fn",
    "make_train_state",
    "make_train_step",
    "make_train_step_from_batch",
    "scale_by_adam",
    "scale_by_learning_rate",
    "warmup_cosine_decay_schedule",
    "weighted_trajectory_mse",
]
