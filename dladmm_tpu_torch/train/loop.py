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
masters in place instead.

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

Not ported yet (ROADMAP.md §1): ``optimizer="fused_adam"``,
``fit_greedy`` and ``fit_sharded``; each raises NotImplementedError.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from torch import Tensor

from dladmm_tpu_torch.baselines.ladmm import ladmm_run
from dladmm_tpu_torch.data.synthetic import make_batch, step_generator
from dladmm_tpu_torch.metrics.core import constraint_residual, nmse_db, per_layer_nmse_db
from dladmm_tpu_torch.models.unroll import DLADMMParams, dladmm_forward
from dladmm_tpu_torch.ops.prox import resolve_prox
from dladmm_tpu_torch.train.qadam_cuda import QAdamFused, WarmupCosine, global_norm

_LATER = "is not ported yet; it is a later slice of the port (ROADMAP.md §1)"


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
        count = state.count + 1
        cf = count.to(torch.float32)
        c1, c2 = 1 - torch.pow(b1, cf), 1 - torch.pow(b2, cf)
        out = kind(*((m / c1) / (torch.sqrt(v / c2) + eps) for m, v in zip(mu, nu)))
        return out, AdamState(count, mu, nu)

    return GradientTransformation(init, update)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    """optax.adam: scale_by_adam then scale_by_learning_rate, fp32 moments."""
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(learning_rate))


def scale_by_learning_rate(learning_rate) -> GradientTransformation:
    """optax.scale_by_learning_rate: updates * -lr(count), the count the
    step's own (pre-increment)."""

    def init(params):
        return _count0(params)

    def update(grads, count, params=None):
        lr = learning_rate(count) if callable(learning_rate) else learning_rate
        return type(grads)(*(g * -lr for g in grads)), count + 1

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax.clip_by_global_norm: t, or t / norm * max_norm above the
    limit (the norm cast to t's dtype first, as optax does: bf16 gradients
    stay bf16)."""

    def update(grads, state, params=None):
        norm = global_norm(grads)
        trigger = norm < max_norm
        return type(grads)(*(torch.where(trigger, g, (g / norm.to(g.dtype)) * max_norm) for g in grads)), state

    return GradientTransformation(lambda params: (), update)


def delayed_clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Global-norm clipping with a one-step-delayed norm: step i is
    scaled by step i-1's norm (step 0 unclipped), so the norm reduction
    and the scaled update touch each gradient once (the JAX package's
    single-pass variant)."""

    def init(params):
        return DelayedClipState(torch.full((), max_norm, dtype=torch.float32, device=params[0].device))

    def update(grads, state, params=None):
        cur = global_norm(grads).to(torch.float32)
        scale = torch.clamp(max_norm / torch.clamp(state.prev_norm, min=1e-16), max=1.0)
        return type(grads)(*(g * scale.to(g.dtype) for g in grads)), DelayedClipState(cur)

    return GradientTransformation(init, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new.append(s)
        return grads, tuple(new)

    return GradientTransformation(init, update)


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


def _apply(optimizer, state: TrainState, grads: DLADMMParams, freeze=(), compute_dtype=None) -> TrainState:
    """The optimizer step on the masters; with a compute copy in the state
    the copy too: the fused sweep writes it in its pass, a plain
    optimizer's new masters are cast again."""
    if freeze:
        grads = DLADMMParams(*(
            torch.zeros_like(g) if name in freeze else g for name, g in zip(grads._fields, grads)
        ))
    cp = state.compute_params
    if hasattr(optimizer, "fused_apply"):
        params, opt_state, cp = optimizer.fused_apply(
            grads, state.opt_state, state.params, compute_dtype if cp is not None else None, cp)
    else:
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
            params = apply_updates(state.params, updates)
            cp = None if cp is None else _cast(params, compute_dtype)
    return TrainState(params, opt_state, state.step + 1, cp)


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
    ``step_generator(seed, i, j)`` each) and applies their mean."""
    if accum_steps < 1 or batch % accum_steps:
        raise ValueError(f"accum_steps={accum_steps} must divide batch={batch}")
    micro = batch // accum_steps
    freeze = tuple(freeze)
    grad = _grad_fn(A, B, layer_weights, dict(step_fn=step_fn, forward_fn=forward_fn, vjp=vjp), compute_dtype)

    def grad_of(state, gen):
        data = make_batch(gen, A, micro, sparsity_x, sparsity_e, A.dtype, B, nonneg_x)
        return grad(state, data.b, data.x_star, data.e_star)

    def train_step(state: TrainState, i: int):
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

    The l1/l1, B = I net runs through the trajectory kernel without its
    Ax stack (ops/cuda_traj.trajectory_forward; its plain version on the
    CPU) unless use_kernel=False; other configs run the plain loop. The
    JAX package's eval uses its scan: the two compute the same function.
    Returns plain Python floats and lists."""
    K = params.W1.shape[0]
    if use_kernel and B is None and step_fn is None:
        from dladmm_tpu_torch.ops.cuda_traj import trajectory_forward

        tx, tz, _ = trajectory_forward(data.b, A, *params)
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
    if getattr(t, "optimizer", "adam") == "fused_adam":
        raise NotImplementedError(f"optimizer='fused_adam' (train/fused_adam.py) {_LATER}")
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
        if getattr(t, "vjp", "auto") != "auto":
            raise ValueError("general-prox configs route through autograd automatically; leave vjp='auto'")
        from dladmm_tpu_torch.ops.reference import make_cached_step

        prox_x_fn, prox_z_fn = prox
        step_fn = make_cached_step(prox_x_fn, prox_z_fn)

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


def fit_greedy(*args, **kwargs):
    raise NotImplementedError(f"fit_greedy (greedy layer-wise training) {_LATER}")


def fit_sharded(*args, **kwargs):
    raise NotImplementedError(f"fit_sharded (DP/TP training on torch.distributed) {_LATER}")


__all__ = [
    "TrainState",
    "adam",
    "apply_updates",
    "chain",
    "clip_by_global_norm",
    "delayed_clip_by_global_norm",
    "evaluate",
    "fit",
    "loss_fn",
    "make_train_state",
    "make_train_step",
    "make_train_step_from_batch",
    "scale_by_adam",
    "scale_by_learning_rate",
    "warmup_cosine_decay_schedule",
    "weighted_trajectory_mse",
]
