"""Hand-written backward for the whole K-layer unroll.

The port of ``dladmm_tpu/ops/unroll_vjp.py``. The D-LADMM layer's
backward needs none of autograd's saved intermediates: every one is
elementwise-recomputable from the carry trajectory alone,

    u_k = Ax_k     + z_k - b + lam_k / beta     (layer inputs)
    v_k = Ax_{k+1} + z_k - b + lam_k / beta     (Ax_{k+1} is the next carry)
    shrink masks / signs = support / sign of x_{k+1}, z_{k+1}

so ``bwd_from_carries`` walks the layers in reverse and rebuilds u, v
and the masks on the fly from the (x, z, lam, Ax) trajectory. Its six
contractions per layer are plain ``torch.matmul`` (the JAX package left
them to XLA too). It serves three callers:

  * ``dladmm_unroll_manual`` / ``dladmm_unroll_manual_general``: the
    plain-loop forward with this backward, final-state loss;
  * ``dladmm_traj_manual_general``: general-B trajectory (deep
    supervision), per-layer cotangents folded in as the sweep passes;
  * the CUDA kernels' autograd Functions (ops/cuda_traj.py), which feed
    it the trajectory the kernel wrote, so nothing is recomputed, for
    the per-layer (deep-supervision) cotangents; and, as
    ops/cuda_bwd.unroll_bwd_plain, the plain version of the backward
    kernel of the final-state loss.

Tie rules follow ``jnp.maximum``: the gradient of max(a, c) is split
0.5/0.5 at a == c (``_max_grad``), at theta = 0 and beta = _BETA_MIN.
The data cotangents (gA, gB, gb) are computed only when the caller
asks for them (``ctx.needs_input_grad``); JAX left that to dead-code
elimination.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from dladmm_tpu_torch.models.unroll import DLADMMParams
from dladmm_tpu_torch.ops.reference import (
    _BETA_MIN,
    LayerParams,
    dladmm_layer_step_cached,
)


def _mn(a: Tensor, M: Tensor) -> Tensor:  # (S, k) x (k, j) -> (S, j)
    return a @ M


def _outer(a: Tensor, c: Tensor) -> Tensor:  # (S, j)^T x (S, k) -> (j, k)
    return a.T @ c


def _unbroadcast(g: Tensor, shape) -> Tensor:
    """Sum-reduce a full-shape gradient back to a broadcastable param
    shape ((n,) or (1,) per layer: the (K, n) and (K, 1) threshold
    forms)."""
    shape = tuple(shape)
    if tuple(g.shape) == shape:
        return g
    extra = g.ndim - len(shape)
    if extra:
        g = g.sum(dim=tuple(range(extra)))
    axes = tuple(
        i for i, (gd, sd) in enumerate(zip(g.shape, shape)) if sd == 1 and gd != 1
    )
    return g.sum(dim=axes, keepdim=True) if axes else g


def _max_grad(a: Tensor, c: float, g: Tensor) -> Tensor:
    """Gradient of max(a, c) w.r.t. a, with jnp.maximum's tie rule
    (ties split the cotangent evenly)."""
    return g * ((a > c).to(g.dtype) + 0.5 * (a == c).to(g.dtype))


def bwd_layer(p: LayerParams, r, cts, A: Tensor, b: Tensor, B: Optional[Tensor] = None, acc=None):
    """One layer of the reverse sweep (the module-docstring algebra).

    cts: cotangents flowing in from layer k+1 as (gx, gz, glam, gAx);
    r: layer k's residuals (6-tuple for B=None, 8-tuple for general B;
    see ``bwd_from_carries``). acc: optional data-cotangent accumulators,
    (gA, gb) for B=None and (gA, gB, gb) for general B; when None the
    A/B/b products are never computed.

    Returns (new_cts, gparams, new_acc)."""
    gx, gz, glam, gAx = cts
    if B is None:
        (lam_in, Ax_in, z_in, x1, z1, Ax1) = r
        Bz_in, Bz1 = z_in, z1
        if acc is not None:
            gA, gb = acc
    else:
        (lam_in, Ax_in, Bz_in, z_in, x1, z1, Ax1, Bz1) = r
        if acc is not None:
            gA, gB, gb = acc
    beta_raw = p.beta
    beta = torch.maximum(beta_raw, beta_raw.new_tensor(_BETA_MIN))
    ib = 1.0 / beta
    base = Bz_in - b + lam_in * ib
    u = Ax_in + base
    v = Ax1 + base
    r1 = Ax1 + Bz1 - b  # dual residual in lam1 = lam + beta*r1

    # lam1 = lam_in + beta * (Ax1 + B z1 - b)
    glam1 = glam
    gbeta = torch.sum(glam1 * r1)
    gBz1 = beta * glam1
    if B is None:
        gz1 = gz + gBz1
    else:
        gz1 = gz + _mn(gBz1, B)
        if acc is not None:
            gB = gB + _outer(gBz1, z1)
    gAx1 = gAx + beta * glam1
    glam_in = glam1

    # z1 = shrink(z_in - v @ W2^T, max(theta2, 0))
    gp2 = gz1 * (z1 != 0).to(gz1.dtype)
    gth2 = _max_grad(p.theta2, 0.0, _unbroadcast(-(gp2 * torch.sign(z1)), p.theta2.shape))
    gz_in = gp2
    gv = -_mn(gp2, p.W2)
    gW2 = -_outer(gp2, v)

    # v = Ax1 + base
    gAx1 = gAx1 + gv
    gbase = gv

    # Ax1 = x1 @ A^T
    gx1 = gx + _mn(gAx1, A)
    if acc is not None:
        gA = gA + _outer(gAx1, x1)

    # x1 = shrink(x_in - u @ W1^T, max(theta1, 0))
    gp1 = gx1 * (x1 != 0).to(gx1.dtype)
    gth1 = _max_grad(p.theta1, 0.0, _unbroadcast(-(gp1 * torch.sign(x1)), p.theta1.shape))
    gx_in = gp1
    gu = -_mn(gp1, p.W1)
    gW1 = -_outer(gp1, u)

    # u = Ax_in + base
    gAx_in = gu
    gbase = gbase + gu

    # base = B z_in - b + lam_in / beta
    if B is None:
        gz_in = gz_in + gbase
    else:
        gz_in = gz_in + _mn(gbase, B)
        if acc is not None:
            gB = gB + _outer(gbase, z_in)
    if acc is not None:
        gb = gb - gbase - beta * glam1
    glam_in = glam_in + gbase * ib
    gbeta = gbeta - torch.sum(gbase * lam_in) * ib * ib
    gbeta_raw = _max_grad(beta_raw, _BETA_MIN, gbeta)

    new_cts = (gx_in, gz_in, glam_in, gAx_in)
    if acc is None:
        new_acc = None
    elif B is None:
        new_acc = (gA, gb)
    else:
        new_acc = (gA, gB, gb)
    return new_cts, LayerParams(gW1, gW2, gth1, gth2, gbeta_raw), new_acc


def bwd_from_carries(
    params: DLADMMParams,
    A: Tensor,
    b: Tensor,
    resid,
    final_cts: Tuple[Tensor, Tensor, Tensor],
    traj_cts: Optional[Tuple[Tensor, Tensor, Tensor]] = None,
    B: Optional[Tensor] = None,
    data_grads: bool = True,
):
    """Reverse sweep over the layers from per-layer residuals.

    resid: (K, ...)-stacked tensors; with B=None a 6-tuple (lam_in,
      Ax_in, z_in, x1, z1, Ax1), with general B an 8-tuple (lam_in,
      Ax_in, Bz_in, z_in, x1, z1, Ax1, Bz1): layer k's input pieces and
      outputs. ``shifted_residuals`` builds the 6-tuple from an output
      trajectory.
    final_cts: cotangents (gx, gz, glam) of the final state.
    traj_cts: optional per-layer cotangents on the (x_k, z_k, lam_k)
      stacks (deep supervision / trajectory loss).
    data_grads: False skips gA/gB/gb (returned as None).

    Returns (gparams, gA, gb) for B=None, or (gparams, gA, gB, gb)."""
    gx, gz, glam = final_cts
    S, m = b.shape
    n = params.W1.shape[1]
    d = params.W2.shape[-2]
    gAx = torch.zeros((S, m), dtype=b.dtype, device=b.device)
    acc = None
    if data_grads:
        acc = (b.new_zeros((m, n)),)
        if B is not None:
            acc = acc + (b.new_zeros((m, d)),)
        acc = acc + (b.new_zeros((S, m)),)
    K = params.W1.shape[0]
    gps = [None] * K
    for k in range(K - 1, -1, -1):
        if traj_cts is not None:
            # This layer's outputs also feed the loss directly.
            ctx, ctz, ctlam = traj_cts
            gx, gz, glam = gx + ctx[k], gz + ctz[k], glam + ctlam[k]
        r = tuple(t[k] for t in resid)
        (gx, gz, glam, gAx), gps[k], acc = bwd_layer(
            params.layer(k), r, (gx, gz, glam, gAx), A, b, B, acc
        )
    gparams = DLADMMParams(*(torch.stack(g) for g in zip(*gps)))
    if acc is None:
        acc = (None, None) if B is None else (None, None, None)
    return (gparams, *acc)


def shifted_residuals(tx: Tensor, tz: Tensor, tlam: Tensor, tax: Tensor):
    """bwd_from_carries residuals from an output trajectory: layer k's
    inputs are layer k-1's outputs (zeros for k = 0)."""

    def shift(t):
        return torch.cat([torch.zeros_like(t[:1]), t[:-1]])

    return (shift(tlam), shift(tax), shift(tz), tx, tz, tax)


def _fwd_scan(params: DLADMMParams, A, b, B=None):
    """Plain forward from zero state that also returns the residuals in
    bwd_from_carries' layout, and the per-layer lam1 stack."""
    S = b.shape[0]
    n = params.W1.shape[1]
    d = params.W2.shape[-2]
    x = b.new_zeros((S, n))
    z = b.new_zeros((S, d))
    lam = torch.zeros_like(b)
    Ax = torch.zeros_like(b)
    Bz = torch.zeros_like(b)
    ys, tlam = [], []
    for k in range(params.K):
        x1, z1, lam1, Ax1, Bz1 = dladmm_layer_step_cached(
            A, B, b, x, z, lam, Ax, Bz, params.layer(k)
        )
        if B is None:
            ys.append((lam, Ax, z, x1, z1, Ax1))
        else:
            ys.append((lam, Ax, Bz, z, x1, z1, Ax1, Bz1))
        tlam.append(lam1)
        x, z, lam, Ax, Bz = x1, z1, lam1, Ax1, Bz1
    resid = tuple(torch.stack(s) for s in zip(*ys))
    return (x, z, lam), resid, torch.stack(tlam)


def _param_grads(gparams: DLADMMParams, params) -> tuple:
    """Cast each leaf's gradient to its parameter's shape (per-layer
    (1,) thresholds stack to (K, 1), as stored)."""
    return tuple(g.reshape(p.shape) for g, p in zip(gparams, params))


class _UnrollManual(torch.autograd.Function):
    """(W1, W2, th1, th2, beta, A, b[, B]) -> (x_K, z_K, lam_K)."""

    @staticmethod
    def forward(ctx, W1, W2, th1, th2, beta, A, b, B=None):
        params = DLADMMParams(W1, W2, th1, th2, beta)
        out, resid, _ = _fwd_scan(params, A, b, B)
        ctx.save_for_backward(W1, W2, th1, th2, beta, A, b, B, *resid)
        return out

    @staticmethod
    def backward(ctx, gx, gz, glam):
        W1, W2, th1, th2, beta, A, b, B, *resid = ctx.saved_tensors
        params = DLADMMParams(W1, W2, th1, th2, beta)
        return _backward(ctx, params, A, b, B, resid, (gx, gz, glam), None)


class _TrajManualGeneral(torch.autograd.Function):
    """(W1, W2, th1, th2, beta, A, b, B) -> (tx, tz, tlam) stacks."""

    @staticmethod
    def forward(ctx, W1, W2, th1, th2, beta, A, b, B):
        params = DLADMMParams(W1, W2, th1, th2, beta)
        _, resid, tlam = _fwd_scan(params, A, b, B)
        ctx.save_for_backward(W1, W2, th1, th2, beta, A, b, B, *resid)
        return resid[4], resid[5], tlam

    @staticmethod
    def backward(ctx, gtx, gtz, gtlam):
        W1, W2, th1, th2, beta, A, b, B, *resid = ctx.saved_tensors
        params = DLADMMParams(W1, W2, th1, th2, beta)
        zeros = (torch.zeros_like(gtx[-1]), torch.zeros_like(gtz[-1]), torch.zeros_like(gtlam[-1]))
        return _backward(ctx, params, A, b, B, resid, zeros, (gtx, gtz, gtlam))


def _backward(ctx, params, A, b, B, resid, final_cts, traj_cts):
    """Shared backward of the Functions whose inputs are (W1, W2, th1,
    th2, beta, A, b[, B]): the data gradients only where asked for."""
    need = ctx.needs_input_grad
    out = bwd_from_carries(
        params, A, b, resid, final_cts, traj_cts, B=B, data_grads=any(need[5:])
    )
    gparams = out[0]
    if B is None:
        gA, gb = out[1:]
        data = (gA, gb, None)
    else:
        gA, gB, gb = out[1:]
        data = (gA, gb, gB)  # the inputs' order: A, b, B
    grads = _param_grads(gparams, params) + tuple(
        g if n else None for g, n in zip(data, need[5:8])
    )
    return grads[: len(need)]


def dladmm_unroll_manual(params: DLADMMParams, A: Tensor, b: Tensor):
    """K-layer unroll (B = I), final state only, with the manual
    backward. The same function as ``dladmm_forward(params, A, b)``;
    returns (x_K, z_K, lam_K)."""
    return _UnrollManual.apply(*params, A, b)


def dladmm_unroll_manual_general(params: DLADMMParams, A: Tensor, B: Tensor, b: Tensor):
    """K-layer unroll with a general z-dictionary B (m, d), final state
    only, manual backward with the two extra B^T contractions per layer
    and a gB accumulator. Returns (x_K, z_K, lam_K)."""
    return _UnrollManual.apply(*params, A, b, B)


def dladmm_traj_manual_general(params: DLADMMParams, A: Tensor, B: Tensor, b: Tensor):
    """General-B trajectory (deep supervision): the stacked per-layer
    (x, z, lam) of shape (K, S, .), with the manual backward folding the
    per-layer cotangents."""
    return _TrajManualGeneral.apply(*params, A, b, B)


__all__ = [
    "bwd_from_carries",
    "bwd_layer",
    "dladmm_traj_manual_general",
    "dladmm_unroll_manual",
    "dladmm_unroll_manual_general",
    "shifted_residuals",
]
