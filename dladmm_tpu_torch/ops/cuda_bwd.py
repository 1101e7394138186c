"""Reverse sweep of the unroll for the final-state loss: the CUDA kernel,
its plain version and the batch-split policy.

The port of ``dladmm_tpu/ops/pallas_bwd.py``: ``_bwd_kernel`` (whole
batch, driven by ``unroll_bwd_pallas``) and ``_bwd_kernel_chunked``
(batch tiles of bs rows with fp32 cross-tile accumulation of the
parameter gradients, driven by ``unroll_bwd_pallas_chunked``). Both are
the one entry ``dladmm_unroll_bwd`` of ``csrc/unroll_bwd.cu``; its design,
bound, race and determinism notes are at the top of that file.

``unroll_bwd`` is the one entry here: on CUDA tensors it launches the
kernel or raises; on CPU tensors it runs ``unroll_bwd_plain``, which is
``ops/unroll_vjp.bwd_from_carries`` on the same trajectory (bf16:
``unroll_bwd_plain_bf16``, the rule of the TPU kernels on bf16 refs). It reads the
forward's stacks tx, tz, tlam, tAx (ops/cuda_traj.trajectory_forward
with ``with_tax``), so nothing of the forward is recomputed. l1/l1 and
B = I only, as the TPU kernels.

Design. One persistent cooperative launch runs the V, X, U chain of
all K layers with grid barriers; a second launch computes all K layers'
weight gradients from the gp1 and gp2 stacks the chain stored; a third
finishes gθ and gβ. The chain's grid and the depth split of each phase
come from ``ops/schedule.bwd_schedule``; a grid the card cannot hold
resident is refused by the launch and raises here.

Batch split. The TPU gates (``bwd_fits_vmem``, and ``bwd_chunk_batch``
as a VMEM fit) are dropped: the CUDA kernel keeps the cotangent state in
device memory and streams every operand through shared-memory tiles, so
it runs at every shape. ``bwd_chunk_batch`` is re-derived for Hopper by
the occupancy of the weight-gradient launch (``bwd_weights``), which
reduces over the batch inside each block: one block per (layer, 32 x 32
tile), K x ``schedule.weight_tiles(m, n)`` blocks, each with a loop over
S. When that is under one wave of the card (``weight_wave``: its
resident blocks a SM, from cudaOccupancyMaxActiveBlocksPerMultiprocessor,
times the SMs), splitting S into slices of bs rows multiplies its blocks
by S / bs (each slice writes an fp32 partial, summed in slice order).
``bs < S`` is the chunked route, counted apart from the whole-batch
route.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch
from torch import Tensor

from dladmm_tpu_torch.models.unroll import DLADMMParams
from dladmm_tpu_torch.ops import cuda_build, schedule
from dladmm_tpu_torch.ops.cuda_unroll import _rounded, kernel_args, storage_dtype
from dladmm_tpu_torch.ops.reference import _BETA_MIN
from dladmm_tpu_torch.ops.unroll_vjp import _param_grads, bwd_from_carries, shifted_residuals
from dladmm_tpu_torch.utils.profiling import check_kernel_outputs

SRC = cuda_build.CSRC / "unroll_bwd.cu"
ROUTES = ("whole", "chunked")
MIN_SPLIT_BATCH = 256

_count_lock = threading.Lock()

_ARGTYPES = ([ctypes.c_void_p] * 22 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 6
             + [ctypes.c_void_p])
# dladmm_unroll_bwd_bf16: a bf16 beta and a bf16 gbeta pointer more.
_ARGTYPES_BF16 = ([ctypes.c_void_p] * 24 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 6
                  + [ctypes.c_void_p])


def weight_wave(device: torch.device, bf16: bool = False) -> int:
    """Blocks of the weight-gradient launch (its fp32 or, with ``bf16``,
    its bf16-storage instantiation) the card holds at once: its resident
    blocks a SM times the SMs (on the H100 at 48 registers a thread,
    5 x 132 = 660)."""
    bps, sms = cuda_build.occupancy(SRC, "dladmm_bwd_weights_occupancy", device.index or 0, int(bf16))
    return bps * sms


def bwd_chunk_batch(m: int, n: int, d: int, S: int, K: int, wave: int) -> Optional[int]:
    """Rows per batch slice of the weight gradients, or None for the
    whole-batch route.

    Rule (Hopper occupancy, not a memory fit): split only when S >= 256
    and the unsplit weight-gradient launch, one block a tile of all K
    layers, is under one ``wave`` of the card (``K *
    schedule.weight_tiles(m, n) < wave``; ``weight_wave``). Then bs is
    the largest of 512, 256, 128 below S whose split fills a wave, else
    128. On the H100 (wave 660) synthetic_small (K = 15 layers of 192
    blocks: 2880) and synthetic_large (K = 20 of 3040) never split; the
    smoke preset (K = 4 of 3) splits a batch of 1024 into slices of 128.
    B = I (d == m) only, as the TPU's chunked kernel."""
    if d != m:
        return None
    blocks = K * schedule.weight_tiles(m, n)
    if S < MIN_SPLIT_BATCH or blocks >= wave:
        return None
    for bs in (512, 256, 128):
        if bs < S and blocks * schedule.cdiv(S, bs) >= wave:
            return bs
    return 128


def unroll_bwd_plain(b, A, W1, W2, th1, th2, beta, tx, tz, tlam, tax, gx, gz, glam,
                     bs: Optional[int] = None, data_grads: bool = False):
    """The kernel's function in plain PyTorch: bwd_from_carries on the
    trajectory, layer k's inputs taken from slice k-1 (zeros for k = 0).
    Same arguments and results as ``unroll_bwd``; ``bs`` changes only
    the kernel's order of summation and is ignored here."""
    del bs
    params = DLADMMParams(W1, W2, th1, th2, beta)
    gparams, gA, gb = bwd_from_carries(
        params, A, b, shifted_residuals(tx, tz, tlam, tax), (gx, gz, glam), data_grads=data_grads
    )
    return DLADMMParams(*_param_grads(gparams, params)), gA, gb


def _tie(t: Tensor, at: float) -> Tensor:
    """jnp.maximum's split of a tie's gradient: 1 above ``at``, 0.5 at it."""
    return (t > at).float() + 0.5 * (t == at).float()


def unroll_bwd_plain_bf16(b, A, W1, W2, th1, th2, beta, tx, tz, tlam, tax, gx, gz, glam,
                          bs: Optional[int] = None, data_grads: bool = False):
    """The bf16 kernel's function in plain PyTorch, the rule of the JAX
    package's ``_bwd_kernel`` and ``_bwd_kernel_chunked`` on bf16 refs
    (pallas_bwd.py): every input (stacks, cotangents, weights) widened
    exactly; the cotangent state carried in fp32 across the layers; the
    activation rounded to bf16 only where it meets a bf16 weight or A
    (``dot32``: gv = -round(gp2) W2, gx1 += round(gAx1) A,
    gu = -round(gp1) W1); gW2 = -gp2^T v and gW1 = -gp1^T u in fp32 (their
    other operand is fp32); each gradient rounded once on output (gbeta
    through fp32, then to beta's dtype), the gAx1 stack stored in bf16.
    gb (``data_grads``): on the whole-batch route (``bs`` None or >= S)
    accumulated in bf16 layer by layer, as ``_bwd_kernel`` does; on the
    chunked route in fp32 and rounded once. Returns what ``unroll_bwd``
    returns, in bf16 (gbeta in beta's dtype).

    Not the same function as ``unroll_bwd_plain`` on bf16 tensors
    (bwd_from_carries, every operation rounded)."""
    K = W1.shape[0]
    S, m = b.shape
    th1_p, th2_p, beta_p = th1, th2, beta
    n = W1.shape[1]
    th1, th2 = th1.reshape(K, -1).float().expand(K, n), th2.reshape(K, -1).float().expand(K, m)
    beta = beta.reshape(K).float()
    b, A = b.float(), A.float()
    gx, gz, glam = gx.float(), gz.float(), glam.float()
    gax = torch.zeros_like(b)
    gb = torch.zeros_like(b)
    whole = bs is None or bs >= S
    zero = torch.zeros_like(b)
    out = {name: [None] * K for name in ("W1", "W2", "th1", "th2", "beta", "gax1")}
    for k in range(K - 1, -1, -1):
        beta_raw = beta[k]
        bt = torch.clamp(beta_raw, min=_BETA_MIN)
        ib = 1.0 / bt
        x1, z1, ax1 = tx[k].float(), tz[k].float(), tax[k].float()
        z_in, lam_in, ax_in = ((zero, zero, zero) if k == 0
                               else (tz[k - 1].float(), tlam[k - 1].float(), tax[k - 1].float()))
        base = z_in - b + lam_in * ib
        u = ax_in + base
        v = ax1 + base
        gbeta = torch.sum(glam * (ax1 + z1 - b))
        gz1 = gz + bt * glam
        gax1 = gax + bt * glam
        gp2 = gz1 * (z1 != 0).float()
        out["th2"][k] = -torch.sum(gp2 * torch.sign(z1), dim=0) * _tie(th2[k], 0.0)
        gv = -(_rounded(gp2) @ W2[k].float())
        out["W2"][k] = -(gp2.T @ v)
        gax1 = gax1 + gv
        gbase = gv
        out["gax1"][k] = gax1.to(torch.bfloat16)
        gx1 = gx + _rounded(gax1) @ A
        gp1 = gx1 * (x1 != 0).float()
        out["th1"][k] = -torch.sum(gp1 * torch.sign(x1), dim=0) * _tie(th1[k], 0.0)
        gu = -(_rounded(gp1) @ W1[k].float())
        out["W1"][k] = -(gp1.T @ u)
        gbase = gbase + gu
        if whole:
            gb = _rounded(gb + _rounded(-gbase - bt * glam))
        else:
            gb = gb + (-gbase - bt * glam)
        gbeta = gbeta - torch.sum(gbase * lam_in) * ib * ib
        out["beta"][k] = gbeta * _tie(beta_raw, _BETA_MIN)
        gx, gz, glam, gax = gp1, gp2 + gbase, glam + gbase * ib, gu
    bf = torch.bfloat16
    gparams = DLADMMParams(
        torch.stack(out["W1"]).to(bf), torch.stack(out["W2"]).to(bf),
        _reduce_theta(torch.stack(out["th1"]).to(bf), th1_p), _reduce_theta(torch.stack(out["th2"]).to(bf), th2_p),
        torch.stack(out["beta"]).to(beta_p.dtype).reshape(beta_p.shape),
    )
    if not data_grads:
        return gparams, None, None
    return gparams, gA_bf16(torch.stack(out["gax1"]), tx), gb.to(bf)


def gA_bf16(gax1: Tensor, tx: Tensor) -> Tensor:
    """gA = sum_k gAx1_k^T x1_k from bf16 stacks as the JAX package forms
    it (pallas_bwd.py:312-314): each layer's product rounded to bf16, their
    sum over the layers taken in fp32 and rounded once."""
    return torch.bmm(gax1.transpose(1, 2), tx).sum(dim=0)


def _reduce_theta(g: Tensor, like: Tensor) -> Tensor:
    """The kernel's (K, n) threshold gradient -> the parameter's shape
    ((K, n), or (K, 1) for scalar thresholds), as ``red`` in
    pallas_bwd.py:297-301."""
    if tuple(like.shape) != tuple(g.shape):
        g = g.sum(dim=-1, keepdim=True)
    return g.reshape(like.shape)


def unroll_bwd(b, A, W1, W2, th1, th2, beta, tx, tz, tlam, tax, gx, gz, glam,
               bs: Optional[int] = None, data_grads: bool = False):
    """Gradients of a loss of the final state (x_K, z_K, lam_K) of the
    K-layer unroll (l1/l1, B = I) -> (gparams, gA, gb).

    b (S, m), A (m, n), W1 (K, n, m), W2 (K, m, m), th1 (K, n) or (K, 1),
    th2 (K, m) or (K, 1), beta (K,); the forward's stacks tx (K, S, n),
    tz, tlam, tax (K, S, m); the cotangents gx (S, n), gz, glam (S, m) of
    the final state. gparams holds each leaf's gradient in its
    parameter's shape. With ``data_grads`` also gA (m, n) and gb (S, m),
    else both None: the kernel writes the gAx1 stack and accumulates gb,
    and gA = sum_k gAx1_k^T x1_k is one einsum here, formed outside the
    kernel as in pallas_bwd.py:312-314.

    ``bs`` (rows per batch slice of the weight gradients): None or
    bs >= S is the whole-batch route, bs < S the chunked route. CUDA
    tensors launch the kernel, counted in ``unroll_bwd.launches[route]``
    (bf16 storage: ``launches_bf16[route]``), and leave the plan it
    launched with in ``unroll_bwd.last_plan`` ((blocks a SM, SMs), chain
    grid, {phase: Split}, WeightSplit); CPU tensors run the plain version.

    The storage type is b's, float32 or bfloat16 (``storage_dtype``; beta
    float32 or b's), and the stacks and cotangents are in it too. bf16
    (bf16 training) runs the kernel's bf16 variant, whose plain version is
    ``unroll_bwd_plain_bf16``; its gradients are bf16, gbeta in beta's
    dtype."""
    if b.device.type == "cpu":
        if storage_dtype(b, A, W1, W2, th1, th2, beta) == torch.bfloat16:
            return unroll_bwd_plain_bf16(b, A, W1, W2, th1, th2, beta, tx, tz, tlam, tax, gx, gz, glam,
                                         bs, data_grads)
        return unroll_bwd_plain(b, A, W1, W2, th1, th2, beta, tx, tz, tlam, tax, gx, gz, glam,
                                bs, data_grads)
    if b.device.type != "cuda":
        raise ValueError(f"unsupported device {b.device}")
    th1_p, th2_p, beta_p = th1, th2, beta
    b, A, W1, W2, th1, th2, beta = kernel_args(b, A, W1, W2, th1, th2, beta)
    dt = b.dtype
    bf16 = dt == torch.bfloat16
    th1, th2 = th1.contiguous(), th2.contiguous()  # this kernel reads (K, n) / (K, m) rows
    S, m = b.shape
    K, n, _ = W1.shape
    if bs is None or bs >= S:
        bs, route = S, "whole"
    elif bs < 1:
        raise ValueError(f"bs must be >= 1, got {bs}")
    else:
        route = "chunked"
    stacks = {"tx": (tx, (K, S, n)), "tz": (tz, (K, S, m)), "tlam": (tlam, (K, S, m)),
              "tax": (tax, (K, S, m)), "gx": (gx, (S, n)), "gz": (gz, (S, m)),
              "glam": (glam, (S, m))}
    ins = []
    for name, (t, shape) in stacks.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != b.device or t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; the kernel takes b's {dt} on {b.device}")
        ins.append(t.contiguous())
    dev = b.device.index
    launch = (cuda_build.entry(SRC, "dladmm_unroll_bwd_bf16", _ARGTYPES_BF16) if bf16
              else cuda_build.entry(SRC, "dladmm_unroll_bwd", _ARGTYPES))
    occ = cuda_build.occupancy(SRC, "dladmm_bwd_occupancy", dev, int(bf16))
    grid, sp, wsplit, lay = schedule.bwd_plan(S, m, n, K, bs, data_grads, *occ,
                                              **({"bf16": True} if bf16 else {}))
    sched = (ctypes.c_int * 7)(grid, *(v for ph in ("v", "x", "u") for v in (sp[ph].slices, sp[ph].length)))
    with torch.cuda.device(b.device):
        kw = dict(dtype=dt, device=b.device)
        gW1, gW2 = torch.empty((K, n, m), **kw), torch.empty((K, m, m), **kw)
        gth1, gth2 = torch.empty((K, n), **kw), torch.empty((K, m), **kw)
        gbeta = torch.empty((K,), dtype=beta.dtype, device=b.device)
        gax1 = torch.empty((K, S, m), **kw) if data_grads else None
        gb = torch.empty((S, m), **kw) if data_grads else None
        ws = torch.empty((lay["_total"][0],), dtype=torch.float32, device=b.device)
        bufs = (ctypes.c_void_p * len(schedule.BWD_BUFFERS))(
            *(ws.data_ptr() + 4 * lay[name][0] for name in schedule.BWD_BUFFERS))
        ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
        tail = (bufs, lay["counters"][1], sched, S, m, n, K, bs, dev, torch.cuda.current_stream(b.device).cuda_stream)
        if bf16:
            b32 = beta.dtype == torch.float32
            err = launch(
                *(t.data_ptr() for t in (b, A, W1, W2, th1, th2)), ptr(beta if b32 else None),
                ptr(None if b32 else beta), *(t.data_ptr() for t in (*ins, gW1, gW2, gth1, gth2)),
                ptr(gbeta if b32 else None), ptr(None if b32 else gbeta), ptr(gax1), ptr(gb), *tail,
            )
        else:
            err = launch(
                *(t.data_ptr() for t in (b, A, W1, W2, th1, th2, beta, *ins)),
                *(t.data_ptr() for t in (gW1, gW2, gth1, gth2, gbeta)), ptr(gax1), ptr(gb), *tail,
            )
        cuda_build.check(SRC, err, "CUDA backward kernel")
    with _count_lock:
        (unroll_bwd.launches_bf16 if bf16 else unroll_bwd.launches)[route] += 1
        unroll_bwd.last_plan = (occ, grid, sp, wsplit)
    check_kernel_outputs("unroll_bwd", gW1, gW2, gth1, gth2, gbeta, gax1, gb)
    gparams = DLADMMParams(gW1, gW2, _reduce_theta(gth1, th1_p), _reduce_theta(gth2, th2_p),
                           gbeta.reshape(beta_p.shape))
    gA = None
    if data_grads:
        gA = gA_bf16(gax1, ins[0]) if bf16 else torch.einsum("ksm,ksn->mn", gax1, ins[0])
    return gparams, gA, gb


unroll_bwd.launches = dict.fromkeys(ROUTES, 0)
unroll_bwd.launches_bf16 = dict.fromkeys(ROUTES, 0)
unroll_bwd.last_plan = None


def reset_launches() -> None:
    """Set both routes' launch counts to 0, in both storages."""
    unroll_bwd.launches = dict.fromkeys(ROUTES, 0)
    unroll_bwd.launches_bf16 = dict.fromkeys(ROUTES, 0)


__all__ = [
    "ROUTES",
    "SRC",
    "bwd_chunk_batch",
    "reset_launches",
    "unroll_bwd",
    "unroll_bwd_plain",
    "unroll_bwd_plain_bf16",
    "weight_wave",
]
