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
``ops/unroll_vjp.bwd_from_carries`` on the same trajectory. It reads the
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
from dladmm_tpu_torch.ops.cuda_unroll import kernel_args
from dladmm_tpu_torch.ops.unroll_vjp import _param_grads, bwd_from_carries, shifted_residuals

SRC = cuda_build.CSRC / "unroll_bwd.cu"
ROUTES = ("whole", "chunked")
MIN_SPLIT_BATCH = 256

_count_lock = threading.Lock()

_ARGTYPES = ([ctypes.c_void_p] * 22 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 6
             + [ctypes.c_void_p])


def weight_wave(device: torch.device) -> int:
    """Blocks of the weight-gradient launch the card holds at once: its
    resident blocks a SM times the SMs (on the H100 at 48 registers a
    thread, 5 x 132 = 660)."""
    bps, sms = cuda_build.occupancy(SRC, "dladmm_bwd_weights_occupancy", device.index or 0)
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
    tensors launch the kernel, counted in ``unroll_bwd.launches[route]``,
    and leave the plan it launched with in ``unroll_bwd.last_plan``
    ((blocks a SM, SMs), chain grid, {phase: Split}, WeightSplit); CPU
    tensors run the plain version."""
    if b.device.type == "cpu":
        return unroll_bwd_plain(b, A, W1, W2, th1, th2, beta, tx, tz, tlam, tax, gx, gz, glam,
                                bs, data_grads)
    if b.device.type != "cuda":
        raise ValueError(f"unsupported device {b.device}")
    th1_p, th2_p, beta_p = th1, th2, beta
    b, A, W1, W2, th1, th2, beta = kernel_args(b, A, W1, W2, th1, th2, beta)
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
        if t.device != b.device or t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; the kernel takes float32 on {b.device}")
        ins.append(t.contiguous())
    launch = cuda_build.entry(SRC, "dladmm_unroll_bwd", _ARGTYPES)
    dev = b.device.index
    occ = cuda_build.occupancy(SRC, "dladmm_bwd_occupancy", dev)
    grid, sp, wsplit, lay = schedule.bwd_plan(S, m, n, K, bs, data_grads, *occ)
    sched = (ctypes.c_int * 7)(grid, *(v for ph in ("v", "x", "u") for v in (sp[ph].slices, sp[ph].length)))
    with torch.cuda.device(b.device):
        kw = dict(dtype=torch.float32, device=b.device)
        gW1, gW2 = torch.empty((K, n, m), **kw), torch.empty((K, m, m), **kw)
        gth1, gth2, gbeta = torch.empty((K, n), **kw), torch.empty((K, m), **kw), torch.empty((K,), **kw)
        gax1 = torch.empty((K, S, m), **kw) if data_grads else None
        gb = torch.empty((S, m), **kw) if data_grads else None
        ws = torch.empty((lay["_total"][0],), **kw)
        bufs = (ctypes.c_void_p * len(schedule.BWD_BUFFERS))(
            *(ws.data_ptr() + 4 * lay[name][0] for name in schedule.BWD_BUFFERS))
        ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
        err = launch(
            *(t.data_ptr() for t in (b, A, W1, W2, th1, th2, beta, *ins)),
            *(t.data_ptr() for t in (gW1, gW2, gth1, gth2, gbeta)), ptr(gax1), ptr(gb),
            bufs, lay["counters"][1], sched, S, m, n, K, bs, dev,
            torch.cuda.current_stream(b.device).cuda_stream,
        )
        cuda_build.check(SRC, err, "CUDA backward kernel")
    with _count_lock:
        unroll_bwd.launches[route] += 1
        unroll_bwd.last_plan = (occ, grid, sp, wsplit)
    gparams = DLADMMParams(gW1, gW2, _reduce_theta(gth1, th1_p), _reduce_theta(gth2, th2_p),
                           gbeta.reshape(beta_p.shape))
    gA = torch.einsum("ksm,ksn->mn", gax1, ins[0]) if data_grads else None
    return gparams, gA, gb


unroll_bwd.launches = dict.fromkeys(ROUTES, 0)
unroll_bwd.last_plan = None


def reset_launches() -> None:
    """Set both routes' launch counts to 0."""
    unroll_bwd.launches = dict.fromkeys(ROUTES, 0)


__all__ = [
    "ROUTES",
    "SRC",
    "bwd_chunk_batch",
    "reset_launches",
    "unroll_bwd",
    "unroll_bwd_plain",
    "weight_wave",
]
