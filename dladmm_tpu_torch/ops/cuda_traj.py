"""Trajectory forward of the unroll: the CUDA kernel, its plain version
and the autograd Functions that train through it.

The port of the trajectory half of ``dladmm_tpu/ops/pallas_unroll.py``
(``_unroll_traj_kernel`` driven by ``_traj_pallas``, and
``make_unrolled_trajectory``; plus ``make_unrolled_forward``'s custom
VJP, whose forward is this kernel). The kernel is the
``dladmm_unroll_trajectory`` entry of ``csrc/unroll.cu``: one persistent
cooperative launch that runs the K layers' three fused GEMM phases with a
grid barrier between them, each layer reading its input state from slice
k-1 of the stacks and writing slice k. Its grid and the depth split of
each phase come from ``ops/schedule.traj_schedule``; a grid the card
cannot hold resident is refused by the launch and raises here.

``trajectory_forward`` is the one entry: on a CUDA tensor it launches
the kernel or raises; on a CPU tensor it runs ``trajectory_forward_plain``.
The TPU's VMEM gates (``traj_fits_vmem``, ``traj_tile_batch``) are
dropped: the kernel runs at every shape. l1/l1 and B = I only, as the
TPU kernel.

bf16. bf16 b, A, weights and thresholds (bf16 training,
``compute_dtype="bfloat16"``) take the kernel's bf16-storage variant
(``dladmm_unroll_trajectory_bf16``), counted apart in
``trajectory_forward.launches_bf16``. Its rule is the JAX kernel's on
bf16 refs: the state stays fp32 from layer to layer (its scratch), and
only the stack stores round to bf16, so it is an fp32 unroll on the
widened inputs whose stacks are rounded where they are stored
(``trajectory_forward_plain_bf16``). It is not the bf16 serving kernel's
rule, which rounds the state between layers.

Training: the forward writes the Ax stack too (``with_tax``), which with
tx, tz, tlam is exactly the residual set of the backward, so the
backward recomputes no forward. A final-state loss
(``unrolled_forward_train``) takes the backward kernel
(ops/cuda_bwd.unroll_bwd, the port of pallas_bwd.py), its batch split
chosen by ``bwd_chunk_batch``. Per-layer cotangents (deep supervision,
``make_unrolled_trajectory``) take the plain reverse sweep
(ops/unroll_vjp.bwd_from_carries), as in the JAX package, which has no
backward kernel for them either.
"""

from __future__ import annotations

import ctypes
import threading

import torch
from torch import Tensor

from dladmm_tpu_torch.models.unroll import DLADMMParams, dladmm_forward
from dladmm_tpu_torch.ops import cuda_build, schedule
from dladmm_tpu_torch.ops.cuda_bwd import bwd_chunk_batch, unroll_bwd, weight_wave
from dladmm_tpu_torch.ops.cuda_unroll import SRC, kernel_args, needs_grad, storage_dtype
from dladmm_tpu_torch.ops.unroll_vjp import _param_grads, bwd_from_carries, shifted_residuals
from dladmm_tpu_torch.utils.profiling import check_kernel_outputs

_count_lock = threading.Lock()


_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
# dladmm_unroll_trajectory_bf16: a bf16 beta pointer and the fp32 state's four buffers more.
_ARGTYPES_BF16 = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 14 + [ctypes.c_void_p]

def trajectory_forward_plain(b, A, W1, W2, th1, th2, beta, with_tax: bool = False):
    """The kernel's function in plain PyTorch: the plain loop from zero
    state, stacking every layer's (x, z, lam) and, with ``with_tax``,
    A x. Same arguments as ``trajectory_forward``."""
    params = DLADMMParams(W1, W2, th1, th2, beta.reshape(-1))
    _, (tx, tz, tlam) = dladmm_forward(params, A, b, capture_trajectory=True)
    if with_tax:
        return tx, tz, tlam, tx @ A.T
    return tx, tz, tlam


def trajectory_forward_plain_bf16(b, A, W1, W2, th1, th2, beta, with_tax: bool = False):
    """The bf16-storage kernel's function in plain PyTorch, the rule of
    the JAX package's ``_unroll_traj_kernel`` on bf16 refs: the fp32
    trajectory (``trajectory_forward_plain``) of the exactly widened
    inputs, its stacks rounded to nearest bf16 where they are stored.
    The state between layers is never rounded. Returns bf16 stacks."""
    out = trajectory_forward_plain(*(t.float() for t in (b, A, W1, W2, th1, th2, beta)), with_tax)
    return tuple(t.to(torch.bfloat16) for t in out)


def trajectory_forward(b, A, W1, W2, th1, th2, beta, with_tax: bool = False):
    """K layers of D-LADMM (l1/l1, B = I) from zero state -> the stacks
    tx (K, S, n), tz (K, S, m), tlam (K, S, m), plus tax = tx A^T
    (K, S, m) when ``with_tax``.

    Shapes as ``cuda_unroll.unroll_forward``; the storage type is b's,
    float32 or bfloat16, as there (``storage_dtype``), and the stacks are
    in it. CUDA tensors launch the kernel; CPU tensors run the plain
    version (``trajectory_forward_plain_bf16`` for bf16). Each kernel
    launch adds one to ``trajectory_forward.launches`` (bf16 storage:
    ``launches_bf16``) and leaves the plan it launched with in
    ``trajectory_forward.last_plan`` ((blocks a SM, SMs), grid, {phase:
    Split}, K)."""
    if b.device.type == "cpu":
        if storage_dtype(b, A, W1, W2, th1, th2, beta) == torch.bfloat16:
            return trajectory_forward_plain_bf16(b, A, W1, W2, th1, th2, beta, with_tax)
        return trajectory_forward_plain(b, A, W1, W2, th1, th2, beta, with_tax)
    if b.device.type != "cuda":
        raise ValueError(f"unsupported device {b.device}")
    b, A, W1, W2, th1, th2, beta = kernel_args(b, A, W1, W2, th1, th2, beta)
    th1, th2 = th1.contiguous(), th2.contiguous()  # this kernel reads (K, n) / (K, m) rows
    S, m = b.shape
    K, n, _ = W1.shape
    bf16 = b.dtype == torch.bfloat16
    dev = b.device.index
    launch = (cuda_build.entry(SRC, "dladmm_unroll_trajectory_bf16", _ARGTYPES_BF16) if bf16
              else cuda_build.entry(SRC, "dladmm_unroll_trajectory", _ARGTYPES))
    occ = cuda_build.occupancy(SRC, "dladmm_traj_occupancy", dev, int(bf16))
    grid, sp, ws = schedule.traj_plan(S, m, n, *occ, **({"bf16_state": True} if bf16 else {}))
    with torch.cuda.device(b.device):
        kw = dict(dtype=b.dtype, device=b.device)
        tx = torch.empty((K, S, n), **kw)
        tz, tlam = (torch.empty((K, S, m), **kw) for _ in range(2))
        if with_tax:
            tax = torch.empty((K, S, m), **kw)
        else:  # fp32: the kernel's Ax scratch; bf16 keeps Ax in the workspace
            tax = None if bf16 else torch.empty((S, m), **kw)
        work = torch.empty((ws["_total"][0],), dtype=torch.float32, device=b.device)
        at = lambda name: work.data_ptr() + 4 * ws[name][0]  # noqa: E731
        stream = torch.cuda.current_stream(b.device).cuda_stream
        sched = (*(v for ph in ("x", "ax", "z") for v in (sp[ph].slices, sp[ph].length)), dev, stream)
        head = (ws["counters"][1], int(with_tax), S, m, n, K, grid)
        if bf16:
            betas = (beta, None) if beta.dtype == torch.float32 else (None, beta)
            err = launch(
                *(t.data_ptr() for t in (b, A, W1, W2, th1, th2)),
                *(None if t is None else t.data_ptr() for t in (*betas, tx, tz, tlam, tax)),
                *(at(name) for name in ("x", "ax", "z", "lam", "zeros", "partials", "counters")),
                *head, *sched,
            )
        else:
            err = launch(
                *(t.data_ptr() for t in (b, A, W1, W2, th1, th2, beta, tx, tz, tlam, tax)),
                at("zeros"), at("partials"), at("counters"), *head, *sched,
            )
        cuda_build.check(SRC, err, "CUDA trajectory kernel")
    with _count_lock:
        if bf16:
            trajectory_forward.launches_bf16 += 1
        else:
            trajectory_forward.launches += 1
        trajectory_forward.last_plan = (occ, grid, sp, K)
    check_kernel_outputs("trajectory_forward", tx, tz, tlam, tax)
    return (tx, tz, tlam, tax) if with_tax else (tx, tz, tlam)


trajectory_forward.launches = 0
trajectory_forward.launches_bf16 = 0
trajectory_forward.last_plan = None


class _Trajectory(torch.autograd.Function):
    """(W1, W2, th1, th2, beta, A, b) -> (tx, tz, tlam); with
    ``final_only`` -> (x_K, z_K, lam_K). Forward: the trajectory kernel
    with the Ax stack. Backward on that trajectory: the backward kernel
    (cuda_bwd.unroll_bwd) for ``final_only``, else bwd_from_carries with
    the per-layer cotangents. In bf16 (bf16 training) both are the bf16
    variants, as in the JAX package (pallas_unroll.py:480-530, 593-652):
    the bf16 kernels, and bwd_from_carries on the bf16 stacks, every
    operation in bf16."""

    @staticmethod
    def forward(ctx, final_only, W1, W2, th1, th2, beta, A, b):
        tx, tz, tlam, tax = trajectory_forward(b, A, W1, W2, th1, th2, beta, with_tax=True)
        ctx.final_only = final_only
        ctx.save_for_backward(W1, W2, th1, th2, beta, A, b, tx, tz, tlam, tax)
        if final_only:
            return tx[-1].clone(), tz[-1].clone(), tlam[-1].clone()
        return tx, tz, tlam

    @staticmethod
    def backward(ctx, gx, gz, glam):
        W1, W2, th1, th2, beta, A, b, tx, tz, tlam, tax = ctx.saved_tensors
        params = DLADMMParams(W1, W2, th1, th2, beta)
        need_data = ctx.needs_input_grad[6:8]
        if ctx.final_only:
            S, m = b.shape
            bs = None  # the plain version has no batch split
            if b.device.type == "cuda":
                wave = weight_wave(b.device, b.dtype == torch.bfloat16)
                bs = bwd_chunk_batch(m, W1.shape[1], W2.shape[1], S, W1.shape[0], wave)
            gparams, gA, gb = unroll_bwd(
                b, A, *params, tx, tz, tlam, tax, gx, gz, glam, bs=bs, data_grads=any(need_data),
            )
        else:
            final = (torch.zeros_like(gx[-1]), torch.zeros_like(gz[-1]), torch.zeros_like(glam[-1]))
            gparams, gA, gb = bwd_from_carries(
                params, A, b, shifted_residuals(tx, tz, tlam, tax), final, (gx, gz, glam),
                data_grads=any(need_data),
            )
        return (None, *_param_grads(gparams, params),
                gA if need_data[0] else None, gb if need_data[1] else None)


def make_unrolled_trajectory():
    """Trajectory forward(params, A, b) -> stacked per-layer (x, z, lam)
    of shape (K, S, .): the NMSE-vs-layer eval and the deep-supervision
    loss. Without a gradient it is the kernel with ``with_tax=False``;
    with one, the autograd Function whose backward folds the per-layer
    cotangents into the manual reverse sweep, fed the kernel's own
    trajectory."""

    def trajectory(params: DLADMMParams, A: Tensor, b: Tensor):
        if needs_grad(params, A, b):
            return _Trajectory.apply(False, *params, A, b)
        return trajectory_forward(b, A, *params)

    return trajectory


def unrolled_forward_train(params: DLADMMParams, A: Tensor, b: Tensor):
    """Final state (x_K, z_K, lam_K) with a gradient: the trajectory
    kernel forward plus the backward kernel (``make_unrolled_forward``'s
    VJP in the JAX package: pallas_unroll.py:613-652). The TPU's three
    backward rungs (whole batch, batch tiles, reverse scan, by VMEM fit)
    become one kernel with an occupancy-chosen batch split."""
    return _Trajectory.apply(True, *params, A, b)


__all__ = [
    "make_unrolled_trajectory",
    "trajectory_forward",
    "trajectory_forward_plain",
    "trajectory_forward_plain_bf16",
    "unrolled_forward_train",
]
