"""int8 whole-unroll inference: the CUDA kernel, its loader and its plain
PyTorch version.

The port of ``dladmm_tpu/ops/quantized.py``'s kernel half
(``_int8_unroll_kernel`` driven by ``dladmm_forward_int8_pallas``). The
kernel is hand-written CUDA C++ for Hopper in ``csrc/int8_unroll.cu``
(``int8_persistent``): one persistent cooperative launch a call, all K
layers with grid barriers between the phases, its products on the int8
tensor cores (``mma.sync`` s8), tiles and depth slices from
``ops/schedule.int8_plan``; its design, bound and rounding notes are at
the top of that file.

``int8_unroll_forward(b, qp, qd)`` is the one entry: on a CUDA tensor it
launches the kernel (building it with ``nvcc`` at first use) or raises;
on a CPU tensor it runs ``int8_unroll_forward_plain``, the same function
in plain PyTorch. The plain version follows the KERNEL's operation order,
which differs from the scan's (``ops/quantized.dladmm_forward_int8``) in
two places: the activation scale is max|act| * (1/127) where the scan
divides by 127, and the dual term is lam * (1/beta) where the scan
divides by beta. A last-bit difference can flip an int8 code, so the two
JAX functions themselves drift apart at synthetic_small, by up to 2% of
the largest value (ROADMAP.md §3); the kernel is held to its plain
version bit for bit, and to the scan by the serving quality contract.

Eligibility. The TPU kernel was gated by VMEM fit (``int8_tile_batch``:
one layer's int8 weights plus a batch tile of state in ~14 MB). The CUDA
kernel streams every operand through shared-memory tiles and keeps the
state in device memory between its phases, so it runs at every batch
S; that gate is dropped. Its only condition is B = I (W2 is (K, m, m)).
"""

from __future__ import annotations

import ctypes
import threading

import torch
from torch import Tensor

from dladmm_tpu_torch.ops import cuda_build, schedule
from dladmm_tpu_torch.ops.quantized import QuantizedDict, QuantizedParams, int8_unroll
from dladmm_tpu_torch.utils.profiling import check_kernel_outputs

SRC = cuda_build.CSRC / "int8_unroll.cu"

_count_lock = threading.Lock()
# 14 pointers; the workspace's 7 offsets, 5 strides, S, m, n, K, tile,
# grid, 3 x (slices, length), device; the stream.
_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 25 + [ctypes.c_void_p]


def plan_for(S: int, m: int, n: int, device_index: int) -> schedule.ServePlan:
    """The int8 kernel's plan on this card, from the occupancy of its two
    tile kernels."""
    occ = tuple(cuda_build.occupancy(SRC, "dladmm_int8_occupancy", device_index, t) for t in schedule.INT8_TILES)
    return schedule.int8_plan(S, m, n, occ)


def int8_unroll_forward_plain(b: Tensor, qp: QuantizedParams, qd: QuantizedDict):
    """The kernel's function in plain PyTorch, in its operation order:
    K int8 layers from zero state -> (x, z, lam)."""
    return int8_unroll(qp, qd, b, kernel_order=True)


def kernel_args(b: Tensor, qp: QuantizedParams, qd: QuantizedDict):
    """Check and shape the kernel's inputs: b (S, m) fp32; A_q (m, n)
    int8 with A_s (m,); W1_q (K, n, m) int8 with W1_s (K, n); W2_q
    (K, m, m) with W2_s (K, m), all contiguous; fp32 thresholds (K, n) /
    (K, m) of any strides, and beta (K,) of any stride. Thresholds given
    as (K, 1) scalars become (K, n) / (K, m) views with a column stride of
    0, and a (K, 1) beta a (K,) view: nothing is copied. Anything else
    the kernel does not take raises."""
    S, m = b.shape
    K, n, _ = qp.W1_q.shape
    expect = {
        "A_q": (qd.A_q, (m, n), torch.int8), "A_s": (qd.A_s, (m,), torch.float32),
        "W1_q": (qp.W1_q, (K, n, m), torch.int8), "W1_s": (qp.W1_s, (K, n), torch.float32),
        "W2_q": (qp.W2_q, (K, m, m), torch.int8), "W2_s": (qp.W2_s, (K, m), torch.float32),
    }
    for name, (t, shape, dtype) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}, expected {shape} "
                "(the kernel needs B = I, so W2_q is (K, m, m))"
            )
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes {dtype}")
    if S < 1 or K < 1:
        raise ValueError(f"need S >= 1 and K >= 1, got S={S}, K={K}")
    th1, th2, beta = qp.theta1, qp.theta2, qp.beta
    if th1.shape != (K, n):
        th1 = th1.reshape(K, -1).expand(K, n)
    if th2.shape != (K, m):
        th2 = th2.reshape(K, -1).expand(K, m)
    if beta.shape != (K,):
        beta = beta.reshape(K)
    args = {
        "b": b, "A_q": qd.A_q, "A_s": qd.A_s, "W1_q": qp.W1_q, "W1_s": qp.W1_s,
        "W2_q": qp.W2_q, "W2_s": qp.W2_s, "theta1": th1, "theta2": th2, "beta": beta,
    }
    for name in ("b", "theta1", "theta2", "beta"):
        if args[name].dtype != torch.float32:
            raise TypeError(f"{name} is {args[name].dtype}; the kernel takes float32")
    for name, t in args.items():
        if not (t.is_contiguous() or name in ("theta1", "theta2", "beta")):
            raise ValueError(f"{name} is not contiguous")
    return tuple(args.values())


def int8_unroll_forward(b: Tensor, qp: QuantizedParams, qd: QuantizedDict):
    """K int8 layers of D-LADMM inference from zero state -> (x, z, lam),
    fp32. qp, qd from ops/quantized.quantize_params; identity B.

    CUDA tensors launch the kernel; CPU tensors run the plain version.
    Each kernel launch adds one to ``int8_unroll_forward.launches`` and
    leaves the plan it launched with in ``int8_unroll_forward.last_plan``
    ((blocks a SM, SMs), grid, {phase: Split}, K)."""
    cuda_build.check_same_device(b, {**qp._asdict(), **qd._asdict()})
    if b.device.type == "cpu":
        return int8_unroll_forward_plain(b, qp, qd)
    if b.device.type != "cuda":
        raise ValueError(f"unsupported device {b.device}")
    args = kernel_args(b, qp, qd)
    th1, th2, beta = args[-3:]
    S, m = b.shape
    K, n, _ = qp.W1_q.shape
    launch = cuda_build.entry(SRC, "dladmm_int8_unroll_forward", _ARGTYPES)
    dev = b.device.index
    plan = plan_for(S, m, n, dev)
    ws, sp = plan.workspace, plan.splits
    with torch.cuda.device(b.device):
        kw = dict(dtype=torch.float32, device=b.device)
        x = torch.empty((S, n), **kw)
        z, lam = torch.empty((2, S, m), **kw).unbind()
        work = torch.empty((ws["_total"][0],), **kw)
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = launch(
            *(t.data_ptr() for t in (*args, x, z, lam, work)),
            *(ws[name][0] for name in (*schedule.INT8_BUFFERS, "_total")),
            *th1.stride(), *th2.stride(), beta.stride(0), S, m, n, K, plan.tile, plan.grid,
            *(v for ph in ("x", "ax", "z") for v in (sp[ph].slices, sp[ph].length)), dev, stream,
        )
        cuda_build.check(SRC, err, "CUDA int8 unroll kernel")
    with _count_lock:
        int8_unroll_forward.launches += 1
        int8_unroll_forward.last_plan = (plan.occ, plan.grid, sp, K)
    check_kernel_outputs("int8_unroll_forward", x, z, lam)
    return x, z, lam


int8_unroll_forward.launches = 0
int8_unroll_forward.last_plan = None


def dladmm_forward_int8_pallas(qp: QuantizedParams, qd: QuantizedDict, b: Tensor):
    """``int8_unroll_forward`` under the JAX package's name and argument
    order (qp, qd, b)."""
    return int8_unroll_forward(b, qp, qd)


__all__ = [
    "SRC",
    "dladmm_forward_int8_pallas",
    "int8_unroll_forward",
    "int8_unroll_forward_plain",
    "kernel_args",
    "plan_for",
]
