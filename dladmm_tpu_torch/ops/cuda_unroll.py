"""Whole-unroll D-LADMM inference: the CUDA kernel, its loader and its
plain PyTorch version.

The port of the inference half of ``dladmm_tpu/ops/pallas_unroll.py``
(``_unroll_kernel`` with ``make_unrolled_forward`` /
``make_unrolled_inference_prox`` / ``prox_megakernel_available``). The
kernel is hand-written CUDA C++ for Hopper in ``csrc/unroll.cu``
(``unroll_persistent``): one persistent cooperative launch a call, all K
layers with grid barriers between the phases, tiles and depth slices
from ``ops/schedule.serve_plan``; its design, bound and race notes are at
the top of that file.

``unroll_forward`` is the one entry: on a CUDA tensor it launches the
kernel (building it with ``nvcc`` at first use) or raises; on a CPU
tensor it runs ``unroll_forward_plain``, the same function as a plain
loop over the cached layer step. The plain version serves the CPU path
and the tests, and the card only as the yardstick the kernel is held
against.

bf16. bf16 b, A, weights and thresholds (``InferenceServer(dtype=
torch.bfloat16)``) take the kernel's bf16-storage variant
(``dladmm_unroll_forward_bf16``), whose plain version is
``unroll_forward_plain_bf16``: fp32 arithmetic with each layer's stored
state rounded to bf16, the rule of the JAX package's kernel on bf16
refs. ``unroll_forward_plain`` fed bf16 is another function, the JAX
package's bf16 scan (every operation rounded), which the plain-loop
routes serve. A bf16 forward that needs a gradient (bf16 training) runs
the bf16 trajectory and backward kernels (ops/cuda_traj.py,
ops/cuda_bwd.py), as an fp32 one runs theirs.

Eligibility. The TPU kernel was gated by VMEM fit (``unroll_fits_vmem``,
``unroll_tile_batch``: one layer's weights plus the batch state in
~14 MB). The CUDA kernel streams every operand through shared-memory
tiles and keeps the state in device memory between its phases, so it
runs at every shape; those gates and the TPU's lane-packing notes are
dropped. Its only conditions are B = I (d == m) and an elementwise prox.
"""

from __future__ import annotations

import ctypes
import threading

import torch
from torch import Tensor

from dladmm_tpu_torch.models.unroll import DLADMMParams, dladmm_forward
from dladmm_tpu_torch.ops import cuda_build, schedule
from dladmm_tpu_torch.ops.prox import get_prox, kernel_exact
from dladmm_tpu_torch.ops.reference import LayerParams, make_cached_step
from dladmm_tpu_torch.utils.profiling import check_kernel_outputs

SRC = cuda_build.CSRC / "unroll.cu"
# The kernel's prox variants (csrc/unroll.cu, enum Prox).
KERNEL_PROX = {"l1": 0, "nonneg_l1": 1, "box": 2, "elastic_net": 3}

_count_lock = threading.Lock()


_ARGTYPES = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 11 + [ctypes.c_float] * 2 + [ctypes.c_int] * 9
             + [ctypes.c_void_p])
# dladmm_unroll_forward_bf16: two beta pointers and the fp32 x work buffer more.
_ARGTYPES_BF16 = [ctypes.c_void_p] * 2 + _ARGTYPES
# The kernel's storage types (csrc/unroll.cu: unroll_persistent<T, BF16, TS>).
STORAGE = (torch.float32, torch.bfloat16)


def staging_vec(inputs, bf16_state: bool) -> int:
    """Elements of one 16-byte chunk of the wide tile's staging (4 fp32,
    8 bf16), or 0 where an input it reads 16 bytes at a time does not
    start on 16 bytes (a view at an odd offset): schedule.tile_edge then
    keeps the 32 tile."""
    if any(t.data_ptr() % 16 for t in inputs):
        return 0
    return 8 if bf16_state else 4


def plan_for(S: int, m: int, n: int, device_index: int, bf16: bool, scratch: bool,
             bf16_state: bool = False, vec: int = 4) -> schedule.ServePlan:
    """The serving kernel's plan on this card: its tile, grid and split
    from the occupancy of the two tile kernels (with bf16 staging: the
    layer step's option; with bf16 storage: ``bf16_state``); ``scratch``:
    the serving forward's second z / lam pair and Ax in the workspace;
    ``vec``: ``staging_vec`` of the call's inputs."""
    occ = [cuda_build.occupancy(SRC, "dladmm_unroll_occupancy", device_index, t, int(bf16), int(bf16_state))
           for t in schedule.TILES]
    return schedule.serve_plan(S, m, n, *occ, scratch, bf16_state, vec)


def _check_prox(prox_x: str, prox_z: str, rho: float) -> None:
    for name in (prox_x, prox_z):
        if name not in KERNEL_PROX:
            raise ValueError(
                f"prox {name!r} has no kernel variant (kernel proxes: "
                f"{sorted(KERNEL_PROX)}); serve it through the plain loop"
            )
    if rho < 0:
        raise ValueError(f"elastic_net rho must be >= 0, got {rho}")


def unroll_forward_plain(
    b: Tensor, A: Tensor, W1: Tensor, W2: Tensor, th1: Tensor, th2: Tensor,
    beta: Tensor, prox_x: str = "l1", prox_z: str = "l1", rho: float = 0.0,
):
    """The kernel's function in plain PyTorch: K cached layer steps from
    zero state (B = I). Same arguments as ``unroll_forward``; returns
    (x, z, lam). Thresholds may be (K, n)/(K, d) or (K, 1). For fp32
    storage; ``unroll_forward_plain_bf16`` is the bf16 storage's."""
    step = make_cached_step(get_prox(prox_x, rho), get_prox(prox_z, rho))
    params = DLADMMParams(W1, W2, th1, th2, beta.reshape(-1))
    return dladmm_forward(params, A, b, step_fn=step)


def _rounded(t: Tensor) -> Tensor:
    """t as a bf16 store holds it, widened back to fp32."""
    return t.to(torch.bfloat16).float()


def unroll_forward_plain_bf16(
    b: Tensor, A: Tensor, W1: Tensor, W2: Tensor, th1: Tensor, th2: Tensor,
    beta: Tensor, prox_x: str = "l1", prox_z: str = "l1", rho: float = 0.0,
):
    """The bf16-storage kernel's function in plain PyTorch, the rule of
    the JAX package's ``_unroll_kernel`` on bf16 refs: every input is
    widened exactly to fp32, each layer runs in fp32 in the kernel's
    order (the fp32 cached step), and only its four stores round: x1,
    z1, lam1 and Ax1 as the next layer reads them. Within a layer the Ax
    product takes the unrounded x1, and v and the dual update the
    unrounded Ax1. Returns bf16 (x, z, lam).

    Not the same function as ``unroll_forward_plain`` on bf16 tensors,
    which rounds every operation as the JAX package's scan does."""
    step = make_cached_step(get_prox(prox_x, rho), get_prox(prox_z, rho))
    K = W1.shape[0]
    A, b = A.float(), b.float()
    th1, th2, beta = th1.reshape(K, -1), th2.reshape(K, -1), beta.reshape(-1)
    S, m = b.shape
    x = b.new_zeros((S, A.shape[1]))
    z = lam = Ax = b.new_zeros((S, m))
    for k in range(K):
        p = LayerParams(W1[k].float(), W2[k].float(), th1[k].float(), th2[k].float(), beta[k].float())
        x, z, lam, Ax, _ = (_rounded(t) for t in step(A, None, b, x, z, lam, Ax, z, p))
    return tuple(t.to(torch.bfloat16) for t in (x, z, lam))


def storage_dtype(b, A, W1, W2, th1, th2, beta) -> torch.dtype:
    """The one storage type of a kernel call, b's: float32 or bfloat16
    for b, A, W1, W2 and the thresholds alike; beta float32 or that
    type. Raises TypeError on anything else (a mix included): no path
    casts behind the caller's back."""
    dt = b.dtype
    if dt not in STORAGE:
        raise TypeError(f"b is {dt}; the kernel takes float32 or bfloat16")
    for name, t in (("A", A), ("W1", W1), ("W2", W2), ("th1", th1), ("th2", th2)):
        if t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype} and b {dt}; the kernel takes one storage type")
    if beta.dtype not in (torch.float32, dt):
        raise TypeError(f"beta is {beta.dtype}; the kernel takes float32 or b's {dt}")
    return dt


def kernel_args(b, A, W1, W2, th1, th2, beta):
    """Check and shape the kernel's inputs: the kernel takes exactly
    b (S, m), A (m, n), W1 (K, n, m), W2 (K, m, m), beta (K,), contiguous,
    and thresholds th1 (K, n), th2 (K, m) of any strides, all on b's
    device, in one storage type (``storage_dtype``: float32 or bfloat16;
    beta float32 or that type). Thresholds given as (K, 1) scalars become
    (K, n) / (K, m) views with a column stride of 0, as the TPU wrapper
    broadcasts them (pallas_unroll.py:188-193); nothing is copied, and
    anything else the kernel does not take raises."""
    S, m = b.shape
    K, n, _ = W1.shape
    for name, t, shape in (("A", A, (m, n)), ("W1", W1, (K, n, m)), ("W2", W2, (K, m, m))):
        if t.shape != shape:
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}, expected {shape} "
                "(the kernel needs B = I, so W2 is (K, m, m))"
            )
    if S < 1 or K < 1:
        raise ValueError(f"need S >= 1 and K >= 1, got S={S}, K={K}")
    if th1.shape != (K, n):
        th1 = th1.reshape(K, -1).expand(K, n)
    if th2.shape != (K, m):
        th2 = th2.reshape(K, -1).expand(K, m)
    if beta.shape != (K,):
        beta = beta.reshape(K)
    args = (b, A, W1, W2, th1, th2, beta)
    storage_dtype(*args)
    dev = b.get_device()
    for name, t in zip(("b", "A", "W1", "W2", "th1", "th2", "beta"), args):
        if t.get_device() != dev:
            raise ValueError(f"{name} is on {t.device}, b on {b.device}")
        if not (t.is_contiguous() or name in ("th1", "th2")):
            raise ValueError(f"{name} is not contiguous")
    return args


def unroll_forward(
    b: Tensor, A: Tensor, W1: Tensor, W2: Tensor, th1: Tensor, th2: Tensor,
    beta: Tensor, prox_x: str = "l1", prox_z: str = "l1", rho: float = 0.0,
):
    """K layers of D-LADMM inference from zero state -> (x, z, lam).

    b (S, m), A (m, n), W1 (K, n, m), W2 (K, d, m) with d == m (B = I),
    th1 (K, n) or (K, 1), th2 (K, d) or (K, 1), beta (K,) or (K, 1).
    prox_x / prox_z name one of the kernel's proxes (KERNEL_PROX); rho
    is the elastic-net curvature. K is read from W1.shape[0].

    The storage type is b's, float32 or bfloat16, and the same for A,
    W1, W2 and the thresholds (beta float32 or that type;
    ``storage_dtype``); the outputs are in it. bf16 storage computes in
    fp32 and rounds each layer's stored state (``unroll_forward_plain_bf16``).

    CUDA tensors launch the kernel; CPU tensors run the plain version.
    Each kernel launch adds one to ``unroll_forward.launches`` and leaves
    the plan it launched with in ``unroll_forward.last_plan`` ((blocks a
    SM, SMs), grid, {phase: Split}, K), as ``trajectory_forward``."""
    _check_prox(prox_x, prox_z, rho)
    if b.device.type == "cpu":
        if storage_dtype(b, A, W1, W2, th1, th2, beta) == torch.bfloat16:
            return unroll_forward_plain_bf16(b, A, W1, W2, th1, th2, beta, prox_x, prox_z, rho)
        return unroll_forward_plain(b, A, W1, W2, th1, th2, beta, prox_x, prox_z, rho)
    if b.device.type != "cuda":
        raise ValueError(f"unsupported device {b.device}")
    b, A, W1, W2, th1, th2, beta = kernel_args(b, A, W1, W2, th1, th2, beta)
    S, m = b.shape
    K, n, _ = W1.shape
    bf16 = b.dtype == torch.bfloat16
    if bf16:
        launch = cuda_build.entry(SRC, "dladmm_unroll_forward_bf16", _ARGTYPES_BF16)
        betas = (beta, None) if beta.dtype == torch.float32 else (None, beta)
        buffers = ("z_tmp", "lam_tmp", "ax", "x", "u", "v", "partials", "counters")
    else:
        launch = cuda_build.entry(SRC, "dladmm_unroll_forward", _ARGTYPES)
        betas, buffers = (beta,), ("z_tmp", "lam_tmp", "ax", "u", "v", "partials", "counters")
    dev = b.device.index
    plan = plan_for(S, m, n, dev, False, True, bf16, staging_vec((b, A, W1, W2), bf16))
    ws, sp = plan.workspace, plan.splits
    scale = {
        p: (1.0 / (1.0 + rho) if p == "elastic_net" else 1.0)
        for p in (prox_x, prox_z)
    }
    with torch.cuda.device(b.device):
        kw = dict(dtype=b.dtype, device=b.device)
        x = torch.empty((S, n), **kw)
        z, lam = torch.empty((2, S, m), **kw).unbind()
        work = torch.empty((ws["_total"][0],), dtype=torch.float32, device=b.device)
        at = lambda name: work.data_ptr() + 4 * ws[name][0] if ws[name][1] else None  # noqa: E731
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = launch(
            *(t.data_ptr() for t in (b, A, W1, W2, th1, th2)),
            *(None if t is None else t.data_ptr() for t in betas),
            *(t.data_ptr() for t in (x, z, lam)), *(at(name) for name in buffers),
            *th1.stride(), *th2.stride(), ws["counters"][1], S, m, n, K,
            KERNEL_PROX[prox_x], KERNEL_PROX[prox_z], scale[prox_x], scale[prox_z], plan.tile, plan.grid,
            *(v for ph in ("x", "ax", "z") for v in (sp[ph].slices, sp[ph].length)), dev, stream,
        )
        cuda_build.check(SRC, err, "CUDA unroll kernel")
    with _count_lock:
        unroll_forward.launches += 1
        unroll_forward.last_plan = (plan.occ, plan.grid, sp, K)
    check_kernel_outputs("unroll_forward", x, z, lam)
    return x, z, lam


unroll_forward.launches = 0
unroll_forward.last_plan = None


def _pair_reason(prox_pair) -> str:
    """Why the kernel cannot run this prox pair, or "" when it can."""
    if prox_pair is None:
        return (
            "no prox callables (prox_pair not given; an opaque step_fn "
            "cannot drive the kernel)"
        )
    if not all(kernel_exact(f) for f in prox_pair):
        return (
            "this prox has no kernel variant (group_l2's row norm stays "
            "on the plain loop, ops/prox.py)"
        )
    (px, rx), (pz, rz) = (f.kernel_prox for f in prox_pair)
    if px == pz == "elastic_net" and rx != rz:
        return "the kernel takes one elastic-net rho for x and z"
    return ""


def prox_megakernel_available(prox_pair, m: int, d: int):
    """(available, reason) for routing a general-prox inference forward
    through the kernel. The TPU version also took n and the batch S to
    ask whether a tile fit VMEM; the CUDA kernel has no such limit
    (module docstring), so it needs only m and d. ``reason`` explains a
    False for the callers' error messages."""
    why = _pair_reason(prox_pair)
    if not why and d != m:
        why = f"the kernel needs B = I (d == m), got d={d}, m={m}"
    return not why, why


def make_unrolled_inference_prox(prox_x, prox_z):
    """Inference forward(params, A, b) -> (x, z, lam) through the kernel
    with a general elementwise prox pair (ops/prox.py callables) in
    place of the l1 shrink, in the storage type of its inputs (float32
    or bfloat16). B = I only, no backward."""
    why = _pair_reason((prox_x, prox_z))
    if why:
        raise ValueError(why)
    (px, rx), (pz, rz) = prox_x.kernel_prox, prox_z.kernel_prox
    rho = rx if px == "elastic_net" else rz

    def forward(params: DLADMMParams, A: Tensor, b: Tensor):
        _no_grad_check(params, A, b)
        return unroll_forward(b, A, *params, prox_x=px, prox_z=pz, rho=rho)

    return forward


def make_unrolled_forward():
    """forward(params, A, b) -> (x_K, z_K, lam_K) through the kernels,
    l1/l1 and B = I. Inference (no gradient asked for) is the
    whole-unroll kernel, whose state never leaves the kernel's buffers;
    a forward that needs a gradient runs the trajectory kernel, and its
    backward the backward kernel (ops/cuda_traj.unrolled_forward_train,
    ops/cuda_bwd.unroll_bwd), as the JAX package's custom VJP does.
    bf16 params, A and b take the bf16-storage kernels: the serving
    kernel for inference, the trajectory and backward kernels with a
    gradient (bf16 training)."""

    def forward(params: DLADMMParams, A: Tensor, b: Tensor):
        if needs_grad(params, A, b):
            from dladmm_tpu_torch.ops.cuda_traj import unrolled_forward_train

            return unrolled_forward_train(params, A, b)
        return unroll_forward(b, A, *params)

    return forward


def needs_grad(params, A, b) -> bool:
    """True when autograd would track this forward."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in (*params, A, b))


def _no_grad_check(params, A, b) -> None:
    if needs_grad(params, A, b):
        raise NotImplementedError(
            "the prox-templated kernel is inference-only, as in the JAX "
            "package: train general-prox configs through the plain loop "
            "(models.unroll.dladmm_forward with make_cached_step)"
        )


__all__ = [
    "KERNEL_PROX",
    "SRC",
    "STORAGE",
    "make_unrolled_forward",
    "make_unrolled_inference_prox",
    "plan_for",
    "prox_megakernel_available",
    "storage_dtype",
    "unroll_forward",
    "unroll_forward_plain",
    "unroll_forward_plain_bf16",
]
