"""The per-layer fused step: the CUDA kernel, its plain version and the
autograd Function that trains through it.

The port of ``dladmm_tpu/ops/pallas_layer.py`` (``_layer_kernel`` driven
by ``_fused_forward``; ``make_fused_step``, ``fused_layer_step``,
``auto_fused_step``). The kernel is the ``dladmm_layer_step`` entry of
``csrc/unroll.cu``: the serving kernel (``unroll_persistent``) at K = 1,
one cooperative launch with two grid barriers, for ONE l1 layer (B = I),
reading the caller's state (x, z, lam, b, Ax) and writing fresh buffers
(x1, z1, lam1, Ax1). It never updates in place: autograd keeps the
inputs for the backward. Its tile, grid and depth split come from
``ops/schedule.serve_plan``.

``layer_step`` is the one entry: on a CUDA tensor it launches the
kernel (built with ``nvcc`` at first use) or raises; on a CPU tensor it
runs ``layer_step_plain``, the port's ``dladmm_layer_step_cached`` (whose
order, ``lam * (1/beta)``, is already the kernel's).

The step_fn from ``make_fused_step`` plugs into
``models.unroll.dladmm_forward(step_fn=...)``, K launches a forward. Its
backward, as the JAX package's custom VJP, recomputes the plain fp32
step under autograd and returns its vector-Jacobian product
(pallas_layer.py:221-228). ``matmul_dtype=torch.bfloat16`` rounds both
operands of each product to bf16 (fp32 accumulation), as ``_dot_t``
does. The state may be bf16 (with A, b, the weights and the thresholds
in bf16, beta fp32): the layer then runs in fp32 and rounds only the
four values it stores, as ``_layer_kernel`` on bf16 refs does; the
kernel keeps the fresh x1 and Ax1 in fp32 until its Ax and z phases have
read them (``dladmm_layer_step_bf16``).

Eligibility. The TPU kernel kept every weight resident in VMEM
(``weights_fit_vmem``, ~13 MB); the CUDA kernel streams weights through
shared-memory tiles and runs at every shape, so that gate is dropped and
``auto_fused_step`` always returns the fp32 step. ``block_s`` was the
TPU's batch tile; the CUDA kernel tiles by its own rule and ignores it.
"""

from __future__ import annotations

import ctypes
import threading

import torch
from torch import Tensor

from dladmm_tpu_torch.ops import cuda_build
from dladmm_tpu_torch.ops.cuda_unroll import plan_for
from dladmm_tpu_torch.ops.reference import (
    _BETA_MIN,
    LayerParams,
    dladmm_layer_step_cached,
    shrink,
)
from dladmm_tpu_torch.utils.profiling import check_kernel_outputs

SRC = cuda_build.CSRC / "unroll.cu"

_count_lock = threading.Lock()
_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
# dladmm_layer_step_bf16: the fp32 homes of x1 and Ax1 more.
_ARGTYPES_BF16 = [ctypes.c_void_p] * 2 + _ARGTYPES


def _check_matmul_dtype(matmul_dtype) -> None:
    if matmul_dtype not in (None, torch.bfloat16):
        raise ValueError(f"matmul_dtype must be None or torch.bfloat16, got {matmul_dtype!r}")


def _bf16_dot_t(v: Tensor, M: Tensor) -> Tensor:
    """(S, k) x (j, k)^T with both operands rounded to bf16, fp32 sums."""
    return v.to(torch.bfloat16).float() @ M.to(torch.bfloat16).float().T


def layer_step_plain(b, A, x, z, lam, Ax, W1, W2, th1, th2, beta, matmul_dtype=None):
    """The kernel's function in plain PyTorch: one cached l1 layer
    (B = I) -> (x1, z1, lam1, Ax1). With bf16 operands, the same
    recurrence with each product's operands rounded to bf16. On bf16
    state (bf16 b, A, x, z, lam, Ax, weights and thresholds; fp32 beta)
    the layer runs in fp32 on the widened inputs and only its four
    outputs round to bf16, as the JAX package's ``_layer_kernel`` stores
    them."""
    _check_matmul_dtype(matmul_dtype)
    if b.dtype == torch.bfloat16:
        args = (b, A, x, z, lam, Ax, W1, W2, th1, th2, beta)
        out = layer_step_plain(*(t.float() for t in args), matmul_dtype=matmul_dtype)
        return tuple(t.to(torch.bfloat16) for t in out)
    beta = beta.reshape(())
    if matmul_dtype is None:
        x1, z1, lam1, Ax1, _ = dladmm_layer_step_cached(
            A, None, b, x, z, lam, Ax, z, LayerParams(W1, W2, th1, th2, beta)
        )
        return x1, z1, lam1, Ax1
    beta = torch.maximum(beta, beta.new_tensor(_BETA_MIN))
    base = z - b + lam * (1.0 / beta)
    x1 = shrink(x - _bf16_dot_t(Ax + base, W1), th1)
    Ax1 = _bf16_dot_t(x1, A)
    z1 = shrink(z - _bf16_dot_t(Ax1 + base, W2), th2)
    return x1, z1, lam + beta * (Ax1 + z1 - b), Ax1


def layer_step(b, A, x, z, lam, Ax, W1, W2, th1, th2, beta, matmul_dtype=None):
    """One l1 layer of D-LADMM (B = I) -> fresh (x1, z1, lam1, Ax1).

    b, z, lam, Ax (S, m); x (S, n); A (m, n); W1 (n, m); W2 (m, m);
    th1 (n,); th2 (m,): all float32, or all bfloat16 (bf16 state, outputs
    in bf16); beta (1,) float32; contiguous, on one device. CUDA tensors
    launch the kernel; CPU tensors run the plain version. Each kernel
    launch adds one to ``layer_step.launches`` and leaves the plan it
    launched with in ``layer_step.last_plan`` ((blocks a SM, SMs), grid,
    {phase: Split}, 1)."""
    _check_matmul_dtype(matmul_dtype)
    tensors = {"A": A, "x": x, "z": z, "lam": lam, "Ax": Ax, "W1": W1, "W2": W2,
               "theta1": th1, "theta2": th2, "beta": beta}
    cuda_build.check_same_device(b, tensors)
    storage = b.dtype
    if storage not in (torch.float32, torch.bfloat16):
        raise TypeError(f"b is {storage}; the kernel takes float32 or bfloat16 state")
    for name, t in tensors.items():
        want = torch.float32 if name == "beta" else storage
        if t.dtype != want:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes {want} here (b is {storage}, beta float32)")
    if b.device.type == "cpu":
        return layer_step_plain(b, A, x, z, lam, Ax, W1, W2, th1, th2, beta, matmul_dtype)
    if b.device.type != "cuda":
        raise ValueError(f"unsupported device {b.device}")
    S, m = b.shape
    n = A.shape[1]
    expect = {"b": (b, (S, m)), "A": (A, (m, n)), "x": (x, (S, n)), "z": (z, (S, m)),
              "lam": (lam, (S, m)), "Ax": (Ax, (S, m)), "W1": (W1, (n, m)), "W2": (W2, (m, m)),
              "theta1": (th1, (n,)), "theta2": (th2, (m,)), "beta": (beta, (1,))}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape} (B = I)")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if S < 1:
        raise ValueError(f"need S >= 1, got S={S}")
    bf16_state = storage == torch.bfloat16
    if bf16_state:
        launch = cuda_build.entry(SRC, "dladmm_layer_step_bf16", _ARGTYPES_BF16)
        homes = ("ax", "x")  # the fp32 x1 and Ax1 the Ax and z phases read
    else:
        launch = cuda_build.entry(SRC, "dladmm_layer_step", _ARGTYPES)
        homes = ()
    bf16 = matmul_dtype is not None
    dev = b.device.index
    plan = plan_for(S, m, n, dev, bf16, False, bf16_state)
    ws, sp = plan.workspace, plan.splits
    with torch.cuda.device(b.device):
        x1 = torch.empty_like(x)
        z1, lam1, Ax1 = torch.empty((3, S, m), dtype=storage, device=b.device).unbind()
        work = torch.empty((ws["_total"][0],), dtype=torch.float32, device=b.device)
        at = lambda name: work.data_ptr() + 4 * ws[name][0]  # noqa: E731
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = launch(
            *(t.data_ptr() for t in (b, A, W1, W2, th1, th2, beta, x, z, lam, Ax, x1, z1, lam1, Ax1)),
            *(at(name) for name in (*homes, "partials", "counters")),
            ws["counters"][1], S, m, n, int(bf16), plan.tile, plan.grid,
            *(v for ph in ("x", "ax", "z") for v in (sp[ph].slices, sp[ph].length)), dev, stream,
        )
        cuda_build.check(SRC, err, "CUDA layer-step kernel")
    with _count_lock:
        layer_step.launches += 1
        layer_step.last_plan = (plan.occ, plan.grid, sp, 1)
    check_kernel_outputs("layer_step", x1, z1, lam1, Ax1)
    return x1, z1, lam1, Ax1


layer_step.launches = 0
layer_step.last_plan = None


class _FusedLayer(torch.autograd.Function):
    """``layer_step``'s arguments -> (x1, z1, lam1, Ax1) through it; the
    backward rematerializes the plain step (B = I) from the saved inputs
    and returns its VJP. On bf16 state that step runs on the widened
    inputs and its outputs are fp32, as the JAX package's reference step
    promotes them through its fp32 beta: the cotangents are aligned to
    them, and each gradient comes back in its leaf's dtype."""

    @staticmethod
    def forward(ctx, matmul_dtype, *args):
        ctx.save_for_backward(*args)
        return layer_step(*args, matmul_dtype=matmul_dtype)

    @staticmethod
    def backward(ctx, *cts):
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            outs = layer_step_plain(*(t.float() for t in leaves))
            outs, cts = zip(*((o, c.to(o.dtype)) for o, c in zip(outs, cts) if o.requires_grad))
            wrt = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(outs, wrt, cts, allow_unused=True))
        return (None, *(next(grads) if n else None for n in need))


def make_fused_step(block_s: int = 256, matmul_dtype=None):
    """A cached-signature step_fn through the layer kernel, for
    ``dladmm_forward(step_fn=...)`` and, with autograd, for
    ``train.loop.make_train_step(step_fn=...)``. A general B goes to the
    plain step (the kernel is B = I). The state may be float32 or
    bfloat16 (then A, b and the weights are too); the thresholds are
    cast to the state's type and beta to float32, as the JAX package's
    step_fn does. ``block_s`` is kept for the JAX package's signature
    and ignored (module docstring)."""
    _check_matmul_dtype(matmul_dtype)

    def step_fn(A, B, b, x, z, lam, Ax, Bz, p: LayerParams):
        if B is not None:
            return dladmm_layer_step_cached(A, B, b, x, z, lam, Ax, Bz, p)
        n, m = p.W1.shape
        th1 = p.theta1.reshape(-1).to(x.dtype).expand(n).contiguous()
        th2 = p.theta2.reshape(-1).to(z.dtype).expand(m).contiguous()
        x1, z1, lam1, Ax1 = _FusedLayer.apply(
            matmul_dtype, b, A, x, z, lam, Ax, p.W1, p.W2, th1, th2, p.beta.reshape(1).float()
        )
        return x1, z1, lam1, Ax1, z1

    return step_fn


def auto_fused_step(m: int, n: int, d: int, block_s: int = 256):
    """The fused step for a problem shape. The TPU version picked fp32
    operands when the weights fit VMEM, else bf16 operands, else None;
    the CUDA kernel has no fit limit, so this is always the fp32 step."""
    return make_fused_step(block_s=block_s)


# The default instance (the JAX package's name).
fused_layer_step = make_fused_step()


__all__ = [
    "SRC",
    "auto_fused_step",
    "fused_layer_step",
    "layer_step",
    "layer_step_plain",
    "make_fused_step",
]
