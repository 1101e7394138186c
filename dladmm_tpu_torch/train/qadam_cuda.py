"""One-pass fused Adam sweeps with int8 or dense moments: the CUDA
kernels, their plain versions and the optimizer around them.

The port of ``dladmm_tpu/train/qadam_pallas.py``. A step reads each
leaf's gradient, fp32 master and two moments once, and writes the master
and the moments once:

  decode mu, nu -> Adam on g * clip_scale in fp32 -> master update ->
  store mu, nu in their format

``adam_step`` is the step of ``QAdamFused.fused_apply``: on the card two
launches and nothing else, whatever the format. The prologue
(``ops/csrc/adam_step.cuh``) computes the global norm, the scalars
[c1, c2, lr, clip_scale], the new count and the SR seeds on the device;
then one sweep runs over a table of every leaf (``step_plan``), passed by
value to the kernel. Nothing in a step waits for the host.

Moment formats (``moment_fmt``):

  * ``int8``: sqrt-companded int8 in two codecs, which one sweep
    (``ops/csrc/qadam_int8.cu``, replacing ``_make_kernel_int8`` and the
    JAX package's jnp path for the small leaves) takes together: per-row
    codes (R, L) and scales (R,) for W1 and W2 viewed as (R, L) rows, and
    flat-256 blocks (train/qmoments.py) for the θ and β stacks. Both are
    updated in place. ``leaf_eligible`` keeps the JAX package's
    thresholds as the rule that picks a leaf's codec: per-row for leaves
    of >= 65536 elements with 128 <= L <= 1638 and >= 128 rows, flat-256
    otherwise. It fixes the state format, so both packages' states stay
    comparable; it is not a memory fit (the CUDA kernel has none below
    L = 2048). The per-row scales are stored (R,): the TPU's lane-packed
    (ceil(R/128), 128) layout is dropped.
  * ``float32``, ``bfloat16``, ``bfloat16_sr``, ``bfloat16_sr_mu``:
    dense moments of the leaf's shape (``DENSE_FMTS``: mu and nu dtypes,
    and which is stored by stochastic rounding). The sweep
    (``ops/csrc/qadam_dense.cu``, replacing ``_make_kernel_dense``) takes
    EVERY leaf, the θ and β stacks too: a dense leaf is stored the same
    way at any size, so ``leaf_eligible`` decides nothing there. The SR
    formats seed each leaf with ``_mix_seed(count, idx)`` (the JAX
    package's hash); the kernel draws its bits from Philox4x32-10, the
    plain version from ``qmoments.random_bits16``: the same rule, other
    bits.

``adam_int8_rows`` and ``adam_dense_rows`` sweep one leaf with given
scalars (the same kernels on a one-leaf table).

bf16 training (``compute_dtype="bfloat16"``): the gradients arrive in
bf16 (all of a step's leaves; widened exactly where they are read), and
the step also writes the bf16 compute copy of the new masters into the
persistent copy ``copy``, in place, in the same sweep: still two
launches, nothing read back (``emit_copy`` of the JAX kernels). The clip
norm of bf16 gradients is the JAX package's in its jitted step
(``optax.global_norm(grads).astype(f32)``): each leaf's fp32 sum of
squares rounded to bf16, those added in bf16, the square root in fp32
(``global_norm``).
"""

from __future__ import annotations

import array
import ctypes
import dataclasses
import functools
import math
import threading
from typing import Any, Optional

import torch
from torch import Tensor

from dladmm_tpu_torch.models.unroll import DLADMMParams
from dladmm_tpu_torch.ops import cuda_build
from dladmm_tpu_torch.train.qmoments import (
    BLOCK,
    GOLDEN,
    U32,
    QMomentsState,
    QTensor,
    _compand,
    dequantize_q8,
    fmix32,
    quantize_q8,
    sr_bfloat16,
)
from dladmm_tpu_torch.utils.profiling import check_kernel_outputs

SRC = cuda_build.CSRC / "qadam_int8.cu"
DENSE_SRC = cuda_build.CSRC / "qadam_dense.cu"
MIN_KERNEL_ELEMS = 1 << 16
MAX_KERNEL_LASTDIM = 1638  # the JAX package's VMEM-derived limit, kept as the codec rule
_INV127 = 1.0 / 127.0  # as a float32: the decode multiplies, as the TPU kernel
# Dense moment formats: fmt -> (mu dtype, nu dtype, SR mu?, SR nu?), the
# JAX package's _DENSE_FMTS.
DENSE_FMTS = {
    "float32": (torch.float32, torch.float32, False, False),
    "bfloat16": (torch.bfloat16, torch.bfloat16, False, False),
    "bfloat16_sr": (torch.bfloat16, torch.bfloat16, True, True),
    "bfloat16_sr_mu": (torch.bfloat16, torch.float32, True, False),
}
MOMENT_FMTS = (*DENSE_FMTS, "int8")
_DENSE_CODE = {fmt: i for i, fmt in enumerate(DENSE_FMTS)}  # csrc/qadam_dense.cu, enum Fmt

_count_lock = threading.Lock()


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_float] * 6 + [
    ctypes.c_int, ctypes.c_void_p,
]
_DENSE_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_float] * 5 + [
    ctypes.c_int, ctypes.c_void_p,
]


def leaf_eligible(leaf: Tensor) -> bool:
    """True when the leaf's moments use the per-row codec and its sweep
    the kernel: >= 2-D, >= 65536 elements, 128 <= L <= 1638 and >= 128
    rows of the (R, L) view, L the last dim. This is the JAX package's
    rule (qadam_pallas.leaf_eligible), kept because it fixes the state
    format; it is not a memory fit."""
    L = leaf.shape[-1] if leaf.ndim else 0
    return (
        leaf.ndim >= 2
        and leaf.numel() >= MIN_KERNEL_ELEMS
        and 128 <= L <= MAX_KERNEL_LASTDIM
        and leaf.numel() // L >= 128
    )


def quantize_rows(x2d: Tensor) -> QTensor:
    """Per-row sqrt-companded int8 on an (R, L) view: codes (R, L),
    scales (R,)."""
    return QTensor(*_compand(x2d.to(torch.float32)))


def dequantize_rows(q: QTensor) -> Tensor:
    c = q.codes.to(torch.float32) * _INV127
    return torch.sign(c) * c * c * q.scale[:, None]


def _adam_core(g, mu, nu, c1, c2, clip_scale, b1, b2, eps):
    """The fp32 update math (c1, c2 the bias corrections, clip_scale the
    global-norm clip factor), in the JAX package's operation order."""
    g = g.to(torch.float32) * clip_scale
    mu = b1 * mu + (1.0 - b1) * g
    nu = b2 * nu + (1.0 - b2) * g * g
    upd = (mu / c1) / (torch.sqrt(nu / c2) + eps)
    return mu, nu, upd


def adam_int8_rows_plain(g, master, mu: QTensor, nu: QTensor, scal, b1=0.9, b2=0.999, eps=1e-8):
    """The kernel's function in plain PyTorch, with its signature and its
    in-place writes: g, master (R, L) fp32; mu, nu per-row QTensors;
    scal [c1, c2, lr, clip_scale]."""
    mu_f, nu_f, upd = _adam_core(
        g, dequantize_rows(mu), dequantize_rows(nu), scal[0], scal[1], scal[3], b1, b2, eps
    )
    master.copy_(master - scal[2] * upd)
    for q, x in ((mu, mu_f), (nu, nu_f)):
        codes, scale = _compand(x)
        q.codes.copy_(codes)
        q.scale.copy_(scale)


def adam_int8_rows(g, master, mu: QTensor, nu: QTensor, scal, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step on an (R, L) leaf with per-row int8 moments, in
    place on master, mu and nu. CUDA tensors launch the kernel (one
    launch, counted in ``adam_int8_rows.launches``); CPU tensors run the
    plain version."""
    R, L = master.shape
    if master.device.type == "cpu":
        return adam_int8_rows_plain(g, master, mu, nu, scal, b1, b2, eps)
    if master.device.type != "cuda":
        raise ValueError(f"unsupported device {master.device}")
    expect = {
        "g": (g, torch.float32, (R, L)), "master": (master, torch.float32, (R, L)),
        "mu.codes": (mu.codes, torch.int8, (R, L)), "mu.scale": (mu.scale, torch.float32, (R,)),
        "nu.codes": (nu.codes, torch.int8, (R, L)), "nu.scale": (nu.scale, torch.float32, (R,)),
        "scal": (scal, torch.float32, (4,)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != master.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}; the kernel "
                f"takes {dtype} {shape} on {master.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    launch = cuda_build.entry(SRC, "dladmm_qadam_int8_rows", _ARGTYPES)
    with torch.cuda.device(master.device):
        err = launch(
            *(t.data_ptr() for t in (g, master, mu.codes, mu.scale, nu.codes, nu.scale, scal)),
            R, L, b1, 1.0 - b1, b2, 1.0 - b2, eps, _INV127, master.device.index,
            torch.cuda.current_stream(master.device).cuda_stream,
        )
        cuda_build.check(SRC, err, "CUDA int8 Adam kernel")
    with _count_lock:
        adam_int8_rows.launches += 1
    check_kernel_outputs("adam_int8_rows", master, mu.scale, nu.scale)


adam_int8_rows.launches = 0


def _mix_seed(count: Tensor, idx) -> Tensor:
    """Hash-mix (step count, leaf index) into one int32 seed per index,
    the JAX package's ``_mix_seed`` bit for bit: uint32 arithmetic
    (emulated on int64 tensors) on the count's device. ``idx`` is an int
    or an integer tensor (one seed per entry)."""
    idx = torch.as_tensor(idx, dtype=torch.int64, device=count.device)
    s = ((count.to(torch.int64) & U32) + (((idx + 1) * GOLDEN) & U32)) & U32
    s = fmix32(s)
    return torch.where(s >= 1 << 31, s - (1 << 32), s).to(torch.int32)


def _store(x: Tensor, dtype, sr: bool, seed, stream: int) -> Tensor:
    if sr:
        return sr_bfloat16(x, seed, stream)
    return x.to(dtype)


def adam_dense_rows_plain(g, master, mu, nu, scal, fmt, seed=None, b1=0.9, b2=0.999, eps=1e-8):
    """The kernel's function in plain PyTorch, with its signature and its
    in-place writes: g, master fp32; mu, nu dense in the format's dtypes
    (all of the leaf's shape); scal [c1, c2, lr, clip_scale]; seed (SR
    formats) an int32 tensor of one element. SR draws its bits from
    ``qmoments.random_bits16`` (stream 0 for mu, 1 for nu)."""
    mu_dt, nu_dt, sr_mu, sr_nu = DENSE_FMTS[fmt]
    mu_f, nu_f, upd = _adam_core(
        g, mu.to(torch.float32), nu.to(torch.float32), scal[0], scal[1], scal[3], b1, b2, eps
    )
    master.copy_(master - scal[2] * upd)
    mu.copy_(_store(mu_f, mu_dt, sr_mu, seed, 0))
    nu.copy_(_store(nu_f, nu_dt, sr_nu, seed, 1))


def adam_dense_rows(g, master, mu, nu, scal, fmt, seed=None, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step on a leaf (any shape) with dense moments, in place
    on master, mu and nu. CUDA tensors launch the kernel (one launch,
    counted in ``adam_dense_rows.launches``); CPU tensors run the plain
    version. The SR formats need ``seed``, an int32 device tensor of one
    element, read by pointer."""
    if fmt not in DENSE_FMTS:
        raise ValueError(f"fmt must be one of {sorted(DENSE_FMTS)}, got {fmt!r}")
    if master.device.type == "cpu":
        return adam_dense_rows_plain(g, master, mu, nu, scal, fmt, seed, b1, b2, eps)
    if master.device.type != "cuda":
        raise ValueError(f"unsupported device {master.device}")
    mu_dt, nu_dt, sr_mu, sr_nu = DENSE_FMTS[fmt]
    shape = tuple(master.shape)
    expect = {
        "g": (g, torch.float32, shape), "master": (master, torch.float32, shape),
        "mu": (mu, mu_dt, shape), "nu": (nu, nu_dt, shape), "scal": (scal, torch.float32, (4,)),
    }
    if sr_mu or sr_nu:
        if seed is None:
            raise ValueError(f"moment_fmt={fmt!r} rounds stochastically and needs a seed")
        expect["seed"] = (seed, torch.int32, tuple(seed.shape))
        if seed.numel() != 1:
            raise ValueError(f"seed must hold one element, got shape {tuple(seed.shape)}")
    for name, (t, dtype, want) in expect.items():
        if t.device != master.device or t.dtype != dtype or tuple(t.shape) != want:
            raise ValueError(
                f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}; the kernel "
                f"takes {dtype} {want} on {master.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    launch = cuda_build.entry(DENSE_SRC, "dladmm_qadam_dense", _DENSE_ARGTYPES)
    with torch.cuda.device(master.device):
        err = launch(
            *(t.data_ptr() for t in (g, master, mu, nu, scal)),
            seed.data_ptr() if (sr_mu or sr_nu) else None,
            master.numel(), _DENSE_CODE[fmt], b1, 1.0 - b1, b2, 1.0 - b2, eps,
            master.device.index, torch.cuda.current_stream(master.device).cuda_stream,
        )
        cuda_build.check(DENSE_SRC, err, "CUDA dense Adam kernel")
    with _count_lock:
        adam_dense_rows.launches += 1
    check_kernel_outputs("adam_dense_rows", master, mu, nu)


adam_dense_rows.launches = 0


def adam_flat_plain(g, master, mu: QTensor, nu: QTensor, scal, b1=0.9, b2=0.999, eps=1e-8):
    """The flat-256 leaves (θ and β stacks): the same math on the codec of
    train/qmoments.py, in place on master and on mu's and nu's codes and
    scales, as the sweep writes them."""
    mu_f, nu_f, upd = _adam_core(
        g, dequantize_q8(mu, master.shape), dequantize_q8(nu, master.shape),
        scal[0], scal[1], scal[3], b1, b2, eps,
    )
    master.copy_(master - scal[2] * upd)
    for q, x in ((mu, mu_f), (nu, nu_f)):
        new = quantize_q8(x)
        q.codes.copy_(new.codes)
        q.scale.copy_(new.scale)


def global_norm(tensors) -> Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm),
    as a device scalar. On bf16 tensors, as the JAX package's jitted step
    computes ``optax.global_norm(grads).astype(f32)`` (XLA on the CPU,
    with excess precision): each tensor's sum of squares in fp32 rounded
    to bf16, those sums added in bf16 in order, the square root of that
    bf16 total in fp32 (not rounded to bf16); returned as fp32."""
    tensors = list(tensors)
    if tensors and tensors[0].dtype == torch.bfloat16:
        total = None
        for t in tensors:
            s = torch.sum(torch.square(t.float())).to(torch.bfloat16)
            total = s if total is None else total + s
        return torch.sqrt(total.float())
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


@dataclasses.dataclass(frozen=True)
class WarmupCosine:
    """optax.warmup_cosine_decay_schedule as an object: linear warmup from
    init_value to peak_value over warmup_steps, then cosine decay to
    end_value at decay_steps, in float32 on the count's device. Calling it
    on a count tensor gives the rate; the fused step's prologue evaluates
    the same fp32 operations from the fields on the card. Every division
    is a true division by a tensor on the count's device (PyTorch's CUDA
    division by a Python number multiplies by its rounded reciprocal)."""

    init_value: float
    peak_value: float
    warmup_steps: int
    decay_steps: int
    end_value: float = 0.0

    def __post_init__(self):
        if not self.decay > 0:
            raise ValueError(
                "the cosine decay needs decay_steps > warmup_steps, got "
                f"{self.decay_steps}, {self.warmup_steps}"
            )

    @property
    def decay(self) -> int:
        return self.decay_steps - self.warmup_steps

    @property
    def alpha(self) -> float:
        return 0.0 if self.peak_value == 0.0 else self.end_value / self.peak_value

    def __call__(self, count: Tensor) -> Tensor:
        count = count.to(torch.int32)
        W, decay, peak, alpha = self.warmup_steps, self.decay, self.peak_value, self.alpha

        def const(v: float) -> Tensor:
            return torch.full((), v, dtype=torch.float32, device=count.device)

        frac = 1 - torch.clamp(count, 0, W).to(torch.float32) / const(float(W))
        warm = (self.init_value - peak) * frac + peak
        t = torch.clamp((count - W).to(torch.float32), max=float(decay))
        cosine = 0.5 * (1 + torch.cos(math.pi * t / const(float(decay))))
        cool = peak * ((1 - alpha) * cosine + alpha)
        return torch.where(count < W, warm, cool)


def step_lr(learning_rate, count: Tensor) -> Tensor:
    """The rate at the step count before its increment, a device scalar."""
    if callable(learning_rate):
        return learning_rate(count).to(torch.float32)
    return torch.full((), learning_rate, dtype=torch.float32, device=count.device)


def step_scalars(grads, count: Tensor, learning_rate, clip_norm=None, b1=0.9, b2=0.999):
    """[c1, c2, lr, clip_scale] as a (4,) fp32 device tensor, and the
    incremented count, all on the device: the prologue's function
    (QAdamFusedPallas._scalars). ``clip / norm`` is PyTorch's
    ``reciprocal(norm) * clip`` (Tensor.__rtruediv__), as the prologue
    computes it."""
    count = count + 1
    cf = count.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, cf)
    c2 = 1.0 - torch.pow(b2, cf)
    lr = step_lr(learning_rate, count - 1)
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / torch.clamp(global_norm(grads), min=1e-16), max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=cf.device)
    return torch.stack([c1, c2, lr, scale]).to(torch.float32), count


def step_seeds(count: Tensor, fmt: str, nleaves: int):
    """The SR formats' per-leaf seeds _mix_seed(count, idx) of the
    incremented count, one device tensor; None for the other formats."""
    if fmt in DENSE_FMTS and any(DENSE_FMTS[fmt][2:]):
        return _mix_seed(count, torch.arange(nleaves, device=count.device))
    return None


# -- one step over a table of leaves (ops/csrc/adam_step.cuh) ----------------

CHUNK = 2048  # elements of a norm chunk and of a dense work block (adam_step.cuh kChunk)
MAX_LEAVES = 8
NORM_BLOCKS = 512  # the prologue's most blocks (kMaxNormBlocks)
BLOCK_WARPS = 8  # warps a block of the sweeps
CODEC_ROWS, CODEC_FLAT, CODEC_DENSE = 0, 1, 2
_LR_CONST, _LR_COSINE, _LR_PTR = 0, 1, 2


def int8_warps(L: int) -> int:
    """Warps of the int8 sweep a row of L codes takes: the power of two W
    with 256 W >= L, so no thread holds more than 8 elements."""
    w = 1
    while 256 * w < L:
        w *= 2
    return w


def int8_vec(L: int, g: int, master: int, mu_codes: int, nu_codes: int, g_bytes: int = 4, copy: int = 0) -> int:
    """Elements a vector access of an int8 row takes, from the data
    pointers: 4, then 2, where L is a multiple and every pointer is
    aligned to it (4 V bytes for fp32, 2 V for bf16: g with g_bytes 2 and
    the compute copy, V for codes); else 1 (ops/csrc/adam_step.cuh
    leaf_vec)."""
    for v in (4, 2):
        if (L % v == 0 and g % (g_bytes * v) == 0 and master % (4 * v) == 0 and mu_codes % v == 0
                and nu_codes % v == 0 and copy % (2 * v) == 0):
            return v
    return 1


def dense_vec(*ptrs: int) -> int:
    """Elements a thread's access of a dense leaf takes: 8 (16-byte
    accesses) where every pointer is 16-byte aligned, else 1
    (ops/csrc/adam_step.cuh leaf_vec)."""
    return 8 if all(p % 16 == 0 for p in ptrs) else 1


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    codec: int  # CODEC_ROWS, CODEC_FLAT or CODEC_DENSE
    n: int  # elements of g and master
    rows: int  # int8: rows of the codes, (R, L) or (nblocks, 256); dense 0
    L: int  # int8: codes a row; dense 0
    warps: int  # int8: warps a row; dense 0
    vec: int  # elements a vector access
    block0: int  # first work block of the sweep
    chunk0: int  # first chunk of the norm


@dataclasses.dataclass(frozen=True)
class StepPlan:
    leaves: tuple
    blocks: int  # work blocks of the sweep, one CUDA block each
    chunks: int  # chunks of the norm
    norm_blocks: int  # blocks of the prologue's launch (with a clip)


@functools.lru_cache(maxsize=64)
def step_plan(specs: tuple) -> StepPlan:
    """The leaf table of one step from each leaf's (codec, n, rows, L,
    vec): an int8 row of L codes takes int8_warps(L) warps, so a work
    block (8 warps) holds 8 // warps rows; a dense work block and a norm
    chunk hold CHUNK elements; each leaf's work blocks and chunks follow
    the previous leaf's. These are the rules of ops/csrc/adam_step.cuh
    lay_out, which the C entry holds the packed table to: a table that
    differs is refused before anything is enqueued."""
    if not 1 <= len(specs) <= MAX_LEAVES:
        raise ValueError(f"the sweep takes 1 to {MAX_LEAVES} leaves, got {len(specs)}")
    leaves, block0, chunk0 = [], 0, 0
    for codec, n, rows, L, vec in specs:
        if codec == CODEC_DENSE:
            warps, blocks = 0, -(-n // CHUNK)
        else:
            warps = int8_warps(L)
            blocks = -(-rows // (BLOCK_WARPS // warps))
        leaves.append(LeafPlan(codec, n, rows, L, warps, vec, block0, chunk0))
        block0 += blocks
        chunk0 += -(-n // CHUNK)
    return StepPlan(tuple(leaves), block0, chunk0, min(chunk0, NORM_BLOCKS))


def pack_step(plan: StepPlan, head_ptrs, leaf_ptrs, lr_mode: int, schedule, has_clip: bool, fmt: int,
              floats, g16: bool = False):
    """The three host arrays of one step (ops/csrc/adam_step.cuh gives the
    layout): pointers (the step's buffers, then 8 a leaf), ints (the
    table's sizes, the rate's mode and schedule steps, the clip, the
    format and whether the gradients are bf16, then 8 a leaf) and
    floats."""
    warmup, decay = (schedule.warmup_steps, schedule.decay) if schedule is not None else (0, 0)
    ptrs = list(head_ptrs)
    ints = [len(plan.leaves), plan.blocks, plan.chunks, plan.norm_blocks, lr_mode, warmup, decay, int(has_clip), fmt,
            int(g16)]
    for lp, lptrs in zip(plan.leaves, leaf_ptrs):
        ptrs += lptrs
        ints += [lp.codec, lp.n, lp.rows, lp.L, lp.warps, lp.vec, lp.block0, lp.chunk0]
    return ptrs, ints, list(floats)


_STEP_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
_NO_SCHEDULE = WarmupCosine(0.0, 0.0, 1, 2)  # fills the schedule's floats when the rate is not one
_workspaces: dict = {}


def _workspace(device: torch.device, stream: int):
    """The prologue's partials (NORM_BLOCKS x MAX_LEAVES fp64: a leaf's
    each, for bf16 gradients) and its counter (one int32, zeroed once; the
    last block of each step clears it again), kept per device and stream
    so that steps on two streams never share one."""
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None:
        ws = _workspaces[key] = (torch.empty(NORM_BLOCKS * MAX_LEAVES, dtype=torch.float64, device=device),
                                 torch.zeros(1, dtype=torch.int32, device=device))
    return ws


def _expect(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}; the sweep takes {dtype} "
                         f"{tuple(shape)} on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check(device_index: int, checks) -> None:
    """Raise on the first (name, tensor, dtype, shape) of ``checks`` whose
    tensor is not contiguous, of that dtype and shape, on the card
    ``device_index``. One pass of cheap tests; the message is built only
    for a miss."""
    for name, t, dtype, shape in checks:
        if not (t.dtype is dtype and t.get_device() == device_index and t.shape == shape and t.is_contiguous()):
            _expect(name, t, dtype, shape, torch.device("cuda", device_index))


def _leaf_spec(idx: int, g, master, mu, nu, fmt: str, g_dt=torch.float32, copy=None):
    """(spec, pointers) of one leaf of the table, after checking it; the
    pointers without the seed and the copy, which follow them. g is of
    ``g_dt`` (float32 or bfloat16: the step's); ``copy`` a bf16 compute
    copy or None."""
    dev, shape = master.get_device(), master.shape
    n = master.numel()
    checks = [(f"leaf {idx} master", master, torch.float32, shape), (f"leaf {idx} g", g, g_dt, shape)]
    if copy is not None:
        checks.append((f"leaf {idx} copy", copy, torch.bfloat16, shape))
    cp = 0 if copy is None else copy.data_ptr()
    if fmt in DENSE_FMTS:
        mu_dt, nu_dt, _, _ = DENSE_FMTS[fmt]
        _check(dev, (*checks, (f"leaf {idx} mu", mu, mu_dt, shape), (f"leaf {idx} nu", nu, nu_dt, shape)))
        ptrs = [g.data_ptr(), master.data_ptr(), mu.data_ptr(), nu.data_ptr()]
        return (CODEC_DENSE, n, 0, 0, dense_vec(*ptrs, cp)), ptrs + [0, 0]
    if leaf_eligible(master):
        codec, L = CODEC_ROWS, shape[-1]
        rows = n // L
    else:
        codec, L = CODEC_FLAT, BLOCK
        rows = -(-n // BLOCK)
    _check(dev, (*checks,
                 (f"leaf {idx} mu.codes", mu.codes, torch.int8, (rows, L)),
                 (f"leaf {idx} mu.scale", mu.scale, torch.float32, (rows,)),
                 (f"leaf {idx} nu.codes", nu.codes, torch.int8, (rows, L)),
                 (f"leaf {idx} nu.scale", nu.scale, torch.float32, (rows,))))
    ptrs = [g.data_ptr(), master.data_ptr(), mu.codes.data_ptr(), nu.codes.data_ptr(), mu.scale.data_ptr(),
            nu.scale.data_ptr()]
    return (codec, n, rows, L, int8_vec(L, *ptrs[:4], g_bytes=g.element_size(), copy=cp)), ptrs


def adam_step_plain(grads, params, mu, nu, count: Tensor, fmt: str, learning_rate, clip_norm=None,
                    b1=0.9, b2=0.999, eps=1e-8, copy=None):
    """adam_step's function in plain PyTorch, with its signature and its
    in-place writes: step_scalars and step_seeds, then each leaf's plain
    sweep (adam_dense_rows_plain, adam_int8_rows_plain on the (R, L) view,
    adam_flat_plain), and with ``copy`` each new master rounded to bf16
    into its copy. Returns (count + 1, scal, seeds)."""
    scal, new_count = step_scalars(grads, count, learning_rate, clip_norm, b1, b2)
    seeds = step_seeds(new_count, fmt, len(grads))
    for idx, (g, master, m, v) in enumerate(zip(grads, params, mu, nu)):
        if fmt in DENSE_FMTS:
            adam_dense_rows_plain(g, master, m, v, scal, fmt, None if seeds is None else seeds[idx], b1, b2, eps)
        elif leaf_eligible(master):
            L = master.shape[-1]
            adam_int8_rows_plain(g.reshape(-1, L), master.view(-1, L), m, v, scal, b1, b2, eps)
        else:
            adam_flat_plain(g, master, m, v, scal, b1, b2, eps)
        if copy is not None:
            copy[idx].copy_(master.to(torch.bfloat16))
    return new_count, scal, seeds


def adam_step(grads, params, mu, nu, count: Tensor, fmt: str, learning_rate, clip_norm=None,
              b1=0.9, b2=0.999, eps=1e-8, copy=None):
    """One optimizer step over every leaf, in place on the fp32 masters
    ``params`` and on the moments ``mu``, ``nu`` (dense tensors, or int8
    QTensors in each leaf's codec: per-row or flat-256). ``count`` is the
    step count before the step (int32 scalar), left as it is. Returns
    (count + 1, scal [c1, c2, lr, clip_scale], seeds or None), all new
    device tensors. The gradients are all fp32 or all bf16 (bf16
    training; their clip norm is the JAX package's bf16 one,
    ``global_norm``); ``copy``, where given, is a bf16 tensor a leaf (the
    persistent compute copy), into which the sweep writes the new master
    rounded to nearest.

    On CUDA tensors two launches (counted in ``adam_step.launches``, and
    those of bf16 gradients in ``adam_step.launches_bf16``): the prologue
    (norm, scalars, count, seeds) and one sweep over the table of leaves;
    nothing is read back. ``learning_rate`` is a float, a
    WarmupCosine (evaluated in the prologue) or any other callable
    (evaluated here into a device scalar the prologue reads). On CPU
    tensors, adam_step_plain.

    A table the C entry does not take (its layout other than step_plan's
    rules give there) is refused before either launch is enqueued: the
    step raises and counts nothing. A launch the runtime refuses raises
    too, with its error cleared, and counts nothing; if it is the
    sweep's, the prologue has run, writing only this call's new buffers
    and leaving its counter cleared."""
    device = params[0].device
    if device.type == "cpu":
        return adam_step_plain(grads, params, mu, nu, count, fmt, learning_rate, clip_norm, b1, b2, eps, copy)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if fmt not in MOMENT_FMTS:
        raise ValueError(f"fmt must be one of {MOMENT_FMTS}, got {fmt!r}")
    _expect("count", count, torch.int32, (), device)
    if copy is not None and len(copy) != len(params):
        raise ValueError(f"copy has {len(copy)} leaves, params {len(params)}")
    g16 = grads[0].dtype == torch.bfloat16
    g_dt = torch.bfloat16 if g16 else torch.float32
    specs, leaf_ptrs = [], []
    grads = [g.contiguous() for g in grads]  # held until the launch is enqueued
    for idx, (g, master, m, v) in enumerate(zip(grads, params, mu, nu)):
        spec, ptrs = _leaf_spec(idx, g, master, m, v, fmt, g_dt, None if copy is None else copy[idx])
        specs.append(spec)
        leaf_ptrs.append(ptrs)
    plan = step_plan(tuple(specs))
    sr = fmt in DENSE_FMTS and any(DENSE_FMTS[fmt][2:])
    new_count = torch.empty((), dtype=torch.int32, device=device)
    scal = torch.empty(4, dtype=torch.float32, device=device)
    seeds = torch.empty(len(specs), dtype=torch.int32, device=device) if sr else None
    for idx, ptrs in enumerate(leaf_ptrs):
        ptrs.append(seeds.data_ptr() + 4 * idx if sr else 0)
        ptrs.append(0 if copy is None else copy[idx].data_ptr())
    schedule, lr_t, lr = None, None, 0.0
    if isinstance(learning_rate, WarmupCosine):
        mode, schedule = _LR_COSINE, learning_rate
    elif callable(learning_rate):
        mode, lr_t = _LR_PTR, step_lr(learning_rate, count).contiguous()
        _expect("learning_rate(count)", lr_t, torch.float32, (), device)
    else:
        mode, lr = _LR_CONST, float(learning_rate)
    s = schedule or _NO_SCHEDULE
    stream = torch.cuda.current_stream(device).cuda_stream
    partials, counter = _workspace(device, stream)
    head = [count.data_ptr(), new_count.data_ptr(), scal.data_ptr(), seeds.data_ptr() if sr else 0,
            lr_t.data_ptr() if lr_t is not None else 0, partials.data_ptr(), counter.data_ptr()]
    floats = [lr, s.init_value - s.peak_value, s.peak_value, math.pi, 1.0 - s.alpha, s.alpha,
              0.0 if clip_norm is None else float(clip_norm), b1, 1.0 - b1, b2, 1.0 - b2, eps, _INV127]
    ptrs, ints, flts = pack_step(plan, head, leaf_ptrs, mode, schedule, clip_norm is not None,
                                 _DENSE_CODE.get(fmt, 0), floats, g16)
    src, name = (DENSE_SRC, "dladmm_adam_step_dense") if fmt in DENSE_FMTS else (SRC, "dladmm_adam_step_int8")
    launch = cuda_build.entry(src, name, _STEP_ARGTYPES)
    arrays = array.array("q", ptrs), array.array("q", ints), array.array("d", flts)  # alive through the call
    with torch.cuda.device(device):
        err = launch(*(a.buffer_info()[0] for a in arrays), device.index, stream)
        cuda_build.check(src, err, "CUDA Adam step")
    with _count_lock:
        if g16:
            adam_step.launches_bf16 += 2
        else:
            adam_step.launches += 2
    check_kernel_outputs("adam_step", scal, *params, *(getattr(v, "scale", v) for v in (*mu, *nu)))
    return new_count, scal, seeds


adam_step.launches = 0
adam_step.launches_bf16 = 0


@dataclasses.dataclass(frozen=True)
class QAdamFused:
    """Fused-sweep Adam with int8 or dense moments (the port of
    QAdamFusedPallas).

    ``fused_apply(grads, state, params, compute_dtype)`` is the step of
    the training loop, in place on the fp32 masters and the state's
    moments: ``adam_step``, two launches on the card; ``update`` is the
    optax-style plain path (same math, returns the negated step and a new
    state).
    Exact global-norm clipping is one scalar computed from the grads on
    the device."""

    learning_rate: Any  # float, a WarmupCosine, or a schedule: count tensor -> lr tensor
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    moment_fmt: str = "int8"
    clip_norm: Optional[float] = None

    def __post_init__(self):
        if self.moment_fmt not in MOMENT_FMTS:
            raise ValueError(
                "moment_fmt must be float32|bfloat16|bfloat16_sr|bfloat16_sr_mu|int8, "
                f"got {self.moment_fmt!r}"
            )

    @property
    def dense(self) -> bool:
        return self.moment_fmt in DENSE_FMTS

    def _zero_moment(self, p: Tensor, which: int):
        """A fresh zero moment of leaf ``p`` in the stored format: mu
        (which=0) or nu (which=1) dense in its DENSE_FMTS dtype, or int8
        in the leaf's codec."""
        if self.dense:
            return torch.zeros(p.shape, dtype=DENSE_FMTS[self.moment_fmt][which], device=p.device)
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if leaf_eligible(p):
            return quantize_rows(z.reshape(-1, p.shape[-1]))
        return quantize_q8(z)

    def init(self, params: DLADMMParams) -> QMomentsState:
        device = params[0].device
        return QMomentsState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu=type(params)(*(self._zero_moment(p, 0) for p in params)),
            nu=type(params)(*(self._zero_moment(p, 1) for p in params)),
        )

    @torch.no_grad()
    def update(self, grads, state: QMomentsState, params=None):
        """optax semantics: (updates, new_state), updates the NEGATED
        scaled step; the state is new, the inputs are untouched."""
        del params
        scal, count = step_scalars(grads, state.count, self.learning_rate, self.clip_norm, self.b1, self.b2)
        seeds = step_seeds(count, self.moment_fmt, len(grads))
        ups, mus, nus = [], [], []
        for idx, (g, mu, nu) in enumerate(zip(grads, state.mu, state.nu)):
            rows = not self.dense and leaf_eligible(g)
            if self.dense:
                mu_f, nu_f = mu.to(torch.float32), nu.to(torch.float32)
            elif rows:
                mu_f, nu_f = (dequantize_rows(q).reshape(g.shape) for q in (mu, nu))
            else:
                mu_f, nu_f = dequantize_q8(mu, g.shape), dequantize_q8(nu, g.shape)
            mu_f, nu_f, upd = _adam_core(g, mu_f, nu_f, scal[0], scal[1], scal[3], self.b1, self.b2, self.eps)
            if self.dense:
                mu_dt, nu_dt, sr_mu, sr_nu = DENSE_FMTS[self.moment_fmt]
                seed = None if seeds is None else seeds[idx]
                mu_n, nu_n = _store(mu_f, mu_dt, sr_mu, seed, 0), _store(nu_f, nu_dt, sr_nu, seed, 1)
            elif rows:
                L = g.shape[-1]
                mu_n, nu_n = quantize_rows(mu_f.reshape(-1, L)), quantize_rows(nu_f.reshape(-1, L))
            else:
                mu_n, nu_n = quantize_q8(mu_f), quantize_q8(nu_f)
            ups.append((-scal[2] * upd).to(g.dtype))
            mus.append(mu_n)
            nus.append(nu_n)
        kind = type(grads)
        return kind(*ups), QMomentsState(count=count, mu=kind(*mus), nu=kind(*nus))

    @torch.no_grad()
    def fused_apply(self, grads, state: QMomentsState, params, compute_dtype=None, compute_params=None):
        """One step in place on the fp32 masters ``params`` and on the
        state's moments (every codec, the flat-256 leaves too); returns
        (params, state, compute_params), the state with the new count, as
        the JAX package's. With ``compute_dtype`` (torch.bfloat16) the same
        sweep writes the new masters rounded to bf16 into
        ``compute_params`` (the persistent copy, in place; new tensors if
        None) and returns it; else the third result is None. The
        gradients may be fp32 or bf16 (bf16 training)."""
        if compute_dtype is not None and compute_dtype != torch.bfloat16:
            raise ValueError(f"compute_dtype must be torch.bfloat16 or None, got {compute_dtype}")
        copy = None
        if compute_dtype is not None:
            copy = compute_params
            if copy is None:
                copy = type(params)(*(torch.empty_like(p, dtype=torch.bfloat16) for p in params))
        count, _, _ = adam_step(grads, params, state.mu, state.nu, state.count, self.moment_fmt,
                                self.learning_rate, self.clip_norm, self.b1, self.b2, self.eps, copy)
        return params, QMomentsState(count=count, mu=state.mu, nu=state.nu), copy


__all__ = [
    "DENSE_FMTS",
    "MOMENT_FMTS",
    "QAdamFused",
    "StepPlan",
    "WarmupCosine",
    "adam_dense_rows",
    "adam_dense_rows_plain",
    "adam_flat_plain",
    "adam_int8_rows",
    "adam_int8_rows_plain",
    "adam_step",
    "adam_step_plain",
    "dequantize_rows",
    "global_norm",
    "leaf_eligible",
    "quantize_rows",
    "step_plan",
    "step_scalars",
    "step_seeds",
]
