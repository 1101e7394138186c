"""One-pass fused Adam sweeps with int8 or dense moments: the CUDA
kernels, their plain versions and the optimizer around them.

The port of ``dladmm_tpu/train/qadam_pallas.py``. For each parameter
leaf a sweep reads the gradient, the fp32 master and the two moments
once, and writes the master and the moments once:

  decode mu, nu -> Adam on g * clip_scale in fp32 -> master update ->
  store mu, nu in their format

Moment formats (``moment_fmt``):

  * ``int8``: per-row sqrt-companded int8. The kernel
    (``ops/csrc/qadam_int8.cu``, replacing ``_make_kernel_int8``) takes
    the W1 and W2 leaves, viewed as (R, L) rows, and updates master,
    codes and scales in place, as the JAX call aliases them. The small
    leaves (θ and β stacks) take the plain flat-256 path, as in the JAX
    package. ``leaf_eligible`` keeps the JAX package's thresholds as the
    rule that picks a leaf's codec: per-row for leaves of >= 65536
    elements with 128 <= L <= 1638 and >= 128 rows, flat-256 blocks
    (train/qmoments.py) otherwise. It fixes the state format, so both
    packages' states stay comparable; it is not a memory fit (the CUDA
    kernel has none below L = 2048). The per-row scales are stored (R,):
    the TPU's lane-packed (ceil(R/128), 128) layout is dropped.
  * ``float32``, ``bfloat16``, ``bfloat16_sr``, ``bfloat16_sr_mu``:
    dense moments of the leaf's shape (``DENSE_FMTS``: mu and nu dtypes,
    and which is stored by stochastic rounding). The kernel
    (``ops/csrc/qadam_dense.cu``, replacing ``_make_kernel_dense``)
    sweeps EVERY leaf, the θ and β stacks too: a dense leaf is stored the
    same way at any size, so ``leaf_eligible`` decides nothing there, and
    one launch costs the host less than the small leaves' eager ops. The
    SR formats seed each leaf with ``_mix_seed(count, idx)`` (the JAX
    package's hash, in uint32 arithmetic emulated on int64 tensors, on
    the device); the kernel draws its bits from Philox4x32-10, the plain
    version from ``qmoments.random_bits16``: the same rule, other bits.

The scalars [c1, c2, lr, clip_scale] are computed on the device from
the device-side step count and read by the kernels through a pointer,
as is the SR seed: nothing in a step waits for the host. There is no
bf16 compute copy: bf16 training is not ported (ROADMAP.md §1).
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Any, Optional

import torch
from torch import Tensor

from dladmm_tpu_torch.models.unroll import DLADMMParams
from dladmm_tpu_torch.ops import cuda_build
from dladmm_tpu_torch.train.qmoments import (
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


adam_dense_rows.launches = 0


def _leaf_apply_plain(g, master, mu: QTensor, nu: QTensor, scal, b1, b2, eps):
    """The small leaves: the same math on the flat-256 codec. Updates
    master in place; returns the new (mu, nu)."""
    mu_f, nu_f, upd = _adam_core(
        g, dequantize_q8(mu, master.shape), dequantize_q8(nu, master.shape),
        scal[0], scal[1], scal[3], b1, b2, eps,
    )
    master.copy_(master - scal[2] * upd)
    return quantize_q8(mu_f), quantize_q8(nu_f)


def global_norm(tensors) -> Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm),
    as a device scalar."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


@dataclasses.dataclass(frozen=True)
class QAdamFused:
    """Fused-sweep Adam with int8 or dense moments (the port of
    QAdamFusedPallas).

    ``fused_apply(grads, state, params)`` is the one-pass sweep of the
    training step, in place on the fp32 masters and the state;
    ``update`` is the optax-style plain path (same math, returns the
    negated step and a new state). Exact global-norm clipping is one
    scalar computed from the grads on the device."""

    learning_rate: Any  # float, or a schedule: count tensor -> lr tensor
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

    def _lr(self, count: Tensor) -> Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(count).to(torch.float32)
        return torch.full((), self.learning_rate, dtype=torch.float32, device=count.device)

    def _scalars(self, grads, state: QMomentsState):
        """[c1, c2, lr, clip_scale] as a (4,) fp32 device tensor, and the
        incremented count; all on the device."""
        count = state.count + 1
        cf = count.to(torch.float32)
        c1 = 1.0 - torch.pow(self.b1, cf)
        c2 = 1.0 - torch.pow(self.b2, cf)
        lr = self._lr(state.count)
        if self.clip_norm is not None:
            norm = global_norm(grads)
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-16), max=1.0)
        else:
            scale = torch.ones((), dtype=torch.float32, device=cf.device)
        return torch.stack([c1, c2, lr, scale]).to(torch.float32), count

    def _seeds(self, count: Tensor, nleaves: int):
        """The SR formats' per-leaf seeds _mix_seed(count, idx), one
        device tensor; None for the other formats."""
        if self.dense and any(DENSE_FMTS[self.moment_fmt][2:]):
            return _mix_seed(count, torch.arange(nleaves, device=count.device))
        return None

    @torch.no_grad()
    def update(self, grads, state: QMomentsState, params=None):
        """optax semantics: (updates, new_state), updates the NEGATED
        scaled step; the state is new, the inputs are untouched."""
        del params
        scal, count = self._scalars(grads, state)
        seeds = self._seeds(count, len(grads))
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
    def fused_apply(self, grads, state: QMomentsState, params):
        """One-pass apply, in place on the fp32 masters ``params`` and on
        the state's moments. Returns (params, state). (The JAX package's
        third result, the bf16 compute copy, belongs to bf16 training,
        which is not ported: ROADMAP.md §1.)"""
        scal, count = self._scalars(grads, state)
        seeds = self._seeds(count, len(grads))
        mus, nus = [], []
        for idx, (g, master, mu, nu) in enumerate(zip(grads, params, state.mu, state.nu)):
            if self.dense:
                adam_dense_rows(g.contiguous(), master, mu, nu, scal, self.moment_fmt,
                                None if seeds is None else seeds[idx], self.b1, self.b2, self.eps)
            elif leaf_eligible(master):
                L = master.shape[-1]
                adam_int8_rows(g.reshape(-1, L).contiguous(), master.view(-1, L), mu, nu,
                               scal, self.b1, self.b2, self.eps)
            else:
                mu, nu = _leaf_apply_plain(g, master, mu, nu, scal, self.b1, self.b2, self.eps)
            mus.append(mu)
            nus.append(nu)
        kind = type(params)
        return params, QMomentsState(count=count, mu=kind(*mus), nu=kind(*nus))


__all__ = [
    "DENSE_FMTS",
    "MOMENT_FMTS",
    "QAdamFused",
    "adam_dense_rows",
    "adam_dense_rows_plain",
    "adam_int8_rows",
    "adam_int8_rows_plain",
    "dequantize_rows",
    "global_norm",
    "leaf_eligible",
    "quantize_rows",
]
