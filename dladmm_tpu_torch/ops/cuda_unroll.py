"""Whole-unroll D-LADMM inference: the CUDA kernel, its loader and its
plain PyTorch version.

The port of the inference half of ``dladmm_tpu/ops/pallas_unroll.py``
(``_unroll_kernel`` with ``make_unrolled_forward`` /
``make_unrolled_inference_prox`` / ``prox_megakernel_available``). The
kernel is hand-written CUDA C++ for Hopper in ``csrc/unroll.cu``; its
design, bound and race notes are at the top of that file.

``unroll_forward`` is the one entry: on a CUDA tensor it launches the
kernel (building it with ``nvcc`` at first use) or raises; on a CPU
tensor it runs ``unroll_forward_plain``, the same function as a plain
loop over the cached layer step. The plain version serves the CPU path
and the tests, and the card only as the yardstick the kernel is held
against.

Eligibility. The TPU kernel was gated by VMEM fit (``unroll_fits_vmem``,
``unroll_tile_batch``: one layer's weights plus the batch state in
~14 MB). The CUDA kernel streams every operand through shared-memory
tiles and keeps the state in device memory between its phases, so it
runs at every shape; those gates and the TPU's lane-packing notes are
dropped. Its only conditions are B = I (d == m) and an elementwise prox.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import torch
from torch import Tensor

from dladmm_tpu_torch.models.unroll import DLADMMParams, dladmm_forward
from dladmm_tpu_torch.ops.prox import get_prox, kernel_exact
from dladmm_tpu_torch.ops.reference import make_cached_step

_SRC = Path(__file__).resolve().parent / "csrc" / "unroll.cu"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# The kernel's prox variants (csrc/unroll.cu, enum Prox).
KERNEL_PROX = {"l1": 0, "nonneg_l1": 1, "box": 2, "elastic_net": 3}

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "unroll kernel is built from ops/csrc/unroll.cu at first use"
    )


def _library_path() -> Path:
    """Where the built kernel lives: keyed by the source and the flags,
    so an edited source never loads a stale build."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return _BUILD_DIR / f"libdladmm_unroll_{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, bool]:
    """Compile csrc/unroll.cu with nvcc for sm_90a into the git-ignored
    build directory unless that exact build exists. Returns (path,
    built_now). The compiler's output, with ptxas's register and
    shared-memory report, goes to ``<path>.log``. Raises on failure."""
    out = _library_path()
    if out.is_file():
        return out, False
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    log = out.with_name(out.name + ".log")
    log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {_SRC.name}:\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out, True


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            fn = lib.dladmm_unroll_forward
            fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [
                ctypes.c_float,
                ctypes.c_float,
                ctypes.c_int,
                ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            lib.dladmm_cuda_error_string.argtypes = [ctypes.c_int]
            lib.dladmm_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


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
    (x, z, lam). Thresholds may be (K, n)/(K, d) or (K, 1)."""
    step = make_cached_step(get_prox(prox_x, rho), get_prox(prox_z, rho))
    params = DLADMMParams(W1, W2, th1, th2, beta.reshape(-1))
    return dladmm_forward(params, A, b, step_fn=step)


def kernel_args(b, A, W1, W2, th1, th2, beta):
    """Check and shape the kernel's inputs: the kernel takes exactly
    b (S, m), A (m, n), W1 (K, n, m), W2 (K, m, m), th1 (K, n),
    th2 (K, m), beta (K,), all float32, contiguous, on b's device.
    Thresholds given as (K, 1) scalars are broadcast here, as the TPU
    driver does (pallas_unroll.py:188-193); nothing else is copied, and
    anything else the kernel does not take raises."""
    S, m = b.shape
    K, n, _ = W1.shape
    expect = {
        "b": (b, (S, m)), "A": (A, (m, n)), "W1": (W1, (K, n, m)),
        "W2": (W2, (K, m, m)),
    }
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}, expected {shape} "
                "(the kernel needs B = I, so W2 is (K, m, m))"
            )
    if S < 1 or K < 1:
        raise ValueError(f"need S >= 1 and K >= 1, got S={S}, K={K}")
    th1 = th1.reshape(K, -1).expand(K, n).contiguous()
    th2 = th2.reshape(K, -1).expand(K, m).contiguous()
    beta = beta.reshape(K).contiguous()
    args = {"b": b, "A": A, "W1": W1, "W2": W2, "th1": th1, "th2": th2, "beta": beta}
    for name, t in args.items():
        if t.device != b.device:
            raise ValueError(f"{name} is on {t.device}, b on {b.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return tuple(args.values())


def unroll_forward(
    b: Tensor, A: Tensor, W1: Tensor, W2: Tensor, th1: Tensor, th2: Tensor,
    beta: Tensor, prox_x: str = "l1", prox_z: str = "l1", rho: float = 0.0,
):
    """K layers of D-LADMM inference from zero state -> (x, z, lam).

    b (S, m), A (m, n), W1 (K, n, m), W2 (K, d, m) with d == m (B = I),
    th1 (K, n) or (K, 1), th2 (K, d) or (K, 1), beta (K,) or (K, 1).
    prox_x / prox_z name one of the kernel's proxes (KERNEL_PROX); rho
    is the elastic-net curvature. K is read from W1.shape[0].

    CUDA tensors launch the kernel; CPU tensors run the plain version.
    Each kernel launch adds one to ``unroll_forward.launches``."""
    _check_prox(prox_x, prox_z, rho)
    if b.device.type == "cpu":
        return unroll_forward_plain(b, A, W1, W2, th1, th2, beta, prox_x, prox_z, rho)
    if b.device.type != "cuda":
        raise ValueError(f"unsupported device {b.device}")
    b, A, W1, W2, th1, th2, beta = kernel_args(b, A, W1, W2, th1, th2, beta)
    S, m = b.shape
    K, n, _ = W1.shape
    lib = _load()
    scale = {
        p: (1.0 / (1.0 + rho) if p == "elastic_net" else 1.0)
        for p in (prox_x, prox_z)
    }
    with torch.cuda.device(b.device):
        x = torch.empty((S, n), dtype=torch.float32, device=b.device)
        z, lam, z_tmp, lam_tmp, ax = (
            torch.empty((S, m), dtype=torch.float32, device=b.device)
            for _ in range(5)
        )
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = lib.dladmm_unroll_forward(
            *(t.data_ptr() for t in (b, A, W1, W2, th1, th2, beta)),
            *(t.data_ptr() for t in (x, z, lam, z_tmp, lam_tmp, ax)),
            S, m, n, K, KERNEL_PROX[prox_x], KERNEL_PROX[prox_z],
            scale[prox_x], scale[prox_z], b.device.index, stream,
        )
        if err != 0:
            msg = lib.dladmm_cuda_error_string(err).decode()
            raise RuntimeError(f"CUDA unroll kernel failed: error {err} ({msg})")
    with _count_lock:
        unroll_forward.launches += 1
    return x, z, lam


unroll_forward.launches = 0


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
    place of the l1 shrink. B = I only, no backward."""
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
    """Inference forward(params, A, b) -> (x_K, z_K, lam_K) through the
    whole-unroll kernel, l1/l1 and B = I. The TPU version's custom VJP
    (trajectory kernel + backward kernels) belongs to the training slice
    (ROADMAP.md); here a forward that needs a gradient raises."""

    def forward(params: DLADMMParams, A: Tensor, b: Tensor):
        _no_grad_check(params, A, b)
        return unroll_forward(b, A, *params)

    return forward


def _no_grad_check(params, A, b) -> None:
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (*params, A, b)
    ):
        raise NotImplementedError(
            "the whole-unroll kernel is inference-only in this port; its "
            "backward is a later slice (ROADMAP.md queue 2); run under "
            "torch.no_grad() or use models.unroll.dladmm_forward"
        )


__all__ = [
    "KERNEL_PROX",
    "build",
    "make_unrolled_forward",
    "make_unrolled_inference_prox",
    "prox_megakernel_available",
    "unroll_forward",
    "unroll_forward_plain",
]
