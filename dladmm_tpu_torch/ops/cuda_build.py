"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Every hand-written kernel of the port is a ``.cu`` file under
``ops/csrc/`` with a plain C interface (the persistent kernels share
``persistent.cuh``). ``build(src)`` compiles one
source for ``sm_90a`` into a shared library in the git-ignored
``dladmm_tpu_torch/_build/``, named by the source's hash and the flags,
so an edited source never loads a stale build; ``build_all`` starts one
nvcc per source at once (chip_smoke.py's build phase). Nothing here runs
at import: the CPU tests import every module on a machine without nvcc.

A kernel's wrapper gets its C entry point from ``entry(src, name,
argtypes)`` (built, loaded and typed at the first launch, cached after)
and passes the returned cudaError_t to ``check``, which raises on one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[Path, ctypes.CDLL] = {}
_entries: Dict[tuple, object] = {}
_lock = threading.Lock()


def nvcc() -> str:
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
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's CUDA "
        "kernels are built from dladmm_tpu_torch/ops/csrc/ at first use"
    )


def library_path(src: Path) -> Path:
    """Where the build of ``src`` lives: keyed by the source, the headers
    beside it (``*.cuh``, which a source may include) and the flags."""
    h = hashlib.sha256(Path(src).read_bytes())
    for header in sorted(Path(src).parent.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libdladmm_{Path(src).stem}_{h.hexdigest()[:16]}.so"


def build(src: Path) -> Tuple[Path, bool]:
    """Compile ``src`` with nvcc unless that exact build exists. Returns
    (path, built_now). The compiler's output, with ptxas's register and
    shared-memory report, goes to ``<path>.log``. Raises on failure."""
    src = Path(src)
    out = library_path(src)
    if out.is_file():
        return out, False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    out.with_name(out.name + ".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src.name}:\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out, True


def build_all(srcs: Iterable[Path]) -> Dict[str, Tuple[Path, bool, float]]:
    """Build every source at once, one nvcc each. Returns {source name:
    (path, built_now, seconds)}; raises on the first failure."""
    import time

    def one(src):
        t0 = time.monotonic()
        path, built = build(src)
        return Path(src).name, (path, built, time.monotonic() - t0)

    srcs = list(srcs)
    with ThreadPoolExecutor(max(1, len(srcs))) as pool:
        return dict(pool.map(one, srcs))


def load(src: Path) -> ctypes.CDLL:
    """The built library of ``src`` (built now if needed), loaded once."""
    src = Path(src)
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            path, _ = build(src)
            lib = ctypes.CDLL(str(path))
            lib.dladmm_cuda_error_string.argtypes = [ctypes.c_int]
            lib.dladmm_cuda_error_string.restype = ctypes.c_char_p
            _libs[src] = lib
        return lib


def entry(src: Path, name: str, argtypes, restype=ctypes.c_int):
    """The C function ``name`` of ``src``'s library with its argument
    types set and, by default, an int (cudaError_t) result; typed once,
    then cached, so a launch pays no ctypes setup."""
    fn = _entries.get((src, name))
    if fn is None:
        fn = getattr(load(src), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _entries[(src, name)] = fn
    return fn


def check(src: Path, err: int, what: str) -> None:
    """Raise if a C entry point of ``src`` returned a CUDA error."""
    if err != 0:
        msg = load(src).dladmm_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


_occupancy: Dict[tuple, Tuple[int, int]] = {}


def occupancy(src, name: str, device_index: int, *args: int):
    """(blocks a SM, SMs) of a persistent kernel on the card, from its C
    entry ``name(*args, device, &blocks, &sms)``
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor and the SM count; the
    int ``args`` pick an instantiation); asked once per device."""
    key = (src, name, device_index, args)
    if key not in _occupancy:
        fn = entry(src, name, [ctypes.c_int] * (len(args) + 1) + [ctypes.c_void_p] * 2)
        bps, sms = ctypes.c_int(0), ctypes.c_int(0)
        check(src, fn(*args, device_index, ctypes.byref(bps), ctypes.byref(sms)), f"{name}")
        _occupancy[key] = (bps.value, sms.value)
    return _occupancy[key]


def check_same_device(b, tensors: dict) -> None:
    """Raise unless every tensor lies on b's device, before a wrapper
    picks its kernel or plain version: a CPU/CUDA mix runs neither."""
    for name, t in tensors.items():
        if t.device != b.device:
            raise ValueError(f"{name} is on {t.device}, b on {b.device}")


__all__ = [
    "BUILD_DIR", "CSRC", "NVCC_FLAGS", "build", "build_all", "check", "check_same_device",
    "entry", "library_path", "load", "nvcc", "occupancy",
]
