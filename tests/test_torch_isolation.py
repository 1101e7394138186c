"""The port stands alone: dladmm_tpu_torch imports neither JAX nor the
JAX package, and its entry points default to CUDA, raising (not falling
back to the CPU) where CUDA is absent."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dladmm_tpu_torch
from dladmm_tpu_torch.utils.platform import resolve_device

PKG = Path(dladmm_tpu_torch.__file__).parent
REPO = PKG.parent


def _modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages([str(PKG)], prefix="dladmm_tpu_torch.")
    )


def test_every_module_imports_without_jax():
    mods = _modules()
    for m in ("ops.cuda_unroll", "ops.cuda_traj", "ops.cuda_bwd", "ops.cuda_int8", "ops.cuda_layer",
              "ops.quantized", "serve", "run", "train.loop", "train.qadam_cuda", "train.qmoments",
              "models.solver", "run_denoise", "data.images", "data.dictionary", "data.fixtures",
              "utils.plots", "train.fused_adam", "parallel", "parallel.mesh", "parallel.multihost",
              "parallel.memory", "parallel.collectives"):
        assert f"dladmm_tpu_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'dladmm_tpu.')))\n"
        "print(repr(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=str(REPO), timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|from\s+jaxlib\b|"
    r"from\s+dladmm_tpu\.|from\s+dladmm_tpu\s+import\b|import\s+dladmm_tpu\b)",
    re.M,
)


def test_sources_never_name_jax_imports():
    sources = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 10
    offenders = [
        f"{p.relative_to(REPO)}: {m.group(0).strip()}"
        for p in sources
        for m in _FORBIDDEN.finditer(p.read_text())
    ]
    assert offenders == []
    # the pattern does catch what it is for, and not the port's own name
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from dladmm_tpu.ops import prox")
    assert not _FORBIDDEN.search("from dladmm_tpu_torch.ops import prox")
    assert not _FORBIDDEN.search("import dladmm_tpu_torch")


def test_resolve_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.delenv("DLADMM_PLATFORM", raising=False)
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("DLADMM_PLATFORM", "cpu")
    assert resolve_device() == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"
    monkeypatch.setenv("DLADMM_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="DLADMM_PLATFORM"):
        resolve_device()
    if torch.cuda.is_available():
        monkeypatch.delenv("DLADMM_PLATFORM")
        assert resolve_device().type == "cuda"
        return
    for env in (None, "cuda", "gpu"):
        if env is None:
            monkeypatch.delenv("DLADMM_PLATFORM", raising=False)
        else:
            monkeypatch.setenv("DLADMM_PLATFORM", env)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device()
    monkeypatch.setenv("DLADMM_PLATFORM", "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")  # an explicit device wins over the env


def test_server_and_cli_do_not_fall_back_to_cpu(monkeypatch, tmp_path):
    """Without CUDA, the entry points raise unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is absent")
    from dladmm_tpu_torch import serve
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.utils.torch_compat import save_torch

    monkeypatch.delenv("DLADMM_PLATFORM", raising=False)
    A = torch.eye(8, 16)
    params = init_dladmm_params(A, K=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.InferenceServer(params, A, buckets=(2,))
    ckpt = tmp_path / "net.pt"
    save_torch(params, ckpt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--config=smoke", "--import-torch", str(ckpt), "--demo", "2"])
    from dladmm_tpu_torch import run_denoise

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_denoise.main(["--quick"])
    monkeypatch.setenv("DLADMM_PLATFORM", "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_denoise.main(["--quick"])
