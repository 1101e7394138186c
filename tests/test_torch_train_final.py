"""Port parity for final-layer-loss training (``layer_loss=None``) with
the dense fused optimizer: the path of ``run --layer-loss=none
--moment-dtype=float32_pallas``.

The training step goes through ``make_unrolled_forward`` in both
packages: the trajectory forward and the backward route (the JAX
package's ``_bwd_kernel`` in interpret mode; the port's ``unroll_bwd``,
whose CPU path is its plain version), then the fused sweep. Params
after 3 steps agree within rtol 1e-5 and atol 1e-6
(tests/test_torch_training.py's for fp32 moments); loss within rtol
1e-5. Then fit, checkpoints of dense and SR states, and the CLI on the
CPU."""

import dataclasses
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dladmm_tpu.data.synthetic import SyntheticBatch as JBatch
from dladmm_tpu.models import api as japi
from dladmm_tpu.models.unroll import DLADMMParams as JParams
from dladmm_tpu.models.unroll import init_dladmm_params as j_init
from dladmm_tpu.train import loop as jloop
from dladmm_tpu.utils.config import TrainConfig
from dladmm_tpu_torch import run as trun
from dladmm_tpu_torch import serve as tserve
from dladmm_tpu_torch.data.synthetic import SyntheticBatch
from dladmm_tpu_torch.models import api as tapi
from dladmm_tpu_torch.train import loop as tloop
from dladmm_tpu_torch.train import qadam_cuda as tqa
from dladmm_tpu_torch.utils.config import get_config
from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

M, N, K, S = 128, 256, 2, 8


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(M, N)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    leaves = [
        np.asarray(v) + 0.02 * np.abs(np.asarray(v)).mean() * rng.normal(size=v.shape).astype(np.float32)
        for v in j_init(jnp.asarray(A), K=K)
    ]
    batches = []
    for _ in range(3):
        x = ((rng.random((S, N)) < 0.1) * rng.normal(size=(S, N))).astype(np.float32)
        e = ((rng.random((S, M)) < 0.1) * rng.normal(size=(S, M))).astype(np.float32)
        batches.append((x @ A.T + e, x, e))
    return A, leaves, batches


def test_final_layer_step_matches_jax():
    t = TrainConfig(lr=3e-3, steps=40, lr_schedule="cosine", clip_norm=1.0, layer_loss=None,
                    moment_dtype="float32_pallas")
    A, leaves, batches = _problem()
    jopt = dataclasses.replace(jloop._build_optimizer(t), interpret=True)
    jfwd, _, jdesc = japi.select_forward(M, N, M, S)
    assert jdesc == "whole-unroll-megakernel"  # its custom VJP: the backward kernel
    jstep = jloop.make_train_step_from_batch(jopt, jnp.asarray(A), forward_fn=jfwd, donate=False)
    jstate = jloop.make_train_state(JParams(*map(jnp.asarray, leaves)), jopt)

    topt = tloop._build_optimizer(t)
    assert isinstance(topt, tqa.QAdamFused) and topt.moment_fmt == "float32"
    tfwd, _, tdesc = tapi.select_forward(M, N, M, S, device="cpu")
    assert tdesc == "whole-unroll-plain-cpu"
    tstep = tloop.make_train_step_from_batch(topt, torch.as_tensor(A), forward_fn=tfwd)
    tstate = tloop.make_train_state(params_from_numpy(*leaves), topt)
    for b, x, e in batches:
        jstate, jl = jstep(jstate, JBatch(*map(jnp.asarray, (b, x, e))))
        tstate, tl = tstep(tstate, SyntheticBatch(*map(torch.as_tensor, (b, x, e))))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for name, g, w in zip(JParams._fields, tstate.params, jstate.params):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=name)
    for moment in ("mu", "nu"):
        for g in getattr(tstate.opt_state, moment):
            assert g.dtype == torch.float32


def _smoke(**train):
    cfg = get_config("smoke")
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train))


@pytest.mark.parametrize("fmt", ["bfloat16_sr_pallas", "bfloat16_sr_mu_pallas"])
def test_final_layer_fit_resume_reproduces_cold_run(tmp_path, fmt):
    """Dense and SR moment states checkpoint and restore (dtypes kept),
    and the SR seeds come from the step count: a run resumed at step 30
    ends bit for bit where the cold run ends."""
    cfg = _smoke(layer_loss=None, moment_dtype=fmt, lr_schedule="cosine", clip_norm=1.0)
    fwd = tapi.select_forward(32, 64, 32, 16, device="cpu")[0]
    cold_dir, warm_dir = tmp_path / "cold", tmp_path / "warm"
    cold, cold_hist = tloop.fit(cfg, forward_fn=fwd, ckpt_dir=str(cold_dir), device="cpu")
    warm_dir.mkdir()
    shutil.copy(cold_dir / "step_30.pt", warm_dir / "step_30.pt")
    warm, warm_hist = tloop.fit(cfg, forward_fn=fwd, ckpt_dir=str(warm_dir), resume=True, device="cpu")
    assert [h["step"] for h in warm_hist] == [60]
    for g, w in zip(warm, cold):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert warm_hist[-1]["nmse_db"] == cold_hist[-1]["nmse_db"]
    assert cold_hist[-1]["nmse_db"] < cold_hist[-1]["curves"]["ladmm_curve_db"][-1]


def test_run_cli_final_layer_dense_then_serve(tmp_path, capsys, monkeypatch):
    """``run --layer-loss=none --moment-dtype=float32_pallas`` on the CPU:
    the plain route of the whole-unroll kernel, a finite NMSE below
    LADMM's, and a checkpoint that serves at its last eval's NMSE. The
    XLA-side moment formats (int8, bfloat16_sr) train through the CLI."""
    monkeypatch.setenv("DLADMM_PLATFORM", "cpu")
    ck = tmp_path / "ck"
    assert trun.main(["--config=smoke", "--layer-loss=none", "--moment-dtype=float32_pallas",
                      "--ckpt-dir", str(ck)]) == 0
    out = capsys.readouterr().out
    summary = json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
    assert summary["route"] == "whole-unroll-plain-cpu"
    assert np.isfinite(summary["final_nmse_db"])
    assert summary["final_nmse_db"] < summary["ladmm_nmse_db_at_K"]
    assert tserve.main(["--config=smoke", "--ckpt-dir", str(ck), "--demo", "64"]) == 0
    served = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert served["nmse_db"] == pytest.approx(summary["final_nmse_db"], abs=0.01)
    for md in ("int8", "bfloat16_sr"):  # the XLA-side formats train through the CLI
        assert trun.main(["--config=smoke", "--steps=2", f"--moment-dtype={md}"]) == 0
        assert np.isfinite(json.loads(capsys.readouterr().out.strip().splitlines()[-1])["final_nmse_db"])
