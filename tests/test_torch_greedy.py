"""Port parity for train/loop.fit_greedy (greedy layer-wise training) on
the CPU at the smoke shape: a stage's step (the k-layer prefix, constant
lr, the config's clip, the final-state forward) against the JAX
package's on the same numpy batches; stage k leaves the layers after k
at their LADMM init; the records; the validations and run.py's
conflicts. Params after 3 steps agree within rtol 1e-5 and atol 1e-6,
tests/test_torch_training.py's tolerance for Adam steps against the JAX
package, outside Adam's eps region: an element whose first gradient is
not zero and below 100 eps (1e-8) is cancellation noise that the two
packages' summation orders move by about 1%, and its first update
g / (|g| + eps) * lr with it (tests/test_torch_fused_adam.py); those are
held within 1e-2 * lr and must be fewer than 5% of a leaf."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dladmm_tpu.data.synthetic import SyntheticBatch as JBatch
from dladmm_tpu.models.unroll import DLADMMParams as JParams
from dladmm_tpu.models.unroll import init_dladmm_params as j_init
from dladmm_tpu.train import loop as jloop
from dladmm_tpu_torch import run as trun
from dladmm_tpu_torch.data.synthetic import SyntheticBatch
from dladmm_tpu_torch.models import api as tapi
from dladmm_tpu_torch.models.unroll import DLADMMParams
from dladmm_tpu_torch.train import loop as tloop
from dladmm_tpu_torch.utils.config import Config, ProblemConfig, TrainConfig, get_config
from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

M, N, K, S = 32, 64, 4, 16


def _cfg(**train):
    base = dict(batch=S, steps=16, eval_every=4, eval_batch=32, lr=1e-3, clip_norm=1.0,
                lr_schedule="cosine", layer_loss="uniform")
    base.update(train)
    return Config(name="g", problem=ProblemConfig(m=M, n=N, K=K), train=TrainConfig(**base))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_stage_step_matches_jax(k):
    """Stage k's step on the k-layer prefix: the stage optimizer
    (constant lr, exact clip) and the final-state loss, 3 steps on the
    same batches in both packages."""
    rng = np.random.default_rng(k)
    A = rng.normal(size=(M, N)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    leaves = [np.asarray(v)[:k] for v in j_init(jnp.asarray(A), K=K)]
    t = dataclasses.replace(_cfg().train, lr_schedule=None, layer_loss=None)
    jopt = jloop._build_optimizer(t)
    jstep = jloop.make_train_step_from_batch(jopt, jnp.asarray(A), donate=False)
    jstate = jloop.make_train_state(JParams(*map(jnp.asarray, leaves)), jopt)
    topt = tloop._build_optimizer(t)
    tfwd = tapi.select_forward(M, N, M, S, device="cpu")[0]
    tstep = tloop.make_train_step_from_batch(topt, torch.as_tensor(A), forward_fn=tfwd)
    tstate = tloop.make_train_state(params_from_numpy(*leaves), topt)
    eps_region = None
    for _ in range(3):
        x = ((rng.random((S, N)) < 0.1) * rng.normal(size=(S, N))).astype(np.float32)
        e = ((rng.random((S, M)) < 0.1) * rng.normal(size=(S, M))).astype(np.float32)
        b = (x @ A.T + e).astype(np.float32)
        jstate, jl = jstep(jstate, JBatch(*map(jnp.asarray, (b, x, e))))
        tstate, tl = tstep(tstate, SyntheticBatch(*map(torch.as_tensor, (b, x, e))))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        if eps_region is None:  # the first (clipped) gradient: mu / (1 - b1)
            g1 = [np.abs(np.asarray(m) / 0.1) for m in jstate.opt_state[1][0].mu]
            eps_region = [(g > 0) & (g < 100 * 1e-8) for g in g1]
    for name, tv, jv, mask in zip(tstate.params._fields, tstate.params, jstate.params, eps_region):
        assert tv.shape[0] == k and mask.mean() < 5e-2
        tv, jv = tv.numpy(), np.asarray(jv)
        np.testing.assert_allclose(tv[mask], jv[mask], rtol=0, atol=1e-2 * t.lr, err_msg=name)
        np.testing.assert_allclose(tv[~mask], jv[~mask], rtol=1e-5, atol=1e-6, err_msg=name)


def test_stages_leave_later_layers_at_init(monkeypatch):
    """Stage k+1 starts from stage k's trained prefix, its new layer k
    still at its LADMM init, and every stage trains what it holds."""
    prefixes = []
    real = tloop.make_train_state

    def record(params, optimizer, compute_dtype=None):
        prefixes.append(DLADMMParams(*(p.clone() for p in params)))
        return real(params, optimizer, compute_dtype)

    monkeypatch.setattr(tloop, "make_train_state", record)
    params, hist = tloop.fit_greedy(_cfg(), steps_per_stage=3, finetune_steps=0, device="cpu")
    from dladmm_tpu_torch.data.synthetic import problem_matrices
    from dladmm_tpu_torch.models.unroll import init_dladmm_params

    init = init_dladmm_params(problem_matrices(_cfg())[0], K=K)
    assert [p.K for p in prefixes] == [1, 2, 3, 4]
    for k in range(1, K):
        nxt = prefixes[k]  # stage k+1's start
        for full, got in zip(init, nxt):
            assert torch.equal(got[k], full[k])  # layer k untouched by stages 1..k
        assert not torch.equal(nxt.W1[:k], init.W1[:k])  # the prefix trained
    assert not torch.equal(params.W1[-1], prefixes[-1].W1[-1])  # stage K wrote its prefix back
    assert [h.get("stage") for h in hist[:K]] == [1, 2, 3, 4]
    assert all(h["steps"] == 3 and np.isfinite(h["loss"]) for h in hist[:K])
    assert hist[-1]["step"] == 3 * K and np.isnan(hist[-1]["loss"]) and np.isfinite(hist[-1]["nmse_db"])


def test_fit_greedy_finetunes_and_beats_ladmm():
    """The default split: half the budget in K stages, half in the
    end-to-end fine-tune (fit with init_params), whose evals follow the
    stage records; the in-place CUDA-sweep route (float32_pallas) at the
    k = K prefix trains as well."""
    for md in ("float32", "float32_pallas"):
        params, hist = tloop.fit_greedy(_cfg(moment_dtype=md), device="cpu")
        stages = [h for h in hist if "stage" in h]
        evals = [h for h in hist if "step" in h]
        assert [h["stage"] for h in stages] == [1, 2, 3, 4] and all(h["steps"] == 2 for h in stages)
        assert [h["step"] for h in evals] == [4, 8]  # the fine-tune's 8 steps
        assert all(torch.isfinite(p).all() for p in params)
        assert evals[-1]["nmse_db"] < evals[-1]["curves"]["ladmm_curve_db"][-1]


BAD = {
    "general_b": (dict(identity_B=False, d=40), {}, "identity-B"),
    "accum": ({}, dict(accum_steps=2), "accumulation"),
    "prox": (dict(prox_z="box"), {}, "l1/l1"),
    "nonneg": (dict(prox_x="nonneg_l1", nonneg_x=True), {}, "l1/l1"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_fit_greedy_validations(case):
    prob, train, match = BAD[case]
    cfg = _cfg(**train)
    cfg = dataclasses.replace(cfg, problem=dataclasses.replace(cfg.problem, **prob))
    with pytest.raises(ValueError, match=match):
        tloop.fit_greedy(cfg, device="cpu")


@pytest.mark.parametrize("extra", [
    ["--ckpt-dir=/nonexistent"], ["--optimizer=fused_adam", "--clip-mode=delayed"],
    ["--config=synthetic_general_b"], ["--config=general_b_dp"],
])
def test_run_cli_greedy_conflicts(extra, monkeypatch):
    monkeypatch.setenv("DLADMM_PLATFORM", "cpu")
    with pytest.raises(SystemExit):
        trun.main(["--config=smoke", "--steps=2", "--greedy", *extra])


def test_run_cli_greedy(monkeypatch, capsys):
    monkeypatch.setenv("DLADMM_PLATFORM", "cpu")
    assert trun.main(["--config=smoke", "--greedy", "--steps=16"]) == 0
    out = capsys.readouterr().out
    assert "kernel path: greedy (per-stage auto-selection)" in out
    import json

    summary = json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
    assert summary["route"].startswith("greedy") and np.isfinite(summary["final_nmse_db"])
    assert get_config("smoke").problem.K == 4
