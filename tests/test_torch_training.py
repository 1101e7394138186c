"""Port parity for the training slice: train/loop.py steps against the
JAX package's on the same batches, and the port's fit, checkpoints, run
CLI and the train -> ``serve --ckpt-dir`` round trip, on the CPU.

The JAX steps run their Pallas kernels in interpret mode (the
trajectory forward and the int8 sweep), as the JAX package's own tests
do. Params after 3 steps agree within rtol 1e-5 and the atol the test
states (tests/test_unroll_vjp.py's for equivalent Adam steps)."""

import dataclasses
import json
import shutil

import jax
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
from dladmm_tpu_torch.utils.config import get_config
from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

# W1 (K, n, m) = (2, 256, 128): the per-row int8 codec; the rest flat.
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


CASES = {
    # the main path: deep supervision through the trajectory forward, int8 sweep
    "deep_int8": dict(layer_loss="uniform", moment_dtype="int8_pallas"),
    # final-layer loss, manual backward, fp32 Adam with the exact clip
    "final_fp32": dict(layer_loss=None, moment_dtype="float32"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_from_batch_matches_jax(case):
    t = TrainConfig(lr=3e-3, steps=40, lr_schedule="cosine", clip_norm=1.0, **CASES[case])
    A, leaves, batches = _problem()
    need_traj = t.layer_loss is not None
    jopt = jloop._build_optimizer(t)
    if hasattr(jopt, "interpret"):
        jopt = dataclasses.replace(jopt, interpret=True)
    jfwd = japi.select_forward(M, N, M, S, need_trajectory=True)[0] if need_traj else None
    jlw = jloop._layer_weights(t.layer_loss, K, jnp.float32)
    jstep = jloop.make_train_step_from_batch(jopt, jnp.asarray(A), layer_weights=jlw,
                                             forward_fn=jfwd, donate=False)
    jstate = jloop.make_train_state(JParams(*map(jnp.asarray, leaves)), jopt)

    topt = tloop._build_optimizer(t)
    tfwd = tapi.select_forward(M, N, M, S, need_trajectory=True, device="cpu")[0] if need_traj else None
    tstep = tloop.make_train_step_from_batch(topt, torch.as_tensor(A),
                                             layer_weights=tloop._layer_weights(t.layer_loss, K),
                                             forward_fn=tfwd)
    tstate = tloop.make_train_state(params_from_numpy(*leaves), topt)
    for b, x, e in batches:
        jstate, jl = jstep(jstate, JBatch(*map(jnp.asarray, (b, x, e))))
        tstate, tl = tstep(tstate, SyntheticBatch(*map(torch.as_tensor, (b, x, e))))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert tstate.step == 3
    # atol 1e-6 is tests/test_unroll_vjp.py's for one Adam step: Adam
    # divides each gradient by its own RMS, so where a gradient is tiny a
    # last-bit difference moves its update by a fraction of lr. With int8
    # moments such a difference may also move one code by one step, which
    # moves that element's update by under 1e-3 of lr per step.
    atol = 1e-3 * t.lr * len(batches) if t.moment_dtype == "int8_pallas" else 1e-6
    for name, g, w in zip(JParams._fields, tstate.params, jstate.params):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=atol, err_msg=name)


def test_accumulation_and_freeze():
    """accum_steps=2 over one batch applies the full batch's gradient
    (an optimizer that keeps the gradient it is given as its state shows
    it); frozen fields keep their values."""
    t = TrainConfig(lr=1e-3, clip_norm=1.0, moment_dtype="float32")
    A, leaves, batches = _problem(seed=1)
    At = torch.as_tensor(A)
    data = SyntheticBatch(*map(torch.as_tensor, batches[0]))
    keep = tloop.GradientTransformation(lambda params: None, lambda g, state, params=None: (g, g))
    outs = []
    for accum in (1, 2):
        step = tloop.make_train_step_from_batch(keep, At, accum_steps=accum)
        state, loss = step(tloop.make_train_state(params_from_numpy(*leaves), keep), data)
        outs.append((float(loss), state.opt_state))
    assert outs[0][0] == pytest.approx(outs[1][0], rel=1e-5)
    for g, w in zip(outs[1][1], outs[0][1]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()))
    opt = tloop._build_optimizer(t)
    step = tloop.make_train_step(opt, At, batch=8, freeze=("beta", "theta1"), seed=3)
    state = tloop.make_train_state(params_from_numpy(*leaves), opt)
    for i in range(2):
        state, _ = step(state, i)
    assert torch.equal(state.params.beta, torch.as_tensor(leaves[4]))
    assert torch.equal(state.params.theta1, torch.as_tensor(leaves[2]))
    assert not torch.equal(state.params.W1, torch.as_tensor(leaves[0]))


def _smoke(**train):
    cfg = get_config("smoke")
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train)) if train else cfg


def test_fit_smoke_beats_ladmm():
    params, history = tloop.fit(_smoke(), device="cpu")
    last = history[-1]
    curves = last["curves"]
    assert [h["step"] for h in history] == [30, 60]
    assert np.isfinite(last["loss"]) and np.isfinite(last["residual"])
    assert len(curves["nmse_curve_db"]) == len(curves["ladmm_curve_db"]) == 4
    assert last["nmse_db"] < curves["ladmm_curve_db"][-1]


def test_checkpoint_resume_reproduces_cold_run(tmp_path):
    cold_dir, warm_dir = tmp_path / "cold", tmp_path / "warm"
    cfg = _smoke(moment_dtype="int8_pallas", lr_schedule="cosine", clip_norm=1.0)
    cold, cold_hist = tloop.fit(cfg, ckpt_dir=str(cold_dir), device="cpu")
    assert sorted(p.name for p in cold_dir.iterdir()) == ["step_30.pt", "step_60.pt"]
    warm_dir.mkdir()
    shutil.copy(cold_dir / "step_30.pt", warm_dir / "step_30.pt")
    warm, warm_hist = tloop.fit(cfg, ckpt_dir=str(warm_dir), resume=True, device="cpu")
    assert [h["step"] for h in warm_hist] == [60]
    for g, w in zip(warm, cold):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert warm_hist[-1]["nmse_db"] == cold_hist[-1]["nmse_db"]
    # resumed at the end: the restored model is reported, nothing trains
    again, hist = tloop.fit(cfg, ckpt_dir=str(cold_dir), resume=True, device="cpu")
    assert hist[0]["step"] == 60 and np.isnan(hist[0]["loss"])
    assert hist[0]["nmse_db"] == cold_hist[-1]["nmse_db"]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_run_cli_then_serve_ckpt_dir(tmp_path, capsys, monkeypatch):
    """The train -> serve round trip on the CPU: the served NMSE of the
    eval batch equals the trained run's final eval NMSE (both draw it
    from seed_keys(cfg)[1], on the checkpoint's dictionary)."""
    monkeypatch.setenv("DLADMM_PLATFORM", "cpu")
    ck, log = tmp_path / "ck", tmp_path / "log.jsonl"
    assert trun.main(["--config=smoke", "--ckpt-dir", str(ck), "--log-jsonl", str(log),
                      "--kernel=pallas", "--export-torch", str(tmp_path / "net.pt")]) == 0
    out = capsys.readouterr().out
    assert "kernel path: trajectory-plain-cpu" in out
    summary = json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
    assert summary["final_nmse_db"] < summary["ladmm_nmse_db_at_K"]
    assert [json.loads(ln)["step"] for ln in log.read_text().splitlines()] == [30, 60]
    assert (tmp_path / "net.pt").is_file()
    assert tserve.main(["--config=smoke", "--ckpt-dir", str(ck), "--demo", "64"]) == 0
    served = _last_json(capsys)
    assert served["route"] == "whole-unroll-plain-cpu"
    assert served["nmse_db"] == pytest.approx(summary["final_nmse_db"], abs=0.01)
    assert trun.main(["--config=smoke", "--ckpt-dir", str(ck), "--eval-only"]) == 0
    assert _last_json(capsys)["final_nmse_db"] == pytest.approx(summary["final_nmse_db"], abs=1e-6)


@pytest.mark.parametrize("extra,says", [
    (["--greedy", "--optimizer=fused_adam", "--clip-mode=delayed"], None), (["--zero1"], None),
    (["--optimizer=fused_adam", "--vjp=xla"], None),
    (["--hbm-gb=80", "--config=tp_small", "--kernel=megakernel"], "have no effect with model_axis=2"),
    (["--config=tp_small"], "--nproc_per_node=8 -m dladmm_tpu_torch.run --config=tp_small"), (["--eval-only"], None),
])
def test_run_cli_rejects_unported_options(extra, says, monkeypatch, capsys):
    """What run.py refuses: the JAX CLI's conflicts (--greedy with the
    fused optimizer, --zero1 on an unsharded config, the fused optimizer
    with --vjp=xla, --eval-only without a checkpoint), the JAX package's
    tensor-parallel refusals (a kernel with model_axis > 1), and a
    tensor-parallel preset in one process (the launch line for its 8
    ranks)."""
    monkeypatch.setenv("DLADMM_PLATFORM", "cpu")
    argv = ["--config=smoke", "--steps=2"] + extra
    if extra[0].startswith("--config") or "--config=tp_small" in extra:
        argv = ["--steps=2"] + extra
    with pytest.raises(SystemExit):
        trun.main(argv)
    if says:
        assert says in capsys.readouterr().err


def test_fit_routes_general_configs():
    """General-prox and general-B presets train through the plain loop
    (autograd / the manual general-B sweep) on the CPU; the loss falls."""
    for name in ("synthetic_nonneg", "synthetic_general_b"):
        cfg = get_config(name)
        cfg = dataclasses.replace(
            cfg,
            problem=dataclasses.replace(cfg.problem, m=16, n=32, K=3, **({"d": 20} if cfg.problem.d else {})),
            train=dataclasses.replace(cfg.train, steps=12, eval_every=6, batch=8, eval_batch=16),
        )
        _, hist = tloop.fit(cfg, device="cpu")
        assert len(hist) == 2 and all(np.isfinite(h["nmse_db"]) for h in hist)
        assert hist[-1]["nmse_db"] < hist[0]["curves"]["nmse_curve_db"][0]
    # bf16 training runs now (values: tests/test_torch_bf16_train.py).
    _, hist = tloop.fit(_smoke(compute_dtype="bfloat16"), device="cpu")
    assert hist and all(np.isfinite(h["nmse_db"]) and np.isfinite(h["loss"]) for h in hist)
    # A tensor-parallel preset in one process: the launch line for its ranks.
    with pytest.raises(RuntimeError, match="nproc_per_node=8"):
        tloop.fit_sharded(get_config("tp_small"), device="cpu")
