"""Port parity for train/fused_adam.py: the fused step (Adam inside the
reverse sweep) against the JAX package's make_fused_adam_step on the
same numpy inputs, against the port's own delayed-clip chain, and fit's
route, validations and resume, on the CPU at the smoke shape (m = 32,
n = 64, K = 4).

Tolerances: the JAX package's (tests/test_fused_adam.py) are rtol 2e-6
and atol 3e-8 on the params while the clip does not bind, rtol 1e-5
where it binds. The port's own delayed-clip chain sums in the fused
step's order and holds them on every element over 5 steps. Against the
JAX package the products sum in other orders, and Adam divides each
gradient by its own RMS, so two kinds of element move further:

  * Adam's eps region: a first gradient 0 < |g| < 100 eps is
    cancellation noise (about 1% apart between the packages), and its
    first update g / (|g| + eps) * lr moves by up to 1e-3 of lr (2 of
    8192 W1 elements, 1.24e-6 apart). These are held within 1e-2 * lr
    and must be fewer than 5% of a leaf;
  * after the first step, an element whose first moment cancels (m
    small against sqrt(v)) carries its gradients' summation-order
    difference into the update: 11 of 4096 W2 elements sit 3e-8 to
    1.2e-7 apart after 5 steps.

So the step against the JAX package is held at the JAX tolerance for
one step (where the update is the gradient's sign outside the eps
region), and over 5 steps at rtol 2e-6 with atol 1e-6, the port's
tolerance for Adam steps against the JAX package
(tests/test_torch_training.py, after tests/test_unroll_vjp.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dladmm_tpu.data.synthetic import SyntheticBatch as JBatch
from dladmm_tpu.models.unroll import DLADMMParams as JParams
from dladmm_tpu.models.unroll import init_dladmm_params as j_init
from dladmm_tpu.train import fused_adam as jfa
from dladmm_tpu_torch.data.synthetic import SyntheticBatch
from dladmm_tpu_torch.train import fused_adam as tfa
from dladmm_tpu_torch.train import loop as tloop
from dladmm_tpu_torch.utils.config import Config, ProblemConfig, TrainConfig
from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

M, N, K, S = 32, 64, 4, 16
LR = 1e-3


def _problem(seed=0, d=None, steps=5):
    """A, B (general B when d), perturbed LADMM-init leaves and ``steps``
    batches, all numpy."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(M, N)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    B = None
    if d is not None:
        B = rng.normal(size=(M, d)).astype(np.float32)
        B /= np.linalg.norm(B, axis=0, keepdims=True)
    leaves = [
        np.asarray(v) + 0.02 * np.abs(np.asarray(v)).mean() * rng.normal(size=v.shape).astype(np.float32)
        for v in j_init(jnp.asarray(A), None if B is None else jnp.asarray(B), K=K)
    ]
    batches = []
    for _ in range(steps):
        x = ((rng.random((S, N)) < 0.1) * rng.normal(size=(S, N))).astype(np.float32)
        e = ((rng.random((S, d or M)) < 0.1) * rng.normal(size=(S, d or M))).astype(np.float32)
        b = x @ A.T + (e if B is None else e @ B.T)
        batches.append((b.astype(np.float32), x, e))
    return A, B, leaves, batches


def _jax_run(A, B, leaves, batches, lr=LR, clip=None, compute_dtype=None, lw=None, freeze=()):
    step = jfa.make_fused_adam_step(
        jnp.asarray(A), lr=lr, clip_norm=clip, donate=False, from_batch=True,
        compute_dtype=compute_dtype, layer_weights=lw, freeze=freeze,
        B=None if B is None else jnp.asarray(B))
    state = jfa.make_fused_adam_state(JParams(*map(jnp.asarray, leaves)), clip, compute_dtype)
    losses = []
    for b, x, e in batches:
        state, loss = step(state, JBatch(*map(jnp.asarray, (b, x, e))))
        losses.append(float(loss))
    return state, losses


def _torch_run(A, B, leaves, batches, lr=LR, clip=None, compute_dtype=None, lw=None, freeze=()):
    step = tfa.make_fused_adam_step(
        torch.as_tensor(A), lr=lr, clip_norm=clip, from_batch=True, compute_dtype=compute_dtype,
        layer_weights=lw, freeze=freeze, B=None if B is None else torch.as_tensor(B))
    state = tfa.make_fused_adam_state(params_from_numpy(*leaves), clip, compute_dtype)
    losses = []
    for b, x, e in batches:
        state, loss = step(state, SyntheticBatch(*map(torch.as_tensor, (b, x, e))))
        losses.append(float(loss))
    return state, losses


def _close(tree_t, tree_j, rtol, atol, what, eps_region=None):
    """Leaf by leaf within (rtol, atol); where ``eps_region`` (a mask a
    leaf) is given, its elements within 1e-2 * LR instead, and fewer than
    5% of the leaf."""
    for i, (name, t, j) in enumerate(zip(tree_t._fields, tree_t, tree_j)):
        t, j = t.float().numpy(), np.asarray(j, np.float32)
        if eps_region is not None:
            mask = eps_region[i]
            assert mask.mean() < 5e-2, (name, int(mask.sum()))
            np.testing.assert_allclose(t[mask], j[mask], rtol=0, atol=1e-2 * LR, err_msg=f"{what}.{name} eps")
            t, j = t[~mask], j[~mask]
        np.testing.assert_allclose(t, j, rtol=rtol, atol=atol, err_msg=f"{what}.{name}")


def _eps_region(A, B, leaves, batches, **kw):
    """Per leaf, the elements whose first gradient (the JAX package's,
    mu after one step / (1 - b1)) is not zero and below 100 Adam eps in
    magnitude."""
    kw = {k: v for k, v in kw.items() if k in ("clip", "lw", "compute_dtype", "freeze")}
    st, _ = _jax_run(A, B, leaves, batches[:1], **kw)
    g = [np.abs(np.asarray(m) / 0.1) for m in st.opt_state.mu]
    return [(v > 0) & (v < 100 * 1e-8) for v in g]


def test_fused_step_matches_jax_nonbinding_clip():
    """While the clip never binds both scale by exactly 1: one step's
    params within the JAX test's rtol 2e-6 / atol 3e-8 (eps region
    aside), 5 steps' within rtol 2e-6 / atol 1e-6, the moments likewise."""
    A, B, leaves, batches = _problem()
    eps = _eps_region(A, B, leaves, batches, clip=1e9)
    jst, _ = _jax_run(A, B, leaves, batches[:1], clip=1e9)
    tst, _ = _torch_run(A, B, leaves, batches[:1], clip=1e9)
    _close(tst.params, jst.params, 2e-6, 3e-8, "params after one step", eps)
    jst, jl = _jax_run(A, B, leaves, batches, clip=1e9)
    tst, tl = _torch_run(A, B, leaves, batches, clip=1e9)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    _close(tst.params, jst.params, 2e-6, 1e-6, "params", eps)
    _close(tst.opt_state.mu, jst.opt_state.mu, 2e-6, 1e-7, "mu")
    _close(tst.opt_state.nu, jst.opt_state.nu, 2e-6, 1e-12, "nu")
    assert int(tst.opt_state.count) == int(jst.opt_state.count) == 5
    np.testing.assert_allclose(float(tst.opt_state.prev_norm), float(jst.opt_state.prev_norm), rtol=1e-6)


CASES = {  # (step kwargs, problem kwargs, rtol); 5 steps, atol 1e-6, eps region aside
    # a binding clip: the norms add in other orders (rtol 1e-5)
    "binding_clip": (dict(clip=1e-4), {}, 1e-5),
    # deep supervision, folded per layer into the sweep
    "deep_supervision": (dict(lw="uniform"), {}, 2e-6),
    # a general z-dictionary B (d != m)
    "general_b": (dict(clip=1e9), dict(d=M + 8), 2e-6),
    # freeze and a warmup-cosine schedule
    "freeze_schedule": (dict(freeze=("beta",), lr="cosine"), {}, 2e-6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_step_matches_jax(case):
    kw, prob, rtol = CASES[case]
    A, B, leaves, batches = _problem(seed=1, **prob)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("lw"):
        jkw["lw"] = jnp.full((K,), 1.0 / K, jnp.float32)
        tkw["lw"] = torch.full((K,), 1.0 / K)
    if kw.get("lr"):
        jkw["lr"] = optax.warmup_cosine_decay_schedule(0.0, LR, 2, 10)
        tkw["lr"] = tloop.warmup_cosine_decay_schedule(0.0, LR, 2, 10)
    jst, jl = _jax_run(A, B, leaves, batches, **jkw)
    tst, tl = _torch_run(A, B, leaves, batches, **tkw)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    _close(tst.params, jst.params, rtol, 1e-6, "params", _eps_region(A, B, leaves, batches, **jkw))
    if case == "binding_clip":
        assert float(tst.opt_state.prev_norm) > 1e-4  # the clip bound
    if case == "freeze_schedule":
        assert torch.equal(tst.params.beta, torch.as_tensor(leaves[4]))
    if case == "general_b":
        assert tst.params.W2.shape == (K, M + 8, M)


def test_fused_bf16_matches_jax_and_chain():
    """bf16 compute: the fp32 masters against the port's bf16 chain on
    the manual backward (the JAX test's comparison, rtol 1e-5 / atol
    1e-7), the compute copy the new masters rounded. Against the JAX
    package's bf16 fused step the first loss agrees within rtol 1e-6,
    but the gradients are other functions: XLA on the CPU keeps bf16
    intermediates in fp32 where the port rounds each operation (as
    bwd_from_carries in bf16 does; ROADMAP.md §3), and 83% of the W1
    elements differ by more than 1e-6 after 3 steps. The masters are
    held within Adam's bound of lr a step here, and element by element
    in test_fused_bf16_update_agrees_with_jax."""
    A, B, leaves, batches = _problem(seed=2, steps=3)
    bf = torch.bfloat16
    tst, tl = _torch_run(A, B, leaves, batches, clip=1e9, compute_dtype=bf)
    jst, jl = _jax_run(A, B, leaves, batches, clip=1e9, compute_dtype=jnp.bfloat16)
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-6)
    _close(tst.params, jst.params, 0, 2 * LR * len(batches), "params vs jax")
    opt = tloop.chain(tloop.delayed_clip_by_global_norm(1e9), tloop.adam(LR))
    step = tloop.make_train_step_from_batch(opt, torch.as_tensor(A), vjp="manual", compute_dtype=bf)
    cst = tloop.make_train_state(params_from_numpy(*leaves), opt, bf)
    for b, x, e in batches:
        cst, _ = step(cst, SyntheticBatch(*map(torch.as_tensor, (b, x, e))))
    _close(tst.params, [p.numpy() for p in cst.params], 1e-5, 1e-7, "params vs chain")
    for cp, p in zip(tst.compute_params, tst.params):
        assert cp.dtype == bf and torch.equal(cp, p.to(bf))


BF16_ULP = 2.0 ** -7  # bf16's spacing relative to a power of two


def test_fused_bf16_update_agrees_with_jax():
    """bf16 compute: each element's update (new master - old) against the
    JAX package's, outside Adam's eps region. After one step both are
    lr * g / (|g| + eps): the signs agree on at least 99.9% of each leaf
    and the updates lie within 2 bf16 ulps of lr (2 * 2^-7 * lr) of each
    other. After 3 steps the signs agree on at least 99% of each leaf and
    each leaf's update differs from the JAX package's by at most 10% of
    its norm. On the CPU (seeds 2, 5, 7) every sign agrees after one step
    with the updates at most 5.5e-3 * lr apart; after 3 steps at least
    99.73% agree, at most 4.7% of the norm apart. A wrong sign moves an
    element by 2 * lr and fails."""
    for seed in (2, 5, 7):
        A, B, leaves, batches = _problem(seed=seed, steps=3)
        eps = _eps_region(A, B, leaves, batches, clip=1e9, compute_dtype=jnp.bfloat16)
        for steps in (1, 3):
            tst, _ = _torch_run(A, B, leaves, batches[:steps], clip=1e9, compute_dtype=torch.bfloat16)
            jst, _ = _jax_run(A, B, leaves, batches[:steps], clip=1e9, compute_dtype=jnp.bfloat16)
            for name, t, j, v, mask in zip(tst.params._fields, tst.params, jst.params, leaves, eps):
                dt = (t.float().numpy() - v)[~mask]
                dj = (np.asarray(j, np.float32) - v)[~mask]
                agree = float((np.sign(dt) == np.sign(dj)).mean())
                what = f"seed {seed}, {steps} step(s), {name}"
                if steps == 1:
                    assert agree >= 0.999, (what, agree)
                    assert float(np.abs(dt - dj).max()) <= 2 * BF16_ULP * LR, what
                else:
                    assert agree >= 0.99, (what, agree)
                    assert np.linalg.norm(dt - dj) <= 0.1 * np.linalg.norm(dj), what


@pytest.mark.parametrize("clip", [1e9, 1e-3])
def test_fused_step_matches_port_delayed_chain(clip):
    """Against the port's chain(delayed_clip_by_global_norm, adam) over
    the manual backward on the same batches: bit for bit while the clip
    does not bind, the JAX test's rtol 1e-5 where it binds."""
    A, B, leaves, batches = _problem(seed=3)
    tst, tl = _torch_run(A, B, leaves, batches, clip=clip)
    opt = tloop.chain(tloop.delayed_clip_by_global_norm(clip), tloop.adam(LR))
    step = tloop.make_train_step_from_batch(opt, torch.as_tensor(A), vjp="manual")
    cst = tloop.make_train_state(params_from_numpy(*leaves), opt)
    cl = []
    for b, x, e in batches:
        cst, loss = step(cst, SyntheticBatch(*map(torch.as_tensor, (b, x, e))))
        cl.append(float(loss))
    np.testing.assert_allclose(tl, cl, rtol=1e-6)
    rtol, atol = (2e-6, 3e-8) if clip > 1 else (1e-5, 1e-8)
    _close(tst.params, [p.numpy() for p in cst.params], rtol, atol, "params")


def test_clip_norm_zero_means_disabled():
    A, B, leaves, batches = _problem(seed=4, steps=1)
    zero, _ = _torch_run(A, B, leaves, batches, clip=0.0)
    none, _ = _torch_run(A, B, leaves, batches, clip=None)
    assert max(float((p - torch.as_tensor(v)).abs().max()) for p, v in zip(zero.params, leaves)) > 0
    for a, b in zip(zero.params, none.params):
        assert torch.equal(a, b)


def _cfg(**train):
    base = dict(batch=S, steps=6, eval_every=3, eval_batch=S, lr=LR, clip_norm=1.0, clip_mode="delayed",
                optimizer="fused_adam", layer_loss="uniform")
    base.update(train)
    return Config(name="t", problem=ProblemConfig(m=M, n=N, K=K), train=TrainConfig(**base))


def test_fit_fused_trains_and_resumes(tmp_path):
    """fit(optimizer='fused_adam') trains (finite, below its first eval),
    checkpoints the FusedAdamState and resumes to the cold run bit for
    bit; general B composes."""
    cold, hist = tloop.fit(_cfg(), device="cpu")
    assert [h["step"] for h in hist] == [3, 6] and all(np.isfinite(h["nmse_db"]) for h in hist)
    assert hist[-1]["nmse_db"] < hist[0]["curves"]["ladmm_curve_db"][-1] + 1.0
    tloop.fit(dataclasses.replace(_cfg(), train=dataclasses.replace(_cfg().train, steps=3)),
              ckpt_dir=str(tmp_path), device="cpu")
    warm, hist2 = tloop.fit(_cfg(), ckpt_dir=str(tmp_path), resume=True, device="cpu")
    assert [h["step"] for h in hist2] == [6]
    for a, b in zip(warm, cold):
        assert torch.equal(a, b)
    from dladmm_tpu_torch.utils.checkpoint import latest_step_dir

    data = torch.load(latest_step_dir(str(tmp_path)), weights_only=True)
    assert set(data["opt_state"]) == {"mu", "nu", "count", "prev_norm"} and int(data["opt_state"]["count"]) == 6
    gen_b = dataclasses.replace(_cfg(), problem=ProblemConfig(m=M, n=N, K=K, identity_B=False, d=M + 4))
    _, gh = tloop.fit(gen_b, device="cpu")
    assert np.isfinite(gh[-1]["nmse_db"])


BAD = {
    "clip_mode_global": (dict(clip_mode="global"), {}, "delayed"),
    "vjp_xla": (dict(vjp="xla"), {}, "vjp='xla'"),
    "accum": (dict(accum_steps=2), {}, "accumulation"),
    "moments": (dict(moment_dtype="int8_pallas"), {}, "moment_dtype"),
    "nonneg": ({}, dict(nonneg_x=True, prox_x="nonneg_l1"), "l1"),
    "prox": ({}, dict(prox_z="box"), "l1 backward"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_fit_fused_validations(case):
    train, prob, match = BAD[case]
    cfg = _cfg(**train)
    if prob:
        cfg = dataclasses.replace(cfg, problem=dataclasses.replace(cfg.problem, **prob))
    with pytest.raises(ValueError, match=match):
        tloop.fit(cfg, device="cpu")


def test_fit_fused_refuses_a_forward_fn():
    with pytest.raises(ValueError, match="owns the forward"):
        tloop.fit(_cfg(), forward_fn=lambda *a: None, device="cpu")


CLI_BAD = {  # run.py's refusals of --optimizer=fused_adam: check_fused_adam's messages
    "clip_mode": (["--config=synthetic_small", "--moment-dtype=float32"], "needs clip_mode='delayed'"),
    "vjp_xla": (["--config=smoke", "--vjp=xla"], "vjp='xla' contradicts it"),
    "kernel": (["--config=smoke", "--kernel=reference"], "does not apply"),
    "moments": (["--config=smoke", "--moment-dtype=int8"], "owns its (fp32) moment"),
    "general_b_vjp_xla": (["--config=synthetic_general_b", "--moment-dtype=float32", "--clip-mode=delayed",
                           "--vjp=xla"], "vjp='xla' contradicts it"),
}


@pytest.mark.parametrize("case", sorted(CLI_BAD))
def test_run_cli_fused_refusals_are_check_fused_adam(case, monkeypatch, capsys):
    """run.py refuses what check_fused_adam refuses, with its message (the
    kernel rule for identity B only, as the JAX CLI has it)."""
    from dladmm_tpu_torch import run as trun

    argv, match = CLI_BAD[case]
    monkeypatch.setenv("DLADMM_PLATFORM", "cpu")
    with pytest.raises(SystemExit):
        trun.main(["--steps=1", "--optimizer=fused_adam", *argv])
    assert match in capsys.readouterr().err
