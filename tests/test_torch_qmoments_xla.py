"""Port parity for the XLA-side reduced-precision Adam moments
(train/qmoments.scale_by_adam_qmoments / adam_qmoments: ``moment_dtype``
int8, bfloat16 and bfloat16_sr without ``_pallas``) and their routing in
train/loop._build_optimizer.

The same numpy gradients go through the JAX package's optax
transformation and the port's on the CPU. Tolerances: the stored
moments equal, with an allowance of one int8 code or one bf16 ulp where
XLA contracts ``b1*m + (1-b1)*g`` into a fused multiply-add (a rounding
the port's separate multiply and add need not share; ROADMAP.md §3 has
the same allowance for the dense kernel); the updates within 2e-6 of
each leaf's largest (pow, sqrt and the divisions round in either
library's own way). bfloat16_sr draws other random bits than jax.random
by design: it is held by unbiasedness over seeds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dladmm_tpu.models.unroll import DLADMMParams as JParams
from dladmm_tpu.train import loop as jloop
from dladmm_tpu.train import qmoments as jqm
from dladmm_tpu.utils.config import TrainConfig
from dladmm_tpu_torch.models.unroll import DLADMMParams
from dladmm_tpu_torch.train import loop as tloop
from dladmm_tpu_torch.train import qmoments as tqm
from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

SHAPES = [(3, 40, 16), (3, 16, 16), (3, 40), (3, 16), (3,)]  # K = 3, n = 40, m = 16
SCALES = [0.1, 2.0, 0.01, 0.1, 1.0]  # per step: gradients of very different sizes
UPD_TOL = 2e-6


def _leaves(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.normal(size=s)).astype(np.float32) for s in SHAPES]


def _t(leaves, dtype=torch.float32) -> DLADMMParams:
    return params_from_numpy(*leaves, dtype=dtype)


def _moments_close(tstate, jstate, fmt):
    for which in ("mu", "nu"):
        for name, t, j in zip(JParams._fields, getattr(tstate, which), getattr(jstate, which)):
            if fmt == "int8":
                dc = np.abs(t.codes.numpy().astype(int) - np.asarray(j.codes).astype(int))
                assert dc.max() <= 1, (which, name)
                np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale), rtol=1e-6, err_msg=name)
            else:
                got = t.float().numpy()
                want = np.asarray(j).astype(np.float32)
                ulp = np.abs(want) * 2.0**-7 + 1e-38
                assert np.all(np.abs(got - want) <= ulp), (which, name)


def _updates_close(tup, jup):
    for name, a, b in zip(JParams._fields, tup, jup):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=UPD_TOL, atol=UPD_TOL * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("fmt", ["bfloat16", "int8"])
def test_adam_qmoments_matches_jax(fmt):
    """5 steps of the same gradients: decoded moments, stored state and
    updates against the JAX package's adam_qmoments."""
    jopt, topt = jqm.adam_qmoments(1e-2, moment_dtype=fmt), tqm.adam_qmoments(1e-2, moment_dtype=fmt)
    jp, tp = JParams(*map(jnp.asarray, _leaves(0))), _t(_leaves(0))
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        g = _leaves(10 + step, SCALES[step])
        jup, js = jopt.update(JParams(*map(jnp.asarray, g)), js, jp)
        tup, ts = topt.update(_t(g), ts, tp)
        _updates_close(tup, jup)
        _moments_close(ts[0], js[0], fmt)
        assert int(ts[0].count) == int(js[0].count) == step + 1
        like = _t(g)
        for which in ("mu", "nu"):  # decoded moments
            for t, j, g_ in zip(tqm._decode(getattr(ts[0], which), like, fmt),
                                jqm._decode(getattr(js[0], which), JParams(*map(jnp.asarray, g)), fmt), like):
                j = np.asarray(j)
                assert t.shape == g_.shape
                np.testing.assert_allclose(t.numpy(), j, rtol=1e-2 if fmt == "int8" else 2.0**-7,
                                           atol=1e-30)
        jp, tp = optax.apply_updates(jp, jup), tloop.apply_updates(tp, tup)
    for name, a, b in zip(JParams._fields, tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("fmt", ["bfloat16", "int8", "bfloat16_sr"])
def test_bf16_gradients_are_widened(fmt):
    """bf16 gradients (compute_dtype="bfloat16") are widened with
    .to(float32): the same state and updates as their fp32 widening, and
    the JAX package's on the same bf16 gradients (its astype(f32))."""
    g = [a.astype(jnp.bfloat16) for a in _leaves(3, 0.5)]
    g16 = _t([np.asarray(a.astype(np.float32)) for a in g], dtype=torch.bfloat16)
    g32 = DLADMMParams(*(v.float() for v in g16))
    opt = tqm.scale_by_adam_qmoments(moment_dtype=fmt)
    p = _t(_leaves(0))
    s0 = opt.init(p)
    u16, s16 = opt.update(g16, s0, p)
    u32, s32 = opt.update(g32, s0, p)
    for a, b in zip(u16, u32):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    assert torch.equal(s16.key, s32.key) if fmt == "bfloat16_sr" else s16.key is None
    if fmt != "bfloat16_sr":
        jopt = jqm.scale_by_adam_qmoments(moment_dtype=fmt)
        jp = JParams(*map(jnp.asarray, _leaves(0)))
        jup, js = jopt.update(JParams(*map(jnp.asarray, g)), jopt.init(jp), jp)
        _updates_close(u16, jup)
        _moments_close(s16, js, fmt)


def test_sr_key_and_unbiasedness():
    """bfloat16_sr: the key is 17 at init and advances once a step; each
    stored value is one of the two bf16 neighbours of the fp32 moment, and
    over 64 keys the stored mean is the fp32 value (unbiased); the first
    step's update is the JAX package's (the zero state decodes exactly)."""
    opt = tqm.scale_by_adam_qmoments(moment_dtype="bfloat16_sr")
    p = _t(_leaves(0))
    s = opt.init(p)
    assert s.key.dtype == torch.int32 and int(s.key) == tqm.SR_KEY0 == 17
    assert all(v.dtype == torch.bfloat16 and not v.any() for v in (*s.mu, *s.nu))
    g = _t(_leaves(4, 0.3))
    u, s1 = opt.update(g, s, p)
    _, s2 = opt.update(g, s1, p)
    keys = [int(s.key), int(s1.key), int(s2.key)]
    assert len(set(keys)) == 3 and int(tqm._next_key(s.key)) == keys[1]
    jopt = jqm.scale_by_adam_qmoments(moment_dtype="bfloat16_sr")
    jp = JParams(*map(jnp.asarray, _leaves(0)))
    jup, _ = jopt.update(JParams(*map(jnp.asarray, _leaves(4, 0.3))), jopt.init(jp), jp)
    _updates_close(u, jup)

    x = torch.from_numpy(np.random.default_rng(5).normal(size=4096).astype(np.float32)) * 1e-3
    lo = x.to(torch.bfloat16)  # nearest; the truncation and its successor bracket x
    draws = torch.stack([tqm._encode(DLADMMParams(x, x, x, x, x), "bfloat16_sr",
                                     torch.tensor(k, dtype=torch.int32))[0].float() for k in range(64)])
    down = (x.view(torch.int32) & ~0xFFFF).view(torch.float32)
    up = ((x.view(torch.int32) & ~0xFFFF) + 0x10000).view(torch.float32)
    assert bool(((draws == down) | (draws == up)).all())
    ulp = (up - down).abs()
    bias = (draws.mean(0) - x) / ulp  # in bf16 ulps: E = 0, sd of a mean of 64 <= 0.0625
    assert float(bias.mean().abs()) < 0.01 and float(bias.abs().max()) < 0.5
    assert not torch.equal(draws[0], lo.float()) or not torch.equal(draws[1], lo.float())


@pytest.mark.parametrize("clip_mode", ["global", "delayed"])
@pytest.mark.parametrize("fmt", ["bfloat16", "int8", "bfloat16_sr"])
def test_clip_chains_match_build_optimizer(fmt, clip_mode):
    """_build_optimizer routes moment_dtype int8 / bfloat16 / bfloat16_sr
    to scale_by_adam_qmoments + scale_by_learning_rate after the global or
    delayed clip, as the JAX package's: 3 steps (one clipped) with the
    cosine schedule; bfloat16_sr is compared on its first step only."""
    t = TrainConfig(lr=1e-2, steps=40, lr_schedule="cosine", clip_norm=1.0, clip_mode=clip_mode,
                    moment_dtype=fmt)
    jopt, topt = jloop._build_optimizer(t), tloop._build_optimizer(t)
    jp, tp = JParams(*map(jnp.asarray, _leaves(5))), _t(_leaves(5))
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(1 if fmt == "bfloat16_sr" else 3):
        g = _leaves(30 + step, scale=2.0 if step == 1 else 0.1)
        jup, js = jopt.update(JParams(*map(jnp.asarray, g)), js, jp)
        tup, ts = topt.update(_t(g), ts, tp)
        _updates_close(tup, jup)
        jp, tp = optax.apply_updates(jp, jup), tloop.apply_updates(tp, tup)
    for name, a, b in zip(JParams._fields, tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7, err_msg=name)


def _smoke(fmt, steps=6, eval_every=3, **kw):
    from dladmm_tpu_torch.utils.config import get_config

    cfg = get_config("smoke")
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, steps=steps, eval_every=eval_every, moment_dtype=fmt, clip_norm=1.0, lr_schedule="cosine",
        **kw))


@pytest.mark.parametrize("fmt", ["int8", "bfloat16_sr"])
def test_checkpoint_roundtrip_and_resume(fmt, tmp_path):
    """The QMomentsState (QTensor leaves, the SR key) survives a
    checkpoint, and a run resumed from the uninterrupted run's step-3
    checkpoint ends where that run ends, bit for bit."""
    import shutil

    from dladmm_tpu_torch.utils.checkpoint import restore_checkpoint

    cold_dir, warm_dir = tmp_path / "cold", tmp_path / "warm"
    full, _ = tloop.fit(_smoke(fmt), ckpt_dir=str(cold_dir), device="cpu")
    opt = tloop._build_optimizer(_smoke(fmt).train)
    state, _, _ = restore_checkpoint(str(cold_dir / "step_3.pt"), tloop.make_train_state(full, opt))
    qstate = state.opt_state[1][0]
    assert isinstance(qstate, tqm.QMomentsState) and int(qstate.count) == 3
    if fmt == "bfloat16_sr":
        assert qstate.key.dtype == torch.int32 and int(qstate.key) != tqm.SR_KEY0
        assert qstate.mu.W1.dtype == torch.bfloat16
    else:
        assert isinstance(qstate.mu.W1, tqm.QTensor) and qstate.mu.W1.codes.dtype == torch.int8
    warm_dir.mkdir()
    shutil.copy(cold_dir / "step_3.pt", warm_dir / "step_3.pt")
    resumed, hist = tloop.fit(_smoke(fmt), ckpt_dir=str(warm_dir), resume=True, device="cpu")
    assert [h["step"] for h in hist] == [6]
    for name, a, b in zip(DLADMMParams._fields, resumed, full):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("fmt", ["int8", "bfloat16", "bfloat16_sr"])
def test_fit_trains_with_each_format(fmt):
    """fit on the smoke preset with each XLA-side format (deep
    supervision, the recipe's clip and cosine schedule) trains: finite,
    and below classical LADMM at K. 120 steps, as the JAX package's own
    test (tests/test_qmoments.py:135-143): at 60 the int8 moments' noise
    leaves the net tied with the LADMM init on this micro config."""
    _, history = tloop.fit(_smoke(fmt, steps=120, eval_every=60), device="cpu")
    last = history[-1]
    assert np.isfinite(last["loss"]) and np.isfinite(last["nmse_db"])
    assert last["nmse_db"] < last["curves"]["ladmm_curve_db"][-1]
