"""Port parity for the dense half of the fused optimizer
(train/qadam_cuda.py: moment formats float32, bfloat16, bfloat16_sr,
bfloat16_sr_mu) and for stochastic rounding (train/qmoments.py).

On the CPU the dense sweep's wrapper runs its plain version. It is held
against the JAX package's ``QAdamFusedPallas(moment_fmt=f)`` with its
Pallas kernel (``_make_kernel_dense``) in interpret mode, over 3 chained
steps from a non-zero state carried across by
``utils.torch_compat.opt_state_from_numpy``: ``fused_apply`` and the
optax-style ``update``. Leaves: W1 (2, 256, 128), which the JAX package
sends to its kernel, and smaller ones it sweeps with jnp; the port
sweeps all of them the same way. Masters within rtol 1e-6, atol 1e-7.
Stored moments equal where the JAX package computes them with jnp (its
``update``, and the leaves its kernel does not take). Its interpret-mode
kernel differs from its own jnp path by one rounding: XLA's CPU compiler
contracts ``b1 * mu + (1 - b1) * g`` into a fused multiply-add, which
neither the jnp path, nor the port's plain version, nor its CUDA kernel
(round-to-nearest intrinsics) does. So on the leaf that kernel sweeps
the moments agree within atol 1e-6 * max|moment| (the largest gap seen
is 1.5e-7 of it after three steps). The SR formats draw other random
bits than the JAX package's (threefry there, a counter hash here,
Philox on the card), so they are held by what SR promises: every stored
value is one of the two bf16 neighbours of the fp32 moment, and the
mean over 64 seeds is the fp32 value within 5 standard errors for each
of 4096 values and within 4 for their sum. The CUDA kernel itself is
held against the plain version by tests/test_torch_cuda.py (``gpu``)
and chip_smoke.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dladmm_tpu.models.unroll import DLADMMParams as JParams
from dladmm_tpu.train import loop as jloop
from dladmm_tpu.train import qadam_pallas as jqa
from dladmm_tpu.utils.config import TrainConfig
from dladmm_tpu_torch.models.unroll import DLADMMParams
from dladmm_tpu_torch.train import loop as tloop
from dladmm_tpu_torch.train import qadam_cuda as tqa
from dladmm_tpu_torch.train import qmoments as tqm
from dladmm_tpu_torch.utils.torch_compat import opt_state_from_numpy, params_from_numpy

SHAPES = [(2, 256, 128), (2, 128, 128), (2, 256), (2, 128), (2,)]


def _cfg(fmt):
    return TrainConfig(lr=1e-2, steps=40, lr_schedule="cosine", clip_norm=1.0, moment_dtype=f"{fmt}_pallas")


def _leaves(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.normal(size=s)).astype(np.float32) for s in SHAPES]


def _carried_state(fmt, seed=1):
    """A JAX optimizer, params and a non-zero dense state after one step,
    and the same carried into the port."""
    jopt = dataclasses.replace(jloop._build_optimizer(_cfg(fmt)), interpret=True)
    jp = JParams(*map(jnp.asarray, _leaves(seed)))
    js = jopt.init(jp)
    jp, js, _ = jopt.fused_apply(JParams(*map(jnp.asarray, _leaves(seed + 1, 0.3))), js, jp)
    return jopt, jp, js, params_from_numpy(*[np.asarray(v) for v in jp]), opt_state_from_numpy(js)


def _assert_masters_close(tp, jp):
    for name, g, w in zip(JParams._fields, tp, jp):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7, err_msg=name)


def _assert_moments_equal(ts, js, jax_kernel_leaves=()):
    """Equal moments, but within atol 1e-6 * max|moment| on the leaves
    the JAX package swept with its interpret-mode kernel (module
    docstring: an FMA there)."""
    want = opt_state_from_numpy(js)
    assert int(ts.count) == int(want.count)
    for moment in ("mu", "nu"):
        for name, g, w in zip(JParams._fields, getattr(ts, moment), getattr(want, moment)):
            assert g.dtype == w.dtype and g.shape == w.shape, (moment, name)
            if name in jax_kernel_leaves:
                torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                           atol=1e-6 * float(w.float().abs().max()))
            else:
                assert torch.equal(g, w), (moment, name, float((g.float() - w.float()).abs().max()))


@pytest.mark.parametrize("fmt", ["float32", "bfloat16"])
def test_fused_sweep_matches_jax_over_three_steps(fmt):
    jopt, jp, js, tp, ts = _carried_state(fmt)
    topt = tloop._build_optimizer(_cfg(fmt))
    assert isinstance(topt, tqa.QAdamFused) and topt.moment_fmt == fmt
    for step in range(3):
        g = _leaves(10 + step, scale=0.5 if step else 3.0)  # step 0 is clipped
        jp, js, _ = jopt.fused_apply(JParams(*map(jnp.asarray, g)), js, jp)
        tp, ts, _ = topt.fused_apply(params_from_numpy(*g), ts, tp)
    _assert_masters_close(tp, jp)
    kernel_leaves = [n for n, v in zip(JParams._fields, jp) if jqa.leaf_eligible(v)]
    assert kernel_leaves == ["W1"]
    _assert_moments_equal(ts, js, kernel_leaves)
    assert tqa.adam_dense_rows.launches == 0  # the CPU launches nothing


@pytest.mark.parametrize("fmt", ["float32", "bfloat16"])
def test_update_matches_jax_over_three_steps(fmt):
    """The optax-style plain path: updates (the negated step) and new
    states, the inputs untouched."""
    jopt, jp, js, tp, ts = _carried_state(fmt, seed=3)
    topt = tloop._build_optimizer(_cfg(fmt))
    for step in range(3):
        g = _leaves(20 + step, scale=0.2)
        jup, js = jopt.update(JParams(*map(jnp.asarray, g)), js, jp)
        jp = optax.apply_updates(jp, jup)
        before = [m.clone() for m in ts.mu]
        tup, ts2 = topt.update(params_from_numpy(*g), ts, tp)
        assert all(torch.equal(a, b) for a, b in zip(before, ts.mu))
        tp, ts = tloop.apply_updates(tp, tup), ts2
        for name, a, b in zip(JParams._fields, tup, jup):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9, err_msg=name)
    _assert_masters_close(tp, jp)
    _assert_moments_equal(ts, js)


def test_mix_seed_matches_jax():
    counts = list(range(0, 5000, 37)) + [2**16 - 1, 2**16, 2**24 + 3, 2**31 - 1]
    c = jnp.asarray(counts, jnp.int32)
    for idx in range(5):
        want = np.asarray(jqa._mix_seed(c, idx))
        got = tqa._mix_seed(torch.tensor(counts, dtype=torch.int32), idx)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    many = tqa._mix_seed(torch.tensor(7, dtype=torch.int32), torch.arange(5))
    np.testing.assert_array_equal(many.numpy(), [int(jqa._mix_seed(jnp.int32(7), i)) for i in range(5)])


def _neighbours(x: torch.Tensor):
    """The two bf16 values around each fp32 x: truncated toward zero,
    and one bf16 step away from zero."""
    bits = x.view(torch.int32)
    lo = (bits & ~0xFFFF).view(torch.float32)
    hi = ((bits & ~0xFFFF) + 0x10000).view(torch.float32)
    return lo, hi


def test_sr_bfloat16_neighbours_and_unbiased():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=4096).astype(np.float32) * np.float32(1e-3))
    x[:8] = torch.tensor([0.0, -0.0, 1.0, -1.0, 1 + 2**-9, 3e-39, 1e30, -2.5])
    lo, hi = _neighbours(x)
    total = torch.zeros_like(x, dtype=torch.float64)
    seeds = 64
    for s in range(seeds):
        y = tqm.sr_bfloat16(x, torch.tensor(s, dtype=torch.int32)).float()
        assert ((y == lo) | (y == hi)).all()
        total += y.double()
    # Each draw is lo or hi: variance (hi - lo)^2 p (1 - p) <= (hi - lo)^2 / 4.
    sigma = (hi - lo).double().abs() / 2 / seeds ** 0.5
    err = (total / seeds - x.double()).abs()
    assert (err <= 5 * sigma + 1e-30).all()
    # the whole set: the mean error over 4096 values is 0 within 4 sigma
    assert abs(float((total / seeds - x.double()).sum())) <= 4 * float(sigma.pow(2).sum().sqrt())
    same = tqm.sr_bfloat16(x, torch.tensor(5, dtype=torch.int32), stream=0)
    assert torch.equal(same, tqm.sr_bfloat16(x, torch.tensor(5, dtype=torch.int32), stream=0))
    assert not torch.equal(same, tqm.sr_bfloat16(x, torch.tensor(5, dtype=torch.int32), stream=1))


@pytest.mark.parametrize("fmt", ["bfloat16_sr", "bfloat16_sr_mu"])
def test_sr_formats_step(fmt):
    """One fused step of an SR format from the JAX state: the masters as
    the JAX package's (this step's rounding does not reach them), each
    stored moment a bf16 neighbour of the fp32 moment of the same step,
    bfloat16_sr_mu's fp32 nu equal to the JAX package's; the same seed
    stores the same bits, and update stores what fused_apply stores."""
    jopt, jp, js, tp, ts = _carried_state(fmt, seed=4)
    topt = tloop._build_optimizer(_cfg(fmt))
    mu_dt, nu_dt, _, _ = tqa.DENSE_FMTS[fmt]
    assert all(m.dtype == mu_dt for m in ts.mu) and all(v.dtype == nu_dt for v in ts.nu)
    g = _leaves(30, scale=0.5)
    exact = tqa.QAdamFused(topt.learning_rate, moment_fmt="float32", clip_norm=1.0)
    f32 = tqa.QMomentsState(ts.count, DLADMMParams(*(m.float() for m in ts.mu)),
                            DLADMMParams(*(v.float() for v in ts.nu)))
    _, want = exact.update(params_from_numpy(*g), f32)
    _, upd_state = topt.update(params_from_numpy(*g), ts)
    jp, js, _ = jopt.fused_apply(JParams(*map(jnp.asarray, g)), js, jp)
    tp, ts, _ = topt.fused_apply(params_from_numpy(*g), ts, tp)
    _assert_masters_close(tp, jp)
    for moment, dt in (("mu", mu_dt), ("nu", nu_dt)):
        for name, got, w, u in zip(JParams._fields, getattr(ts, moment), getattr(want, moment),
                                   getattr(upd_state, moment)):
            assert got.dtype == dt
            assert torch.equal(got, u), (moment, name)
            if dt == torch.float32:
                np.testing.assert_array_equal(got.numpy(), getattr(js, moment)[JParams._fields.index(name)])
                continue
            lo, hi = _neighbours(w)
            assert ((got.float() == lo) | (got.float() == hi)).all(), (moment, name)


def test_dense_rows_plain_is_in_place():
    master = torch.as_tensor(_leaves(40)[0]).reshape(-1, 128)
    mu = torch.zeros_like(master, dtype=torch.bfloat16)
    nu = torch.zeros_like(master, dtype=torch.bfloat16)
    ptrs = [t.data_ptr() for t in (master, mu, nu)]
    before = master.clone()
    g = torch.as_tensor(_leaves(41)[0]).reshape(-1, 128)
    tqa.adam_dense_rows(g, master, mu, nu, torch.tensor([0.1, 0.001, 1e-3, 1.0]), "bfloat16_sr",
                        torch.tensor(3, dtype=torch.int32))
    assert [t.data_ptr() for t in (master, mu, nu)] == ptrs
    assert not torch.equal(master, before) and bool(mu.ne(0).any()) and bool(nu.ne(0).any())
    assert tqa.adam_dense_rows.launches == 0
    with pytest.raises(ValueError, match="fmt"):
        tqa.adam_dense_rows(g, master, mu, nu, torch.zeros(4), "int8")


def test_dense_state_carries_from_jax_bit_for_bit():
    for fmt in tqa.DENSE_FMTS:
        _, _, js, _, ts = _carried_state(fmt, seed=6)
        topt = tloop._build_optimizer(_cfg(fmt))
        fresh = topt.init(params_from_numpy(*_leaves(0)))
        for moment in ("mu", "nu"):
            for name, got, w, z in zip(JParams._fields, getattr(ts, moment), getattr(js, moment),
                                       getattr(fresh, moment)):
                assert got.dtype == z.dtype and got.shape == z.shape and not bool(z.any()), (fmt, name)
                np.testing.assert_array_equal(got.float().numpy(), np.asarray(w, np.float32))
