"""Port parity: dladmm_tpu_torch.ops (layer steps, shrink, proxes) against
the JAX package's dladmm_tpu.ops on the same numpy inputs, on the CPU.

Tolerances are the JAX megakernel tests' rtol 1e-5 / atol 1e-6: both
sides compute in float32 and differ only in summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dladmm_tpu.ops import prox as jprox
from dladmm_tpu.ops import reference as jref
from dladmm_tpu_torch.ops import prox as tprox
from dladmm_tpu_torch.ops import reference as tref

RTOL, ATOL = 1e-5, 1e-6
SHAPES = [(16, 32, 8), (33, 77, 13)]  # (m, n, S)


def _close(got, want, **kw):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL, **kw
    )


def _layer(m, n, d, S, seed, general_B=False):
    """One layer's params, a state and b, drawn with numpy at the scales
    of a real solve: unit-norm dictionary columns, a small state."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * rng.normal(size=s)).astype(np.float32)

    def dictionary(rows, cols):
        M = f(rows, cols)
        return M / np.linalg.norm(M, axis=0, keepdims=True)

    arrs = dict(
        A=dictionary(m, n), b=f(S, m), x=f(S, n, scale=0.1),
        z=f(S, d, scale=0.1), lam=f(S, m, scale=0.1),
        W1=f(n, m, scale=0.1), W2=f(d, m, scale=0.1),
        theta1=np.abs(f(n, scale=0.05)), theta2=np.abs(f(d, scale=0.05)),
        beta=np.float32(1.3),
    )
    arrs["B"] = dictionary(m, d) if general_B else None
    return arrs


def _both(arrs):
    j = {k: None if v is None else jnp.asarray(v) for k, v in arrs.items()}
    t = {k: None if v is None else torch.as_tensor(v) for k, v in arrs.items()}
    return j, t


@pytest.mark.parametrize("general_B", [False, True])
@pytest.mark.parametrize("m,n,S", SHAPES)
def test_layer_step_matches_jax(m, n, S, general_B):
    d = m + 5 if general_B else m
    j, t = _both(_layer(m, n, d, S, seed=m, general_B=general_B))
    pj = jref.LayerParams(j["W1"], j["W2"], j["theta1"], j["theta2"], j["beta"])
    pt = tref.LayerParams(t["W1"], t["W2"], t["theta1"], t["theta2"], t["beta"])
    want = jref.dladmm_layer_step(j["A"], j["B"], j["b"], j["x"], j["z"], j["lam"], pj)
    got = tref.dladmm_layer_step(t["A"], t["B"], t["b"], t["x"], t["z"], t["lam"], pt)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("general_B", [False, True])
@pytest.mark.parametrize("m,n,S", SHAPES)
def test_cached_layer_step_matches_jax(m, n, S, general_B):
    d = m + 5 if general_B else m
    j, t = _both(_layer(m, n, d, S, seed=n, general_B=general_B))
    pj = jref.LayerParams(j["W1"], j["W2"], j["theta1"], j["theta2"], j["beta"])
    pt = tref.LayerParams(t["W1"], t["W2"], t["theta1"], t["theta2"], t["beta"])
    Axj = jref.apply_dict(j["x"], j["A"])
    Bzj = jref.apply_B(j["z"], j["B"])
    Axt = tref.apply_dict(t["x"], t["A"])
    Bzt = tref.apply_B(t["z"], t["B"])
    _close(Axt, Axj)
    _close(Bzt, Bzj)
    want = jref.dladmm_layer_step_cached(
        j["A"], j["B"], j["b"], j["x"], j["z"], j["lam"], Axj, Bzj, pj
    )
    got = tref.dladmm_layer_step_cached(
        t["A"], t["B"], t["b"], t["x"], t["z"], t["lam"], Axt, Bzt, pt
    )
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(g, w)


def test_layer_step_clamps_beta_and_theta():
    """beta below _BETA_MIN and negative thresholds are clamped at use,
    as in the JAX step."""
    arrs = _layer(16, 32, 16, 8, seed=3)
    arrs["beta"] = np.float32(-2.0)
    arrs["theta1"] = -np.abs(arrs["theta1"])
    j, t = _both(arrs)
    assert tref._BETA_MIN == jref._BETA_MIN
    pj = jref.LayerParams(j["W1"], j["W2"], j["theta1"], j["theta2"], j["beta"])
    pt = tref.LayerParams(t["W1"], t["W2"], t["theta1"], t["theta2"], t["beta"])
    want = jref.dladmm_layer_step(j["A"], None, j["b"], j["x"], j["z"], j["lam"], pj)
    got = tref.dladmm_layer_step(t["A"], None, t["b"], t["x"], t["z"], t["lam"], pt)
    # beta clamped to 1e-6 scales lam / beta to ~1e6: the float32
    # rounding of both sides scales with it, so atol is relative to the
    # largest output.
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            np.asarray(g), w, rtol=RTOL, atol=RTOL * np.abs(w).max()
        )


@pytest.mark.parametrize("theta", [0.3, -0.2, "vector"])
def test_shrink_matches_jax(theta):
    rng = np.random.default_rng(1)
    u = rng.normal(size=(9, 21)).astype(np.float32)
    u[0, :3] = 0.0
    th = rng.normal(size=(21,)).astype(np.float32) if theta == "vector" else np.float32(theta)
    want = jref.shrink(jnp.asarray(u), jnp.asarray(th))
    got = tref.shrink(torch.as_tensor(u), torch.as_tensor(th))
    _close(got, want)


@pytest.mark.parametrize("name", ["l1", "nonneg_l1", "box", "elastic_net", "group_l2"])
def test_prox_matches_jax(name):
    """All five proxes, vector and scalar thresholds (some negative, so
    the clamp is hit), with an exactly-zero row for group_l2's safe
    norm."""
    rng = np.random.default_rng(2)
    u = rng.normal(size=(7, 19)).astype(np.float32)
    u[3] = 0.0
    for th in (
        (0.3 * rng.normal(size=(19,))).astype(np.float32),
        np.float32(0.4),
        np.float32(-0.1),
    ):
        want = jprox.get_prox(name, rho=0.3)(jnp.asarray(u), jnp.asarray(th))
        got = tprox.get_prox(name, rho=0.3)(torch.as_tensor(u), torch.as_tensor(th))
        _close(got, want)


def test_group_l2_zero_row_has_finite_grad():
    """The safe norm keeps autograd finite on an all-zero row."""
    u = torch.zeros((2, 5), requires_grad=True)
    with torch.no_grad():
        u[1] = torch.arange(5.0)
    tprox.prox_group_l2(u, torch.tensor(0.5)).sum().backward()
    assert torch.isfinite(u.grad).all()


def test_registry_matches_jax():
    assert tprox.PROX_NAMES == jprox.PROX_NAMES
    for name in tprox.PROX_NAMES:
        assert tprox.kernel_exact(tprox.get_prox(name, 0.3)) == jprox.kernel_exact(
            jprox.get_prox(name, 0.3)
        ), name
    for args in [("l1", "l1", 0.0), ("elastic_net", "l1", 0.0),
                 ("elastic_net", "l1", 0.2), ("box", "l1", 0.0)]:
        assert tprox.is_l1(*args) == jprox.is_l1(*args)
    with pytest.raises(ValueError, match="unknown prox"):
        tprox.get_prox("l3")
    with pytest.raises(ValueError, match="rho"):
        tprox.get_prox("elastic_net", rho=-1.0)


def test_init_state_shapes():
    b = torch.ones((5, 7))
    x, z, lam = tref.init_state(b, 11, 13)
    assert x.shape == (5, 11) and z.shape == (5, 13) and lam.shape == (5, 7)
    assert not (x.any() or z.any() or lam.any())
