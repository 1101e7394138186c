"""Port parity for the high-level solver API (models/solver.py,
``DLADMMSolver``) at m = 20, n = 40, K = 6.

The same numpy dictionary, observations and (perturbed) parameters go
into the JAX package's DLADMMSolver and the port's. The JAX solver runs
its scan (kernel="reference"), or its Pallas kernels in interpret mode
where a case names them; the port's runs its policy on the CPU (the
kernels' plain versions) and its own plain loop. Forwards within rtol
1e-5 / atol 1e-6 (the JAX package's own solver tolerance,
tests/test_solver.py); NMSE curves within 1e-3 dB. The raise rules are
the JAX package's. On the card tests/test_torch_cuda.py runs the solver
through the kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dladmm_tpu.baselines.ladmm import ladmm_run as j_ladmm
from dladmm_tpu.models.solver import DLADMMSolver as JSolver
from dladmm_tpu.models.unroll import DLADMMParams as JParams
from dladmm_tpu.models.unroll import init_dladmm_params as j_init
from dladmm_tpu_torch.baselines.ladmm import ladmm_run
from dladmm_tpu_torch.models import DLADMMSolver
from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

M, N, K, S = 20, 40, 6, 12


def _problem(seed=0, d=None, nonneg=False):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(M, N)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    B = None
    if d is not None:
        B = rng.normal(size=(M, d)).astype(np.float32)
        B /= np.linalg.norm(B, axis=0, keepdims=True)
    x = (rng.random((S, N)) < 0.1) * rng.normal(size=(S, N))
    if nonneg:
        x = np.abs(x)
    e = (rng.random((S, d or M)) < 0.1) * rng.normal(size=(S, d or M))
    b = (x @ A.T + (e if B is None else e @ B.T)).astype(np.float32)
    return A, B, b, x.astype(np.float32)


def _solvers(A, B=None, perturb=0.05, seed=1, **kw):
    """A JAX solver and a port solver on the same (perturbed LADMM-exact)
    parameters."""
    p0 = j_init(jnp.asarray(A), None if B is None else jnp.asarray(B), K=K)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(v) + perturb * rng.normal(size=v.shape).astype(np.float32) for v in p0]
    leaves[-1] = np.abs(leaves[-1])  # beta > 0
    j = JSolver(A=jnp.asarray(A), params=JParams(*map(jnp.asarray, leaves)),
                B=None if B is None else jnp.asarray(B), **kw)
    t = DLADMMSolver(A=torch.from_numpy(A), params=params_from_numpy(*leaves),
                     B=None if B is None else torch.from_numpy(B), **kw)
    return j, t


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kernel", ["auto", "reference"])
def test_solve_trajectory_curve_residual_match_jax(kernel):
    A, _, b, x_star = _problem()
    js, ts = _solvers(A, kernel="reference")
    ts = DLADMMSolver(A=ts.A, params=ts.params, kernel=kernel)
    tb, jb = torch.from_numpy(b), jnp.asarray(b)
    for got, want in zip(ts.solve(tb), js.solve(jb)):
        _close(got, want)
    for got, want in zip(ts.trajectory(tb), js.trajectory(jb)):
        assert got.shape == want.shape
        _close(got, want)
    np.testing.assert_allclose(ts.nmse_curve(tb, torch.from_numpy(x_star)).numpy(),
                               np.asarray(js.nmse_curve(jb, jnp.asarray(x_star))), atol=1e-3)
    assert float(ts.residual(tb)) == pytest.approx(float(js.residual(jb)), rel=1e-5, abs=1e-7)
    assert ts.K == js.K == K


def test_solve_matches_jax_pallas_kernels():
    """The port's default route against the JAX package's default route
    (its Pallas whole-unroll and trajectory kernels, interpret mode)."""
    A, _, b, _ = _problem(seed=3)
    js, ts = _solvers(A, seed=4)
    tb, jb = torch.from_numpy(b), jnp.asarray(b)
    for got, want in zip(ts.solve(tb), js.solve(jb)):
        _close(got, want)
    for got, want in zip(ts.trajectory(tb), js.trajectory(jb)):
        _close(got, want)


@pytest.mark.parametrize("prox_x,prox_z,rho", [
    ("nonneg_l1", "l1", 0.0), ("box", "l1", 0.0), ("l1", "elastic_net", 0.3), ("group_l2", "l1", 0.0),
])
def test_general_proxes_match_jax(prox_x, prox_z, rho):
    """General proxes: solve (the port's prox-kernel route where the prox
    has one, else the plain loop) and trajectory (plain loop) against the
    JAX package's scan."""
    A, _, b, _ = _problem(seed=5, nonneg=prox_x == "nonneg_l1")
    kw = dict(prox_x=prox_x, prox_z=prox_z, prox_rho=rho)
    js, ts = _solvers(A, kernel="reference", **kw)
    ta = DLADMMSolver(A=ts.A, params=ts.params, **kw)  # kernel="auto"
    tb, jb = torch.from_numpy(b), jnp.asarray(b)
    route = ta._paths(S)[2]
    assert route == ("plain-loop-prox" if prox_x == "group_l2" else "whole-unroll-plain-cpu-prox")
    for solver in (ts, ta):
        for got, want in zip(solver.solve(tb), js.solve(jb)):
            _close(got, want)
        for got, want in zip(solver.trajectory(tb), js.trajectory(jb)):
            _close(got, want)
    if prox_x == "nonneg_l1":
        assert float(ta.solve(tb)[0].min()) >= 0.0


def test_general_B_matches_jax():
    A, B, b, x_star = _problem(seed=7, d=16)
    js, ts = _solvers(A, B=B, seed=8)
    assert ts._paths(S)[2] == "plain-loop-reference"
    tb, jb = torch.from_numpy(b), jnp.asarray(b)
    x, z = ts.solve(tb)
    assert z.shape == (S, 16)
    for got, want in zip((x, z), js.solve(jb)):
        _close(got, want)
    for got, want in zip(ts.trajectory(tb), js.trajectory(jb)):
        _close(got, want)
    assert float(ts.residual(tb)) == pytest.approx(float(js.residual(jb)), rel=1e-5, abs=1e-7)


def test_raise_rules():
    """kernel='pallas' with a general prox raises; kernel='megakernel'
    with a general prox raises for trajectory and fit, and for a prox
    without a kernel variant; l1 with 'megakernel' or 'pallas' runs."""
    A, _, b, _ = _problem()
    tA, tb = torch.from_numpy(A), torch.from_numpy(b)
    with pytest.raises(ValueError, match="l1/l1-only"):
        DLADMMSolver.create(tA, K=4, kernel="pallas", prox_x="nonneg_l1").solve(tb)
    mega = DLADMMSolver.create(tA, K=4, kernel="megakernel", prox_x="nonneg_l1")
    with pytest.raises(ValueError, match="solve\\(\\) only"):
        mega.trajectory(tb)
    with pytest.raises(ValueError, match="solve\\(\\) only"):
        mega.fit(0, steps=1, batch=4)
    with pytest.raises(ValueError, match="prox kernel unavailable"):
        DLADMMSolver.create(tA, K=4, kernel="megakernel", prox_x="group_l2").solve(tb)
    with pytest.raises(ValueError, match="kernel"):
        DLADMMSolver.create(tA, K=4, kernel="cuda").solve(tb)
    for kernel in ("megakernel", "pallas"):
        x, _ = DLADMMSolver.create(tA, K=4, kernel=kernel).solve(tb)
        assert x.shape == (S, N)


def test_untrained_equals_ladmm():
    """The JAX package's tests/test_solver.py check: the LADMM-exact init
    solves as classical LADMM at the same depth."""
    A, _, b, _ = _problem(seed=1)
    tA, tb = torch.from_numpy(A), torch.from_numpy(b)
    x, z = DLADMMSolver.create(tA, K=6).solve(tb)
    xl, zl, _ = ladmm_run(tA, tb, iters=6)
    _close(x, xl, rtol=2e-5)
    _close(z, zl, rtol=2e-5)
    xj, zj, _ = j_ladmm(jnp.asarray(A), jnp.asarray(b), iters=6)
    _close(x, xj, rtol=2e-5)
    _close(z, zj, rtol=2e-5)


def test_general_prox_kernel_semantics():
    """The JAX package's check: the prox route ('megakernel') equals the
    plain loop ('reference') for nonneg_l1, and 'auto' keeps x >= 0."""
    A, _, b, _ = _problem(seed=2)
    tA, tb = torch.from_numpy(A), torch.from_numpy(b)
    x_mega, z_mega = DLADMMSolver.create(tA, K=4, kernel="megakernel", prox_x="nonneg_l1").solve(tb)
    x_ref, z_ref = DLADMMSolver.create(tA, K=4, kernel="reference", prox_x="nonneg_l1").solve(tb)
    _close(x_mega, x_ref)
    _close(z_mega, z_ref)
    x, _ = DLADMMSolver.create(tA, K=4, prox_x="nonneg_l1").solve(tb)
    assert float(x.min()) >= 0.0


@pytest.mark.parametrize("prox_x", ["l1", "nonneg_l1"])
def test_fit_trains_and_returns_a_new_solver(prox_x):
    """fit (int seed, step_generator draws, plain fp32 Adam) returns a new
    solver whose last layer beats the untrained one on held-out data and
    leaves the original untouched; the same seed repeats exactly."""
    from dladmm_tpu_torch.data.synthetic import make_batch, make_dictionary

    g = torch.Generator().manual_seed(0)
    A = make_dictionary(g, M, N)
    data = make_batch(g, A, 64, nonneg_x=prox_x == "nonneg_l1")
    solver = DLADMMSolver.create(A, K=K, prox_x=prox_x)
    before = [p.clone() for p in solver.params]
    trained = solver.fit(3, steps=150, batch=32, lr=3e-3, nonneg_x=prox_x == "nonneg_l1")
    again = solver.fit(3, steps=2, batch=32, lr=3e-3, nonneg_x=prox_x == "nonneg_l1")
    assert all(torch.equal(a, b) for a, b in zip(solver.params, before))
    assert trained is not solver and trained.kernel == solver.kernel and trained.prox_x == prox_x
    c0 = solver.nmse_curve(data.b, data.x_star)
    c1 = trained.nmse_curve(data.b, data.x_star)
    assert c1.shape == (K,) and float(c1[-1]) < float(c0[-1]) - 0.5
    assert float(trained.residual(data.b)) < float(solver.residual(data.b)) + 0.1
    twice = solver.fit(3, steps=2, batch=32, lr=3e-3, nonneg_x=prox_x == "nonneg_l1")
    assert all(torch.equal(a, b) for a, b in zip(again.params, twice.params))
