"""Port parity: dladmm_tpu_torch.models.unroll (init, the K-layer loop,
the nn.Module) and utils.config against the JAX package on the CPU.

Inputs are drawn with numpy and handed to both packages; parameters are
the LADMM-exact init plus a 0.05 N(0,1) perturbation, as in
tests/test_pallas_unroll.py, carried across with params_from_numpy.
Tolerances are rtol 1e-5 / atol 1e-6 (float32 on both sides)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dladmm_tpu.models import unroll as junroll
from dladmm_tpu.utils import config as jconfig
from dladmm_tpu_torch.models import unroll as tunroll
from dladmm_tpu_torch.utils import config as tconfig
from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL, **kw):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=rtol, atol=atol, **kw
    )


def _dictionary(rng, m, n):
    A = rng.normal(size=(m, n)).astype(np.float32)
    return A / np.linalg.norm(A, axis=0, keepdims=True)


def _setup(m, n, K, S, seed=0, general_B=False, d=None):
    """A, B, b and perturbed LADMM-exact params as numpy arrays."""
    rng = np.random.default_rng(seed)
    A = _dictionary(rng, m, n)
    B = _dictionary(rng, m, d) if general_B else None
    x_star = (rng.random((S, n)) < 0.1) * rng.normal(size=(S, n))
    e_star = (rng.random((S, m)) < 0.1) * rng.normal(size=(S, m))
    b = (x_star @ A.T + e_star).astype(np.float32)
    p0 = junroll.init_dladmm_params(
        jnp.asarray(A), None if B is None else jnp.asarray(B), K=K
    )
    leaves = [
        np.asarray(leaf) + 0.05 * rng.normal(size=leaf.shape).astype(np.float32)
        for leaf in p0
    ]
    return A, B, b, leaves


@pytest.mark.parametrize("per_coordinate", [True, False])
@pytest.mark.parametrize("general_B", [False, True])
def test_init_dladmm_params_matches_jax(per_coordinate, general_B):
    rng = np.random.default_rng(4)
    A = _dictionary(rng, 33, 77)
    B = _dictionary(rng, 33, 40) if general_B else None
    want = junroll.init_dladmm_params(
        jnp.asarray(A), None if B is None else jnp.asarray(B), K=5, beta=0.7,
        per_coordinate=per_coordinate,
    )
    got = tunroll.init_dladmm_params(
        torch.as_tensor(A), None if B is None else torch.as_tensor(B), K=5,
        beta=0.7, per_coordinate=per_coordinate,
    )
    for name, g, w in zip(want._fields, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        _close(g, w, err_msg=name)
    _close(tunroll.spectral_norm_sq(torch.as_tensor(A)),
           junroll.spectral_norm_sq(jnp.asarray(A)))


@pytest.mark.parametrize(
    "case", ["final", "trajectory", "general_B", "warm_start"]
)
@pytest.mark.parametrize("m,n,K,S", [(16, 32, 4, 8), (33, 77, 5, 13)])
def test_dladmm_forward_matches_jax(m, n, K, S, case):
    general_B = case == "general_B"
    A, B, b, leaves = _setup(m, n, K, S, seed=K, general_B=general_B, d=m + 7)
    pj = junroll.DLADMMParams(*map(jnp.asarray, leaves))
    pt = params_from_numpy(*leaves, device="cpu")
    kw_j = dict(capture_trajectory=case == "trajectory")
    kw_t = dict(kw_j)
    if general_B:
        kw_j["B"], kw_t["B"] = jnp.asarray(B), torch.as_tensor(B)
    if case == "warm_start":
        rng = np.random.default_rng(9)
        d = pt.W2.shape[1]
        init = [0.1 * rng.normal(size=s).astype(np.float32)
                for s in ((S, n), (S, d), (S, m))]
        for key, arr in zip(("x0", "z0", "lam0"), init):
            kw_j[key], kw_t[key] = jnp.asarray(arr), torch.as_tensor(arr)
    want = junroll.dladmm_forward(pj, jnp.asarray(A), jnp.asarray(b), **kw_j)
    got = tunroll.dladmm_forward(pt, torch.as_tensor(A), torch.as_tensor(b), **kw_t)
    if case == "trajectory":
        (got, got_traj), (want, want_traj) = got, want
        for g, w in zip(got_traj, want_traj):
            assert tuple(g.shape) == tuple(w.shape) == (K, S, g.shape[-1])
            _close(g, w)
    for g, w in zip(got, want):
        _close(g, w)


def test_dladmm_forward_validates_shapes():
    A, _, b, leaves = _setup(16, 32, 3, 4)
    pt = params_from_numpy(*leaves)
    with pytest.raises(ValueError, match="inconsistent"):
        tunroll.dladmm_forward(pt, torch.as_tensor(A.T.copy()), torch.as_tensor(b))
    with pytest.raises(ValueError, match="b must be"):
        tunroll.dladmm_forward(pt, torch.as_tensor(A), torch.as_tensor(b[:, :5]))
    with pytest.raises(ValueError, match="B must be"):
        tunroll.dladmm_forward(
            pt, torch.as_tensor(A), torch.as_tensor(b), B=torch.ones(3, 3)
        )


def test_dladmm_module_holds_params_and_matches_loop():
    A, _, b, leaves = _setup(16, 32, 4, 8, seed=5)
    pt = params_from_numpy(*leaves)
    net = tunroll.DLADMM(pt)
    names = [n for n, _ in net.named_parameters()]
    assert names == list(tunroll.DLADMMParams._fields)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    for g, w in zip(net(At, bt), tunroll.dladmm_forward(pt, At, bt)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # Autograd reaches every parameter through the plain loop.
    x, z, _ = net(At, bt)
    (x.square().mean() + z.square().mean()).backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in net.parameters())


def test_synthetic_data_contract(tmp_path):
    """The port's data/synthetic.py keeps the JAX package's contract
    (unit-norm columns, b = A x* + e* or A x* + B z*, Bernoulli-Gaussian
    codes, nonneg x*, fresh generators per call); its numbers differ
    from jax.random's by design, so the structure is what is compared."""
    from dladmm_tpu.data import synthetic as jdata
    from dladmm_tpu_torch.data import synthetic as tdata

    cfg = tconfig.get_config("synthetic_general_b")
    A, B = tdata.problem_matrices(cfg)
    A2, B2 = tdata.problem_matrices(cfg)
    assert torch.equal(A, A2) and torch.equal(B, B2)
    Aj, Bj = jdata.problem_matrices(jconfig.get_config("synthetic_general_b"))
    assert tuple(A.shape) == Aj.shape and tuple(B.shape) == Bj.shape
    _close(torch.linalg.vector_norm(A, dim=0), np.ones(A.shape[1]))
    A_small, none_b = tdata.problem_matrices(tconfig.get_config("smoke"))
    assert none_b is None and not torch.equal(A_small, A[: A_small.shape[0], : A_small.shape[1]])
    g1, g2 = tdata.seed_keys(cfg)[1], tdata.seed_keys(cfg)[1]
    batch = tdata.make_batch(g1, A, 400, 0.1, 0.2, B=B, nonneg_x=True)
    again = tdata.make_batch(g2, A, 400, 0.1, 0.2, B=B, nonneg_x=True)
    assert torch.equal(batch.b, again.b)
    assert batch.e_star.shape == (400, B.shape[1]) and (batch.x_star >= 0).all()
    _close(batch.b, batch.x_star @ A.T + batch.e_star @ B.T, rtol=1e-5, atol=1e-5)
    assert abs(float((batch.x_star != 0).float().mean()) - 0.1) < 0.01
    assert abs(float((batch.e_star != 0).float().mean()) - 0.2) < 0.02
    arr = np.arange(6.0).reshape(2, 3)
    np.save(tmp_path / "r.npy", arr)
    np.savez(tmp_path / "r.npz", other=arr + 1, b=arr)
    for spec in ("r.npy", "r.npz", "r.npz:b"):
        np.testing.assert_array_equal(tdata.load_array_spec(str(tmp_path / spec)), arr)
    np.testing.assert_array_equal(
        tdata.load_array_spec(str(tmp_path / "r.npz") + ":other"), arr + 1
    )


def test_presets_match_jax():
    """The port's copy of utils/config.py: every preset equal to the JAX
    package's, field by field."""
    assert sorted(tconfig.PRESETS) == sorted(jconfig.PRESETS)
    for name, jc in jconfig.PRESETS.items():
        tc = tconfig.PRESETS[name]
        for part in ("problem", "train", "sharding"):
            assert dataclasses.asdict(getattr(tc, part)) == dataclasses.asdict(
                getattr(jc, part)
            ), (name, part)
        assert tc.name == jc.name
    assert tconfig.get_config("smoke", train=tconfig.TrainConfig(seed=3)).train.seed == 3
    with pytest.raises(KeyError, match="unknown config"):
        tconfig.get_config("bogus")
