"""The port's manual backward (ops/unroll_vjp.py) against ``jax.grad`` of
the JAX package's unroll and against the port's own autograd through
the plain loop, for every parameter leaf and the A, B, b cotangents.

Final-state and deep-supervision (trajectory) losses, B = I and a
general B, (K, n) and (K, 1) thresholds. Inputs are drawn with numpy;
rtol 2e-5 of each leaf's largest gradient (tests/test_unroll_vjp.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dladmm_tpu.models.unroll import DLADMMParams as JParams
from dladmm_tpu.models.unroll import dladmm_forward as j_forward
from dladmm_tpu.models.unroll import init_dladmm_params as j_init
from dladmm_tpu_torch.models.unroll import dladmm_forward
from dladmm_tpu_torch.ops import unroll_vjp
from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

M, N, K, S, D = 16, 32, 4, 8, 20


def _problem(general_B, per_coordinate, seed=0):
    rng = np.random.default_rng(seed)

    def dictionary(rows, cols):
        X = rng.normal(size=(rows, cols)).astype(np.float32)
        return X / np.linalg.norm(X, axis=0, keepdims=True)

    A = dictionary(M, N)
    B = dictionary(M, D) if general_B else None
    b = rng.normal(size=(S, M)).astype(np.float32)
    p0 = j_init(jnp.asarray(A), None if B is None else jnp.asarray(B), K=K,
                per_coordinate=per_coordinate)
    leaves = [
        np.asarray(v) + 0.1 * np.abs(np.asarray(v)).mean()
        * rng.normal(size=v.shape).astype(np.float32)
        for v in p0
    ]
    return A, B, b, leaves


def _loss(traj, x, z, lam, lib):
    if traj:
        w = lib.arange(1, K + 1, dtype=x.dtype) / K
        per = lib.sum(x * x, axis=(1, 2)) if lib is jnp else torch.sum(x * x, dim=(1, 2))
        zz = lib.sum(z * lib.cos(z), axis=(1, 2)) if lib is jnp else torch.sum(z * torch.cos(z), dim=(1, 2))
        return lib.sum(w * (per + zz)) + 0.1 * lib.sum(lam)
    return lib.sum(x * x) + lib.sum(z * lib.cos(z)) + 0.1 * lib.sum(lam)


def _jax_grads(A, B, b, leaves, traj):
    def loss(p, A_, b_, B_):
        if traj:
            _, (tx, tz, tl) = j_forward(p, A_, b_, B=B_, capture_trajectory=True)
            return _loss(True, tx, tz, tl, jnp)
        return _loss(False, *j_forward(p, A_, b_, B=B_), jnp)

    Bj = None if B is None else jnp.asarray(B)
    argnums = (0, 1, 2) if B is None else (0, 1, 2, 3)
    g = jax.grad(loss, argnums=argnums)(
        JParams(*map(jnp.asarray, leaves)), jnp.asarray(A), jnp.asarray(b), Bj
    )
    return [np.asarray(v) for v in (*g[0], *g[1:])]


def _port_grads(A, B, b, leaves, traj, manual):
    p = params_from_numpy(*leaves)
    data = [torch.as_tensor(A), torch.as_tensor(b)] + ([] if B is None else [torch.as_tensor(B)])
    for t in (*p, *data):
        t.requires_grad_()
    At, bt = data[0], data[1]
    Bt = None if B is None else data[2]
    if manual and traj:
        out = unroll_vjp.dladmm_traj_manual_general(p, At, Bt, bt)
    elif manual:
        out = (unroll_vjp.dladmm_unroll_manual(p, At, bt) if Bt is None
               else unroll_vjp.dladmm_unroll_manual_general(p, At, Bt, bt))
    elif traj:
        _, out = dladmm_forward(p, At, bt, B=Bt, capture_trajectory=True)
    else:
        out = dladmm_forward(p, At, bt, B=Bt)
    _loss(traj, *out, torch).backward()
    return [t.grad.numpy() for t in (*p, *data)]


def _assert_close(got, want):
    names = list(JParams._fields) + ["A", "b", "B"]
    assert len(got) == len(want)
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(
            g, w, rtol=2e-5, atol=2e-5 * (np.abs(w).max() + 1e-12), err_msg=name
        )


CASES = [("final", False), ("final", True), ("trajectory", True)]


@pytest.mark.parametrize("per_coordinate", [True, False])
@pytest.mark.parametrize("loss,general_B", CASES)
def test_manual_backward_matches_jax_grad(loss, general_B, per_coordinate):
    A, B, b, leaves = _problem(general_B, per_coordinate)
    traj = loss == "trajectory"
    _assert_close(_port_grads(A, B, b, leaves, traj, manual=True),
                  _jax_grads(A, B, b, leaves, traj))


@pytest.mark.parametrize("loss,general_B", CASES)
def test_manual_backward_matches_port_autograd(loss, general_B):
    A, B, b, leaves = _problem(general_B, per_coordinate=True, seed=1)
    traj = loss == "trajectory"
    _assert_close(_port_grads(A, B, b, leaves, traj, manual=True),
                  _port_grads(A, B, b, leaves, traj, manual=False))


def test_manual_forward_equals_plain_loop_and_skips_data_grads():
    """Same outputs as the plain loop; with A and b not requiring a
    gradient the sweep computes no data cotangents."""
    A, _, b, leaves = _problem(False, True, seed=2)
    p = params_from_numpy(*leaves)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    for g, w in zip(unroll_vjp.dladmm_unroll_manual(p, At, bt), dladmm_forward(p, At, bt)):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
    out = unroll_vjp.bwd_from_carries(
        p, At, bt, unroll_vjp._fwd_scan(p, At, bt)[1],
        tuple(torch.ones_like(t) for t in dladmm_forward(p, At, bt)), data_grads=False,
    )
    assert out[1] is None and out[2] is None
    for leaf in p:
        leaf.requires_grad_()
    x, z, _ = unroll_vjp.dladmm_unroll_manual(p, At, bt)
    gW1, gbeta = torch.autograd.grad((x * x).sum() + z.sum(), [p.W1, p.beta])
    assert gW1.shape == p.W1.shape and gbeta.shape == p.beta.shape


def test_shifted_residuals_layout():
    tx, tz, tl, ta = (torch.arange(3.0).reshape(3, 1, 1) + i for i in range(4))
    lam_in, ax_in, z_in, x1, z1, ax1 = unroll_vjp.shifted_residuals(tx, tz, tl, ta)
    assert lam_in[0].item() == 0 and lam_in[2].item() == tl[1].item()
    assert ax_in[1].item() == ta[0].item() and z_in[2].item() == tz[1].item()
    assert x1 is tx and z1 is tz and ax1 is ta
