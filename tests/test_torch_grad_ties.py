"""Gradient tie rule of the port's plain layer step against ``jax.grad``.

``jnp.maximum`` splits the gradient 0.5/0.5 where its two arguments are
equal; the JAX package's clamps (theta at 0, beta at _BETA_MIN) are all
``jnp.maximum``, and its manual backward copies that rule
(``_max_grad``). The port's clamps are ``torch.maximum`` for the same
reason: ``torch.clamp`` passes the whole gradient at a tie, which gave
exactly twice ``jax.grad``'s value for the tied theta and beta.

Inputs are drawn with numpy; rtol 2e-5 of each leaf's largest gradient
(tests/test_unroll_vjp.py's tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dladmm_tpu.models.unroll import DLADMMParams as JParams
from dladmm_tpu.models.unroll import dladmm_forward as j_forward
from dladmm_tpu.models.unroll import init_dladmm_params as j_init
from dladmm_tpu.ops import prox as jprox
from dladmm_tpu.ops.reference import make_cached_step as j_cached_step
from dladmm_tpu_torch.models.unroll import dladmm_forward
from dladmm_tpu_torch.ops import prox as tprox
from dladmm_tpu_torch.ops.reference import make_cached_step
from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

M, N, K, S = 8, 16, 3, 5


def _tied_problem(tie: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(M, N)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    b = rng.normal(size=(S, M)).astype(np.float32)
    leaves = [
        np.asarray(v) + 0.05 * rng.normal(size=v.shape).astype(np.float32)
        for v in j_init(jnp.asarray(A), K=K)
    ]
    if tie == "theta":
        leaves[2][1] = 0.0  # max(theta1, 0) ties at layer 1
        leaves[3][2] = 0.0
    else:
        leaves[4][2] = np.float32(1e-6)  # max(beta, _BETA_MIN) ties at layer 2
    return A, b, leaves


def _jax_grads(A, b, leaves, step=None):
    def loss(p):
        x, z, lam = j_forward(p, jnp.asarray(A), jnp.asarray(b), step_fn=step)
        return jnp.sum(x**2) + jnp.sum(z**2) + 1e-3 * jnp.sum(lam**2)

    return jax.grad(loss)(JParams(*map(jnp.asarray, leaves)))


def _port_grads(A, b, leaves, step=None):
    p = params_from_numpy(*leaves)
    for leaf in p:
        leaf.requires_grad_()
    x, z, lam = dladmm_forward(p, torch.as_tensor(A), torch.as_tensor(b), step_fn=step)
    (torch.sum(x**2) + torch.sum(z**2) + 1e-3 * torch.sum(lam**2)).backward()
    return [leaf.grad for leaf in p]


def _assert_grads_close(got, want):
    for name, g, w in zip(JParams._fields, got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=2e-5, atol=2e-5 * np.abs(w).max(), err_msg=name
        )


@pytest.mark.parametrize("tie", ["theta", "beta"])
def test_autograd_splits_ties_like_jax(tie):
    """l1/l1 plain loop at theta = 0 and at beta = 1e-6."""
    A, b, leaves = _tied_problem(tie)
    _assert_grads_close(_port_grads(A, b, leaves), _jax_grads(A, b, leaves))


@pytest.mark.parametrize("name", ["nonneg_l1", "box", "group_l2"])
def test_prox_thresholds_split_ties_like_jax(name):
    """The general proxes' threshold clamps (ops/prox.py) at theta = 0."""
    A, b, leaves = _tied_problem("theta", seed=1)
    step_t = make_cached_step(tprox.get_prox(name), tprox.prox_l1)
    step_j = j_cached_step(jprox.get_prox(name), jprox.prox_l1)
    _assert_grads_close(
        _port_grads(A, b, leaves, step_t), _jax_grads(A, b, leaves, step_j)
    )
