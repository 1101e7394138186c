"""Port parity for the trajectory module (ops/cuda_traj.py) and the
training policy of models/api.select_forward.

On the CPU the trajectory kernel's wrapper runs its plain version; it is
held against the JAX package's Pallas ``_unroll_traj_kernel`` run in
interpret mode (``_traj_pallas(interpret=True)``), as the JAX package's
own tests run it, with and without the Ax stack. The autograd Functions
around it are held against ``jax.grad`` through the JAX package's
``make_unrolled_trajectory`` / ``make_unrolled_forward``. The CUDA
kernel itself is held against the plain version by
tests/test_torch_cuda.py (``gpu``) and chip_smoke.py.
Forward tolerance rtol 1e-5 / atol 1e-6; gradients rtol 2e-5 of each
leaf's largest value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dladmm_tpu.models.unroll import DLADMMParams as JParams
from dladmm_tpu.models.unroll import init_dladmm_params as j_init
from dladmm_tpu.ops import pallas_unroll as jpu
from dladmm_tpu_torch.models import api
from dladmm_tpu_torch.ops import cuda_traj, cuda_unroll
from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

SHAPES = [(16, 32, 4, 8), (33, 77, 5, 13)]  # (m, n, K, S); the second is ragged


def _setup(m, n, K, S, seed=0, scalar_theta=False):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    x_star = ((rng.random((S, n)) < 0.1) * rng.normal(size=(S, n))).astype(np.float32)
    e_star = ((rng.random((S, m)) < 0.1) * rng.normal(size=(S, m))).astype(np.float32)
    b = (x_star @ A.T + e_star).astype(np.float32)
    p0 = j_init(jnp.asarray(A), K=K, per_coordinate=not scalar_theta)
    leaves = [
        np.asarray(leaf) + 0.05 * rng.normal(size=leaf.shape).astype(np.float32)
        for leaf in p0
    ]
    return A, b, x_star, e_star, leaves


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _grad_close(got, want, names):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            np.asarray(g), w, rtol=2e-5, atol=2e-5 * (np.abs(w).max() + 1e-12), err_msg=name
        )


@pytest.mark.parametrize("with_tax", [True, False])
@pytest.mark.parametrize("m,n,K,S", SHAPES)
def test_trajectory_plain_matches_jax_kernel(m, n, K, S, with_tax):
    A, b, _, _, leaves = _setup(m, n, K, S, seed=S)
    want = jpu._traj_pallas(
        JParams(*map(jnp.asarray, leaves)), jnp.asarray(A), jnp.asarray(b),
        matmul_dtype=None, interpret=True, with_tax=with_tax,
    )
    got = cuda_traj.trajectory_forward(
        torch.as_tensor(b), torch.as_tensor(A), *params_from_numpy(*leaves), with_tax=with_tax
    )
    assert len(got) == len(want) == (4 if with_tax else 3)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)
    assert cuda_traj.trajectory_forward.launches == 0  # the CPU path launches nothing


def _deep_loss(tx, tz, tlam, lib):
    w = (lib.arange(1, tx.shape[0] + 1) / tx.shape[0]).astype(jnp.float32) if lib is jnp else (
        torch.arange(1, tx.shape[0] + 1, dtype=torch.float32) / tx.shape[0])
    per = [lib.sum(tx[k] * tx[k]) + lib.sum(tz[k] * lib.cos(tz[k])) for k in range(tx.shape[0])]
    return sum(wk * pk for wk, pk in zip(w, per)) + 0.1 * lib.sum(tlam)


@pytest.mark.parametrize("scalar_theta", [False, True])
def test_trajectory_grads_match_jax(scalar_theta):
    """make_unrolled_trajectory: gradients of a per-layer loss for every
    parameter leaf and for A and b against the JAX package's."""
    A, b, _, _, leaves = _setup(16, 32, 4, 8, seed=3, scalar_theta=scalar_theta)
    jfn = jpu.make_unrolled_trajectory(interpret=True)
    want = jax.grad(lambda p, A_, b_: _deep_loss(*jfn(p, A_, b_), jnp), argnums=(0, 1, 2))(
        JParams(*map(jnp.asarray, leaves)), jnp.asarray(A), jnp.asarray(b)
    )
    p = params_from_numpy(*leaves)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    for t in (*p, At, bt):
        t.requires_grad_()
    _deep_loss(*cuda_traj.make_unrolled_trajectory()(p, At, bt), torch).backward()
    names = list(JParams._fields) + ["A", "b"]
    _grad_close([t.grad for t in (*p, At, bt)], [*want[0], want[1], want[2]], names)


def test_forward_train_grads_match_jax():
    """make_unrolled_forward with a gradient (the trajectory kernel plus
    the manual backward) against jax.grad through the JAX package's
    make_unrolled_forward; params only, A and b need no gradient."""
    A, b, x_star, e_star, leaves = _setup(33, 77, 5, 13, seed=4)
    jfn = jpu.make_unrolled_forward(interpret=True)

    def jloss(p):
        x, z, _ = jfn(p, jnp.asarray(A), jnp.asarray(b))
        return jnp.mean((x - x_star) ** 2) + jnp.mean((z - e_star) ** 2)

    want = jax.grad(jloss)(JParams(*map(jnp.asarray, leaves)))
    p = params_from_numpy(*leaves)
    for t in p:
        t.requires_grad_()
    x, z, _ = cuda_unroll.make_unrolled_forward()(p, torch.as_tensor(A), torch.as_tensor(b))
    loss = torch.mean((x - torch.as_tensor(x_star)) ** 2) + torch.mean((z - torch.as_tensor(e_star)) ** 2)
    _close(loss.detach(), jloss(JParams(*map(jnp.asarray, leaves))))
    got = torch.autograd.grad(loss, list(p))
    _grad_close(got, want, JParams._fields)


def test_select_forward_training_routes():
    """need_trajectory gives the trajectory forward (route named by the
    device); "pallas" is the JAX package's name for the same route as
    "auto"; reference and general B keep the plain loop."""
    for kernel in ("auto", "megakernel", "pallas"):
        fwd, step, desc = api.select_forward(16, 32, 16, 8, kernel=kernel, need_trajectory=True, device="cpu")
        assert step is None and desc == "trajectory-plain-cpu"
        assert api.select_forward(16, 32, 16, 8, kernel=kernel, need_trajectory=True,
                                  device="cuda")[2] == "cuda-trajectory-kernel"
        assert api.select_forward(16, 32, 16, 8, kernel=kernel)[2] == "cuda-whole-unroll-kernel"
    A, b, _, _, leaves = _setup(16, 32, 4, 8, seed=5)
    fwd = api.select_forward(16, 32, 16, 8, need_trajectory=True, device="cpu")[0]
    with torch.no_grad():
        tx, tz, tlam = fwd(params_from_numpy(*leaves), torch.as_tensor(A), torch.as_tensor(b))
    assert tx.shape == (4, 8, 32) and tz.shape == tlam.shape == (4, 8, 16)
    for kw in (dict(kernel="reference"), dict(identity_B=False)):
        assert api.select_forward(16, 32, 16, 8, need_trajectory=True, **kw) == (
            None, None, "plain-loop-reference")
    with pytest.raises(ValueError, match="kernel="):
        api.select_forward(16, 32, 16, 8, kernel="cuda")
