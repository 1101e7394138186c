"""Port parity for the backward module (ops/cuda_bwd.py) and the backward
of ``make_unrolled_forward``.

On the CPU ``unroll_bwd`` runs its plain version (``unroll_bwd_plain``,
bwd_from_carries on the trajectory). It is held against the JAX
package's backward kernels run in interpret mode, as the JAX package's
own tests run them: ``unroll_bwd_pallas`` (``_bwd_kernel``, the whole
batch) and ``unroll_bwd_pallas_chunked`` (``_bwd_kernel_chunked``, batch
tiles of 4 and 8 rows), on one trajectory and one set of final-state
cotangents made with numpy. Every parameter gradient, gA and gb; per-
coordinate and scalar thresholds; ties at theta = 0 and beta = 1e-6.
Tolerance rtol 2e-5, atol 2e-5 * max|leaf| (tests/test_pallas_bwd.py's).
The CUDA kernel itself is held against the plain version by
tests/test_torch_cuda.py (``gpu``) and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dladmm_tpu.models.unroll import DLADMMParams as JParams
from dladmm_tpu.models.unroll import init_dladmm_params as j_init
from dladmm_tpu.ops import pallas_bwd as jbwd
from dladmm_tpu.ops import pallas_unroll as jpu
from dladmm_tpu_torch.ops import cuda_bwd, cuda_traj, cuda_unroll, schedule
from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

M, N, K, S = 16, 32, 4, 16


def _setup(seed=0, scalar_theta=False, ties=False):
    """A, b, perturbed LADMM-exact params (with ties: theta1 of layer 1
    and theta2 of layer 2 partly 0, and unless ties == "theta" beta of
    layer 1 at 1e-6), the port's plain trajectory (tx, tz, tlam, tax)
    and final cotangents."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(M, N)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    b = rng.normal(size=(S, M)).astype(np.float32)
    leaves = [
        np.asarray(v) + 0.05 * np.abs(np.asarray(v)).mean() * rng.normal(size=v.shape).astype(np.float32)
        for v in j_init(jnp.asarray(A), K=K, per_coordinate=not scalar_theta)
    ]
    if ties:
        leaves[2][1, ::2] = 0.0
        leaves[3][2, ::3] = 0.0
        if ties != "theta":
            leaves[4][1] = np.float32(1e-6)
    traj = cuda_traj.trajectory_forward_plain(
        torch.as_tensor(b), torch.as_tensor(A), *params_from_numpy(*leaves), with_tax=True
    )
    traj = [t.numpy() for t in traj]
    cts = [rng.normal(size=(S, N)).astype(np.float32), rng.normal(size=(S, M)).astype(np.float32),
           0.1 * rng.normal(size=(S, M)).astype(np.float32)]
    return A, b, leaves, traj, cts


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5,
                               atol=2e-5 * (np.abs(want).max() + 1e-12), err_msg=name)


@pytest.mark.parametrize("bs", [None, 4, 8])
@pytest.mark.parametrize("scalar_theta,ties", [(False, False), (False, True), (True, True)])
def test_plain_matches_jax_backward_kernels(bs, scalar_theta, ties):
    A, b, leaves, traj, cts = _setup(seed=bs or 1, scalar_theta=scalar_theta, ties=ties)
    jargs = (JParams(*map(jnp.asarray, leaves)), jnp.asarray(A), jnp.asarray(b),
             tuple(map(jnp.asarray, traj)), tuple(map(jnp.asarray, cts)))
    if bs is None:
        want = jbwd.unroll_bwd_pallas(*jargs, interpret=True)
    else:
        want = jbwd.unroll_bwd_pallas_chunked(*jargs, bs=bs, interpret=True)
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    got = cuda_bwd.unroll_bwd(t(b), t(A), *params_from_numpy(*leaves), *map(t, traj), *map(t, cts),
                              bs=bs, data_grads=True)
    for name, g, w in zip(JParams._fields, got[0], want[0]):
        assert tuple(g.shape) == tuple(w.shape), name
        _close(g, w, name)
    _close(got[1], want[1], "gA")
    _close(got[2], want[2], "gb")
    assert cuda_bwd.unroll_bwd.launches == {"whole": 0, "chunked": 0}  # the CPU launches nothing


def test_without_data_grads_only_params():
    A, b, leaves, traj, cts = _setup(seed=5)
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    args = (t(b), t(A), *params_from_numpy(*leaves), *map(t, traj), *map(t, cts))
    gp, gA, gb = cuda_bwd.unroll_bwd(*args)
    assert gA is None and gb is None
    full = cuda_bwd.unroll_bwd_plain(*args, data_grads=True)
    for g, w in zip(gp, full[0]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _final_loss(x, z, lam, lib):
    return lib.sum(x * x) + lib.sum(z * lib.cos(z)) + 0.1 * lib.sum(lam)


@pytest.mark.parametrize("scalar_theta", [False, True])
def test_forward_grads_match_jax(scalar_theta):
    """make_unrolled_forward with a gradient (trajectory forward, then
    the backward route) against jax.grad through the JAX package's
    make_unrolled_forward (its backward kernel in interpret mode): every
    parameter leaf, A and b. Ties at theta = 0 only: beta = 1e-6 scales
    lam by 1e6 and the two forwards' last-bit differences with it (the
    backward at that tie is held on one trajectory above)."""
    A, b, leaves, _, _ = _setup(seed=7, scalar_theta=scalar_theta, ties="theta")
    jfn = jpu.make_unrolled_forward(interpret=True)
    want = jax.grad(lambda p, A_, b_: _final_loss(*jfn(p, A_, b_), jnp), argnums=(0, 1, 2))(
        JParams(*map(jnp.asarray, leaves)), jnp.asarray(A), jnp.asarray(b)
    )
    p = params_from_numpy(*leaves)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    for leaf in (*p, At, bt):
        leaf.requires_grad_()
    _final_loss(*cuda_unroll.make_unrolled_forward()(p, At, bt), torch).backward()
    names = list(JParams._fields) + ["A", "b"]
    for name, g, w in zip(names, [leaf.grad for leaf in (*p, At, bt)], [*want[0], want[1], want[2]]):
        _close(g, w, name)


def test_chunk_policy_by_occupancy():
    """The Hopper rule: split S only at S >= 256 when the unsplit
    weight-gradient launch, K layers of 32 x 32 tiles, is under one wave
    of the card. The wave is the H100's for that launch: 5 resident
    blocks a SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the
    card, chip_smoke.py phase 13) x 132 SMs. Each of synthetic_small's
    cases at its K = 15 (2880 blocks: never split), and at K = 1 (192
    blocks), where the rule splits as it did for one layer's launch."""
    wave = 5 * 132
    assert schedule.weight_tiles(250, 500) == 192
    assert cuda_bwd.bwd_chunk_batch(250, 500, 250, 1024, 15, wave) is None  # 2880 blocks fill a wave
    assert cuda_bwd.bwd_chunk_batch(250, 500, 250, 1024, 1, wave) == 256  # 4 slices: 768 blocks; 2 give 384
    assert cuda_bwd.bwd_chunk_batch(250, 500, 250, 64, 15, wave) is None
    assert cuda_bwd.bwd_chunk_batch(250, 500, 250, 64, 1, wave) is None
    assert cuda_bwd.bwd_chunk_batch(250, 500, 250, 255, 15, wave) is None
    assert cuda_bwd.bwd_chunk_batch(250, 500, 250, 255, 1, wave) is None
    assert cuda_bwd.bwd_chunk_batch(250, 500, 250, 256, 15, wave) is None
    assert cuda_bwd.bwd_chunk_batch(250, 500, 250, 256, 1, wave) == 128
    assert cuda_bwd.bwd_chunk_batch(1000, 2000, 1000, 1024, 20, wave) is None  # 60 800 blocks
    assert cuda_bwd.bwd_chunk_batch(1000, 2000, 1000, 1024, 1, wave) is None  # 3040 blocks fill a wave
    assert cuda_bwd.bwd_chunk_batch(250, 500, 200, 1024, 15, wave) is None  # B = I only
    assert cuda_bwd.bwd_chunk_batch(250, 500, 200, 1024, 1, wave) is None
    assert cuda_bwd.bwd_chunk_batch(250, 500, 250, 4096, 15, wave) is None
    assert cuda_bwd.bwd_chunk_batch(250, 500, 250, 4096, 1, wave) == 512  # 8 slices of 512 fill a wave
    assert cuda_bwd.bwd_chunk_batch(64, 64, 64, 1024, 15, wave) == 128  # 120 blocks; 8 slices give 960
    assert cuda_bwd.bwd_chunk_batch(64, 64, 64, 1024, 1, wave) == 128  # 8 blocks: no split fills a wave
    assert cuda_bwd.bwd_chunk_batch(32, 64, 32, 1024, 4, wave) == 128  # the smoke preset: 12 blocks
