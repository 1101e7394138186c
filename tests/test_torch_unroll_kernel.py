"""Port parity for the whole-unroll kernel module (ops/cuda_unroll.py),
the LADMM baseline and the metrics.

On the CPU the kernel's wrapper runs its plain version; it is held
against the JAX package's Pallas ``_unroll_kernel`` run in interpret
mode through make_unrolled_forward / make_unrolled_inference_prox, as
the JAX package's own tests run it. The CUDA kernel itself is held
against the plain version by tests/test_torch_cuda.py (``gpu`` tests,
skipped without a card) and by chip_smoke.py. Tolerances are rtol 1e-5
/ atol 1e-6 unless a test states otherwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dladmm_tpu.baselines.ladmm import ladmm_run as j_ladmm_run
from dladmm_tpu.metrics import core as jmetrics
from dladmm_tpu.models.unroll import DLADMMParams as JParams
from dladmm_tpu.models.unroll import init_dladmm_params as j_init
from dladmm_tpu.ops import pallas_unroll as jpu
from dladmm_tpu.ops import prox as jprox
from dladmm_tpu_torch.baselines.ladmm import ladmm_run
from dladmm_tpu_torch.metrics import core as tmetrics
from dladmm_tpu_torch.models.unroll import init_dladmm_params
from dladmm_tpu_torch.ops import cuda_unroll
from dladmm_tpu_torch.ops import prox as tprox
from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

RTOL, ATOL = 1e-5, 1e-6
SHAPES = [(16, 32, 4, 8), (33, 77, 5, 13)]  # (m, n, K, S); the second is ragged


def _close(got, want, rtol=RTOL, atol=ATOL, **kw):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=rtol, atol=atol, **kw
    )


def _setup(m, n, K, S, seed=0, scalar_theta=False):
    """Numpy A, b, x*, e* and perturbed LADMM-exact params (the
    tests/test_pallas_unroll.py recipe, drawn with numpy)."""
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


@pytest.mark.parametrize("scalar_theta", [False, True])
@pytest.mark.parametrize("m,n,K,S", SHAPES)
def test_unrolled_forward_matches_jax_kernel(m, n, K, S, scalar_theta):
    """make_unrolled_forward() on the CPU (the plain version) against
    JAX's interpret-mode _unroll_kernel; (K, 1) thresholds are the form
    from_torch produces."""
    A, b, _, _, leaves = _setup(m, n, K, S, seed=S, scalar_theta=scalar_theta)
    want = jpu.make_unrolled_forward(interpret=True)(
        JParams(*map(jnp.asarray, leaves)), jnp.asarray(A), jnp.asarray(b)
    )
    got = cuda_unroll.make_unrolled_forward()(
        params_from_numpy(*leaves, device="cpu"), torch.as_tensor(A), torch.as_tensor(b)
    )
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("prox_name", ["nonneg_l1", "box", "elastic_net"])
def test_inference_prox_matches_jax_kernel(prox_name):
    """The prox-templated forward (prox_x = the named op, prox_z = l1,
    elastic_net at rho 0.3) against JAX's interpret-mode kernel."""
    m, n, K, S = 16, 32, 4, 8
    A, b, _, _, leaves = _setup(m, n, K, S, seed=11)
    want = jpu.make_unrolled_inference_prox(
        jprox.get_prox(prox_name, rho=0.3), jprox.prox_l1, interpret=True
    )(JParams(*map(jnp.asarray, leaves)), jnp.asarray(A), jnp.asarray(b))
    got = cuda_unroll.make_unrolled_inference_prox(
        tprox.get_prox(prox_name, rho=0.3), tprox.prox_l1
    )(params_from_numpy(*leaves), torch.as_tensor(A), torch.as_tensor(b))
    for g, w in zip(got, want):
        _close(g, w)


def test_kernel_args_broadcast_and_reject():
    """The wrapper's argument checks, reachable without a card. (K, 1)
    thresholds become (K, n) / (K, m) views with a column stride of 0
    over the caller's storage (no copy); per-coordinate ones pass as
    they are."""
    A, b, _, _, leaves = _setup(16, 32, 3, 5, scalar_theta=True)
    t = [torch.as_tensor(a) for a in (b, A, *leaves)]
    b_, A_, W1, W2, th1, th2, beta = cuda_unroll.kernel_args(*t)
    assert th1.shape == (3, 32) and th2.shape == (3, 16) and beta.shape == (3,)
    assert th1.stride() == (1, 0) and th2.stride() == (1, 0)
    assert th1.data_ptr() == t[4].data_ptr() and th2.data_ptr() == t[5].data_ptr()
    assert torch.equal(th1, t[4].expand(3, 32)) and torch.equal(th1[:, 0], t[4][:, 0])
    _, _, _, _, leaves_pc = _setup(16, 32, 3, 5)
    th1_pc = torch.as_tensor(leaves_pc[2])
    got = cuda_unroll.kernel_args(*t[:4], th1_pc, *t[5:])[4]
    assert got.stride() == (32, 1) and got.data_ptr() == th1_pc.data_ptr()
    bad_w2 = torch.zeros((3, 20, 16))
    with pytest.raises(ValueError, match="B = I"):
        cuda_unroll.kernel_args(t[0], t[1], t[2], bad_w2, *t[4:])
    with pytest.raises(TypeError, match="float32"):
        cuda_unroll.kernel_args(t[0].double(), *t[1:])
    with pytest.raises(ValueError, match="contiguous"):
        cuda_unroll.kernel_args(t[0], torch.as_tensor(A.T.copy()).T, *t[2:])
    with pytest.raises(ValueError, match="no kernel variant"):
        cuda_unroll.unroll_forward(*t, prox_x="group_l2")


def test_layers_slice_runs_k_layers():
    """K is read from W1: a layers=k prefix equals a k-layer forward."""
    A, b, _, _, leaves = _setup(16, 32, 5, 6, seed=2)
    p = params_from_numpy(*leaves)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    fwd = cuda_unroll.make_unrolled_forward()
    got = fwd(type(p)(*(v[:2] for v in p)), At, bt)
    want = jpu.make_unrolled_forward(interpret=True)(
        JParams(*(jnp.asarray(v[:2]) for v in leaves)), jnp.asarray(A), jnp.asarray(b)
    )
    for g, w in zip(got, want):
        _close(g, w)


def test_forward_is_inference_only():
    """The whole-unroll kernel serves inference only: under no_grad the
    forward is unroll_forward; a forward that needs a gradient goes to
    the trajectory kernel and the manual backward (ops/cuda_traj.py,
    gradients held against JAX's by tests/test_torch_traj.py), with the
    same outputs. The prox-templated forward stays inference-only."""
    A, b, _, _, leaves = _setup(16, 32, 2, 4)
    p = params_from_numpy(*leaves)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    with torch.no_grad():
        want = cuda_unroll.make_unrolled_forward()(p, At, bt)
    p = type(p)(p.W1.requires_grad_(), *p[1:])
    got = cuda_unroll.make_unrolled_forward()(p, At, bt)
    assert all(g.grad_fn is not None for g in got)
    for g, w in zip(got, want):
        _close(g.detach(), w)
    with pytest.raises(NotImplementedError, match="inference-only"):
        cuda_unroll.make_unrolled_inference_prox(tprox.prox_nonneg_l1, tprox.prox_l1)(p, At, bt)


def test_prox_kernel_availability_reasons():
    nn_, l1 = tprox.get_prox("nonneg_l1"), tprox.get_prox("l1")
    ok, why = cuda_unroll.prox_megakernel_available((nn_, l1), 16, 16)
    assert ok and why == ""
    ok, why = cuda_unroll.prox_megakernel_available(None, 16, 16)
    assert not ok and "prox_pair" in why
    ok, why = cuda_unroll.prox_megakernel_available((tprox.get_prox("group_l2"), l1), 16, 16)
    assert not ok and "kernel variant" in why
    ok, why = cuda_unroll.prox_megakernel_available(
        (tprox.get_prox("elastic_net", 0.1), tprox.get_prox("elastic_net", 0.2)), 16, 16
    )
    assert not ok and "rho" in why
    ok, why = cuda_unroll.prox_megakernel_available((nn_, l1), 16, 24)
    assert not ok and "B = I" in why
    # No VMEM-style fit gate: the flagship shape is eligible.
    assert cuda_unroll.prox_megakernel_available((nn_, l1), 1000, 1000)[0]
    with pytest.raises(ValueError, match="kernel variant"):
        cuda_unroll.make_unrolled_inference_prox(tprox.get_prox("group_l2"), l1)


@pytest.mark.parametrize("beta", [1.0, 0.5])
def test_ladmm_exact_init_forward_equals_port_ladmm(beta):
    """An untrained LADMM-exact net through the kernel's forward is
    classical LADMM (the port's independent baseline); rtol 2e-5 as in
    tests/test_ladmm_equivalence.py."""
    A, b, _, _, _ = _setup(20, 40, 12, 8, seed=42)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    params = init_dladmm_params(At, K=12, beta=beta)
    got = cuda_unroll.make_unrolled_forward()(params, At, bt)
    want = ladmm_run(At, bt, iters=12, beta=beta)
    for g, w in zip(got, want):
        _close(g, w, rtol=2e-5)


@pytest.mark.parametrize("variant", ["l1", "trajectory", "general_B", "prox"])
def test_ladmm_run_matches_jax(variant):
    A, b, _, _, _ = _setup(20, 40, 2, 8, seed=7)
    kw_j, kw_t = {}, {}
    if variant == "general_B":
        rng = np.random.default_rng(8)
        B = rng.normal(size=(20, 24)).astype(np.float32)
        B /= np.linalg.norm(B, axis=0, keepdims=True)
        kw_j["B"], kw_t["B"] = jnp.asarray(B), torch.as_tensor(B)
    if variant == "prox":
        kw_j["prox_x"] = jprox.get_prox("nonneg_l1")
        kw_t["prox_x"] = tprox.get_prox("nonneg_l1")
    traj = variant == "trajectory"
    want = j_ladmm_run(jnp.asarray(A), jnp.asarray(b), iters=10, beta=0.8,
                       capture_trajectory=traj, **kw_j)
    got = ladmm_run(torch.as_tensor(A), torch.as_tensor(b), iters=10, beta=0.8,
                    capture_trajectory=traj, **kw_t)
    if traj:
        (got, got_t), (want, want_t) = got, want
        for g, w in zip(got_t, want_t):
            _close(g, w)
    for g, w in zip(got, want):
        _close(g, w)


def test_metrics_match_jax():
    A, b, x_star, e_star, _ = _setup(20, 40, 2, 9, seed=3)
    rng = np.random.default_rng(5)
    x_hat = (x_star + 0.1 * rng.normal(size=x_star.shape)).astype(np.float32)
    x_star = x_star.copy()
    x_star[0] = 0.0  # a zero-support sample is left out of the mean
    z = (e_star + 0.1 * rng.normal(size=e_star.shape)).astype(np.float32)
    B = rng.normal(size=(20, 20)).astype(np.float32)
    J, T = jnp.asarray, torch.as_tensor
    _close(tmetrics.nmse_db(T(x_hat), T(x_star)), jmetrics.nmse_db(J(x_hat), J(x_star)))
    traj = np.stack([x_hat, 0.5 * x_hat, x_star])
    _close(tmetrics.per_layer_nmse_db(T(traj), T(x_star)),
           jmetrics.per_layer_nmse_db(J(traj), J(x_star)))
    for Bn in (None, B):
        _close(
            tmetrics.constraint_residual(T(A), T(b), T(x_hat), T(z), None if Bn is None else T(Bn)),
            jmetrics.constraint_residual(J(A), J(b), J(x_hat), J(z), None if Bn is None else J(Bn)),
        )
    _close(tmetrics.psnr(T(x_hat), T(x_star), 2.0), jmetrics.psnr(J(x_hat), J(x_star), 2.0))
    zero = np.zeros_like(x_star)
    assert np.isnan(float(tmetrics.nmse_db(T(x_hat), T(zero))))
    assert np.isnan(float(jmetrics.nmse_db(J(x_hat), J(zero))))

