"""The port's CUDA kernels on the card, against their plain versions:
the whole-unroll kernel, the trajectory kernel, the int8 Adam sweep, the
training gradients through them, and fit on the card.

Every test here needs a CUDA card: each is marked ``gpu`` and skips at
run time without one. The file imports no JAX, so it also runs where
JAX is not installed; tests/conftest.py does import JAX, so run it there
with

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_cuda.py

Tolerance: 1e-4 * max(1, max|ref|) (chip_smoke.py's), because the
kernel's FMA loop and cuBLAS sum in different orders and the unroll
carries the difference through K layers.
"""

import threading

import numpy as np
import pytest
import torch

from dladmm_tpu_torch.models.unroll import DLADMMParams, init_dladmm_params
from dladmm_tpu_torch.ops import cuda_unroll
from dladmm_tpu_torch.serve import BatchingServer, InferenceServer

TOL = 1e-4
SHAPES = [(16, 32, 4, 8), (33, 77, 5, 13), (250, 500, 15, 1), (250, 500, 15, 64)]


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _problem(m, n, K, S, seed, device, scalar_theta=False):
    """A, b and LADMM-exact params plus 0.05 N(0,1) * RMS of each leaf,
    drawn with numpy."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    b = rng.normal(size=(S, m)).astype(np.float32)
    At = torch.as_tensor(A)
    p0 = init_dladmm_params(At, K=K, per_coordinate=not scalar_theta)
    leaves = [
        leaf + 0.05 * torch.as_tensor(rng.normal(size=tuple(leaf.shape)).astype(np.float32))
        * leaf.pow(2).mean().sqrt()
        for leaf in p0
    ]
    return (At.to(device), torch.as_tensor(b, device=device),
            DLADMMParams(*leaves).to(device))


def _assert_close(got, want):
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        tol = TOL * max(1.0, float(w.abs().max()))
        err = float((g - w).abs().max())
        assert err <= tol, (err, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("prox_x", ["l1", "nonneg_l1", "box", "elastic_net"])
@pytest.mark.parametrize("m,n,K,S", SHAPES)
def test_kernel_matches_plain(cuda_device, m, n, K, S, prox_x):
    """Ragged tiles (m=33, n=77, S=13), S = 1 and the four kernel proxes
    (elastic net at rho 0.3); one launch is counted per call."""
    A, b, p = _problem(m, n, K, S, seed=m + S, device=cuda_device)
    before = cuda_unroll.unroll_forward.launches
    got = cuda_unroll.unroll_forward(b, A, *p, prox_x=prox_x, rho=0.3)
    want = cuda_unroll.unroll_forward_plain(b, A, *p, prox_x=prox_x, rho=0.3)
    torch.cuda.synchronize()
    assert cuda_unroll.unroll_forward.launches == before + 1
    _assert_close(got, want)


@pytest.mark.gpu
def test_scalar_thresholds_and_layer_prefix(cuda_device):
    """(K, 1) thresholds (from_torch's form) are broadcast by the
    wrapper; a contiguous layers=k prefix runs k layers."""
    A, b, p = _problem(33, 77, 5, 13, seed=1, device=cuda_device, scalar_theta=True)
    _assert_close(cuda_unroll.unroll_forward(b, A, *p),
                  cuda_unroll.unroll_forward_plain(b, A, *p))
    pre = DLADMMParams(*(v[:2] for v in p))
    _assert_close(cuda_unroll.unroll_forward(b, A, *pre),
                  cuda_unroll.unroll_forward_plain(b, A, *pre))


@pytest.mark.gpu
def test_side_stream_and_worker_thread(cuda_device):
    """The kernel launches on the caller's current stream, also from a
    thread that never touched the card before."""
    A, b, p = _problem(64, 128, 4, 32, seed=2, device=cuda_device)
    want = cuda_unroll.unroll_forward_plain(b, A, *p)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = cuda_unroll.unroll_forward(b, A, *p)
    torch.cuda.current_stream().wait_stream(side)
    _assert_close(got, want)
    out = {}
    t = threading.Thread(target=lambda: out.update(r=cuda_unroll.unroll_forward(b, A, *p)))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    torch.cuda.synchronize()
    _assert_close(out["r"], want)


@pytest.mark.gpu
def test_servers_route_through_the_kernel(cuda_device):
    A, _, p = _problem(64, 128, 4, 1, seed=3, device=cuda_device)
    before = cuda_unroll.unroll_forward.launches
    server = InferenceServer(p, A, max_batch=16)  # default device: cuda
    assert set(server.routes.values()) == {"cuda-whole-unroll-kernel"}
    assert cuda_unroll.unroll_forward.launches == before + len(server.buckets)
    rng = np.random.default_rng(4)
    reqs = [rng.normal(size=(s, 64)).astype(np.float32) for s in (1, 3, 5, 7)]
    front = BatchingServer(server)
    try:
        futs = [front.submit(r) for r in reqs]
        batched = [f.result(timeout=120) for f in futs]
    finally:
        front.close()
    for r, (xb, zb) in zip(reqs, batched):
        xw, zw, _ = cuda_unroll.unroll_forward_plain(
            torch.as_tensor(r, device=cuda_device), server.A, *server.params
        )
        _assert_close((torch.as_tensor(xb), torch.as_tensor(zb)), (xw.cpu(), zw.cpu()))


# -- the training slice's kernels ------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("with_tax", [True, False])
@pytest.mark.parametrize("m,n,K,S", SHAPES)
def test_trajectory_kernel_matches_plain(cuda_device, m, n, K, S, with_tax):
    """Every layer's state in the stacks, ragged tiles and S = 1; one
    launch per call."""
    from dladmm_tpu_torch.ops import cuda_traj

    A, b, p = _problem(m, n, K, S, seed=m + S + 1, device=cuda_device)
    before = cuda_traj.trajectory_forward.launches
    got = cuda_traj.trajectory_forward(b, A, *p, with_tax=with_tax)
    want = cuda_traj.trajectory_forward_plain(b, A, *p, with_tax=with_tax)
    torch.cuda.synchronize()
    assert cuda_traj.trajectory_forward.launches == before + 1
    assert len(got) == (4 if with_tax else 3)
    _assert_close(got, want)
    # the last layer is the inference kernel's answer
    _assert_close([t[-1] for t in got[:3]], cuda_unroll.unroll_forward(b, A, *p))


def _int8_state(R, L, seed, device):
    from dladmm_tpu_torch.train import qadam_cuda as tqa

    rng = np.random.default_rng(seed)
    t = lambda *s, scale=1.0: torch.as_tensor((scale * rng.normal(size=s)).astype(np.float32), device=device)  # noqa: E731
    mu = tqa.quantize_rows(t(R, L, scale=1e-2))
    nu = tqa.quantize_rows(t(R, L, scale=1e-3).abs())
    return t(R, L), mu, nu, [t(R, L, scale=1e-2) for _ in range(3)]


@pytest.mark.gpu
@pytest.mark.parametrize("R,L", [(512, 128), (7500, 250), (3750, 250), (40000, 1000)])
def test_int8_sweep_matches_plain(cuda_device, R, L):
    """Three chained steps in place from a non-zero state: masters within
    rtol 1e-6, codes within one step, scales within rtol 1e-6. The
    leaves: the CPU tests' smallest, synthetic_small's W1 and W2, and
    synthetic_large's W1 (R = 20 * 2000)."""
    from dladmm_tpu_torch.train import qadam_cuda as tqa

    master, mu, nu, grads = _int8_state(R, L, seed=R, device=cuda_device)
    ref = (master.clone(), tqa.QTensor(mu.codes.clone(), mu.scale.clone()),
           tqa.QTensor(nu.codes.clone(), nu.scale.clone()))
    before = tqa.adam_int8_rows.launches
    for i, g in enumerate(grads):
        cf = float(i + 2)
        scal = torch.tensor([1 - 0.9**cf, 1 - 0.999**cf, 1e-3, 0.7], device=cuda_device)
        tqa.adam_int8_rows(g, master, mu, nu, scal)
        tqa.adam_int8_rows_plain(g, *ref, scal)
    torch.cuda.synchronize()
    assert tqa.adam_int8_rows.launches == before + 3
    torch.testing.assert_close(master, ref[0], rtol=1e-6, atol=1e-9)
    for got, want in ((mu, ref[1]), (nu, ref[2])):
        assert int((got.codes.int() - want.codes.int()).abs().max()) <= 1
        torch.testing.assert_close(got.scale, want.scale, rtol=1e-6, atol=0)


@pytest.mark.gpu
def test_training_gradients_on_the_card(cuda_device):
    """One deep-supervision loss at synthetic_small S = 64: the kernel
    path (trajectory kernel + manual backward) against autograd through
    the plain loop, rtol 2e-5 of each leaf's largest gradient."""
    from dladmm_tpu_torch.models.unroll import dladmm_forward
    from dladmm_tpu_torch.ops import cuda_traj
    from dladmm_tpu_torch.train.loop import weighted_trajectory_mse

    A, b, p = _problem(250, 500, 15, 64, seed=5, device=cuda_device)
    w = torch.full((15,), 1 / 15, device=cuda_device)
    x_star, z_star = torch.zeros(64, 500, device=cuda_device), torch.zeros(64, 250, device=cuda_device)
    grads = []
    for kernel in (True, False):
        leaves = [t.detach().clone().requires_grad_() for t in p]
        q = DLADMMParams(*leaves)
        if kernel:
            tx, tz, _ = cuda_traj.make_unrolled_trajectory()(q, A, b)
        else:
            _, (tx, tz, _) = dladmm_forward(q, A, b, capture_trajectory=True)
        grads.append(torch.autograd.grad(weighted_trajectory_mse(tx, tz, x_star, z_star, w), leaves))
    for g, want in zip(*grads):
        torch.testing.assert_close(g, want, rtol=2e-5, atol=2e-5 * float(want.abs().max()))


@pytest.mark.gpu
def test_fit_on_the_card_uses_both_kernels(cuda_device):
    import dataclasses

    from dladmm_tpu_torch.ops import cuda_traj
    from dladmm_tpu_torch.train import qadam_cuda as tqa
    from dladmm_tpu_torch.train.loop import fit
    from dladmm_tpu_torch.models.api import select_forward
    from dladmm_tpu_torch.utils.config import get_config

    cfg = get_config("synthetic_small")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, steps=20, eval_every=10))
    fwd, _, desc = select_forward(250, 500, 250, 64, need_trajectory=True, device=cuda_device)
    assert desc == "cuda-trajectory-kernel"
    t0, a0 = cuda_traj.trajectory_forward.launches, tqa.adam_int8_rows.launches
    _, hist = fit(cfg, forward_fn=fwd, device=cuda_device)
    assert cuda_traj.trajectory_forward.launches - t0 == 20 + 2  # steps + evals
    assert tqa.adam_int8_rows.launches - a0 == 2 * 20  # W1 and W2 per step
    assert all(np.isfinite(h["nmse_db"]) for h in hist)
