"""The CUDA whole-unroll kernel on the card, against its plain version.

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
