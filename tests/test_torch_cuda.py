"""The port's CUDA kernels on the card, against their plain versions:
the whole-unroll kernel and the layer step (one persistent cooperative
launch each: both tile edges, their repeat bit for bit, a refused grid,
two servers on two streams at once), the trajectory kernel (also
persistent: its repeat bit for bit, shapes with more work items than
blocks, and a refused grid), the int8 Adam sweep, the backward kernel
(both routes), the dense Adam sweep, the training
gradients through them, fit on the card, the int8 whole-unroll kernel
and its servers, and the per-layer fused step.

Every test here needs a CUDA card: each is marked ``gpu`` and skips at
run time without one. The file imports no JAX, so it also runs where
JAX is not installed; tests/conftest.py does import JAX, so run it there
with

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_cuda.py

Tolerance of the forwards: 1e-4 * max(1, max|ref|) (chip_smoke.py's),
because the kernel's FMA loop and cuBLAS sum in different orders and
the unroll carries the difference through K layers. The backward and
the sweeps state theirs.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from dladmm_tpu_torch.models.unroll import DLADMMParams, init_dladmm_params
from dladmm_tpu_torch.ops import cuda_unroll
from dladmm_tpu_torch.serve import BatchingServer, InferenceServer
from dladmm_tpu_torch.train.step_checks import bf16_neighbours

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


def _force_tile(monkeypatch, tile):
    """Make the serving wrappers launch the ``tile`` kernel, whatever
    ops/schedule.serve_tile would choose."""
    from dladmm_tpu_torch.ops import schedule

    monkeypatch.setattr(schedule, "serve_plan",
                        lambda *a: schedule.make_serve_plan(*a, tile=tile))


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("prox_x", ["l1", "elastic_net"])
@pytest.mark.parametrize("m,n,K,S", SHAPES)
def test_kernel_matches_plain_at_both_tiles(cuda_device, monkeypatch, m, n, K, S, prox_x, tile):
    """Each tile edge of the serving kernel at every shape, whatever the
    plan would choose there: ragged tiles, S = 1, split and unsplit
    phases; the plan it launched with is kept in last_plan."""
    _force_tile(monkeypatch, tile)
    A, b, p = _problem(m, n, K, S, seed=m + S + 5, device=cuda_device)
    got = cuda_unroll.unroll_forward(b, A, *p, prox_x=prox_x, prox_z=prox_x, rho=0.3)
    want = cuda_unroll.unroll_forward_plain(b, A, *p, prox_x=prox_x, prox_z=prox_x, rho=0.3)
    torch.cuda.synchronize()
    _assert_close(got, want)
    occ, grid, splits, k = cuda_unroll.unroll_forward.last_plan
    assert k == K and all(sp.tile == tile for sp in splits.values()) and grid <= occ[0] * occ[1]


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,K,S", [(250, 500, 15, 256), (1000, 2000, 20, 1024)])
def test_serving_kernels_repeat_bit_for_bit(cuda_device, m, n, K, S):
    """No float atomics in the serving kernel's split-K sums: two calls of
    either entry give the same bits (synthetic_small's largest serving
    bucket on the 32 tile, synthetic_large S = 1024 on the 64 tile; the
    layer step in fp32 and with bf16 operands)."""
    from dladmm_tpu_torch.ops import cuda_layer

    A, b, p = _problem(m, n, K, S, seed=S + 17, device=cuda_device)
    one, two = (cuda_unroll.unroll_forward(b, A, *p) for _ in range(2))
    assert all(torch.equal(g, w) for g, w in zip(one, two))
    assert cuda_unroll.unroll_forward.last_plan[2]["x"].tile == (64 if m == 1000 else 32)
    state = (torch.zeros((S, n), device=cuda_device), *one[1:], torch.zeros_like(b))
    layer = (p.W1[1], p.W2[1], p.theta1[1].contiguous(), p.theta2[1].contiguous(), p.beta[1:2].contiguous())
    for md in (None, torch.bfloat16):
        one, two = (cuda_layer.layer_step(b, A, *state, *layer, matmul_dtype=md) for _ in range(2))
        assert all(torch.equal(g, w) for g, w in zip(one, two))


@pytest.mark.gpu
def test_serving_kernels_raise_when_the_grid_is_refused(cuda_device, monkeypatch):
    """A grid larger than the card holds resident: both entries raise,
    count no launch and leave no error behind (patched
    ops/schedule.serve_plan: one block more than the card holds)."""
    from dladmm_tpu_torch.ops import cuda_layer, schedule

    b, A, state, layer = _layer_state(250, 500, 64, seed=3, device=cuda_device)
    _, _, p = _problem(250, 500, 3, 64, seed=3, device=cuda_device)
    serve_plan = schedule.serve_plan

    def refused(*a):
        plan = serve_plan(*a)
        return plan._replace(grid=plan.occ[0] * plan.occ[1] + 1)

    monkeypatch.setattr(schedule, "serve_plan", refused)
    u0, l0 = cuda_unroll.unroll_forward.launches, cuda_layer.layer_step.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_unroll.unroll_forward(b, A, *p)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_layer.layer_step(b, A, *state, *layer)
    assert cuda_unroll.unroll_forward.launches == u0 and cuda_layer.layer_step.launches == l0
    torch.cuda.synchronize()
    monkeypatch.undo()
    _assert_close(cuda_unroll.unroll_forward(b, A, *p), cuda_unroll.unroll_forward_plain(b, A, *p))
    _assert_close(cuda_layer.layer_step(b, A, *state, *layer), cuda_layer.layer_step_plain(b, A, *state, *layer))


@pytest.mark.gpu
def test_two_servers_on_two_streams_at_once(cuda_device):
    """Two InferenceServer calls at once, from two threads on two streams,
    each a cooperative grid of every block the card holds resident
    (synthetic_small bucket 2048: 1024 tiles in the x phase): both finish
    and equal one call each, bit for bit."""
    A, _, p = _problem(250, 500, 15, 1, seed=13, device=cuda_device)
    server = InferenceServer(p, A, buckets=(256, 2048))
    occ, grid, _, _ = cuda_unroll.unroll_forward.last_plan
    assert grid == occ[0] * occ[1]  # the last warm-up: bucket 2048
    rng = np.random.default_rng(14)
    reqs = [torch.as_tensor(rng.normal(size=(2048, 250)).astype(np.float32), device=cuda_device)
            for _ in range(2)]
    want = [server.solve(r) for r in reqs]
    torch.cuda.synchronize()
    got, start = [None, None], threading.Barrier(2)

    def call(i):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.default_stream())
        with torch.cuda.stream(stream):
            start.wait()
            got[i] = server.solve(reqs[i])
            stream.synchronize()

    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))


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
    t0, a0 = cuda_traj.trajectory_forward.launches, tqa.adam_step.launches
    _, hist = fit(cfg, forward_fn=fwd, device=cuda_device)
    assert cuda_traj.trajectory_forward.launches - t0 == 20 + 2  # steps + evals
    assert tqa.adam_step.launches - a0 == 2 * 20  # prologue and sweep per step
    assert all(np.isfinite(h["nmse_db"]) for h in hist)


# -- the final-layer training slice's kernels --------------------------------


def _bwd_case(m, n, K, S, seed, device, ties=False):
    """Problem, the trajectory kernel's stacks and random final-state
    cotangents; with ties, theta1 of layer 1 partly 0 and beta of the
    last layer at 1e-6 (its tie point)."""
    from dladmm_tpu_torch.ops import cuda_traj

    A, b, p = _problem(m, n, K, S, seed=seed, device=device)
    if ties:
        p.theta1[min(1, K - 1), ::2] = 0.0
        p.beta[K - 1] = 1e-6
    traj = cuda_traj.trajectory_forward(b, A, *p, with_tax=True)
    g = torch.Generator(device=device).manual_seed(seed)
    cts = [torch.randn((S, n), generator=g, device=device), torch.randn((S, m), generator=g, device=device),
           0.1 * torch.randn((S, m), generator=g, device=device)]
    return A, b, p, traj, cts


def _assert_grads_close(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5 * float(w.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("data_grads", [True, False])
@pytest.mark.parametrize("m,n,K,S,bs,ties", [
    (16, 32, 4, 8, None, False), (33, 77, 5, 13, None, True), (33, 77, 5, 13, 4, True),
    (250, 500, 15, 64, None, True), (250, 500, 15, 1024, 128, False),
])
def test_bwd_kernel_matches_plain(cuda_device, m, n, K, S, bs, ties, data_grads):
    """The backward kernel against its plain version on the trajectory
    kernel's stacks: ragged tiles and slices, ties at theta = 0 and
    beta = 1e-6, the chunked route; rtol 2e-5 and 2e-5 of each leaf's
    largest value (tests/test_pallas_bwd.py's). One launch per call,
    counted under its route."""
    from dladmm_tpu_torch.ops import cuda_bwd

    A, b, p, traj, cts = _bwd_case(m, n, K, S, seed=m + S, device=cuda_device, ties=ties)
    route = "chunked" if bs is not None and bs < S else "whole"
    before = dict(cuda_bwd.unroll_bwd.launches)
    got = cuda_bwd.unroll_bwd(b, A, *p, *traj, *cts, bs=bs, data_grads=data_grads)
    want = cuda_bwd.unroll_bwd_plain(b, A, *p, *traj, *cts, data_grads=data_grads)
    torch.cuda.synchronize()
    assert cuda_bwd.unroll_bwd.launches[route] == before[route] + 1
    _assert_grads_close(got[0], want[0])
    _assert_grads_close(got[1:], want[1:])


@pytest.mark.gpu
def test_bwd_kernel_repeats_bit_for_bit(cuda_device):
    """No float atomics: two calls give the same bits, on both routes."""
    from dladmm_tpu_torch.ops import cuda_bwd

    A, b, p, traj, cts = _bwd_case(250, 500, 3, 512, seed=8, device=cuda_device)
    for bs in (None, 128):
        one = cuda_bwd.unroll_bwd(b, A, *p, *traj, *cts, bs=bs, data_grads=True)
        two = cuda_bwd.unroll_bwd(b, A, *p, *traj, *cts, bs=bs, data_grads=True)
        for g, w in zip([*one[0], one[1], one[2]], [*two[0], two[1], two[2]]):
            assert torch.equal(g, w)


@pytest.mark.gpu
def test_trajectory_kernel_repeats_bit_for_bit(cuda_device):
    """No float atomics in the persistent kernel's split-K sums: two calls
    give the same bits, with and without the Ax stack."""
    from dladmm_tpu_torch.ops import cuda_traj

    A, b, p = _problem(250, 500, 15, 64, seed=31, device=cuda_device)
    for with_tax in (True, False):
        one = cuda_traj.trajectory_forward(b, A, *p, with_tax=with_tax)
        two = cuda_traj.trajectory_forward(b, A, *p, with_tax=with_tax)
        for g, w in zip(one, two):
            assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,K,S", [(250, 500, 15, 3000), (1000, 2000, 20, 1024)])
def test_trajectory_kernel_with_more_items_than_blocks(cuda_device, m, n, K, S):
    """Shapes whose phases have more tiles than the persistent grid has
    blocks (synthetic_small S = 3000, synthetic_large S = 1024), so every
    block loops over several items."""
    from dladmm_tpu_torch.ops import cuda_traj

    A, b, p = _problem(m, n, K, S, seed=S + 7, device=cuda_device)
    got = cuda_traj.trajectory_forward(b, A, *p, with_tax=True)
    want = cuda_traj.trajectory_forward_plain(b, A, *p, with_tax=True)
    torch.cuda.synchronize()
    _, grid, splits, _ = cuda_traj.trajectory_forward.last_plan  # the plan it launched with
    assert max(sp.items for sp in splits.values()) > grid
    _assert_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("data_grads", [True, False])
def test_bwd_kernel_whole_batch_1024(cuda_device, data_grads):
    """The whole-batch route at synthetic_small S = 1024 (the policy's
    route there): every layer's 2880 weight-gradient tiles summed over
    1024 rows, against the plain version at the backward's tolerance."""
    from dladmm_tpu_torch.ops import cuda_bwd

    A, b, p, traj, cts = _bwd_case(250, 500, 15, 1024, seed=1029, device=cuda_device)
    assert cuda_bwd.bwd_chunk_batch(250, 500, 250, 1024, 15, cuda_bwd.weight_wave(cuda_device)) is None
    before = dict(cuda_bwd.unroll_bwd.launches)
    got = cuda_bwd.unroll_bwd(b, A, *p, *traj, *cts, data_grads=data_grads)
    want = cuda_bwd.unroll_bwd_plain(b, A, *p, *traj, *cts, data_grads=data_grads)
    torch.cuda.synchronize()
    assert cuda_bwd.unroll_bwd.launches["whole"] == before["whole"] + 1
    _assert_grads_close(got[0], want[0])
    _assert_grads_close(got[1:], want[1:])


@pytest.mark.gpu
def test_persistent_kernels_raise_when_the_grid_is_refused(cuda_device, monkeypatch):
    """A grid larger than the card holds resident is refused by the
    cooperative launch: both wrappers raise, count no launch and run
    nothing in the kernel's place. Forced by patching the plans the
    wrappers launch with (ops/schedule.traj_plan, bwd_plan) to one block
    more than the card holds."""
    from dladmm_tpu_torch.ops import cuda_bwd, cuda_traj, schedule

    A, b, p, traj, cts = _bwd_case(250, 500, 3, 64, seed=2, device=cuda_device)
    traj_plan, bwd_plan = schedule.traj_plan, schedule.bwd_plan
    monkeypatch.setattr(schedule, "traj_plan",
                        lambda *a: (a[-2] * a[-1] + 1, *traj_plan(*a)[1:]))
    monkeypatch.setattr(schedule, "bwd_plan",
                        lambda *a: (a[-2] * a[-1] + 1, *bwd_plan(*a)[1:]))
    t0, b0 = cuda_traj.trajectory_forward.launches, dict(cuda_bwd.unroll_bwd.launches)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_traj.trajectory_forward(b, A, *p, with_tax=True)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_bwd.unroll_bwd(b, A, *p, *traj, *cts)
    assert cuda_traj.trajectory_forward.launches == t0
    assert cuda_bwd.unroll_bwd.launches == b0
    torch.cuda.synchronize()  # nothing was left running or faulted
    # the refusal is not left behind for the next kernel's launch check
    _assert_close(cuda_unroll.unroll_forward(b, A, *p), cuda_unroll.unroll_forward_plain(b, A, *p))
    monkeypatch.undo()
    _assert_close(cuda_traj.trajectory_forward(b, A, *p), cuda_traj.trajectory_forward_plain(b, A, *p))


def _final_loss(x, z, lam):
    return torch.mean(x * x) + torch.mean(z * torch.cos(z)) + 0.1 * torch.mean(lam)


@pytest.mark.gpu
@pytest.mark.parametrize("S,reference", [(64, "plain-loop"), (64, "same-forward"), (1024, "same-forward")])
def test_final_layer_gradients_on_the_card(cuda_device, S, reference):
    """make_unrolled_forward's gradient (trajectory kernel + backward
    kernel, on the route the policy picks), A and b included, within
    rtol 2e-5 of each leaf's scale of: autograd through the plain loop
    ("plain-loop"), or the plain backward on the kernel's own trajectory
    ("same-forward", the route before the backward kernel). At S = 1024
    only the second: there the gradient moves by 0.5% of its largest
    value between an fp32 and an fp64 plain forward (measured on the
    CPU at these params), so two forwards that round differently cannot
    agree to 2e-5."""
    from dladmm_tpu_torch.models.unroll import dladmm_forward
    from dladmm_tpu_torch.ops import cuda_bwd, cuda_traj

    A, b, p = _problem(250, 500, 15, S, seed=S, device=cuda_device)
    route = "chunked" if cuda_bwd.bwd_chunk_batch(250, 500, 250, S, 15, cuda_bwd.weight_wave(cuda_device)) else "whole"
    leaves = [t.detach().clone().requires_grad_() for t in (*p, A, b)]
    before = dict(cuda_bwd.unroll_bwd.launches)
    x, z, lam = cuda_unroll.make_unrolled_forward()(DLADMMParams(*leaves[:5]), leaves[5], leaves[6])
    got = torch.autograd.grad(_final_loss(x, z, lam), leaves)
    assert cuda_bwd.unroll_bwd.launches[route] == before[route] + 1
    if reference == "plain-loop":
        ref = [t.detach().clone().requires_grad_() for t in (*p, A, b)]
        x, z, lam = dladmm_forward(DLADMMParams(*ref[:5]), ref[5], ref[6])
        want = torch.autograd.grad(_final_loss(x, z, lam), ref)
    else:
        traj = cuda_traj.trajectory_forward(b, A, *p, with_tax=True)
        final = [t[-1].clone().requires_grad_() for t in traj[:3]]
        cts = torch.autograd.grad(_final_loss(*final), final)
        gp, gA, gb = cuda_bwd.unroll_bwd_plain(b, A, *p, *traj, *cts, data_grads=True)
        want = (*gp, gA, gb)
    _assert_grads_close(got, want)


def _dense_state(shape, fmt, seed, device):
    from dladmm_tpu_torch.train import qadam_cuda as tqa

    mu_dt, nu_dt, _, _ = tqa.DENSE_FMTS[fmt]
    g = torch.Generator(device=device).manual_seed(seed)
    rand = lambda scale: scale * torch.randn(shape, generator=g, device=device)  # noqa: E731
    return (rand(0.05), rand(1e-2).to(mu_dt), (rand(3e-2) ** 2).to(nu_dt), [rand(1e-2) for _ in range(3)])


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["float32", "bfloat16", "bfloat16_sr", "bfloat16_sr_mu"])
@pytest.mark.parametrize("shape", [(2, 256, 128), (15, 500, 250), (15, 250), (15,)])
def test_dense_sweep_matches_plain(cuda_device, fmt, shape):
    """Three chained steps in place from a non-zero state. Masters within
    rtol 1e-6. Round-to-nearest moments equal to the plain version's;
    SR moments one of the two bf16 neighbours of the plain fp32 moment
    of the same step (other bits than the plain version's, by design)."""
    from dladmm_tpu_torch.train import qadam_cuda as tqa

    master, mu, nu, grads = _dense_state(shape, fmt, seed=sum(shape), device=cuda_device)
    _, _, sr_mu, sr_nu = tqa.DENSE_FMTS[fmt]
    before = tqa.adam_dense_rows.launches
    for i, g in enumerate(grads):
        cf = float(i + 2)
        scal = torch.tensor([1 - 0.9**cf, 1 - 0.999**cf, 1e-3, 0.7], device=cuda_device)
        seed = torch.tensor(1000 + i, dtype=torch.int32, device=cuda_device)
        ref = [master.clone(), mu.to(torch.float32, copy=True), nu.to(torch.float32, copy=True)]
        tqa.adam_dense_rows_plain(g, *ref, scal, "float32")
        tqa.adam_dense_rows(g, master, mu, nu, scal, fmt, seed)
        torch.cuda.synchronize()
        torch.testing.assert_close(master, ref[0], rtol=1e-6, atol=1e-9)
        for got, want, sr in ((mu, ref[1], sr_mu), (nu, ref[2], sr_nu)):
            if got.dtype == torch.float32:
                assert torch.equal(got, want)
            elif sr:
                lo, hi = bf16_neighbours(want)
                assert ((got.float() == lo) | (got.float() == hi)).all()
            else:
                assert torch.equal(got, want.to(torch.bfloat16))
        master = ref[0].clone()  # the next step starts from the same state on both sides
    assert tqa.adam_dense_rows.launches == before + 3


@pytest.mark.gpu
def test_dense_sr_is_unbiased_on_the_card(cuda_device):
    """Over 64 seeds the mean stored SR moment is the fp32 moment within
    5 standard errors per value and 4 for the sum."""
    from dladmm_tpu_torch.train import qadam_cuda as tqa

    shape = (64, 128)
    master, mu, nu, grads = _dense_state(shape, "bfloat16_sr", seed=3, device=cuda_device)
    scal = torch.tensor([0.19, 0.002, 1e-3, 1.0], device=cuda_device)
    ref = [master.clone(), mu.to(torch.float32, copy=True), nu.to(torch.float32, copy=True)]
    tqa.adam_dense_rows_plain(grads[0], *ref, scal, "float32")
    for moment, want in ((1, ref[1]), (2, ref[2])):
        total = torch.zeros(shape, dtype=torch.float64, device=cuda_device)
        for s in range(64):
            st = [master.clone(), mu.clone(), nu.clone()]
            tqa.adam_dense_rows(grads[0], *st, scal, "bfloat16_sr", torch.tensor(s, dtype=torch.int32, device=cuda_device))
            total += st[moment].double()
        lo, hi = bf16_neighbours(want)
        sigma = (hi - lo).double().abs() / 2 / 8
        err = total / 64 - want.double()
        assert (err.abs() <= 5 * sigma + 1e-30).all()
        assert abs(float(err.sum())) <= 4 * float(sigma.pow(2).sum().sqrt())


@pytest.mark.gpu
def test_no_fallback_without_a_build(cuda_device, tmp_path, monkeypatch):
    """With no built library and no nvcc, a CUDA call to either new
    kernel raises; nothing runs the plain version in its place."""
    from dladmm_tpu_torch.ops import cuda_bwd, cuda_build
    from dladmm_tpu_torch.train import qadam_cuda as tqa

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    A, b, p, traj, cts = _bwd_case(16, 32, 2, 8, seed=1, device=cuda_device)
    master, mu, nu, grads = _dense_state((4, 8), "float32", seed=1, device=cuda_device)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "nvcc", no_nvcc)
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "_entries", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_bwd.unroll_bwd(b, A, *p, *traj, *cts)
    with pytest.raises(RuntimeError, match="nvcc"):
        tqa.adam_dense_rows(grads[0], master, mu, nu, torch.ones(4, device=cuda_device), "float32")


@pytest.mark.gpu
def test_fit_final_layer_on_the_card_uses_the_kernels(cuda_device):
    import dataclasses

    from dladmm_tpu_torch.models.api import select_forward
    from dladmm_tpu_torch.ops import cuda_bwd, cuda_traj
    from dladmm_tpu_torch.train import qadam_cuda as tqa
    from dladmm_tpu_torch.train.loop import fit
    from dladmm_tpu_torch.utils.config import get_config

    cfg = get_config("synthetic_small")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, steps=20, eval_every=10, layer_loss=None, moment_dtype="float32_pallas"))
    fwd, _, desc = select_forward(250, 500, 250, 64, device=cuda_device)
    assert desc == "cuda-whole-unroll-kernel"
    t0, d0 = cuda_traj.trajectory_forward.launches, tqa.adam_step.launches
    b0 = dict(cuda_bwd.unroll_bwd.launches)
    _, hist = fit(cfg, forward_fn=fwd, device=cuda_device)
    assert cuda_traj.trajectory_forward.launches - t0 == 20 + 2  # steps + evals
    assert cuda_bwd.unroll_bwd.launches["whole"] - b0["whole"] == 20
    assert cuda_bwd.unroll_bwd.launches["chunked"] == b0["chunked"]
    assert tqa.adam_step.launches - d0 == 2 * 20  # prologue and sweep over every leaf, every step
    assert all(np.isfinite(h["nmse_db"]) for h in hist)


# -- int8 serving and the per-layer fused step -------------------------------


def _int8_case(m, n, K, S, seed, device, scalar_theta=False):
    """b with an all-zero row (a padded bucket row) and the quantized
    net and dictionary, on the card."""
    from dladmm_tpu_torch.ops.quantized import quantize_params

    A, b, p = _problem(m, n, K, S, seed=seed, device=device, scalar_theta=scalar_theta)
    if S > 1:
        b[S // 2] = 0.0
    return b, *quantize_params(p, A)


@pytest.mark.gpu
@pytest.mark.parametrize("scalar_theta", [False, True])
@pytest.mark.parametrize("m,n,K,S", SHAPES + [(1000, 2000, 20, 64)])
def test_int8_kernel_matches_plain_bit_for_bit(cuda_device, m, n, K, S, scalar_theta):
    """Round-to-nearest intrinsics in the plain version's order: the
    kernel's x, z and lam equal its plain version's bit for bit, ragged
    tiles, S = 1, a zero row and (K, 1) thresholds included; one launch
    per call."""
    from dladmm_tpu_torch.ops import cuda_int8

    b, qp, qd = _int8_case(m, n, K, S, seed=m + S, device=cuda_device, scalar_theta=scalar_theta)
    before = cuda_int8.int8_unroll_forward.launches
    got = cuda_int8.int8_unroll_forward(b, qp, qd)
    want = cuda_int8.int8_unroll_forward_plain(b, qp, qd)
    torch.cuda.synchronize()
    assert cuda_int8.int8_unroll_forward.launches == before + 1
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert torch.equal(g, w), int((g != w).sum())
    if S > 1:
        assert (got[0][S // 2] == 0).all()


@pytest.mark.gpu
def test_int8_servers_on_the_card(cuda_device):
    """dtype="int8": auto and megakernel take the kernel (one launch per
    bucket at warm-up), reference the plain scan (none); BatchingServer
    over the kernel route equals the kernel's plain version per request,
    bit for bit."""
    from dladmm_tpu_torch.ops import cuda_int8

    A, _, p = _problem(64, 128, 4, 1, seed=6, device=cuda_device)
    before = cuda_int8.int8_unroll_forward.launches
    for kernel in ("auto", "megakernel"):
        server = InferenceServer(p, A, max_batch=16, dtype="int8", kernel=kernel)
        assert set(server.routes.values()) == {"cuda-int8-unroll-kernel"}
    assert cuda_int8.int8_unroll_forward.launches == before + 2 * len(server.buckets)
    ref = InferenceServer(p, A, max_batch=16, dtype="int8", kernel="reference")
    assert set(ref.routes.values()) == {"plain-loop-int8-reference"}
    assert cuda_int8.int8_unroll_forward.launches == before + 2 * len(server.buckets)
    rng = np.random.default_rng(7)
    reqs = [rng.normal(size=(s, 64)).astype(np.float32) for s in (1, 3, 5, 7)]
    front = BatchingServer(server)
    try:
        batched = [f.result(timeout=120) for f in [front.submit(r) for r in reqs]]
    finally:
        front.close()
    for r, (xb, zb) in zip(reqs, batched):
        xw, zw, _ = cuda_int8.int8_unroll_forward_plain(torch.as_tensor(r, device=cuda_device), *server._operands)
        assert np.array_equal(xb, xw.cpu().numpy()) and np.array_equal(zb, zw.cpu().numpy())


def _force_int8_plan(monkeypatch, **choice):
    """Make the int8 wrapper launch with a forced tile and/or depth slices
    (ops/schedule.make_int8_plan's ``tile`` and ``slices``)."""
    from dladmm_tpu_torch.ops import schedule

    monkeypatch.setattr(schedule, "int8_plan", lambda *a: schedule.make_int8_plan(*a, **choice))


def _assert_bit_equal(got, want):
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert torch.equal(g, w), int((g != w).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("slices", [1, 2, 3, 8])
@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("m,n,K,S", [(37, 75, 3, 13), (33, 77, 5, 1), (250, 500, 15, 64)])
def test_int8_kernel_matches_plain_at_every_plan_choice(cuda_device, monkeypatch, m, n, K, S, tile, slices):
    """Each tile edge and depth split the plan can make (forced: one slice,
    a few, and as many as the 64-byte steps allow), at odd widths (weight
    rows of 37, 75 and 33, 77 bytes: staged a byte or two at a time) and
    at synthetic_small: bit for bit, the plan kept in last_plan."""
    from dladmm_tpu_torch.ops import cuda_int8

    _force_int8_plan(monkeypatch, tile=tile, slices=slices)
    b, qp, qd = _int8_case(m, n, K, S, seed=m + S + slices, device=cuda_device)
    got = cuda_int8.int8_unroll_forward(b, qp, qd)
    want = cuda_int8.int8_unroll_forward_plain(b, qp, qd)
    torch.cuda.synchronize()
    _assert_bit_equal(got, want)
    occ, grid, splits, k = cuda_int8.int8_unroll_forward.last_plan
    assert k == K and grid <= occ[0] * occ[1] and all(sp.tile == tile for sp in splits.values())
    assert all(1 <= sp.slices <= slices for sp in splits.values())


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,K,S", [(250, 500, 15, 256), (1000, 2000, 20, 64)])
def test_int8_kernel_repeats_bit_for_bit(cuda_device, m, n, K, S):
    """Row maxima by integer atomics and split-K sums in int32: a second
    call gives the same bits."""
    from dladmm_tpu_torch.ops import cuda_int8

    b, qp, qd = _int8_case(m, n, K, S, seed=S + 21, device=cuda_device)
    one, two = (cuda_int8.int8_unroll_forward(b, qp, qd) for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(one, two))


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 64, 256])
def test_int8_solve_is_one_kernel_under_the_profiler(cuda_device, S):
    """A solve enqueues the one cooperative kernel and no other device
    operation (no memset, no copy of the thresholds): every device event
    the profiler records over three solves is int8_persistent."""
    from torch.profiler import ProfilerActivity, profile

    from dladmm_tpu_torch.ops import cuda_int8

    b, qp, qd = _int8_case(250, 500, 15, S, seed=S + 22, device=cuda_device)
    qp = qp._replace(theta1=qp.theta1.mean(dim=1, keepdim=True), theta2=qp.theta2.mean(dim=1, keepdim=True))
    cuda_int8.int8_unroll_forward(b, qp, qd)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            cuda_int8.int8_unroll_forward(b, qp, qd)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    assert names and len(names) <= 3, names
    assert all("int8_persistent" in name for name in names), names


@pytest.mark.gpu
def test_int8_kernel_raises_when_the_grid_or_plan_is_refused(cuda_device, monkeypatch):
    """A grid larger than the card holds resident, and a plan whose
    workspace or split breaks the kernel's layout rules (csrc lay_out):
    the wrapper raises, counts no launch and leaves no error behind, and
    the next call runs."""
    from dladmm_tpu_torch.ops import cuda_int8, schedule

    b, qp, qd = _int8_case(250, 500, 3, 64, seed=23, device=cuda_device)
    int8_plan = schedule.int8_plan

    def bad_grid(*a):
        plan = int8_plan(*a)
        return plan._replace(grid=plan.occ[0] * plan.occ[1] + 1)

    def bad_workspace(*a):
        plan = int8_plan(*a)
        ws = dict(plan.workspace)
        ws["v"] = ws["u"]
        return plan._replace(workspace=ws)

    def bad_split(*a):
        plan = int8_plan(*a)
        sp = dict(plan.splits)
        sp["ax"] = sp["ax"]._replace(length=sp["ax"].length - 32)
        return plan._replace(splits=sp)

    for bad in (bad_grid, bad_workspace, bad_split):
        monkeypatch.setattr(schedule, "int8_plan", bad)
        before = cuda_int8.int8_unroll_forward.launches
        with pytest.raises(RuntimeError, match="CUDA error"):
            cuda_int8.int8_unroll_forward(b, qp, qd)
        assert cuda_int8.int8_unroll_forward.launches == before
        torch.cuda.synchronize()
        monkeypatch.undo()
        _assert_bit_equal(cuda_int8.int8_unroll_forward(b, qp, qd), cuda_int8.int8_unroll_forward_plain(b, qp, qd))


@pytest.mark.gpu
def test_int8_solves_on_two_streams_at_once(cuda_device):
    """Two int8 solves at once, from two threads on two streams, each a
    cooperative grid of every block the card holds resident
    (synthetic_small S = 2048): both finish and equal one call each, bit
    for bit."""
    from dladmm_tpu_torch.ops import cuda_int8

    cases = [_int8_case(250, 500, 15, 2048, seed=24 + i, device=cuda_device) for i in range(2)]
    want = [cuda_int8.int8_unroll_forward(*c) for c in cases]
    occ, grid, _, _ = cuda_int8.int8_unroll_forward.last_plan
    assert grid == occ[0] * occ[1]
    torch.cuda.synchronize()
    got, start = [None, None], threading.Barrier(2)

    def call(i):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.default_stream())
        with torch.cuda.stream(stream):
            start.wait()
            got[i] = cuda_int8.int8_unroll_forward(*cases[i])
            stream.synchronize()

    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))


def _layer_state(m, n, S, seed, device):
    """A state after 2 plain layers, its problem and layer 2's params."""
    from dladmm_tpu_torch.ops.reference import dladmm_layer_step_cached

    A, b, p = _problem(m, n, 3, S, seed=seed, device=device)
    x, z, lam = (torch.zeros((S, k), device=device) for k in (n, m, m))
    Ax = torch.zeros_like(lam)
    for k in range(2):
        x, z, lam, Ax, _ = dladmm_layer_step_cached(A, None, b, x, z, lam, Ax, z, p.layer(k))
    th = (p.theta1[2].contiguous(), p.theta2[2].contiguous(), p.beta[2:3].contiguous())
    return b, A, (x, z, lam, Ax), (p.W1[2], p.W2[2], *th)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m,n,K,S", SHAPES)
def test_layer_step_matches_plain_in_fresh_buffers(cuda_device, m, n, K, S, bf16):
    """One layer from a non-zero state: inputs unchanged after the call,
    outputs in new buffers; fp32 operands within TOL of the plain step,
    bf16 operands within 5% relative Frobenius error of it (and not equal
    to the fp32 kernel's); one launch per call."""
    from dladmm_tpu_torch.ops import cuda_layer

    b, A, state, layer = _layer_state(m, n, S, seed=m + S + 2, device=cuda_device)
    before = [t.clone() for t in state]
    n0 = cuda_layer.layer_step.launches
    md = torch.bfloat16 if bf16 else None
    got = cuda_layer.layer_step(b, A, *state, *layer, matmul_dtype=md)
    want = cuda_layer.layer_step_plain(b, A, *state, *layer)
    torch.cuda.synchronize()
    assert cuda_layer.layer_step.launches == n0 + 1
    for t, t0 in zip(state, before):
        assert torch.equal(t, t0)
    assert not any(g.data_ptr() == t.data_ptr() for g in got for t in (*state, b))
    if not bf16:
        _assert_close(got, want)
        return
    fp32 = cuda_layer.layer_step(b, A, *state, *layer)
    for g, w, f in zip(got, want, fp32):
        if float(w.norm()) > 0:
            assert float((g - w).norm() / w.norm()) < 0.05
            assert not torch.equal(g, f)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m,n,K,S", SHAPES)
def test_layer_step_matches_plain_at_both_tiles(cuda_device, monkeypatch, m, n, K, S, bf16, tile):
    """The layer step on each tile edge of the serving kernel, whatever
    the plan would choose: fp32 operands within TOL of the plain step;
    bf16 operands within 1e-3 relative Frobenius error of the plain
    step's bf16 mode (both round the same fp32 operands; a sum's order
    can move x1 across a bf16 rounding boundary, which Ax1 then sees)."""
    from dladmm_tpu_torch.ops import cuda_layer

    _force_tile(monkeypatch, tile)
    b, A, state, layer = _layer_state(m, n, S, seed=m + S + 9, device=cuda_device)
    md = torch.bfloat16 if bf16 else None
    got = cuda_layer.layer_step(b, A, *state, *layer, matmul_dtype=md)
    want = cuda_layer.layer_step_plain(b, A, *state, *layer, matmul_dtype=md)
    torch.cuda.synchronize()
    if bf16:
        for g, w in zip(got, want):
            assert torch.isfinite(g).all() and float((g - w).norm()) <= 1e-3 * float(w.norm())
    else:
        _assert_close(got, want)
    assert all(sp.tile == tile for sp in cuda_layer.layer_step.last_plan[2].values())


@pytest.mark.gpu
def test_fused_step_forward_and_grads_on_the_card(cuda_device):
    """dladmm_forward(step_fn=fused_layer_step) at synthetic_small S = 64:
    K launches, within TOL of the plain loop; its gradient (the Function's
    rematerialized backward) within rtol 2e-5 of each leaf's largest
    value of autograd through the plain loop."""
    from dladmm_tpu_torch.models.unroll import dladmm_forward
    from dladmm_tpu_torch.ops import cuda_layer

    A, b, p = _problem(250, 500, 15, 64, seed=12, device=cuda_device)
    n0 = cuda_layer.layer_step.launches
    with torch.no_grad():
        _assert_close(dladmm_forward(p, A, b, step_fn=cuda_layer.fused_layer_step), dladmm_forward(p, A, b))
    assert cuda_layer.layer_step.launches == n0 + 15
    grads = []
    for step in (cuda_layer.fused_layer_step, None):
        leaves = [t.detach().clone().requires_grad_() for t in p]
        x, z, lam = dladmm_forward(DLADMMParams(*leaves), A, b, step_fn=step)
        grads.append(torch.autograd.grad(_final_loss(x, z, lam), leaves))
    _assert_grads_close(*grads)


@pytest.mark.gpu
def test_new_kernels_raise_without_a_build_or_on_a_device_mix(cuda_device, tmp_path, monkeypatch):
    """With no built library and no nvcc, a CUDA call to the int8 kernel
    or the layer step raises; a CPU/CUDA mix raises before either
    version runs."""
    from dladmm_tpu_torch.ops import cuda_build, cuda_int8, cuda_layer

    b, qp, qd = _int8_case(16, 32, 2, 8, seed=1, device=cuda_device)
    lb, lA, state, layer = _layer_state(16, 32, 8, seed=1, device=cuda_device)
    with pytest.raises(ValueError, match="is on"):
        cuda_int8.int8_unroll_forward(b.cpu(), qp, qd)
    with pytest.raises(ValueError, match="is on"):
        cuda_layer.layer_step(lb, lA.cpu(), *state, *layer)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "nvcc", no_nvcc)
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "_entries", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_int8.int8_unroll_forward(b, qp, qd)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_layer.layer_step(lb, lA, *state, *layer)


# -- the optimizer step: prologue and one sweep over every leaf --------------

STEP_PRESETS = {"synthetic_small": (250, 500, 15), "synthetic_large": (1000, 2000, 20)}
STEP_FMTS = ["int8", "float32", "bfloat16", "bfloat16_sr", "bfloat16_sr_mu"]


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", STEP_FMTS)
@pytest.mark.parametrize("preset", list(STEP_PRESETS))
def test_adam_step_matches_plain(cuda_device, preset, fmt):
    """adam_step (prologue + one sweep, 2 launches a step) over the five
    leaves of a preset, 3 chained steps with the warmup-cosine rate and a
    clip. Each step: its scalars within 2 ulp of step_scalars', the count
    and seeds equal; its state equal to the one-leaf sweeps' run with its
    scalars from the state before it (masters and moments bit for bit, SR
    too; flat int8 codes, which the one-leaf path sweeps with the plain
    version, within one step); and held against the plain version's step
    from that state (step_checks.plain_step_diff)."""
    from dladmm_tpu_torch.train import qadam_cuda as tqa
    from dladmm_tpu_torch.train import step_checks as sc

    shapes = sc.preset_shapes(*STEP_PRESETS[preset])
    params, mu, nu, grads = sc.step_state(shapes, fmt, seed=shapes[0][0] + len(fmt), device=cuda_device)
    sched = tqa.WarmupCosine(0.0, 1e-2, 2, 40)
    count = torch.tensor(1, dtype=torch.int32, device=cuda_device)
    before = tqa.adam_step.launches
    for step, g in enumerate(grads):
        pre = sc.clone_state(params, mu, nu)
        old = count.clone()
        count, scal, seeds = tqa.adam_step(g, params, mu, nu, count, fmt, sched, 1.0)
        pscal, pcount = tqa.step_scalars(g, old, sched, 1.0)
        pseeds = tqa.step_seeds(pcount, fmt, len(shapes))
        one = sc.clone_state(*pre)
        sc.one_leaf_step(fmt, g, *one, scal, seeds)
        torch.cuda.synchronize()
        assert torch.equal(old, count - 1) and torch.equal(count, pcount)
        assert sc.scal_ulps(scal, pscal) <= 2, (step, scal.tolist(), pscal.tolist())
        assert (float(scal[3]) < 1.0) == (step != 1)
        assert (seeds is None) == (pseeds is None) and (seeds is None or torch.equal(seeds, pseeds))
        sc.check_against_one_leaf(fmt, (params, mu, nu), one, f"step {step}")
        sc.plain_step_diff(fmt, g, pre, (params, mu, nu), scal, seeds)
    assert tqa.adam_step.launches == before + 2 * len(grads)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "float32", "bfloat16_sr"])
def test_adam_step_scalar_paths_and_rate_modes(cuda_device, fmt):
    """Odd widths take the scalar accesses: an int8 leaf of L = 251 (and
    flat leaves of odd size), dense leaves one float off 16-byte alignment;
    each with a constant rate, a plain callable and no clip: the scalars
    within 2 ulp and the state equal to the one-leaf sweeps' run with the
    kernel's scalars."""
    from dladmm_tpu_torch.train import qadam_cuda as tqa
    from dladmm_tpu_torch.train import step_checks as sc

    shapes = [(2, 256, 251), (3, 7, 5), (33,), (2, 300), (1,)]
    for lr, clip in ((3e-3, None), (lambda c: 1e-3 / (1.0 + c.to(torch.float32)), 0.5)):
        params, mu, nu, grads = sc.step_state(shapes, fmt, seed=251, device=cuda_device)
        if fmt != "int8":  # views one element in: 4-byte aligned only
            def shift(t):
                buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
                buf[1:] = t.reshape(-1)
                return buf[1:].view(t.shape)

            params, mu, nu = (DLADMMParams(*map(shift, tree)) for tree in (params, mu, nu))
            grads = [DLADMMParams(*map(shift, g)) for g in grads]
            plan = tqa.step_plan(tuple(tqa._leaf_spec(i, *leaf, fmt)[0] for i, leaf in
                                       enumerate(zip(grads[0], params, mu, nu))))
            assert {lp.vec for lp in plan.leaves} == {1}
        else:
            assert tqa.int8_vec(251, 0, 0, 0, 0) == 1 and tqa.leaf_eligible(params[0])
        count = torch.tensor(0, dtype=torch.int32, device=cuda_device)
        for g in grads:
            ref = sc.clone_state(params, mu, nu)
            new, scal, seeds = tqa.adam_step(g, params, mu, nu, count, fmt, lr, clip)
            _, pscal, _ = tqa.adam_step_plain(g, *sc.clone_state(*ref), count, fmt, lr, clip)
            sc.one_leaf_step(fmt, g, *ref, scal, seeds)
            torch.cuda.synchronize()
            assert sc.scal_ulps(scal, pscal) <= 2, (scal.tolist(), pscal.tolist())
            sc.check_against_one_leaf(fmt, (params, mu, nu), ref, "odd widths")
            count = new


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "bfloat16_sr"])
def test_adam_step_repeats_bit_for_bit(cuda_device, fmt):
    """Two steps from the same state and gradients (synthetic_large: the
    norm over 512 blocks' partials) write the same bits and scalars."""
    from dladmm_tpu_torch.train import qadam_cuda as tqa
    from dladmm_tpu_torch.train import step_checks as sc

    shapes = sc.preset_shapes(*STEP_PRESETS["synthetic_large"])
    params, mu, nu, grads = sc.step_state(shapes, fmt, seed=3, device=cuda_device)
    runs = []
    for _ in range(2):
        state = sc.clone_state(params, mu, nu)
        count = torch.tensor(5, dtype=torch.int32, device=cuda_device)
        _, scal, _ = tqa.adam_step(grads[0], *state, count, fmt, 1e-3, 1.0)
        runs.append((state, scal))
    torch.cuda.synchronize()
    (s1, c1), (s2, c2) = runs
    assert torch.equal(c1, c2)
    assert sc.same_state(s1, s2)


@pytest.mark.gpu
def test_adam_step_raises_when_the_launch_is_refused(cuda_device, monkeypatch):
    """A packed table other than the C side's layout rules give (a sweep
    of 0 blocks; a leaf's vector width narrower than its alignment allows)
    is refused before either launch is enqueued: adam_step raises, counts
    no launch and leaves the state as it was, and the next step runs."""
    from dladmm_tpu_torch.train import qadam_cuda as tqa
    from dladmm_tpu_torch.train import step_checks as sc

    shapes = [(2, 256, 128), (2, 128, 128), (2, 256), (2, 128), (2,)]
    params, mu, nu, grads = sc.step_state(shapes, "float32", seed=1, device=cuda_device)
    count = torch.tensor(0, dtype=torch.int32, device=cuda_device)
    plan = tqa.step_plan
    specs = tuple(tqa._leaf_spec(i, *leaf, "float32")[0] for i, leaf in enumerate(zip(grads[0], params, mu, nu)))
    assert plan(specs).leaves[0].vec == 8

    def narrow(p):
        return dataclasses.replace(p, leaves=(dataclasses.replace(p.leaves[0], vec=1),) + p.leaves[1:])

    for bad in (lambda specs: dataclasses.replace(plan(specs), blocks=0), lambda specs: narrow(plan(specs))):
        before, state = tqa.adam_step.launches, sc.clone_state(params, mu, nu)
        monkeypatch.setattr(tqa, "step_plan", bad)
        with pytest.raises(RuntimeError, match="CUDA Adam step failed"):
            tqa.adam_step(grads[0], params, mu, nu, count, "float32", 1e-3, 1.0)
        torch.cuda.synchronize()
        assert tqa.adam_step.launches == before and sc.same_state((params, mu, nu), state)
        monkeypatch.setattr(tqa, "step_plan", plan)
        new, _, _ = tqa.adam_step(grads[0], params, mu, nu, count, "float32", 1e-3, 1.0)
        torch.cuda.synchronize()
        assert int(new) == 1 and tqa.adam_step.launches == before + 2


# -- bf16 serving and the layer step on bf16 state ---------------------------

# bf16 kernel against its plain version: each output within BF16_TOL_ULPS
# bf16 ulps of its largest magnitude (chip_smoke.py's tolerance and its
# derivation: another summation order moves the plain version by up to 3).
BF16_TOL_ULPS = 12.0


def _problem16(m, n, K, S, seed, device, scalar_theta=False):
    A, b, p = _problem(m, n, K, S, seed, device, scalar_theta)
    return A.bfloat16(), b.bfloat16(), DLADMMParams(*(t.bfloat16() for t in p))


def _assert_bf16_close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape
        assert torch.isfinite(g.float()).all()
        top = float(w.float().abs().max())
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0
        err = float((g.float() - w.float()).abs().max())
        assert err <= BF16_TOL_ULPS * ulp, (err, ulp)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("prox", ["l1", "nonneg_l1", "box", "elastic_net"])
@pytest.mark.parametrize("m,n,K,S", SHAPES)
def test_bf16_kernel_matches_plain(cuda_device, monkeypatch, m, n, K, S, prox, tile):
    """The bf16-storage serving kernel against unroll_forward_plain_bf16 at
    both tile edges, every prox (as prox_x and prox_z at once; elastic net
    at rho 0.3), ragged tiles and S = 1, bf16 beta; a second call bit for
    bit."""
    _force_tile(monkeypatch, tile)
    A, b, p = _problem16(m, n, K, S, seed=m + S + 25, device=cuda_device)
    kw = dict(prox_x=prox, prox_z=prox, rho=0.3)
    got = cuda_unroll.unroll_forward(b, A, *p, **kw)
    again = cuda_unroll.unroll_forward(b, A, *p, **kw)
    torch.cuda.synchronize()
    _assert_bf16_close(got, cuda_unroll.unroll_forward_plain_bf16(b, A, *p, **kw))
    assert all(torch.equal(g, w) for g, w in zip(got, again))
    assert cuda_unroll.unroll_forward.last_plan[2]["x"].tile == tile


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,K,S", [(250, 500, 15, 256), (1000, 2000, 20, 1024)])
def test_bf16_kernel_with_fp32_beta_and_scalar_thresholds(cuda_device, m, n, K, S):
    """fp32 beta beside bf16 storage (the other beta pointer) and (K, 1)
    thresholds, at synthetic_small's largest serving bucket and at
    synthetic_large S = 1024 (the 64 tile)."""
    A, b, p = _problem16(m, n, K, S, seed=S + 27, device=cuda_device, scalar_theta=True)
    p = p._replace(beta=p.beta.float())
    got = cuda_unroll.unroll_forward(b, A, *p)
    torch.cuda.synchronize()
    _assert_bf16_close(got, cuda_unroll.unroll_forward_plain_bf16(b, A, *p))
    assert cuda_unroll.unroll_forward.last_plan[2]["x"].tile == (64 if m == 1000 else 32)


@pytest.mark.gpu
@pytest.mark.parametrize("matmul_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("m,n,S", [(16, 32, 8), (33, 77, 13), (250, 500, 256)])
def test_bf16_layer_step_matches_plain(cuda_device, m, n, S, matmul_dtype):
    """The layer step on bf16 state (bf16 outputs, fp32 beta) against its
    plain version, a second call bit for bit; and the K-layer loop through
    the fused step equals the bf16 whole-unroll kernel bit for bit: both
    read each layer's stored bf16 state, on the same plan."""
    from dladmm_tpu_torch.models.unroll import dladmm_forward
    from dladmm_tpu_torch.ops import cuda_layer

    A, b, p = _problem16(m, n, 4, S, seed=S + 29, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(S)
    state = [torch.randn(s, generator=g, device=cuda_device).bfloat16() for s in ((S, n), (S, m), (S, m), (S, m))]
    one = (b, A, *state, p.W1[1], p.W2[1], p.theta1[1].contiguous(), p.theta2[1].contiguous(), p.beta[1:2].float())
    got = cuda_layer.layer_step(*one, matmul_dtype=matmul_dtype)
    again = cuda_layer.layer_step(*one, matmul_dtype=matmul_dtype)
    torch.cuda.synchronize()
    _assert_bf16_close(got, cuda_layer.layer_step_plain(*one, matmul_dtype=matmul_dtype))
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    if matmul_dtype is None:
        loop = dladmm_forward(p, A, b, step_fn=cuda_layer.fused_layer_step)
        whole = cuda_unroll.unroll_forward(b, A, *p)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(loop, whole))


@pytest.mark.gpu
def test_bf16_launch_refused_on_mixed_dtypes(cuda_device):
    """A mix of storage types is refused before anything is launched: bf16
    b with fp32 weights, fp16, a bf16 beta in the layer step; no launch is
    counted and the next call runs."""
    from dladmm_tpu_torch.ops import cuda_layer

    A, b, p = _problem(33, 77, 3, 13, seed=31, device=cuda_device)
    A16, b16, p16 = A.bfloat16(), b.bfloat16(), DLADMMParams(*(t.bfloat16() for t in p))
    u0, l0 = cuda_unroll.unroll_forward.launches, cuda_layer.layer_step.launches
    for bad in ((b16, A16, p), (b16, A, p16), (b.half(), A.half(), DLADMMParams(*(t.half() for t in p)))):
        with pytest.raises(TypeError, match="the kernel takes"):
            cuda_unroll.unroll_forward(bad[0], bad[1], *bad[2])
    state = [torch.zeros((13, k), dtype=torch.bfloat16, device=cuda_device) for k in (77, 33, 33, 33)]
    layer = (p16.W1[0], p16.W2[0], p16.theta1[0].contiguous(), p16.theta2[0].contiguous())
    with pytest.raises(TypeError, match="the kernel takes"):
        cuda_layer.layer_step(b16, A16, *state, *layer, p16.beta[:1])
    with pytest.raises(TypeError, match="the kernel takes"):
        cuda_layer.layer_step(b16, A16, *state, p.W1[0], *layer[1:], p.beta[:1])
    assert cuda_unroll.unroll_forward.launches == u0 and cuda_layer.layer_step.launches == l0
    torch.cuda.synchronize()
    _assert_bf16_close(cuda_unroll.unroll_forward(b16, A16, *p16), cuda_unroll.unroll_forward_plain_bf16(b16, A16, *p16))


@pytest.mark.gpu
def test_bf16_kernels_raise_when_the_grid_is_refused(cuda_device, monkeypatch):
    """The bf16 entries, like the fp32 ones: a grid one block larger than
    the card holds resident raises, counts no launch and leaves no error
    behind."""
    from dladmm_tpu_torch.ops import cuda_layer, schedule

    A, b, p = _problem16(250, 500, 3, 64, seed=33, device=cuda_device)
    state = [torch.zeros((64, k), dtype=torch.bfloat16, device=cuda_device) for k in (500, 250, 250, 250)]
    one = (b, A, *state, p.W1[0], p.W2[0], p.theta1[0].contiguous(), p.theta2[0].contiguous(), p.beta[:1].float())
    serve_plan = schedule.serve_plan

    def refused(*a):
        plan = serve_plan(*a)
        return plan._replace(grid=plan.occ[0] * plan.occ[1] + 1)

    monkeypatch.setattr(schedule, "serve_plan", refused)
    u0, l0 = cuda_unroll.unroll_forward.launches, cuda_layer.layer_step.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_unroll.unroll_forward(b, A, *p)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_layer.layer_step(*one)
    assert cuda_unroll.unroll_forward.launches == u0 and cuda_layer.layer_step.launches == l0
    torch.cuda.synchronize()
    monkeypatch.undo()
    _assert_bf16_close(cuda_unroll.unroll_forward(b, A, *p), cuda_unroll.unroll_forward_plain_bf16(b, A, *p))
    _assert_bf16_close(cuda_layer.layer_step(*one), cuda_layer.layer_step_plain(*one))


@pytest.mark.gpu
def test_two_bf16_servers_on_two_streams_at_once(cuda_device):
    """Two bf16 InferenceServer calls at once, from two threads on two
    streams, each a cooperative grid of every block the card holds
    resident (synthetic_small bucket 2048): both finish and equal one call
    each, bit for bit; the routes are the bf16 kernel's."""
    A, _, p = _problem(250, 500, 15, 1, seed=35, device=cuda_device)
    server = InferenceServer(p, A, buckets=(256, 2048), dtype=torch.bfloat16)
    assert set(server.routes.values()) == {"cuda-whole-unroll-bf16-kernel"}
    occ, grid, _, _ = cuda_unroll.unroll_forward.last_plan
    assert grid == occ[0] * occ[1]
    rng = np.random.default_rng(36)
    reqs = [torch.as_tensor(rng.normal(size=(2048, 250)).astype(np.float32), device=cuda_device)
            for _ in range(2)]
    want = [server.solve(r) for r in reqs]
    torch.cuda.synchronize()
    got, start = [None, None], threading.Barrier(2)

    def call(i):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.default_stream())
        with torch.cuda.stream(stream):
            start.wait()
            got[i] = server.solve(reqs[i])
            stream.synchronize()

    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        assert all(a.dtype == torch.bfloat16 and torch.equal(a, b) for a, b in zip(g, w))


# -- bf16 training: the bf16 trajectory, backward and step --------------------

TRAJ16_TOL_ULPS = 1.0  # chip_smoke.py's: the state stays fp32, a stored value meets one rounding
BWD16_TOL_ULPS = 2.0  # chip_smoke.py's: gradients rounded once, activations rounded where staged


def _within_ulps(got, want, ulps):
    """Each bf16 result within ``ulps`` bf16 ulps of its largest
    magnitude (a result whose plain version is all zero: equal)."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.isfinite(g.float()).all()
        top = float(w.float().abs().max())
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0
        err = float((g.float() - w.float()).abs().max())
        assert err <= ulps * ulp, (err, ulp)


@pytest.mark.gpu
@pytest.mark.parametrize("with_tax", [True, False])
@pytest.mark.parametrize("m,n,K,S", SHAPES)
def test_bf16_trajectory_kernel_matches_plain(cuda_device, m, n, K, S, with_tax):
    """The bf16 trajectory kernel (fp32 state, rounded stack stores)
    against trajectory_forward_plain_bf16: each stack within
    TRAJ16_TOL_ULPS bf16 ulps of its largest magnitude, bf16 stacks, a
    second call bit for bit; its launch counted in launches_bf16."""
    from dladmm_tpu_torch.ops import cuda_traj

    A, b, p = _problem16(m, n, K, S, seed=m + S + 1, device=cuda_device)
    n16, n32 = cuda_traj.trajectory_forward.launches_bf16, cuda_traj.trajectory_forward.launches
    got = cuda_traj.trajectory_forward(b, A, *p, with_tax=with_tax)
    again = cuda_traj.trajectory_forward(b, A, *p, with_tax=with_tax)
    want = cuda_traj.trajectory_forward_plain_bf16(b, A, *p, with_tax=with_tax)
    torch.cuda.synchronize()
    assert cuda_traj.trajectory_forward.launches_bf16 == n16 + 2 and cuda_traj.trajectory_forward.launches == n32
    assert len(got) == (4 if with_tax else 3)
    _within_ulps(got, want, TRAJ16_TOL_ULPS)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def _bwd16_case(m, n, K, S, seed, device, ties=False):
    """_bwd_case in bf16: the bf16 trajectory kernel's stacks, bf16
    cotangents; ties set on the bf16 params."""
    from dladmm_tpu_torch.ops import cuda_traj

    A, b, p = _problem16(m, n, K, S, seed, device)
    if ties:
        p.theta1[min(1, K - 1), ::2] = 0.0
        p.beta[K - 1] = 1e-6
    traj = cuda_traj.trajectory_forward(b, A, *p, with_tax=True)
    g = torch.Generator(device=device).manual_seed(seed)
    cts = [torch.randn((S, n), generator=g, device=device).bfloat16(),
           torch.randn((S, m), generator=g, device=device).bfloat16(),
           (0.1 * torch.randn((S, m), generator=g, device=device)).bfloat16()]
    return A, b, p, traj, cts


@pytest.mark.gpu
@pytest.mark.parametrize("data_grads", [True, False])
@pytest.mark.parametrize("m,n,K,S,bs,ties", [
    (16, 32, 4, 8, None, False), (33, 77, 5, 13, None, True), (33, 77, 5, 13, 4, True),
    (250, 500, 15, 64, None, True), (250, 500, 15, 1024, 128, False),
])
def test_bf16_bwd_kernel_matches_plain(cuda_device, m, n, K, S, bs, ties, data_grads):
    """The bf16 backward kernel against unroll_bwd_plain_bf16 on the bf16
    trajectory kernel's stacks: both routes, ragged tiles, ties; each
    gradient bf16 (gbeta in beta's dtype) within BWD16_TOL_ULPS bf16 ulps
    of its leaf's largest magnitude; a second call bit for bit; one launch
    a call counted under its route in launches_bf16."""
    from dladmm_tpu_torch.ops import cuda_bwd

    A, b, p, traj, cts = _bwd16_case(m, n, K, S, seed=m + S + 2, device=cuda_device, ties=ties)
    route = "chunked" if bs is not None and bs < S else "whole"
    before, before32 = dict(cuda_bwd.unroll_bwd.launches_bf16), dict(cuda_bwd.unroll_bwd.launches)
    got = cuda_bwd.unroll_bwd(b, A, *p, *traj, *cts, bs=bs, data_grads=data_grads)
    again = cuda_bwd.unroll_bwd(b, A, *p, *traj, *cts, bs=bs, data_grads=data_grads)
    want = cuda_bwd.unroll_bwd_plain_bf16(b, A, *p, *traj, *cts, bs=bs, data_grads=data_grads)
    torch.cuda.synchronize()
    assert cuda_bwd.unroll_bwd.launches_bf16[route] == before[route] + 2
    assert cuda_bwd.unroll_bwd.launches == before32
    assert all(g.dtype == torch.bfloat16 for g in got[0])
    pairs = [(g, w) for g, w in zip((*got[0], *got[1:]), (*want[0], *want[1:])) if w is not None]
    assert all(g is not None for g, _ in pairs) and (got[1] is None) == (not data_grads)
    _within_ulps([g for g, _ in pairs], [w for _, w in pairs], BWD16_TOL_ULPS)
    assert all(torch.equal(g, a) for g, a in zip(got[0], again[0]))


@pytest.mark.gpu
def test_bf16_training_kernels_take_an_fp32_beta(cuda_device):
    """bf16 storage with an fp32 beta (the storage rule allows it): the
    trajectory and backward kernels against their plain versions, gbeta
    in fp32."""
    from dladmm_tpu_torch.ops import cuda_bwd, cuda_traj

    A, b, p, traj, cts = _bwd16_case(33, 77, 5, 13, seed=9, device=cuda_device, ties=True)
    p = p._replace(beta=p.beta.float())
    got = cuda_traj.trajectory_forward(b, A, *p, with_tax=True)
    _within_ulps(got, cuda_traj.trajectory_forward_plain_bf16(b, A, *p, with_tax=True), TRAJ16_TOL_ULPS)
    for bs in (None, 4):
        g = cuda_bwd.unroll_bwd(b, A, *p, *got, *cts, bs=bs, data_grads=True)
        w = cuda_bwd.unroll_bwd_plain_bf16(b, A, *p, *got, *cts, bs=bs, data_grads=True)
        torch.cuda.synchronize()
        assert g[0].beta.dtype == w[0].beta.dtype == torch.float32
        _within_ulps([*g[0], *g[1:]], [*w[0], *w[1:]], BWD16_TOL_ULPS)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "float32", "bfloat16", "bfloat16_sr", "bfloat16_sr_mu"])
def test_bf16_adam_step_writes_the_copy(cuda_device, fmt):
    """adam_step on bf16 gradients with the compute copy, 3 chained
    steps on synthetic_small's five leaves (chip_smoke.py phase 28): the
    state equal to the one-leaf sweeps' run on the widened gradients with
    the step's scalars, held against the plain version's step, the copy
    equal to the new master rounded, the clip scale within 2^-7 of
    step_scalars' and equal to the prologue's bf16-norm rule computed
    apart, which the fp32 norm's scale fails (step_checks.clip_scale_diff);
    counted in launches_bf16."""
    from dladmm_tpu_torch.train import qadam_cuda as tqa
    from dladmm_tpu_torch.train import step_checks as sc

    shapes = sc.preset_shapes(250, 500, 15)
    params, mu, nu, grads32 = sc.step_state(shapes, fmt, seed=71, device=cuda_device)
    grads = [DLADMMParams(*(t.bfloat16() for t in g)) for g in grads32]
    copy = DLADMMParams(*(torch.empty_like(t, dtype=torch.bfloat16) for t in params))
    sched = tqa.WarmupCosine(0.0, 1e-2, 2, 40)
    count = torch.tensor(1, dtype=torch.int32, device=cuda_device)
    for step, g in enumerate(grads):
        pre = sc.clone_state(params, mu, nu)
        old, n16 = count, tqa.adam_step.launches_bf16
        count, scal, seeds = tqa.adam_step(g, params, mu, nu, count, fmt, sched, 1.0, copy=copy)
        assert tqa.adam_step.launches_bf16 == n16 + 2
        pscal, pcount = tqa.step_scalars(g, old, sched, 1.0)
        one = sc.clone_state(*pre)
        sc.one_leaf_step(fmt, [t.float() for t in g], *one, scal, seeds)
        torch.cuda.synchronize()
        assert torch.equal(count, pcount) and sc.scal_ulps(scal[:3], pscal[:3]) <= 2
        assert abs(float(scal[3]) - float(pscal[3])) <= 2.0 ** -7 * float(pscal[3])
        rule = sc.clip_scale_diff(g, 1.0, float(scal[3]), f"step {step}")
        assert rule["clipped"] == (step != 1)
        sc.check_against_one_leaf(fmt, (params, mu, nu), one, f"step {step}")
        sc.plain_step_diff(fmt, g, pre, (params, mu, nu), scal, seeds, f"step {step}")
        assert all(torch.equal(c, t.bfloat16()) for c, t in zip(copy, params))


@pytest.mark.gpu
def test_bf16_training_kernels_raise_when_the_grid_is_refused(cuda_device, monkeypatch):
    """The bf16 trajectory and backward entries, like the fp32 ones: a
    grid one block larger than the card holds resident raises, counts no
    launch and leaves no error behind; a bf16 step with fp32 masters of
    another shape, or a mix of fp32 and bf16 gradients, is refused before
    anything is enqueued."""
    from dladmm_tpu_torch.ops import cuda_bwd, cuda_traj, schedule
    from dladmm_tpu_torch.train import qadam_cuda as tqa

    A, b, p, traj, cts = _bwd16_case(250, 500, 3, 64, seed=3, device=cuda_device)
    traj_plan, bwd_plan = schedule.traj_plan, schedule.bwd_plan
    monkeypatch.setattr(schedule, "traj_plan",
                        lambda *a, **kw: (a[3] * a[4] + 1, *traj_plan(*a, **kw)[1:]))
    monkeypatch.setattr(schedule, "bwd_plan",
                        lambda *a, **kw: (a[6] * a[7] + 1, *bwd_plan(*a, **kw)[1:]))
    t0, b0 = cuda_traj.trajectory_forward.launches_bf16, dict(cuda_bwd.unroll_bwd.launches_bf16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_traj.trajectory_forward(b, A, *p, with_tax=True)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_bwd.unroll_bwd(b, A, *p, *traj, *cts)
    assert cuda_traj.trajectory_forward.launches_bf16 == t0 and cuda_bwd.unroll_bwd.launches_bf16 == b0
    torch.cuda.synchronize()
    monkeypatch.undo()
    _within_ulps(cuda_traj.trajectory_forward(b, A, *p), cuda_traj.trajectory_forward_plain_bf16(b, A, *p),
                 TRAJ16_TOL_ULPS)
    params = DLADMMParams(*(t.float().contiguous() for t in p))
    opt = tqa.QAdamFused(1e-3, moment_fmt="float32")
    state = opt.init(params)
    g16 = DLADMMParams(*(torch.zeros_like(t, dtype=torch.bfloat16) for t in params))
    mixed = g16._replace(beta=torch.zeros_like(params.beta))
    s0 = tqa.adam_step.launches_bf16
    with pytest.raises(ValueError, match="leaf 4 g"):
        opt.fused_apply(mixed, state, params, torch.bfloat16)
    bad = DLADMMParams(*(torch.empty_like(t, dtype=torch.bfloat16) for t in params))._replace(
        W2=torch.empty((3, 250, 249), dtype=torch.bfloat16, device=cuda_device))
    with pytest.raises(ValueError, match="leaf 1 copy"):
        opt.fused_apply(g16, state, params, torch.bfloat16, bad)
    assert tqa.adam_step.launches_bf16 == s0
    _, _, copy = opt.fused_apply(g16, state, params, torch.bfloat16)
    torch.cuda.synchronize()
    assert all(torch.equal(c, t.bfloat16()) for c, t in zip(copy, params))


def _patch_case(K, S, seed, device):
    """The image benchmark's shape: the 64 x 256 DCT dictionary, b the
    median-DC residuals of 8 x 8 patches of impulse-corrupted synthetic
    images (S = 225: one 64 x 64 image; 961: one 128 x 128; 3844: four),
    and LADMM-exact params plus 0.05 N(0,1) * RMS of each leaf."""
    from dladmm_tpu_torch.data.dictionary import dct_dictionary
    from dladmm_tpu_torch.data.images import extract_patches, patch_dc, salt_pepper, synthetic_image

    size, count = {225: (64, 1), 961: (128, 1), 3844: (128, 4)}[S]
    g = torch.Generator(device=device).manual_seed(seed)
    A = dct_dictionary(device=device)
    patches = torch.cat([extract_patches(salt_pepper(g, synthetic_image(size, device=device), 0.1))
                         for _ in range(count)])
    b = (patches - patch_dc(patches)).contiguous()
    rng = np.random.default_rng(seed)
    p0 = init_dladmm_params(A.cpu(), K=K)
    leaves = [leaf + 0.05 * torch.as_tensor(rng.normal(size=tuple(leaf.shape)).astype(np.float32))
              * leaf.pow(2).mean().sqrt() for leaf in p0]
    return A, b, DLADMMParams(*leaves).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [8, 15])
@pytest.mark.parametrize("S", [225, 961, 3844])
def test_patch_shape_kernels_match_plain(cuda_device, K, S):
    """Rows 1, 2, 4 and 5 at the image benchmark's shape (m = 64, n = 256,
    S tails that are no multiple of the 32 tile): the whole-unroll and
    trajectory kernels within TOL of their plain versions, the backward on
    the route bwd_chunk_batch picks, on the whole batch and on slices of
    128 rows within 2e-5 of each leaf's largest gradient; each repeats bit
    for bit."""
    from dladmm_tpu_torch.ops import cuda_bwd, cuda_traj

    A, b, p = _patch_case(K, S, seed=S + K, device=cuda_device)
    got = cuda_unroll.unroll_forward(b, A, *p)
    _assert_close(got, cuda_unroll.unroll_forward_plain(b, A, *p))
    assert all(torch.equal(g, w) for g, w in zip(got, cuda_unroll.unroll_forward(b, A, *p)))
    traj = cuda_traj.trajectory_forward(b, A, *p, with_tax=True)
    _assert_close(traj, cuda_traj.trajectory_forward_plain(b, A, *p, with_tax=True))
    assert all(torch.equal(g, w) for g, w in zip(traj, cuda_traj.trajectory_forward(b, A, *p, with_tax=True)))
    gen = torch.Generator(device=cuda_device).manual_seed(S)
    cts = [torch.randn(t[-1].shape, generator=gen, device=cuda_device) for t in traj[:3]]
    want = cuda_bwd.unroll_bwd_plain(b, A, *p, *traj, *cts, data_grads=True)
    policy = cuda_bwd.bwd_chunk_batch(64, 256, 64, S, K, cuda_bwd.weight_wave(cuda_device))
    for bs in {policy, None, 128}:
        route = "chunked" if bs is not None and bs < S else "whole"
        before = dict(cuda_bwd.unroll_bwd.launches)
        one = cuda_bwd.unroll_bwd(b, A, *p, *traj, *cts, bs=bs, data_grads=True)
        two = cuda_bwd.unroll_bwd(b, A, *p, *traj, *cts, bs=bs, data_grads=True)
        torch.cuda.synchronize()
        assert cuda_bwd.unroll_bwd.launches[route] == before[route] + 2
        _assert_grads_close(one[0], want[0])
        _assert_grads_close(one[1:], want[1:])
        for g, w in zip([*one[0], one[1], one[2]], [*two[0], two[1], two[2]]):
            assert torch.equal(g, w)


@pytest.mark.gpu
def test_solver_on_the_card(cuda_device):
    """DLADMMSolver with A on the card: solve through the whole-unroll
    kernel, trajectories and nmse_curve through the trajectory kernel, fit
    through the trajectory and backward kernels, a nonneg_l1 solve through
    the kernel's prox variant; answers within TOL of the kernels' plain
    versions on the card."""
    from dladmm_tpu_torch.models import DLADMMSolver
    from dladmm_tpu_torch.ops import cuda_bwd, cuda_traj

    A, b, _ = _problem(250, 500, 15, 64, seed=11, device=cuda_device)
    gpu = DLADMMSolver.create(A, K=15)
    u0, t0 = cuda_unroll.unroll_forward.launches, cuda_traj.trajectory_forward.launches
    solved, traj = gpu.solve(b), gpu.trajectory(b)
    assert cuda_unroll.unroll_forward.launches == u0 + 1 and cuda_traj.trajectory_forward.launches == t0 + 1
    _assert_close(solved, cuda_unroll.unroll_forward_plain(b, A, *gpu.params)[:2])
    _assert_close(traj, cuda_traj.trajectory_forward_plain(b, A, *gpu.params))
    x_star = torch.zeros((64, 500), device=cuda_device)
    x_star[:, ::7] = 1.0
    assert gpu.nmse_curve(b, x_star).shape == (15,)
    w0 = cuda_bwd.unroll_bwd.launches["whole"]
    trained = gpu.fit(0, steps=3, batch=64)
    assert cuda_bwd.unroll_bwd.launches["whole"] == w0 + 3
    assert trained.params.W1.device.type == "cuda" and torch.isfinite(trained.residual(b))
    nonneg = DLADMMSolver.create(A, K=15, prox_x="nonneg_l1")
    u1 = cuda_unroll.unroll_forward.launches
    x, z = nonneg.solve(b)
    assert cuda_unroll.unroll_forward.launches == u1 + 1 and float(x.min()) >= 0.0
    _assert_close((x, z), cuda_unroll.unroll_forward_plain(b, A, *nonneg.params, prox_x="nonneg_l1")[:2])


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "bfloat16", "bfloat16_sr"])
def test_xla_side_step_on_the_card_equals_cpu(cuda_device, fmt):
    """The XLA-side reduced-precision Adam (train/qmoments.adam_qmoments)
    on the card, 3 steps of the same gradients as on the CPU: the stored
    moments, the count and the SR key equal; the updates within 1e-6 of
    each leaf's largest (pow of the bias corrections may round apart)."""
    from dladmm_tpu_torch.train import qmoments as tqm

    rng = np.random.default_rng(4)
    shapes = [(15, 256, 64), (15, 64, 64), (15, 256), (15, 64), (15,)]
    params = DLADMMParams(*(torch.as_tensor(rng.normal(size=s).astype(np.float32)) for s in shapes))
    grads = [DLADMMParams(*(torch.as_tensor((0.1 * rng.normal(size=s)).astype(np.float32)) for s in shapes))
             for _ in range(3)]
    opt = tqm.adam_qmoments(1e-2, moment_dtype=fmt)
    cs, gs = opt.init(params), opt.init(params.to(cuda_device))
    for g in grads:
        cu, cs = opt.update(g, cs, params)
        gu, gs = opt.update(g.to(cuda_device), gs, params.to(cuda_device))
        for a, w in zip(gu, cu):
            torch.testing.assert_close(a.cpu(), w, rtol=1e-6, atol=1e-6 * float(w.abs().max()))
        qc, qg = cs[0], gs[0]
        assert int(qc.count) == int(qg.count)
        assert (qc.key is None and qg.key is None) or torch.equal(qc.key, qg.key.cpu())
        for mc, mg in zip((*qc.mu, *qc.nu), (*qg.mu, *qg.nu)):
            if fmt == "int8":
                assert torch.equal(mc.codes, mg.codes.cpu()) and torch.equal(mc.scale, mg.scale.cpu())
            else:
                assert torch.equal(mc, mg.cpu())


# -- greedy depths, the fused step, data-parallel pieces ------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 2, 3])
@pytest.mark.parametrize("m,n,S,bs", [(32, 64, 16, None), (250, 500, 64, None), (250, 500, 1024, 128)])
def test_greedy_depths_match_plain(cuda_device, K, m, n, S, bs):
    """Rows 2 and 4 at the prefix depths greedy's first stages run
    (K = 1, 2, 3; the plans were sized at K >= 4): the trajectory kernel
    at TOL, the backward kernel on its stacks (both routes) at
    tests/test_pallas_bwd.py's tolerance, one launch each."""
    from dladmm_tpu_torch.ops import cuda_bwd, cuda_traj

    A, b, p = _problem(m, n, K, S, seed=K + S, device=cuda_device)
    before = cuda_traj.trajectory_forward.launches
    got = cuda_traj.trajectory_forward(b, A, *p, with_tax=True)
    want = cuda_traj.trajectory_forward_plain(b, A, *p, with_tax=True)
    torch.cuda.synchronize()
    assert cuda_traj.trajectory_forward.launches == before + 1
    _assert_close(got, want)
    A, b, p, traj, cts = _bwd_case(m, n, K, S, seed=K + S, device=cuda_device, ties=K > 1)
    route = "chunked" if bs is not None and bs < S else "whole"
    before = dict(cuda_bwd.unroll_bwd.launches)
    g = cuda_bwd.unroll_bwd(b, A, *p, *traj, *cts, bs=bs, data_grads=False)
    w = cuda_bwd.unroll_bwd_plain(b, A, *p, *traj, *cts, data_grads=False)
    torch.cuda.synchronize()
    assert cuda_bwd.unroll_bwd.launches[route] == before[route] + 1
    _assert_grads_close(g[0], w[0])


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype,lw,clip", [(None, False, 1e-3), (None, True, 1.0),
                                                   (torch.bfloat16, True, 1.0)])
def test_fused_adam_step_on_the_card_equals_cpu(cuda_device, compute_dtype, lw, clip):
    """train/fused_adam's step (plain PyTorch: the forward loop, the
    reverse sweep with Adam in it) on CUDA tensors against the same step
    on CPU tensors, 3 steps on the same batches: the losses within rtol
    1e-5 (bf16 2e-2), the count equal and the compute copy the masters
    rounded. The params: every element within Adam's reach of a sign flip
    (2 * lr a step, tests/test_distributed.py's bf16 bound), and in fp32
    all but 0.1% of each leaf within rtol 5e-5 and atol 1e-2 * lr. Where a
    gradient cancels (a sum of terms much larger than itself) the card's
    and the CPU's summation orders move it, and Adam's second and third
    updates divide it by its own RMS (one W1 element of 8192 sits
    2.3e-5 apart; tests/test_torch_fused_adam.py). In bf16, each
    element's update (new master - old) after 1 and after 3 steps: the
    signs agree on at least 99% of each nonzero update, and after 3 steps
    each leaf's update differs by at most 10% of its norm (the bounds of
    the bf16 comparison with the JAX package,
    tests/test_torch_fused_adam.py)."""
    from dladmm_tpu_torch.data.synthetic import SyntheticBatch
    from dladmm_tpu_torch.train import fused_adam

    m, n, K, S, lr = 32, 64, 4, 16, 1e-3
    A, b, p = _problem(m, n, K, S, seed=5, device="cpu")
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        x = torch.as_tensor(((rng.random((S, n)) < 0.1) * rng.normal(size=(S, n))).astype(np.float32))
        e = torch.as_tensor(((rng.random((S, m)) < 0.1) * rng.normal(size=(S, m))).astype(np.float32))
        batches.append(SyntheticBatch(x @ A.T + e, x, e))
    weights = torch.full((K,), 1.0 / K) if lw else None
    out = {}
    for dev in ("cpu", cuda_device):
        step = fused_adam.make_fused_adam_step(A.to(dev), lr=lr, clip_norm=clip, from_batch=True,
                                               compute_dtype=compute_dtype,
                                               layer_weights=None if weights is None else weights.to(dev))
        st = fused_adam.make_fused_adam_state(p.to(dev), clip, compute_dtype)
        losses, first = [], None
        for bt in batches:
            st, loss = step(st, SyntheticBatch(*(v.to(dev) for v in bt)))
            losses.append(float(loss))
            first = first or [v.cpu().clone() for v in st.params]
        out[str(torch.device(dev).type)] = (st, losses, first)
    (cs, cl, c1), (gs, gl, g1) = out["cpu"], out["cuda"]
    bf16 = compute_dtype is not None
    np.testing.assert_allclose(gl, cl, rtol=2e-2 if bf16 else 1e-5)
    assert int(gs.opt_state.count) == int(cs.opt_state.count) == 3
    for a, w in zip(gs.params, cs.params):
        d = (a.cpu() - w).abs()
        assert float(d.max()) <= 2 * lr * 3
        if not bf16:
            assert float((d > 1e-2 * lr + 5e-5 * w.abs()).float().mean()) <= 1e-3
    if bf16:
        for cp, mp in zip(gs.compute_params, gs.params):
            assert torch.equal(cp, mp.to(torch.bfloat16))
        for steps, card, cpu in ((1, g1, c1), (3, [v.cpu() for v in gs.params], list(cs.params))):
            for name, a, w, v in zip(p._fields, card, cpu, p):
                da, dw = (a - v).flatten(), (w - v).flatten()
                moved = dw != 0
                agree = float((torch.sign(da[moved]) == torch.sign(dw[moved])).float().mean())
                assert agree >= 0.99, (steps, name, agree)
                if steps == 3:
                    assert float((da - dw).norm()) <= 0.1 * float(dw.norm()), (name, float((da - dw).norm() / dw.norm()))


@pytest.mark.gpu
def test_detect_hbm_bytes_on_the_card(cuda_device):
    from dladmm_tpu_torch.parallel import memory

    got = memory.detect_hbm_bytes()
    assert got == float(torch.cuda.get_device_properties(0).total_memory) and got > 1e10


@pytest.mark.gpu
def test_time_chained_on_the_whole_unroll_kernel(cuda_device):
    """bench/timing.time_chained on row 1 at synthetic_small S = 256: a
    positive calibrated slope (strict: no UNCALIBRATED fallback) within a
    factor of two of the CUDA-event median of one solve, the kernel
    launched on every step of the chains."""
    from dladmm_tpu_torch.bench.timing import median_ms, time_chained

    A, b, p = _problem(250, 500, 15, 256, 3, cuda_device)
    cuda_unroll.unroll_forward.launches = 0
    with torch.no_grad():
        slope = time_chained(lambda c: b + 1e-12 * cuda_unroll.unroll_forward(c, A, *p)[2], b, iters=32,
                             strict=True)
        launches = cuda_unroll.unroll_forward.launches
        (ms,) = median_ms([lambda: cuda_unroll.unroll_forward(b, A, *p)], 11)
    assert slope > 0 and 0.5 * ms <= slope * 1e3 <= 2 * ms
    assert launches >= 3 * (32 + 8) + 2  # best of 3 chains of 8 and of 32 steps, a warm-up step each


@pytest.mark.gpu
def test_nan_debug_in_the_kernel_wrappers(cuda_device):
    """enable_nan_debug: a NaN row of b through the whole-unroll and
    trajectory kernels raises from each wrapper's own check (no dispatch
    mode sees a ctypes launch), and the same calls are silent once it is
    off."""
    from dladmm_tpu_torch.ops.cuda_traj import trajectory_forward
    from dladmm_tpu_torch.utils import profiling

    A, b, p = _problem(64, 128, 4, 16, 5, cuda_device)
    b[3] = float("nan")
    calls = {"unroll_forward": lambda: cuda_unroll.unroll_forward(b, A, *p),
             "trajectory_forward": lambda: trajectory_forward(b, A, *p)}
    profiling.enable_nan_debug(True)
    try:
        for name, call in calls.items():
            with pytest.raises(FloatingPointError, match=f"the kernel of {name}"):
                with torch.no_grad():
                    call()
    finally:
        profiling.enable_nan_debug(False)
    with torch.no_grad():
        _, _, lam = calls["unroll_forward"]()
    assert torch.isnan(lam[3]).any() and torch.isfinite(lam[:3]).all()
