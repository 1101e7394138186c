"""The plain reference against a hand-computed unroll, and against the
program's own plain functions at a tiny size on the CPU (the reference
shares no code with them)."""

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.reference import compare
from benchmark.reference.optim import Int8Adam, warmup_cosine
from benchmark.reference.solver import loss, loss_and_grads, solve_rows, unroll

CFG = {"m": 6, "n": 10, "K": 3, "beta": 1.0, "sparsity_x": 0.3, "sparsity_e": 0.3,
       "init": {"w1_noise": 0.1, "w2_noise": 0.05, "theta_log_sd": 0.2, "beta_log_sd": 0.1}}


def _problem(seed=4, dtype=torch.float64):
    A = inputs.dictionary(CFG, seed, "cpu")
    params = inputs.parameters(CFG, A, seed)
    b = inputs.observations(CFG, A, seed, 5)
    return A.to(dtype), [p.to(dtype) for p in params], b.to(dtype)


def _by_hand(A, params, b):
    """The recurrence, element by element in numpy float64."""
    A, b = A.numpy(), b.numpy()
    W1, W2, t1, t2, beta = (p.numpy() for p in params)
    S, m = b.shape
    n = A.shape[1]
    x, z, lam = np.zeros((S, n)), np.zeros((S, m)), np.zeros((S, m))

    def shrink(u, t):
        return np.sign(u) * np.maximum(np.abs(u) - np.maximum(t, 0), 0)

    for k in range(W1.shape[0]):
        bk = max(beta[k], 1e-6)
        for s in range(S):
            u = A @ x[s] + z[s] - b[s] + lam[s] / bk
            x[s] = shrink(x[s] - W1[k] @ u, t1[k])
            v = A @ x[s] + z[s] - b[s] + lam[s] / bk
            z[s] = shrink(z[s] - W2[k] @ v, t2[k])
            lam[s] = lam[s] + bk * (A @ x[s] + z[s] - b[s])
    return x, z, lam


def test_unroll_matches_the_recurrence_by_hand():
    A, params, b = _problem()
    x, z, lam = unroll(params, A, b)
    hx, hz, hl = _by_hand(A, params, b)
    np.testing.assert_allclose(x.numpy(), hx, atol=1e-12)
    np.testing.assert_allclose(z.numpy(), hz, atol=1e-12)
    np.testing.assert_allclose(lam.numpy(), hl, atol=1e-12)
    bx, bz = solve_rows(params, A, b, block=2)
    torch.testing.assert_close(bx, x, rtol=0, atol=1e-12)
    torch.testing.assert_close(bz, z, rtol=0, atol=1e-12)


def test_unroll_and_losses_match_the_programs_plain_loop():
    from dladmm_tpu_torch.models.unroll import DLADMMParams, dladmm_forward
    from dladmm_tpu_torch.train.loop import _layer_weights, loss_fn

    A, params, b = _problem(dtype=torch.float32)
    x, z, _ = unroll(params, A, b)
    px, pz, _ = dladmm_forward(DLADMMParams(*params), A, b)
    torch.testing.assert_close(x, px, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(z, pz, rtol=1e-5, atol=1e-6)
    xs, es = torch.randn(5, 10), torch.randn(5, 6)
    for layer_loss in (None, "uniform"):
        ours = loss(params, A, b, xs, es, layer_loss)
        theirs = loss_fn(DLADMMParams(*params), A, b, xs, es, layer_weights=_layer_weights(layer_loss, 3))
        assert float(ours) == pytest.approx(float(theirs), rel=1e-5)


def test_int8_adam_follows_the_programs_optimizer():
    from dladmm_tpu_torch.models.unroll import DLADMMParams
    from dladmm_tpu_torch.train.loop import apply_updates
    from dladmm_tpu_torch.train.qadam_cuda import QAdamFused, WarmupCosine

    torch.manual_seed(0)
    shapes = [(3, 200, 400), (3, 400, 400), (3, 200), (3, 400), (3,)]  # one per-row leaf pair, three flat
    params = [torch.randn(s) * 0.1 for s in shapes]
    ours = [p.clone() for p in params]
    opt = Int8Adam(ours, 1e-3, 100, 1.0)
    prog = QAdamFused(WarmupCosine(0.0, 1e-3, 5, 100), moment_fmt="int8", clip_norm=1.0)
    state = prog.init(DLADMMParams(*params))
    theirs = DLADMMParams(*params)
    for _ in range(4):
        grads = [torch.randn(s) for s in shapes]
        opt.step(ours, grads)
        upd, state = prog.update(DLADMMParams(*grads), state)
        theirs = apply_updates(theirs, upd)
    # The two compute the clip scale and bias corrections in other
    # precisions (fp64 here, fp32 there), so a value at an int8 rounding
    # edge can take the next code on one side: a few elements in ten
    # thousand, each by a part of one step (lr 1e-3).
    for a, b in zip(ours, theirs):
        off = torch.abs(a - b)
        assert float(torch.mean((off > 1e-7).double())) < 1e-3
        assert float(off.max()) < 2e-5


def test_warmup_cosine_is_the_programs_rate():
    from dladmm_tpu_torch.train.qadam_cuda import WarmupCosine

    sched = WarmupCosine(0.0, 2e-4, 500, 10000)
    for count in (0, 1, 2, 499, 500, 777, 9999, 10000, 12000):
        assert warmup_cosine(count, 2e-4, 10000) == float(sched(torch.tensor(count, dtype=torch.int32)))


def test_gaps_and_numbers():
    assert compare.max_gap(torch.tensor([1.0, 2.0]), torch.tensor([1.0, 4.0])) == 0.5
    assert compare.leaf_gaps([1.0, 2.0, 3.0], [1.0, 2.0, 4.0]) == [0.0, 0.0, 0.25]
    assert compare.leaf_gaps([5.0, 2.0], [1.0, 2.0], keep=[False, True]) == [0.0]
    nums = compare.numbers({"a": 1e-7, "b": float("nan")}, {"a": 1e-6, "b": 1.0, "c": 0})
    assert [n["value"] for n in nums] == [1e-7, float("inf"), float("inf")]
    assert not compare.passed(nums) and compare.passed(nums[:1])


def test_a_fault_in_the_loss_shows():
    A, params, b = _problem(dtype=torch.float32)
    xs, es = torch.randn(5, 10), torch.randn(5, 6)
    full, g_full = loss_and_grads(params, A, b, xs, es, "uniform")
    half, g_half = loss_and_grads(params, A, b[:2], xs[:2], es[:2], "uniform")
    assert compare.rel_gap(float(half), float(full)) > 1e-3
