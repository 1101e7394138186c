"""The frozen yardstick: its bounds at known shapes and against the
program's own (where they were copied from), the generator's draws bit
for bit, and the arithmetic of the metrics on a hand-made trace."""

import math

import pytest
import torch

from benchmark.metrics import idle_pct, serve_mfu, solve_calls, solve_roofline
from benchmark.spec import ROOT, load_module, metric_file
from benchmark.traffic.common import percentile, stratified_exponential, stratified_lognormal
from benchmark.yardstick import roofline as ys
from benchmark.yardstick import synthetic
from benchmark.yardstick import trace as tr


def test_bounds_at_the_quoted_shapes():
    # PERF.md's kernel table: row 1 at synthetic_small S = 256, row 2 at
    # synthetic_large S = 1024.
    assert ys.bound(256, 250, 500, 15) == (pytest.approx(0.0358, abs=5e-5), "operations")
    assert ys.traj_bound(1024, 1000, 2000, 20, True) == (pytest.approx(3.057, abs=5e-4), "operations")
    assert ys.bwd_bound(1024, 1000, 2000, 20)[0] == pytest.approx(4.891, abs=5e-4)


@pytest.mark.parametrize("shape", [(64, 250, 500, 15), (1024, 250, 500, 15), (1024, 1000, 2000, 20)])
def test_bounds_equal_the_programs_at_the_copy(shape):
    from dladmm_tpu_torch.bench import roofline as prog

    S, m, n, K = shape
    assert ys.bound(*shape) == prog.bound(*shape)
    assert ys.traj_bound(*shape, True) == prog.traj_bound(*shape, True)
    assert ys.bwd_bound(*shape) == prog.bwd_bound(*shape)
    assert ys.int8_serve_bound(*shape) == prog.int8_serve_bound(*shape)
    leaves = [(K, n, m), (K, m, m), (K, n), (K, m), (K,)]
    for fmt in ("int8", "float32"):
        assert ys.step_bounds(leaves, fmt) == prog.step_bounds(leaves, fmt)
    assert ys.dense_bound(K * n * m, "bfloat16") == prog.dense_bound(K * n * m, "bfloat16")
    assert ys.int8_bound([(K * n, m)]) == prog.int8_bound([(K * n, m)])


def test_model_flops():
    assert ys.solve_flops(1, 250, 500, 15) == 2 * 250 * 1250 * 15
    assert ys.train_step_flops(64, 250, 500, 15) == ys.solve_flops(64, 250, 500, 15) + 2 * 64 * 15 * (
        2 * 250 * 250 + 3 * 500 * 250)


def test_the_generator_copy_draws_the_programs_rows():
    from dladmm_tpu_torch.data import synthetic as prog

    for seed, i in ((0, 0), (2**31 + 77, 3)):
        a = synthetic.draw_batch(synthetic.step_generator(seed, i), 12, 24, 5)
        b = prog.draw_batch(prog.step_generator(seed, i), 12, 24, 5)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_percentile_is_nearest_rank_and_counts_failures():
    v = list(range(1, 101))
    assert percentile(v, 95) == 95 and percentile(v, 50) == 50 and percentile(v, 100) == 100
    assert percentile([1.0] * 94 + [math.inf] * 6, 95) == math.inf
    assert percentile([3.0], 95) == 3.0


def test_stratified_draws_are_the_same_multiset_for_every_seed():
    sizes = stratified_lognormal(1000, 4, 1.0, 1, 64)
    assert sizes.min() >= 1 and sizes.max() <= 64 and sorted(sizes)[500] == 4
    gaps = stratified_exponential(10000, 1 / 7200)
    assert gaps.mean() == pytest.approx(1 / 7200, rel=2e-3)


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _trace():
    """A window [0, 1000] us: two solves on thread 2 (rows 37 of bucket
    64 at 100-300, rows 60 of 64 at 500-700), each launching one row-1
    kernel of 100 us; the marker and a kernel launched outside any span."""
    ev = [_ev("user_annotation", "bench.window", 0, 1000),
          _ev("user_annotation", "bench.solve:37/64", 100, 200, tid=2),
          _ev("user_annotation", "bench.solve:60/64", 500, 200, tid=2),
          _ev("cuda_runtime", "cudaLaunchKernel", 150, 5, tid=2, corr=1),
          _ev("cuda_runtime", "cudaLaunchKernel", 550, 5, tid=2, corr=2),
          _ev("cuda_runtime", "cudaLaunchKernel", 800, 5, tid=1, corr=3),
          _ev("kernel", "void unroll_persistent<32, false, float>(ServeArgs<float>)", 160, 100, tid=7, corr=1),
          _ev("kernel", "void unroll_persistent<32, false, float>(ServeArgs<float>)", 560, 100, tid=7, corr=2),
          _ev("kernel", "void other_kernel()", 810, 50, tid=7, corr=3),
          _ev("kernel", "at::cuda::spin_kernel(long)", 0, 10, tid=7),
          _ev("cpu_op", "aten::cat", 250, 320, tid=2)]
    return {"events": ev, "lo": 0.0, "hi": 1000.0, "cfg": {"m": 250, "n": 500, "K": 15}, "batch": 64}


def test_serve_readers_on_a_hand_made_trace():
    ctx = _trace()
    calls = solve_calls(ctx)
    assert sorted((r, b, len(k)) for r, b, k in calls) == [(37, 64, 1), (60, 64, 1)]
    from benchmark.metrics import bucket_fill, dispatch_rows

    assert dispatch_rows(ctx) == 48.5 and bucket_fill(ctx) == pytest.approx(100 * 97 / 128)
    assert solve_roofline(ctx) == pytest.approx(100 * 2 * ys.bound(64, 250, 500, 15)[0] * 1e3 / 200)
    assert serve_mfu(ctx) == pytest.approx(100 * 97 * ys.solve_flops(1, 250, 500, 15) / (1e-3 * ys.PEAK_FP32_FLOPS))
    assert idle_pct(ctx) == pytest.approx(100 * (1 - 250 / 1000))  # the marker is no busy time
    assert tr.count_port_kernels(ctx["events"])["unroll_forward"] == 2
    gaps = tr.idle_gaps(ctx["events"], 0, 1000)
    assert gaps[0] == (0, 160) and sum(e - s for s, e in gaps) == 750
    labels = dict(tr.label_gaps(ctx["events"], gaps, skip=("bench.window",)))
    # 260-560 lies inside aten::cat; the rest inside no host operation.
    assert labels == pytest.approx({"aten::cat": 300e-6, "no host operation": 450e-6})


def test_train_readers_on_a_hand_made_trace():
    ctx = _trace()
    ev = ctx["events"]
    ev += [_ev("user_annotation", "bench.step", 100, 300), _ev("user_annotation", "bench.step", 450, 300),
           _ev("kernel", "void (anonymous namespace)::traj_persistent<float>(TrajArgs<float>)", 300, 200, tid=7),
           _ev("kernel", "void (anonymous namespace)::bwd_chain<float>(ChainArgs<float>)", 600, 100, tid=7),
           _ev("kernel", "void (anonymous namespace)::bwd_weights<float>(WeightArgs<float>)", 700, 50, tid=7),
           _ev("kernel", "void (anonymous namespace)::finish<float>(float const*)", 750, 10, tid=7)]
    read = {n: load_module(metric_file(ROOT, n), n).read for n in
            ("kernels_per_step", "train_mfu", "traj_roofline", "bwd_roofline")}
    assert read["kernels_per_step"](ctx) == 7 / 2  # the marker left out
    c = ctx["cfg"]
    assert read["train_mfu"](ctx) == pytest.approx(100 * 2 * ys.train_step_flops(64, 250, 500, 15) / (1e-3 * ys.PEAK_FP32_FLOPS))
    assert read["traj_roofline"](ctx) == pytest.approx(100 * ys.traj_bound(64, c["m"], c["n"], c["K"], True)[0] * 1e3 / 200)
    assert read["bwd_roofline"](ctx) == pytest.approx(100 * ys.bwd_bound(64, c["m"], c["n"], c["K"])[0] * 1e3 / 160)


def test_readers_return_nothing_without_device_time():
    ctx = _trace()
    ctx["events"] = [e for e in ctx["events"] if e["cat"] != "kernel"]
    for name in ("solve_roofline.batch", "serve_mfu.batch", "idle_pct.batch", "train_mfu", "traj_roofline",
                 "bwd_roofline", "kernels_per_step"):
        assert load_module(metric_file(ROOT, name), name).read(ctx) is None
