"""The cell tp_large-train-final: its entries validate, its traffic kind
(traffic/train_steps_lean.py) rehearses on the CPU and reads ``correct``,
the faults planted under its timed path fail, its Adam reference agrees
with the program's fp32 Adam, and its five readers read hand-made
traces; on the card, the controls fail at the cell's size."""

import contextlib
import io
import json

import pytest
import torch

from benchmark import run as bench
from benchmark import spec as specs
from benchmark.reference import compare
from benchmark.reference.adam import Adam
from benchmark.tests.test_bench_yardstick import _ev
from benchmark.yardstick import roofline as ys

ROOT = specs.ROOT
CELL, CONFIG, TRAFFIC = "tp_large-train-final", "tp_large", "train_final_b256_fp32"
NEW = ("traj_roofline.tp_large", "bwd_roofline.tp_large", "optimizer_roofline.tp_large",
       "kernels_per_step.tp_large", "idle_pct.tp_large")
ACCEPTED = ("train_mfu", "data_idle_pct.train", "optimizer_ms.train")  # the cell appended to their workloads


def _cfg():
    return specs.config(specs.load(), CONFIG)


def _read(name, ctx):
    return specs.load_module(specs.metric_file(ROOT, name), name).read(ctx)


def test_the_cell_its_configuration_and_metrics_validate():
    spec = specs.load()
    specs.validate(spec)
    cell = specs.cell(spec, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, TRAFFIC, 1)
    assert [m["name"] for m in specs.per_layer(spec, CELL)] == list(ACCEPTED + NEW)
    assert [m["name"] for m in specs.end_to_end(spec, CELL)] == ["train_samples_per_s", "setup_s"]
    cfg = _cfg()
    entry = next(c for c in spec["configs"] if c["name"] == CONFIG)
    assert entry["reduced"] == cfg["reduced"] == ["model_axis"]
    assert (cfg["m"], cfg["n"], cfg["K"], cfg["train"]["batch"]) == (8192, 16384, 20, 256)
    assert cfg["train"]["moment_dtype"] == "float32" and cfg["train"]["lr_schedule"] is None
    assert specs.mix(TRAFFIC)["kind"] == "train_steps_lean"


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_rehearses_on_the_cpu(trace):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(["--workload", CELL, "--seed", str(2**31 + 11), "--seconds", "0.6", "--trace", str(trace),
                         "--rehearse"])
    line = json.loads([ln for ln in buf.getvalue().splitlines() if ln.startswith("{")][-1])
    assert rc == 0 and line["rehearsal"] and line["correct"] and "metrics" not in line
    assert line["attempted"] > 0 and line["failed"] == 0


def _rehearsed(fault=None, seed=2**31 + 23):
    work = bench.workload(_cfg(), specs.mix(TRAFFIC), seed, 0.4, torch.device("cpu"), rehearse=True)
    work.fault = fault
    work.setup()
    run = work.measure()
    work.release()
    return work, run


def test_a_sound_run_is_correct_and_keeps_no_copy_of_the_state():
    work, run = _rehearsed()
    assert run["failed"] == 0 and compare.passed(work.check())
    assert not hasattr(work, "params") and not hasattr(work, "first_moments")


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "flipped"])
def test_a_fault_under_the_timed_path_makes_correct_false(fault):
    work, _ = _rehearsed(fault)
    assert not compare.passed(work.check())


def test_the_half_batch_control_fails():
    work, _ = _rehearsed()
    assert not compare.passed(work.check(control="half_batch"))


def test_the_adam_reference_matches_the_programs_fp32_adam():
    """Three steps from count 50 on seeded weights and gradients, the
    reference handed one layer's slice of each leaf at a time: the
    parameters within three fp32 ulps of their size plus 1e-3 of lr
    (each step rounds them, fp64 bias corrections and fused
    multiply-adds round the updates otherwise), while each leaf moved by
    more than lr / 2."""
    from dladmm_tpu_torch.models.unroll import DLADMMParams
    from dladmm_tpu_torch.train import loop

    g = torch.Generator().manual_seed(5)
    K, n, m, lr = 3, 32, 16, 2e-4
    params = DLADMMParams(*(torch.randn(s, generator=g) for s in ((K, n, m), (K, m, m), (K, n), (K, m), (K,))))
    grads = [DLADMMParams(*(torch.randn(p.shape, generator=g) * 10.0 ** -i for p in params)) for i in range(3)]
    optimizer = loop.adam(lr)
    state = loop.make_train_state(params, optimizer)
    state = state._replace(opt_state=loop.zip_nodes(
        state.opt_state, state.opt_state, lambda a, _: a,
        lambda v, _: torch.full_like(v, 50) if v.dim() == 0 and not v.is_floating_point() else v))
    ref = [p.clone() for p in params]
    views = [v[k] for k in range(K) for v in ref]
    opt = Adam(views, lr, 50)
    for gr in grads:
        state = loop._apply(optimizer, state, gr)
        opt.step(views, [v[k] for k in range(K) for v in gr])
    for p, r, p0 in zip(state.params, ref, params):
        torch.testing.assert_close(p, r, rtol=3 * 2.0 ** -23, atol=1e-3 * lr)
        assert float((p - p0).abs().max()) > 0.5 * lr


def _step_trace():
    """A window [0, 1000] us: two bench.step spans, each holding a
    train.data span and a train.optimizer span; a trajectory launch
    (300), a reverse sweep (160) and in each optimizer span two
    elementwise kernels (20 and 30 us)."""
    ev = [_ev("user_annotation", "bench.window", 0, 1000),
          _ev("user_annotation", "bench.step", 0, 480), _ev("user_annotation", "bench.step", 490, 500),
          _ev("user_annotation", "train.data", 0, 40), _ev("user_annotation", "train.data", 490, 10),
          _ev("user_annotation", "train.optimizer", 400, 70), _ev("user_annotation", "train.optimizer", 900, 80),
          *(_ev("cuda_runtime", "cudaLaunchKernel", ts, 2, corr=c) for ts, c in ((401, 1), (410, 2), (901, 3), (910, 4))),
          _ev("kernel", "void (anonymous namespace)::traj_persistent<float>(TrajArgs<float>)", 50, 300, tid=7),
          _ev("kernel", "void (anonymous namespace)::bwd_chain<float>(ChainArgs<float>)", 500, 100, tid=7),
          _ev("kernel", "void (anonymous namespace)::bwd_weights<float>(WeightArgs<float>)", 600, 50, tid=7),
          _ev("kernel", "void (anonymous namespace)::finish<float>(float const*)", 650, 10, tid=7),
          _ev("kernel", "void at::native::vectorized_elementwise_kernel<4>(int, MulFunctor)", 420, 20, tid=7, corr=1),
          _ev("kernel", "void at::native::vectorized_elementwise_kernel<4>(int, AddFunctor)", 440, 30, tid=7, corr=2),
          _ev("kernel", "void at::native::vectorized_elementwise_kernel<4>(int, MulFunctor)", 920, 20, tid=7, corr=3),
          _ev("kernel", "void at::native::vectorized_elementwise_kernel<4>(int, AddFunctor)", 940, 30, tid=7, corr=4),
          _ev("kernel", "at::cuda::spin_kernel(long)", 0, 10, tid=7)]
    cfg = _cfg()
    return {"events": ev, "lo": 0.0, "hi": 1000.0, "cfg": cfg, "mix": specs.mix(TRAFFIC), "batch": 256}


def test_the_new_readers_on_a_hand_made_trace():
    ctx = _step_trace()
    c = ctx["cfg"]
    elems = c["K"] * (c["n"] * c["m"] + c["m"] ** 2 + c["n"] + c["m"] + 1)
    assert elems == 4_027_023_380
    traj_ms = ys.traj_bound(256, 8192, 16384, 20, True)[0]
    assert _read("traj_roofline.tp_large", ctx) == pytest.approx(100 * traj_ms * 1e3 / 300)
    assert _read("bwd_roofline.tp_large", ctx) == pytest.approx(100 * ys.bwd_bound(256, 8192, 16384, 20)[0] * 1e3 / 160)
    assert _read("optimizer_roofline.tp_large", ctx) == pytest.approx(100 * ys.dense_bound(elems, "float32")[0] / 0.05)
    assert _read("kernels_per_step.tp_large", ctx) == 8 / 2  # the marker left out
    busy = 300 + 160 + 2 * 50
    assert _read("idle_pct.tp_large", ctx) == pytest.approx(100 * (1 - busy / 1000))
    bare = {**ctx, "events": [e for e in ctx["events"] if e["cat"] != "kernel"]}
    assert all(_read(name, bare) is None for name in NEW)


def test_the_accepted_training_readers_read_the_cell():
    """train_mfu, data_idle_pct.train and optimizer_ms.train, the cell
    appended to their workloads, read its hand-made trace as they read
    large-train-final's: the step's model operations at batch 256, the
    idle time under train.data (0-40 and 490-500: nothing runs there
    but the marker, which is left out), the optimizer's kernels a span."""
    ctx = _step_trace()
    c = ctx["cfg"]
    flops = ys.train_step_flops(256, c["m"], c["n"], c["K"])
    assert _read("train_mfu", ctx) == pytest.approx(100 * 2 * flops / (1e-3 * ys.PEAK_FP32_FLOPS))
    assert _read("data_idle_pct.train", ctx) == pytest.approx(100 * (40 + 10) / 1000)
    assert _read("optimizer_ms.train", ctx) == pytest.approx(0.05)


@pytest.mark.gpu
def test_the_controls_fail_on_the_card_at_the_cell_s_size():
    """On three seeds: the reference in TF32 put in the program's place
    and the reference on half the batch fail the check; on one seed the
    faults "unchanged" and "flipped" planted in the program fail it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 and the cell's size exist only there")
    from benchmark import harness

    harness.host_threads()
    dev = torch.device("cuda", 0)
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        work = bench.workload(_cfg(), specs.mix(TRAFFIC), seed, 1.0, dev)
        work.setup()
        work.release()
        for control in ("tf32", "half_batch"):
            assert not compare.passed(work.check(control=control)), (seed, control)
        del work
        torch.cuda.empty_cache()
    for fault in ("unchanged", "flipped"):
        work = bench.workload(_cfg(), specs.mix(TRAFFIC), 2**31 + 404, 1.0, dev)
        work.fault = fault
        work.setup()
        work.release()
        assert not compare.passed(work.check()), fault
        del work
        torch.cuda.empty_cache()
