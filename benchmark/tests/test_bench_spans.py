"""The idle device time put down to the program's spans
(yardstick/spans.py) and its four readers, on hand-written traces; the
accepted readers read the same with the program's spans in the trace."""

import pytest

from benchmark import spec
from benchmark.metrics import idle_pct
from benchmark.spec import ROOT, load_module, metric_file
from benchmark.tests.test_bench_yardstick import _ev
from benchmark.yardstick import spans

NEW = ("data_idle_pct.train", "optimizer_ms.train", "prep_idle_pct.batch", "enqueue_idle_pct.batch")


def _read(name, ctx):
    return load_module(metric_file(ROOT, name), name).read(ctx)


def _idle(ctx) -> dict:
    return spans.idle_by_span(ctx, spans.window_lane(ctx))


def _serve():
    """A window [0, 1000] us on thread 1: one request, serve.solve
    100-500 holding serve.prep 120-200 and serve.forward 250-300; the
    copy in 150-180 and the forward 310-480 on the device; a serve.prep
    on thread 2 over 500-1000. Idle: [0, 150], [180, 310], [480, 1000]."""
    ev = [_ev("user_annotation", "bench.window", 0, 1000),
          _ev("user_annotation", "bench.solve:1024/1024", 90, 420),
          _ev("user_annotation", "serve.solve", 100, 400),
          _ev("user_annotation", "serve.prep", 120, 80),
          _ev("user_annotation", "serve.forward", 250, 50),
          _ev("user_annotation", "serve.prep", 500, 500, tid=2),
          _ev("cuda_runtime", "cudaMemcpyAsync", 140, 5, corr=1),
          _ev("cuda_runtime", "cudaLaunchKernel", 260, 5, corr=2),
          _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 150, 30, tid=7, corr=1),
          _ev("kernel", "void unroll_persistent<32, false, float>(ServeArgs<float>)", 310, 170, tid=7, corr=2),
          _ev("kernel", "at::cuda::spin_kernel(long)", 0, 10, tid=7),
          _ev("cpu_op", "aten::copy_", 130, 60)]
    return {"events": ev, "lo": 0.0, "hi": 1000.0, "cfg": {"m": 250, "n": 500, "K": 15}}


def _train():
    """A window [0, 1000] us on thread 1: train.step 0-900 holding
    train.data 10-400 and train.optimizer 800-880 (its prologue 850-860
    and sweep 860-900 on the device), a second train.optimizer 990-1010
    that the window's end cuts; the trajectory 400-800. Idle: [0, 400],
    [800, 850], [900, 1000]."""
    ev = [_ev("user_annotation", "bench.window", 0, 1000),
          _ev("user_annotation", "bench.step", 0, 900),
          _ev("user_annotation", "train.step", 0, 900),
          _ev("user_annotation", "train.data", 10, 390),
          _ev("user_annotation", "train.optimizer", 800, 80),
          _ev("user_annotation", "train.optimizer", 990, 20),
          _ev("cuda_runtime", "cudaLaunchKernel", 300, 5, corr=4),
          _ev("cuda_runtime", "cudaLaunchKernel", 810, 5, corr=5),
          _ev("cuda_runtime", "cudaLaunchKernel", 820, 5, corr=6),
          _ev("cuda_runtime", "cudaLaunchKernel", 995, 5, corr=7),
          _ev("kernel", "void (anonymous namespace)::traj_persistent<float>(TrajArgs<float>)", 400, 400, tid=7, corr=4),
          _ev("kernel", "adam_prologue", 850, 10, tid=7, corr=5),
          _ev("kernel", "qadam_int8_sweep", 860, 40, tid=7, corr=6),
          _ev("kernel", "qadam_int8_sweep", 1000, 5, tid=7, corr=7)]
    return {"events": ev, "lo": 0.0, "hi": 1000.0, "cfg": {"m": 250, "n": 500, "K": 15}, "batch": 64}


def test_the_window_lane_is_the_thread_of_the_range_that_spans_the_window():
    assert spans.window_lane(_serve()) == (1, 1)
    moved = _serve()
    moved["events"] = [{**e, "tid": 5} if e["name"] == "bench.window" else e for e in moved["events"]]
    assert spans.window_lane(moved) == (1, 5)
    assert _read("prep_idle_pct.batch", moved) is None
    bare = _serve()
    bare["events"] = [e for e in bare["events"] if e["name"] != "bench.window"]
    assert spans.window_lane(bare) is None and _read("prep_idle_pct.batch", bare) is None


def test_a_gap_counts_only_where_it_overlaps_a_span_and_goes_to_the_innermost():
    # serve.prep 120-200 meets the gaps only at 120-150 and 180-200; the
    # solve's own time is what its children leave: 100-120, 200-250,
    # 300-310, 480-500.
    got = _idle(_serve())
    assert got == pytest.approx({"outside": 600, "serve.solve": 100, "serve.prep": 50, "serve.forward": 50})
    assert _read("prep_idle_pct.batch", _serve()) == pytest.approx(5.0)
    assert _read("enqueue_idle_pct.batch", _serve()) == pytest.approx(5.0)


def test_spans_on_another_thread_are_ignored():
    ctx = _serve()
    ctx["events"] = [e for e in ctx["events"] if e["tid"] != 2]
    assert _idle(ctx) == _idle(_serve())
    ctx["events"] = [{**e, "tid": 3} if e["name"].startswith("serve.") else e for e in ctx["events"]]
    assert _idle(ctx) == pytest.approx({"outside": 800})
    assert _read("prep_idle_pct.batch", ctx) is None


@pytest.mark.parametrize("make", [_serve, _train])
def test_the_spans_and_outside_add_up_to_the_idle_time(make):
    ctx = make()
    total = sum(_idle(ctx).values())
    assert 100 * total / (ctx["hi"] - ctx["lo"]) == pytest.approx(idle_pct(ctx))


def test_train_readers():
    # Idle: train.step 0-10, train.data 10-400, train.optimizer 800-850 and
    # 990-1000, outside 900-990. The optimizer span cut by the window's
    # end is left out of the mean; its kernel lies after the window.
    ctx = _train()
    assert _idle(ctx) == pytest.approx(
        {"train.step": 10, "train.data": 390, "train.optimizer": 60, "outside": 90})
    assert _read("data_idle_pct.train", ctx) == pytest.approx(39.0)
    assert _read("optimizer_ms.train", ctx) == pytest.approx(0.05)


def test_a_child_that_outlasts_its_parent_is_cut_at_the_parents_end():
    segs = spans.innermost([_ev("user_annotation", "serve.solve", 0, 100),
                            _ev("user_annotation", "serve.forward", 60, 50),
                            _ev("user_annotation", "serve.solve", 150, 10)])
    assert segs == [(0, 60, "serve.solve"), (60, 100, "serve.forward"), (150, 160, "serve.solve")]


@pytest.mark.parametrize("make", [_serve, _train])
@pytest.mark.parametrize("name", NEW)
def test_readers_return_nothing_without_spans_or_device_time(make, name):
    bare = make()
    bare["events"] = [e for e in bare["events"] if not e["name"].startswith(("serve.", "train."))]
    assert _read(name, bare) is None
    idle = make()
    idle["events"] = [e for e in idle["events"] if e["cat"] not in ("kernel", "gpu_memcpy")]
    assert _read(name, idle) is None


@pytest.mark.parametrize("make", [_serve, _train])
def test_the_accepted_readers_read_the_same_with_the_programs_spans(make):
    """Every per-layer metric accepted before the spans reads only the
    benchmark's spans and the device's events."""
    bare = make()
    bare["events"] = [e for e in bare["events"] if not e["name"].startswith(("serve.", "train."))]
    for m in spec.load()["per_layer"]:
        if m["name"] in NEW:
            continue
        assert _read(m["name"], make()) == _read(m["name"], bare), m["name"]


def test_the_benchmark_validates_with_the_span_metrics():
    s = spec.load()
    spec.validate(s)
    new = {m["name"]: m for m in s["per_layer"] if m["name"] in NEW}
    assert [m["name"] for m in s["per_layer"][-4:]] == list(NEW)
    assert all(m["source"] == "program_span" for m in new.values())
    assert new["data_idle_pct.train"]["workloads"] == new["optimizer_ms.train"]["workloads"] == ["large-train-final"]
    assert new["prep_idle_pct.batch"]["workloads"] == ["large-serve-batch", "small-serve-batch"]
