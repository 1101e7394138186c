"""utils/profiling and bench/profile_step on the CPU: the trace writes a
Chrome trace; the program's spans are a shared no-op without a profiler
session and land in its trace with one, nested as a served request and a
training step open them, under the names the benchmark's readers use;
enable_nan_debug raises FloatingPointError
at the first NaN an aten operation or a kernel wrapper makes and is off
again with nothing left pushed; summarize's per-step figures on a
hand-written trace, capture in its smoke mode; and the two examples as
subprocesses (``slow``, as tests/test_examples.py runs the JAX ones).
The card's side is chip_smoke.py phases 47 and 49 and the ``gpu`` cases
of tests/test_torch_cuda.py."""

import ast
import collections
import json
import os
import subprocess
import sys
import threading

import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from dladmm_tpu_torch.bench import profile_step
from dladmm_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def nan_debug():
    """enable_nan_debug(True) for the test, off again after it whatever
    happens."""
    profiling.enable_nan_debug(True)
    try:
        yield
    finally:
        profiling.enable_nan_debug(False)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as d:
        torch.randn(32, 32) @ torch.randn(32, 32)
    assert os.listdir(d) == [profiling.TRACE_FILE]
    with open(os.path.join(d, profiling.TRACE_FILE)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names


# The program's spans (utils/profiling.span) and the benchmark's readers
# of them (benchmark/metrics/).
SPANS = {"serve.solve", "serve.prep", "serve.forward", "train.step", "train.data", "train.optimizer"}
SPAN_READERS = ("data_idle_pct.train", "optimizer_ms.train", "prep_idle_pct.batch", "enqueue_idle_pct.batch",
                "patches_ms.denoise")


def _spans(trace_dir) -> list:
    with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as f:
        return sorted((e for e in json.load(f)["traceEvents"]
                       if e.get("ph") == "X" and e.get("name") in SPANS), key=lambda e: (e["ts"], -e["dur"]))


def _inside(inner, outer) -> bool:
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_span_without_a_session_is_the_shared_no_op(tmp_path):
    """No session: every span is one shared no-op and records nothing,
    not even in a session opened while it is still open."""
    first = profiling.span("serve.solve")
    assert first is profiling.span("train.step") and not isinstance(first, torch.profiler.record_function)
    with first:
        with profiling.trace(str(tmp_path / "tr")) as d:
            torch.ones(4).sum()
    assert _spans(d) == []


def _harness_session():
    """A session as the benchmark's harness opens one: every thread."""
    from torch.profiler import ProfilerActivity, profile

    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return profile(activities=[ProfilerActivity.CPU], experimental_config=config)


@pytest.mark.parametrize("session", ["trace", "all_threads"])
def test_spans_are_on_in_every_thread_inside_a_session(tmp_path, session):
    """Inside profiling.trace, and inside a session over every thread as
    the harness opens it, a span is a record_function range in the main
    thread and in a worker thread; after the session it is the no-op
    again. The every-thread session records the worker's span on the
    worker's thread."""
    seen = {}

    def worker():
        seen["worker"] = profiling.span("train.data")
        with seen["worker"]:
            torch.ones(4).sum()

    ctx = profiling.trace(str(tmp_path / "tr")) if session == "trace" else _harness_session()
    with ctx as handle:
        main = profiling.span("train.step")
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    assert isinstance(main, torch.profiler.record_function)
    assert isinstance(seen["worker"], torch.profiler.record_function)
    assert not isinstance(profiling.span("train.step"), torch.profiler.record_function)
    if session == "all_threads":
        events = [e for e in handle.events() if e.name == "train.data"]
        assert len(events) == 1 and events[0].thread != threading.main_thread().native_id


def test_a_served_request_writes_its_spans(tmp_path):
    """InferenceServer.solve on the CPU: one serve.solve holding
    serve.prep and then serve.forward, on one thread; the bucket's warm-up
    at construction is no request."""
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.serve import InferenceServer

    g = torch.Generator().manual_seed(0)
    A = torch.randn(8, 16, generator=g)
    with profiling.trace(str(tmp_path / "tr")) as d:
        server = InferenceServer(init_dladmm_params(A, K=3), A, max_batch=8, device="cpu")
        x, _ = server.solve(torch.randn(5, 8, generator=g).numpy())
    assert x.shape == (5, 16)
    spans = _spans(d)
    assert [e["name"] for e in spans] == ["serve.solve", "serve.prep", "serve.forward"]
    solve, prep, fwd = spans
    assert _inside(prep, solve) and _inside(fwd, solve) and prep["ts"] + prep["dur"] <= fwd["ts"]
    assert len({e["tid"] for e in spans}) == 1


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_a_training_step_writes_its_spans(tmp_path, accum_steps):
    """make_train_step on the CPU: one train.step holding a train.data a
    microbatch and then one train.optimizer, on one thread."""
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.train import loop

    A = torch.randn(8, 16, generator=torch.Generator().manual_seed(1))
    opt = loop.adam(1e-3)
    step = loop.make_train_step(opt, A, batch=4, accum_steps=accum_steps)
    state = loop.make_train_state(init_dladmm_params(A, K=3), opt)
    with profiling.trace(str(tmp_path / "tr")) as d:
        state, loss = step(state, 0)
    assert state.step == 1 and torch.isfinite(loss)
    spans = _spans(d)
    assert [e["name"] for e in spans] == ["train.step"] + ["train.data"] * accum_steps + ["train.optimizer"]
    assert all(_inside(e, spans[0]) for e in spans[1:])
    assert spans[accum_steps]["ts"] + spans[accum_steps]["dur"] <= spans[-1]["ts"]
    assert len({e["tid"] for e in spans}) == 1


def _ops_by_span(trace_dir) -> dict:
    """{program span name: Counter of the host operations whose innermost
    program span it is}, on the spans' threads."""
    with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") in SPANS]
    out = collections.defaultdict(collections.Counter)
    for op in events:
        if op.get("cat") != "cpu_op":
            continue
        holders = [sp for sp in spans if sp["tid"] == op["tid"] and _inside(op, sp)]
        if holders:
            out[min(holders, key=lambda sp: sp["dur"])["name"]][op["name"]] += 1
    return out


def test_a_served_requests_spans_hold_its_copy_pad_and_forward(tmp_path):
    """The boundaries the serving metrics read: the request's cast and
    copy (``aten::_to_copy``) and its pad (``aten::cat``) lie in
    serve.prep, the forward's products in serve.forward, and neither
    span holds the other's work."""
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.serve import InferenceServer

    g = torch.Generator().manual_seed(0)
    A = torch.randn(8, 16, generator=g)
    server = InferenceServer(init_dladmm_params(A, K=3), A, max_batch=8, device="cpu")
    b = torch.randn(5, 8, generator=g, dtype=torch.float64).numpy()  # cast, and padded to the bucket of 8
    with profiling.trace(str(tmp_path / "tr")) as d:
        server.solve(b)
    ops = _ops_by_span(d)
    assert ops["serve.prep"]["aten::_to_copy"] >= 1 and ops["serve.prep"]["aten::cat"] == 1
    assert ops["serve.forward"]["aten::mm"] >= 1 and ops["serve.prep"]["aten::mm"] == 0
    assert ops["serve.forward"]["aten::cat"] == 0
    assert not {"aten::_to_copy", "aten::cat", "aten::mm"} & set(ops["serve.solve"])


def test_a_training_steps_spans_hold_its_draw_and_update(tmp_path):
    """The boundaries the training metrics read: the batch's draw
    (``rand``, ``randn``, ``where``) and its product b = x*·Aᵀ lie in
    train.data, Adam's ``sqrt`` in train.optimizer; the loss's forward and
    backward in neither."""
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.train import loop

    A = torch.randn(8, 16, generator=torch.Generator().manual_seed(1))
    opt = loop.adam(1e-3)
    step = loop.make_train_step(opt, A, batch=4)
    state = loop.make_train_state(init_dladmm_params(A, K=3), opt)
    with profiling.trace(str(tmp_path / "tr")) as d:
        step(state, 0)
    ops = _ops_by_span(d)
    for name in ("aten::rand", "aten::randn", "aten::where"):
        assert ops["train.data"][name] >= 1 and sum(c[name] for c in ops.values()) == ops["train.data"][name], name
    assert ops["train.data"]["aten::mm"] == 1
    assert ops["train.optimizer"]["aten::sqrt"] >= 1
    assert sum(c["aten::sqrt"] for c in ops.values()) == ops["train.optimizer"]["aten::sqrt"]
    assert ops["train.optimizer"]["aten::mm"] == 0 and ops["train.step"]["aten::mm"] >= 1


class _Avg:
    """A stand-in for one of torch.profiler's averaged events."""

    def __init__(self, key, device, us, annotation=False):
        self.key, self.device_time_total, self.count, self.is_user_annotation = key, us, 2, annotation
        self.device_type = type("DeviceType", (), {"name": device})


def test_device_kernels_leave_out_the_ranges_mirrored_on_the_device():
    """The profiler mirrors each record_function range onto the device's
    timeline as a user annotation: device_kernels counts the kernels and
    copies, not those ranges, nor host ops, runtime calls and the
    marker."""
    events = [_Avg("void unroll_persistent<32, false, float>(ServeArgs<float>)", "CUDA", 100.0),
              _Avg("Memcpy HtoD (Pageable -> Device)", "CUDA", 10.0),
              _Avg("serve.forward", "CUDA", 120.0, annotation=True),
              _Avg("train.optimizer", "CUDA", 40.0, annotation=True),
              _Avg("aten::copy_", "CPU", 30.0),
              _Avg("cudaLaunchKernel", "CUDA", 5.0),
              _Avg(f"void at::cuda::{profiling.MARKER}(long)", "CUDA", 50.0)]
    prof = type("Prof", (), {"key_averages": lambda self: events})()
    got = profiling.device_kernels(prof, steps=2)
    assert got == {"unroll_persistent<32, false, float>": {"us": 50.0, "calls": 1.0},
                   "Memcpy HtoD": {"us": 5.0, "calls": 1.0}}
    assert profiling.is_annotation(events[2]) and not profiling.is_annotation(events[0])
    assert not profiling.is_annotation(object())


@pytest.mark.gpu
def test_profile_fn_counts_no_program_span_as_a_kernel():
    """On the card: profile_fn over a served request and over a training
    step (both open the program's spans) reports device operations only,
    no serve.* or train.* range."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the profiler's device records exist only there")
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.serve import InferenceServer
    from dladmm_tpu_torch.train import loop

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    A = torch.randn(250, 500, generator=g)
    server = InferenceServer(init_dladmm_params(A, K=15), A, max_batch=64, device=dev)
    b = torch.randn(64, 250, generator=g).numpy()
    served = profiling.profile_fn(lambda: server.solve(b), "serve.solve", reps=3)
    opt = loop.adam(1e-3)
    step = loop.make_train_step(opt, A.to(dev), batch=64)
    state = [loop.make_train_state(init_dladmm_params(A.to(dev), K=15), opt), 0]

    def train():  # profile_fn runs it under no_grad; the step takes a gradient
        with torch.enable_grad():
            state[0], _ = step(state[0], state[1])
        state[1] += 1

    trained = profiling.profile_fn(train, "train.step", reps=3)
    for prof in (served, trained):
        names = set(prof["per_call"])
        assert names and not any(n.startswith(("serve.", "train.")) for n in names), names
        assert prof["device_busy_share"] <= 1.0, prof["device_busy_share"]


def _string_constants(path) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.value for n in ast.walk(tree) if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def _program_span_names() -> set:
    """The names of every ``profiling.span("...")`` call in the port."""
    names = set()
    for root, _, files in os.walk(os.path.join(REPO, "dladmm_tpu_torch")):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name)) as f:
                tree = ast.parse(f.read())
            for n in ast.walk(tree):
                if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) and n.func.attr == "span"
                        and isinstance(n.func.value, ast.Name) and n.func.value.id == "profiling"):
                    names.add(n.args[0].value)
    return names


def test_the_benchmark_reads_the_programs_span_names():
    """The port opens exactly the six spans, and each reader of a span in
    benchmark/metrics/ names one of them (and the harness's own spans are
    never the program's)."""
    assert _program_span_names() == SPANS
    read = set()
    for metric in SPAN_READERS:
        names = {v for v in _string_constants(os.path.join(REPO, "benchmark", "metrics", f"{metric}.py"))
                 if v.startswith(("serve.", "train.", "bench."))}
        assert len(names) == 1 and names <= SPANS, (metric, names)
        read |= names
    assert read == {"train.data", "train.optimizer", "serve.prep", "serve.forward"}


def test_nan_debug_raises_on_an_aten_nan(nan_debug):
    x = torch.ones(4)
    with pytest.raises(FloatingPointError, match="aten.log"):
        torch.log(-x)
    torch.empty(1000)  # uninitialised memory is no operation's NaN
    assert torch.isfinite(torch.log(x)).all()


def test_nan_debug_raises_on_the_plain_unroll_fed_a_nan():
    """The kernel's plain version (CPU tensors) fed a NaN row of b: the
    first aten operation that makes a NaN raises; the kernel wrapper's own
    check (check_kernel_outputs) raises on a NaN output while the mode is
    on, and neither does anything once it is off."""
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.ops.cuda_unroll import unroll_forward

    g = torch.Generator().manual_seed(0)
    A = torch.randn(8, 16, generator=g)
    p = init_dladmm_params(A, K=3)
    b = torch.randn(5, 8, generator=g)
    b[2] = float("nan")
    out_with_nan = torch.tensor([1.0, float("nan")])
    profiling.enable_nan_debug(True)
    try:
        with pytest.raises(FloatingPointError, match="NaN in output"):
            unroll_forward(b, A, *p)
        with pytest.raises(FloatingPointError, match="the kernel of unroll_forward"):
            profiling.check_kernel_outputs("unroll_forward", b[:2, :2].abs(), out_with_nan)
        profiling.enable_nan_debug(True)  # twice on is once on
    finally:
        profiling.enable_nan_debug(False)
    assert not profiling.nan_debug_enabled() and _get_current_dispatch_mode() is None
    assert not torch.is_anomaly_enabled()
    x, _, _ = unroll_forward(b, A, *p)
    assert torch.isnan(x[2]).all() and torch.isfinite(x[[0, 1, 3, 4]]).all()
    profiling.check_kernel_outputs("unroll_forward", x)
    profiling.enable_nan_debug(False)  # off when off is a no-op


def test_nan_debug_checks_the_backward(nan_debug):
    """A NaN made in the backward raises too (anomaly mode and the
    dispatch mode see the backward's operations)."""
    w = torch.tensor([1.0, 2.0], requires_grad=True)
    loss = torch.sqrt(w * 0).sum()  # finite forward; d sqrt at 0 is inf, and inf * 0 in mul's backward NaN
    with pytest.raises((FloatingPointError, RuntimeError), match="NaN|nan"):
        loss.backward()


def _event(name, ts, dur, cat="kernel", pid=0, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid}


def test_retry_incomplete_runs_a_session_again(capsys):
    """A session that raises IncompleteProfile is run again, each retry
    reported, and its result comes back with the sessions it took; after
    the last attempt the IncompleteProfile propagates; any other failure
    propagates at once."""
    calls = []

    def session():
        calls.append(1)
        if len(calls) < 3:
            raise profiling.IncompleteProfile(f"missed a launch in session {len(calls)}")
        return "whole"

    assert profiling.retry_incomplete(session, "three sessions") == ("whole", 3)
    retries = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [(r["phase"], r["attempt"]) for r in retries] == [("profile_retry", 1), ("profile_retry", 2)]
    def never():
        calls.append(1)
        raise profiling.IncompleteProfile(f"missed a launch in session {len(calls)}")

    calls.clear()
    with pytest.raises(profiling.IncompleteProfile, match=f"session {profiling.PROFILE_ATTEMPTS}"):
        profiling.retry_incomplete(never, "never whole")
    assert len(calls) == profiling.PROFILE_ATTEMPTS

    def wrong():
        calls.append(1)
        raise AssertionError("ran another kernel")

    calls.clear()
    with pytest.raises(AssertionError, match="another kernel"):
        profiling.retry_incomplete(wrong, "wrong")
    assert len(calls) == 1


def test_profiling_imports_no_bench_module():
    """utils/profiling is the lower layer: bench/profile_step imports its
    marker and trace file, and it imports nothing of bench/."""
    import ast

    with open(profiling.__file__) as f:
        tree = ast.parse(f.read())
    names = [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    names += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    assert names and not [n for n in names if n.startswith("dladmm_tpu_torch.bench")]
    assert profile_step.MARKER == profiling.MARKER and profile_step.TRACE_FILE == profiling.TRACE_FILE


def test_summarize_a_hand_written_trace(tmp_path):
    """Two steps of two kernels and a memset: exact per-step figures, the
    marker left out of the times, the window and the counts; host events
    ignored on the device lane; the port's kernels beside their wrappers'
    counts."""
    events = [
        _event("void at::native::spin_kernel(long)", 0.0, 500.0),
        _event("void (anonymous namespace)::traj_persistent<float>(TrajArgs<float>)", 1000.0, 300.0),
        _event("bwd_chain<float>(ChainArgs<float>)", 1400.0, 100.0),
        _event("Memset (Device)", 1550.0, 10.0, cat="gpu_memset"),
        _event("void (anonymous namespace)::traj_persistent<float>(TrajArgs<float>)", 2000.0, 320.0),
        _event("bwd_chain<float>(ChainArgs<float>)", 2400.0, 110.0),
        _event("Memset (Device)", 2600.0, 10.0, cat="gpu_memset"),
        _event("aten::mm", 900.0, 5000.0, cat="cpu_op", tid=1),
        _event("cudaLaunchKernel", 950.0, 5.0, cat="cuda_runtime", tid=1),
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
    ]
    (tmp_path / profiling.TRACE_FILE).write_text(json.dumps({"traceEvents": events}))
    (tmp_path / "launches.json").write_text(json.dumps({"trajectory_forward": 2, "unroll_bwd": 2, "adam_step": 0}))
    s = profile_step.summarize(str(tmp_path), steps=2)
    assert s["lane"] == "device" and s["steps_profiled"] == 2 and s["marker_recorded"]
    assert s["step_total_us"] == pytest.approx((2610.0 - 1000.0) / 2)
    assert s["leaf_op_us_per_step"] == pytest.approx((300 + 100 + 10 + 320 + 110 + 10) / 2)
    top = {r["op"]: r for r in s["top_ops"]}
    assert list(top) == ["traj_persistent<float>", "bwd_chain<float>", "Memset"]
    assert top["traj_persistent<float>"]["per_step_us"] == pytest.approx(310.0)
    assert top["bwd_chain<float>"]["calls_per_step"] == 1.0
    assert top["Memset"]["pct_of_leaf_time"] == pytest.approx(100 * 20 / 850)
    assert s["kernels"] == {"trajectory_forward": {"trace_launches": 2, "wrapper_launches": 2},
                            "unroll_bwd": {"trace_launches": 2, "wrapper_launches": 2}}


@pytest.mark.parametrize("which", profile_step.STEPS)
def test_capture_smoke_mode_on_the_cpu(monkeypatch, which):
    """DLADMM_BENCH_SMOKE: capture runs the step at 100 x 200, K = 4, batch
    32 on the CPU and summarize reads the host lane (no device events);
    no kernel wrapper launched."""
    monkeypatch.setenv("DLADMM_BENCH_SMOKE", "1")
    trace_dir, steps = profile_step.capture(steps=2, which=which)
    s = profile_step.summarize(trace_dir, steps)
    assert s["lane"] == "host" and s["steps_profiled"] == 2 and s["top_ops"] and not s["marker_recorded"]
    assert s["step_total_us"] > 0 and s["leaf_op_us_per_step"] > 0 and s["kernels"] == {}
    with open(os.path.join(trace_dir, "launches.json")) as f:
        assert not any(json.load(f).values())
    with pytest.raises(ValueError, match="which="):
        profile_step.capture(steps=1, which="bogus")


@pytest.mark.slow
@pytest.mark.parametrize(
    "module,expect",
    [
        ("dladmm_tpu_torch.examples.quickstart", "served 10 solves"),
        ("dladmm_tpu_torch.examples.distributed", "sharded serving: 200 solves"),
    ],
)
def test_example_runs_clean(module, expect):
    env = dict(os.environ, DLADMM_PLATFORM="cpu", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", module], capture_output=True, text=True, timeout=540, env=env,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:] + out.stdout[-2000:]
    assert expect in out.stdout
