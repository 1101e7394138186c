"""utils/profiling and bench/profile_step on the CPU: the trace writes a
Chrome trace, StepTimer laps, enable_nan_debug raises FloatingPointError
at the first NaN an aten operation or a kernel wrapper makes and is off
again with nothing left pushed; summarize's per-step figures on a
hand-written trace, capture in its smoke mode; and the two examples as
subprocesses (``slow``, as tests/test_examples.py runs the JAX ones).
The card's side is chip_smoke.py phases 47 and 49 and the ``gpu`` cases
of tests/test_torch_cuda.py."""

import json
import os
import subprocess
import sys

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


def test_trace_writes_a_chrome_trace_and_step_timer_laps(tmp_path):
    timer = profiling.StepTimer()
    with profiling.trace(str(tmp_path / "tr")) as d:
        y = torch.randn(32, 32) @ torch.randn(32, 32)
    assert os.listdir(d) == [profiling.TRACE_FILE]
    with open(os.path.join(d, profiling.TRACE_FILE)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    assert timer.lap(sync_on=y) >= 0 and timer.lap(sync_on={"a": [y, (y,)]}) >= 0 and timer.lap() >= 0


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
