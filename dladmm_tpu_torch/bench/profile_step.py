"""Kernel-level profile of the flagship train step: a torch.profiler
trace on the card, summarised as device time by kernel.

``python -m dladmm_tpu_torch.bench.profile_step [--step shipped|fused|qadam_int8] [--out summary.json]``

The port of ``dladmm_tpu/bench/profile_step.py``. ``capture`` runs
``steps`` training steps at synthetic_large (A 1000 x 2000, K = 20,
batch 1024) inside utils/profiling.trace and counts each kernel
wrapper's launches over them; ``summarize`` reads the Chrome trace back
and keeps the device's kernel and memset events: the top operations by
time a step, the device time of the chain's window a step, and, for
each of the port's kernels that ran, its launches in the trace beside
its wrapper's count. ``DLADMM_BENCH_SMOKE=1`` runs 100 x 200, K = 4,
batch 32 on the CPU (the control flow only; a CPU trace has no device
lane, so the summary reads the outermost host operations instead).
The trace opens with utils/profiling.profile_marker, which the summary
leaves out.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile

import torch

from dladmm_tpu_torch.utils.profiling import MARKER, TRACE_FILE, kernel_name

# The port's kernels by wrapper: each launch its wrapper counts is one
# device kernel whose name holds one of these (adam_step counts two a
# step, its prologue and its sweep).
PORT_KERNELS = {
    "unroll_forward": ("unroll_persistent",),
    "trajectory_forward": ("traj_persistent",),
    "unroll_bwd": ("bwd_chain",),
    "int8_unroll_forward": ("int8_persistent",),
    "adam_step": ("adam_prologue", "qadam_int8_sweep", "qadam_dense_sweep"),
}


def reset_launches() -> None:
    """Every kernel wrapper's launch count set to 0."""
    from dladmm_tpu_torch.ops import cuda_bwd, cuda_int8, cuda_layer, cuda_traj, cuda_unroll
    from dladmm_tpu_torch.train import qadam_cuda

    cuda_unroll.unroll_forward.launches = cuda_int8.int8_unroll_forward.launches = 0
    cuda_traj.trajectory_forward.launches = cuda_traj.trajectory_forward.launches_bf16 = 0
    cuda_bwd.reset_launches()
    cuda_layer.layer_step.launches = 0
    qadam_cuda.adam_step.launches = qadam_cuda.adam_step.launches_bf16 = 0


def wrapper_launches() -> dict:
    """Each kernel wrapper's launches since reset_launches, fp32 and bf16
    together (layer_step launches unroll_persistent too)."""
    from dladmm_tpu_torch.ops import cuda_bwd, cuda_int8, cuda_layer, cuda_traj, cuda_unroll
    from dladmm_tpu_torch.train import qadam_cuda

    return {"unroll_forward": cuda_unroll.unroll_forward.launches + cuda_layer.layer_step.launches,
            "trajectory_forward": cuda_traj.trajectory_forward.launches + cuda_traj.trajectory_forward.launches_bf16,
            "unroll_bwd": sum(cuda_bwd.unroll_bwd.launches.values()) + sum(cuda_bwd.unroll_bwd.launches_bf16.values()),
            "int8_unroll_forward": cuda_int8.int8_unroll_forward.launches,
            "adam_step": qadam_cuda.adam_step.launches + qadam_cuda.adam_step.launches_bf16}


STEPS = ("shipped", "fused", "qadam_int8")


def capture(steps: int = 12, which: str = "shipped", device=None):
    """Trace ``steps`` training steps on one batch at synthetic_large
    (batch 1024) in bf16 compute; returns (trace_dir, steps). The trace
    is trace_dir/trace.json; each wrapper's launches over the traced
    steps are in trace_dir/launches.json.

    which: ``shipped``, train/loop.make_train_step_from_batch with plain
    Adam at lr 1e-3 and bf16 compute on the policy's forward (the bf16
    trajectory kernel and, for the final-layer loss, the bf16 backward
    kernel: the port's manual VJP on the card, rows 2 and 4);
    ``fused``, train/fused_adam.make_fused_adam_step in bf16 (Adam inside
    the reverse sweep, plain PyTorch); ``qadam_int8``, the shipped step
    with train/qadam_cuda.QAdamFused int8 moments (row 3's sweep)."""
    from dladmm_tpu_torch.data.synthetic import make_batch, make_dictionary
    from dladmm_tpu_torch.models.api import select_forward
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.train.loop import adam, make_train_state, make_train_step_from_batch
    from dladmm_tpu_torch.utils import profiling
    from dladmm_tpu_torch.utils.platform import resolve_device

    if which not in STEPS:
        raise ValueError(f"which={which!r}: one of {STEPS}")
    smoke = bool(os.environ.get("DLADMM_BENCH_SMOKE"))
    device = resolve_device("cpu" if smoke else device)
    m, n, K, S = (100, 200, 4, 32) if smoke else (1000, 2000, 20, 1024)
    gen = torch.Generator().manual_seed(0)
    A = make_dictionary(gen, m, n)
    data = make_batch(gen, A, S)
    A, data = A.to(device), type(data)(*(v.to(device) for v in data))
    params = init_dladmm_params(A, K=K)
    bf = torch.bfloat16
    if which == "fused":
        from dladmm_tpu_torch.train.fused_adam import make_fused_adam_state, make_fused_adam_step

        step = make_fused_adam_step(A, lr=1e-3, compute_dtype=bf, from_batch=True)
        state = make_fused_adam_state(params, None, bf)
    else:
        if which == "qadam_int8":
            from dladmm_tpu_torch.train.qadam_cuda import QAdamFused

            opt = QAdamFused(1e-3, moment_fmt="int8")
        else:
            opt = adam(1e-3)
        forward_fn = select_forward(m, n, m, S, device=device, dtype=bf)[0]
        step = make_train_step_from_batch(opt, A, forward_fn=forward_fn, compute_dtype=bf)
        state = make_train_state(params, opt, bf)

    def run(state):
        for _ in range(steps):
            state = step(state, data)[0]
        return state

    state = run(state)  # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    trace_dir = tempfile.mkdtemp(prefix="dladmm_prof_")
    reset_launches()
    with profiling.trace(trace_dir, cuda=device.type == "cuda"):
        run(state)
    with open(os.path.join(trace_dir, "launches.json"), "w") as f:
        json.dump(wrapper_launches(), f)
    return trace_dir, steps


def _outermost(events):
    """The events no other event of the same thread contains."""
    out, ends = [], {}
    for e in sorted(events, key=lambda e: (e.get("pid"), e.get("tid"), e["ts"], -e["dur"])):
        lane = (e.get("pid"), e.get("tid"))
        if e["ts"] >= ends.get(lane, float("-inf")):
            out.append(e)
            ends[lane] = e["ts"] + e["dur"]
    return out


def summarize(trace_dir: str, steps: int, top: int = 20):
    """Per-step figures of a trace_dir that ``capture`` (or
    utils/profiling.trace) wrote: the device's kernel and memset events,
    the marker left out (marker_recorded says whether the trace holds
    it). step_total_us: the window from the first such
    event's start to the last one's end, a step; leaf_op_us_per_step:
    their summed time a step; top_ops: the ``top`` operations by time,
    each with its time and launches a step and share of the leaf time;
    kernels: for each of the port's kernels that ran (PORT_KERNELS), its
    launches in the trace beside its wrapper's count (launches.json,
    where capture wrote one). A trace with no device event (a CPU run)
    is read on its host lane: the outermost CPU operations."""
    with open(os.path.join(trace_dir, TRACE_FILE)) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    lane = "device"
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memset")]
    kept = [e for e in device if MARKER not in e["name"]]
    if not kept:
        lane = "host"
        kept = _outermost([e for e in events if e.get("cat") == "cpu_op"])
    per_op = collections.Counter()
    calls = collections.Counter()
    for e in kept:
        name = kernel_name(e["name"])
        per_op[name] += e["dur"]
        calls[name] += 1
    leaf_total = sum(per_op.values())
    window = (max(e["ts"] + e["dur"] for e in kept) - min(e["ts"] for e in kept)) if kept else 0.0
    rows = [
        {
            "op": name[:90],
            "per_step_us": us / steps,
            "calls_per_step": calls[name] / steps,
            "pct_of_leaf_time": 100 * us / max(leaf_total, 1e-9),
        }
        for name, us in per_op.most_common(top)
    ]
    launches_path = os.path.join(trace_dir, "launches.json")
    wrappers = {}
    if os.path.exists(launches_path):
        with open(launches_path) as f:
            wrappers = json.load(f)
    kernels = {}
    for wrapper, patterns in PORT_KERNELS.items():
        in_trace = sum(c for name, c in calls.items() if any(p in name for p in patterns)) if lane == "device" else 0
        if in_trace or wrappers.get(wrapper):
            kernels[wrapper] = {"trace_launches": in_trace, "wrapper_launches": wrappers.get(wrapper)}
    return {
        "lane": lane,
        "marker_recorded": len(kept) < len(device),
        "step_total_us": window / steps,
        "leaf_op_us_per_step": leaf_total / steps,
        "steps_profiled": steps,
        "top_ops": rows,
        "kernels": kernels,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None)
    ap.add_argument(
        "--step",
        default="shipped",
        choices=list(STEPS),
        help="which flagship step to profile (fused = Adam inside the reverse sweep, train/fused_adam.py; "
             "qadam_int8 = the one-pass optimizer sweep with int8 moments, train/qadam_cuda.py)",
    )
    args = ap.parse_args(argv)
    trace_dir, steps = capture(which=args.step)
    result = summarize(trace_dir, steps) | {"trace_dir": trace_dir}
    out = json.dumps(result, indent=2)
    print(out)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(out + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
