"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (build, inputs from the seed, warm-up) is timed from the start of
this module to the window's start (``setup_s``). ``--trace 0`` measures
the cell's end-to-end metrics; ``--trace 1`` runs the same window with a
traced sub-window and reports the per-layer metrics, ``busy_s``,
``window_s`` and a ``breakdown``. After the window the device's peak
memory is read, the program's state freed, and the reference decides
``correct``; each number compared is printed beside its limit, last on
stderr and last in the result line (``check``).

Without a CUDA card, or with fewer cards than the cell asks for, the run
fails and prints no result. ``--rehearse`` runs the same path on the CPU
at a tiny size (traffic/<kind>.py's REHEARSAL) and prints a line without
any metric: a check of the control flow, not a measurement.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# The program builds its CUDA sources into dladmm_tpu_torch/_build/ in
# the checkout itself; it uses no Triton or torch extension cache.
os.environ["USE_FLAX"] = "0"

from benchmark import harness, spec as specs  # noqa: E402
from benchmark.reference import compare  # noqa: E402


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true", help="the CPU rehearsal at a tiny size; no metric")
    return ap.parse_args(argv)


def workload(cfg: dict, mix: dict, seed: int, seconds: float, device, rehearse: bool = False, root: Path = ROOT):
    """The driver of ``mix`` (traffic/<kind>.py Workload) over ``cfg``; with
    ``rehearse`` the kind's tiny sizes over them."""
    kind = specs.load_module(specs.kind_file(root, mix["kind"]), mix["kind"])
    if rehearse:
        cfg = {**cfg, **kind.REHEARSAL["config"]}
        over = kind.REHEARSAL["mix"]
        mix = {**mix, **{k: ({**mix[k], **v} if isinstance(v, dict) else v) for k, v in over.items()}}
    return kind.Workload(cfg, mix, seed, seconds, device)


def build(cell_name: str, seed: int, seconds: float, device, rehearse: bool = False, root: Path = ROOT):
    """(spec, cell, the cell's driver), BENCHMARK.json checked first."""
    spec = specs.load(root)
    specs.validate(spec, root)
    cell = specs.cell(spec, cell_name)
    cfg, mix = specs.config(spec, cell["config"], root), specs.mix(cell["traffic"], root)
    return spec, cell, workload(cfg, mix, seed, seconds, device, rehearse, root)


def main(argv=None) -> int:
    args = _args(argv)
    import torch

    harness.host_threads()

    chips = specs.cell(specs.load(), args.workload)["chips"]
    if args.rehearse:
        device = torch.device("cpu")
    elif not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: cell {args.workload} needs {chips} CUDA card(s); cuda available: "
              f"{torch.cuda.is_available()}, cards: {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    else:
        device = torch.device("cuda", 0)
    spec, cell, work = build(args.workload, args.seed, args.seconds, device, args.rehearse)
    work.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    harness.settle()
    tracer = harness.Tracer(device)
    host, pauses = harness.HostProbe(), harness.GcPauses()
    run = work.traced(tracer) if args.trace else work.measure()
    print(pauses.close(), file=sys.stderr)
    print(host.close(), file=sys.stderr)
    setup_s = run["t_start"] - T0
    harness.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    found = harness.jax_modules()
    if found:
        print(f"benchmark: JAX or the JAX package loaded after the window: {found}", file=sys.stderr)
        return 4
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": peak}
    metrics, extra = {}, {}
    if args.trace:
        ctx = {**run["trace"], "cfg": work.cfg, "mix": work.mix}
        summary = harness.device_summary(ctx)
        device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        for m in specs.per_layer(spec, cell["name"]):
            value = specs.load_module(specs.metric_file(ROOT, m["name"]), m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"breakdown": summary["breakdown"], "trace_sessions": tracer.sessions}
        del ctx, run["trace"]
    else:
        for m in specs.end_to_end(spec, cell["name"]):
            value = setup_s if m["name"] == "setup_s" else run["metrics"].get(m["name"])
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    work.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = work.check()
    correct = compare.passed(numbers) and run["failed"] == 0
    for n in numbers:
        print(f"check {n['name']} {n['value']!r} limit {n['limit']!r}", file=sys.stderr)
    check = {n["name"]: {"value": n["value"], "limit": n["limit"]} for n in numbers}
    if args.rehearse:
        result = {"rehearsal": True, "correct": correct, "attempted": run["attempted"], "failed": run["failed"],
                  "read": sorted(metrics), "check": check}
    else:
        result = {"correct": correct, "attempted": run["attempted"], "failed": run["failed"], "metrics": metrics,
                  "device": device_info, **extra, "check": check}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
