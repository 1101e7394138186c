"""Readings the benchmark's limits and rates are set from, on the card.

    python3 -m benchmark.calibrate knee --workload <open-loop cell> --rates 2000,4000 --seconds 6
    python3 -m benchmark.calibrate readings --workload <cell> --seeds 12 --controls 3 --seconds 3

``knee``: the open-loop cell at each offered rate, one process: the
completed rate, latency percentiles, how late the generator ran, and
whether the backlog grew (median latency of the last fifth of the
requests over the first fifth's). ``readings``: the numbers ``correct``
compares, for the program on ``--seeds`` seeds (a short window each;
training needs none), and for the control, the reference in TF32 in the
program's place, on ``--controls`` seeds (training also the fault "half
of the batch left out" planted in the reference). Seeds are fresh ones
drawn from ``--base``. Each line goes to stdout as JSON and to
``chiprun_out/calibrate_<what>_<cell>.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from benchmark import run as bench
from benchmark.traffic.common import percentile


def _emit(out, rec):
    line = json.dumps(rec)
    print(line, flush=True)
    out.write(line + "\n")
    out.flush()


def knee(cell: str, rates, seconds: float, seed: int, out, device, rehearse: bool) -> None:
    import torch

    for rate in rates:
        _, _, w = bench.build(cell, seed, seconds, device, rehearse)
        w.mix = {**w.mix, "rate_per_s": rate}
        w.setup()
        run = w.measure()
        n = len(w.due)
        lat = np.where(np.isnan(w.done), np.inf, w.done - (w.t_start + w.due))
        fifth = max(1, n // 5)
        done = w.done[~np.isnan(w.done)]
        calls = len(getattr(w, "calls", [])) or None
        _emit(out, {"what": "knee", "cell": cell, "offered_per_s": rate, "requests": n,
                    "completed_per_s": len(done) / (done.max() - w.t_start) if len(done) else 0.0,
                    "p50_ms": percentile(lat, 50) * 1e3, "p95_ms": run["metrics"]["serve_p95_ms"],
                    "p99_ms": percentile(lat, 99) * 1e3,
                    "late_p99_ms": float(np.nanpercentile(w.sent - (w.t_start + w.due), 99)) * 1e3,
                    "backlog_ratio": float(np.median(lat[-fifth:]) / np.median(lat[:fifth])),
                    "failed": run["failed"], "calls": calls})
        w.release()
        del w
        if device.type == "cuda":
            torch.cuda.empty_cache()


def readings(cell: str, seeds, controls, seconds: float, out, device, rehearse: bool) -> None:
    import torch

    for i, seed in enumerate(list(seeds) + list(controls)):
        control = i >= len(seeds)
        _, _, w = bench.build(cell, seed, seconds, device, rehearse)
        w.setup()
        train = hasattr(w, "reference")
        run = None if train or control else w.measure()
        w.release()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        kinds = (["tf32", "half_batch"] if train else ["tf32"]) if control else [None]
        for kind in kinds:
            nums = w.check(control=kind)
            _emit(out, {"what": "control" if control else "program", "fault": kind, "cell": cell, "seed": seed,
                        "failed": None if run is None else run["failed"],
                        "attempted": None if run is None else run["attempted"],
                        **{n["name"]: n["value"] for n in nums}, **getattr(w, "last", {})})
        del w
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("what", choices=("knee", "readings"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--base", type=int, default=2**31 + 12345)
    ap.add_argument("--rehearse", action="store_true", help="on the CPU at the kinds' tiny sizes")
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness

    harness.host_threads()
    device = torch.device("cpu") if args.rehearse else torch.device("cuda", 0)
    rng = np.random.default_rng(args.base)
    seeds = [int(s) for s in rng.integers(2**31, 2**31 + 2**30, size=args.seeds + args.controls)]
    path = Path(bench.ROOT) / "chiprun_out" / f"calibrate_{args.what}_{args.workload}.jsonl"
    path.parent.mkdir(exist_ok=True)
    t0 = time.monotonic()
    with open(path, "w") as out:
        if args.what == "knee":
            knee(args.workload, [float(r) for r in args.rates.split(",")], args.seconds, seeds[0], out, device,
                 args.rehearse)
        else:
            readings(args.workload, seeds[:args.seeds], seeds[args.seeds:], args.seconds, out, device,
                     args.rehearse)
    print(f"calibrate {args.what} {args.workload}: {time.monotonic() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
