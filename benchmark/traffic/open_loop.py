"""Open-loop serving: independent clients send requests of a few rows on
a Poisson schedule, through ``serve.BatchingServer`` over
``serve.InferenceServer``.

Mix parameters: ``rate_per_s`` (offered requests a second), rows a request
lognormal (``rows_median``, ``rows_sigma``, clipped to ``rows_min`` ..
``rows_max``), the servers' ``max_batch`` and ``max_delay_ms``,
``pool_rows`` (distinct observation rows, each request a slice of them at
a seeded offset), ``check_requests`` (how many requests, drawn from the
seed, are held against the reference), ``warm_requests``, the traced
sub-window (``trace_at_s``, ``trace_s``) and the ``limits``.

The sizes and gaps are the same multiset for every seed (stratified
quantiles), in the seed's order. A request's latency runs from when it
was due to when its result is on the host; one that fails or never
completes counts as infinitely late. After the window every request is
waited for, a minute at most.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from benchmark import harness, inputs
from benchmark.reference import compare, precision
from benchmark.reference.solver import solve_rows
from benchmark.traffic.common import percentile, stratified_exponential, stratified_lognormal

WAIT_S = 60.0
# A tiny run of the same path on the CPU (the rehearsal).
REHEARSAL = {"config": {"m": 16, "n": 32, "K": 3},
             "mix": {"rate_per_s": 100, "pool_rows": 256, "check_requests": 20, "warm_requests": 5,
                     "max_batch": 16, "rows_max": 8, "trace_at_s": 0.2, "trace_s": 0.3}}


class Workload:
    def __init__(self, cfg: dict, mix: dict, seed: int, seconds: float, device):
        self.cfg, self.mix, self.seed, self.seconds, self.device = cfg, mix, seed, seconds, device
        self.fault = None  # a planted fault (the tests): "altered"

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from dladmm_tpu_torch.models.unroll import DLADMMParams
        from dladmm_tpu_torch.serve import BatchingServer, InferenceServer

        cfg, mix = self.cfg, self.mix
        if self.device.type == "cuda":
            from dladmm_tpu_torch.ops import cuda_build

            cuda_build.build_all([cuda_build.CSRC / "unroll.cu"])
        self.A = inputs.dictionary(cfg, self.seed, self.device)
        self.params = inputs.parameters(cfg, self.A, self.seed)
        self.pool = inputs.observations(cfg, self.A, self.seed, mix["pool_rows"]).cpu().numpy()
        count = max(1, int(mix["rate_per_s"] * self.seconds))
        rng = inputs.rng(self.seed, inputs.ORDER)
        sizes = rng.permutation(stratified_lognormal(count, mix["rows_median"], mix["rows_sigma"],
                                                     mix["rows_min"], mix["rows_max"]))
        gaps = rng.permutation(stratified_exponential(count, 1.0 / mix["rate_per_s"]))
        due = np.cumsum(gaps) - gaps[0]
        keep = due < self.seconds
        self.sizes, self.due = sizes[keep], due[keep]
        self.offsets = rng.integers(0, mix["pool_rows"] - self.sizes + 1)
        n = len(self.sizes)
        self.checked = set(inputs.rng(self.seed, inputs.SAMPLE).choice(n, min(n, mix["check_requests"]),
                                                                        replace=False).tolist())
        self.done = np.full(n, np.nan)
        self.failed = np.zeros(n, dtype=bool)
        self.sent = np.full(n, np.nan)
        self.results = {}
        self.server = InferenceServer(DLADMMParams(*self.params), self.A, max_batch=mix["max_batch"],
                                      device=self.device)
        solve = self.server.solve

        def traced_solve(b):
            with harness.span(f"bench.solve:{b.shape[0]}/{self.server._bucket_for(b.shape[0])}"):
                x, z = solve(b)
                if self.fault == "altered":
                    x = x.clone()
                    x[0, 0] += 1.0
                return x, z

        self.server.solve = traced_solve
        self.front = BatchingServer(self.server, max_delay_ms=mix["max_delay_ms"])
        # Warm the front end: requests of the mix's sizes, at its rate.
        warm = []
        for s in self.sizes[: mix["warm_requests"]]:
            warm.append(self.front.submit(self.pool[: int(s)]))
            time.sleep(1.0 / mix["rate_per_s"])
        for f in warm:
            f.result(timeout=WAIT_S)

    # -- the window -----------------------------------------------------
    def _finish(self, i: int, fut) -> None:
        t = time.monotonic()
        if fut.exception() is not None:
            self.failed[i] = True
            return
        self.done[i] = t
        if i in self.checked:
            x, z = fut.result()
            self.results[i] = (x.copy(), z.copy())

    def _send(self, i: int, until: float) -> int:
        """Send requests from index i while they are due before ``until``
        (seconds into the window); returns the next index."""
        t0 = self.t_start
        while i < len(self.due) and self.due[i] < until:
            wait = t0 + self.due[i] - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            self.sent[i] = time.monotonic()
            off, s = int(self.offsets[i]), int(self.sizes[i])
            fut = self.front.submit(self.pool[off: off + s])
            fut.add_done_callback(lambda f, i=i: self._finish(i, f))
            i += 1
        return i

    def _drain(self) -> None:
        deadline = self.t_start + self.seconds + WAIT_S
        while time.monotonic() < deadline and np.isnan(self.done).sum() > self.failed.sum():
            time.sleep(0.01)
        self.front.close()

    def measure(self) -> dict:
        self.t_start = time.monotonic()
        self._send(0, self.seconds)
        self._drain()
        lat = np.where(np.isnan(self.done), np.inf, self.done - (self.t_start + self.due))
        late = self.sent - (self.t_start + self.due)
        n = len(self.due)
        print(f"open loop: {n} requests in {self.seconds} s at {self.mix['rate_per_s']}/s; generator late "
              f"p50 {np.nanmedian(late) * 1e3:.4f} ms, p99 {np.nanpercentile(late, 99) * 1e3:.4f} ms, "
              f"max {np.nanmax(late) * 1e3:.4f} ms; latency p50 {percentile(lat, 50) * 1e3:.4f} ms, "
              f"p99 {percentile(lat, 99) * 1e3:.4f} ms; p95 by fifth of the window (ms) "
              f"{[round(percentile(part, 95) * 1e3, 4) for part in np.array_split(lat, 5)]}", file=sys.stderr)
        return {"t_start": self.t_start, "attempted": n, "failed": int(np.isinf(lat).sum()),
                "metrics": {"serve_p95_ms": percentile(lat, 95) * 1e3}}

    def traced(self, tracer) -> dict:
        """The window with a traced sub-window from ``trace_at_s``."""
        self.t_start = time.monotonic()
        state = {"i": self._send(0, self.mix["trace_at_s"]), "paused": time.monotonic()}

        def body():
            # The schedule waits while the profiler starts and stops, so
            # the traced sub-window sees the mix's steady arrivals.
            self.t_start += time.monotonic() - state["paused"]
            state["i"] = self._send(state["i"], self.due[min(state["i"], len(self.due) - 1)] + self.mix["trace_s"])
            state["paused"] = time.monotonic()

        ctx, _ = tracer.capture(body)
        self.t_start += time.monotonic() - state["paused"]
        self._send(state["i"], self.seconds)
        self._drain()
        n = len(self.due)
        return {"t_start": self.t_start, "attempted": n, "failed": int((np.isnan(self.done)).sum()), "trace": ctx}

    # -- after the window -----------------------------------------------
    def release(self) -> None:
        self.front.close()
        del self.front, self.server

    def check(self, control=None) -> list:
        """x_gap and z_gap of the checked requests that completed (with
        ``control`` "tf32", of the reference in TF32 in the program's
        place), and the failed requests."""
        import torch

        idx = sorted(self.results) if not control else sorted(self.checked)
        if not idx:
            return compare.numbers({"failed": float(np.isnan(self.done).sum())}, self.mix["limits"])
        rows = np.concatenate([self.pool[int(self.offsets[i]): int(self.offsets[i] + self.sizes[i])] for i in idx])
        b = torch.from_numpy(rows).to(self.device)
        with precision(tf32=False):
            x_ref, z_ref = solve_rows(self.params, self.A, b)
        if control:
            with precision(tf32=True):
                x_p, z_p = solve_rows(self.params, self.A, b)
        else:
            x_p = torch.from_numpy(np.concatenate([self.results[i][0] for i in idx])).to(self.device)
            z_p = torch.from_numpy(np.concatenate([self.results[i][1] for i in idx])).to(self.device)
        values = {"failed": float(np.isnan(self.done).sum()) if not control else 0.0,
                  "x_gap": compare.max_gap(x_p, x_ref), "z_gap": compare.max_gap(z_p, z_ref)}
        return compare.numbers(values, self.mix["limits"])
