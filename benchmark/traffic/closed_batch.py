"""Closed-loop batch serving: one caller codes a corpus in requests of
``rows`` rows through ``serve.InferenceServer.solve``, each request's b
handed in as a host tensor and its x and z copied back to the host
before the next is sent.

Mix parameters: ``rows``, the server's ``max_batch``, ``pool_rows``
(distinct observation rows; a request is a slice at a seeded offset),
``check_requests`` (request indices, drawn from the seed among the first
``check_among``, held against the reference), ``warm_requests``, the
traced sub-window (``trace_at_s``, ``trace_s``) and the ``limits``.
The rate is the rows returned over the time from the window's start to
the end of its last request, which starts before ``--seconds`` ran out.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import harness, inputs
from benchmark.reference import compare, precision
from benchmark.reference.solver import solve_rows

REHEARSAL = {"config": {"m": 16, "n": 32, "K": 3},
             "mix": {"rows": 8, "max_batch": 8, "pool_rows": 64, "check_requests": 2, "check_among": 4,
                     "warm_requests": 1, "trace_at_s": 0.1, "trace_s": 0.2}}


class Workload:
    def __init__(self, cfg: dict, mix: dict, seed: int, seconds: float, device):
        self.cfg, self.mix, self.seed, self.seconds, self.device = cfg, mix, seed, seconds, device
        self.fault = None

    def setup(self) -> None:
        import torch

        from dladmm_tpu_torch.models.unroll import DLADMMParams
        from dladmm_tpu_torch.serve import InferenceServer

        cfg, mix = self.cfg, self.mix
        if self.device.type == "cuda":
            from dladmm_tpu_torch.ops import cuda_build

            cuda_build.build_all([cuda_build.CSRC / "unroll.cu"])
        self.A = inputs.dictionary(cfg, self.seed, self.device)
        self.params = inputs.parameters(cfg, self.A, self.seed)
        self.pool = inputs.observations(cfg, self.A, self.seed, mix["pool_rows"]).cpu().numpy()
        rng = inputs.rng(self.seed, inputs.ORDER)
        self.offsets = rng.integers(0, mix["pool_rows"] - mix["rows"] + 1, size=1 << 16)
        self.checked = set(inputs.rng(self.seed, inputs.SAMPLE).choice(
            mix["check_among"], mix["check_requests"], replace=False).tolist())
        self.results = {}
        self.server = InferenceServer(DLADMMParams(*self.params), self.A, max_batch=mix["max_batch"],
                                      device=self.device)
        self.torch = torch
        for i in range(mix["warm_requests"]):
            self._request(i, keep=False)
        self.count = 0

    def _request(self, i: int, keep: bool = True) -> None:
        rows = self.mix["rows"]
        off = int(self.offsets[i % len(self.offsets)])
        b = self.torch.from_numpy(self.pool[off: off + rows])
        with harness.span(f"bench.solve:{rows}/{self.server._bucket_for(rows)}"):
            x, z = self.server.solve(b)
            x, z = x.cpu(), z.cpu()
        if self.fault == "altered":
            x[0, 0] += 1.0
        if keep and i in self.checked:
            self.results[i] = (x.numpy(), z.numpy())

    def _run(self, until: float) -> None:
        while time.monotonic() - self.t_start < until:
            self._request(self.count)
            self.count += 1

    def measure(self) -> dict:
        self.t_start = time.monotonic()
        self._run(self.seconds)
        elapsed = time.monotonic() - self.t_start
        return {"t_start": self.t_start, "attempted": self.count, "failed": 0,
                "metrics": {"serve_rows_per_s": self.count * self.mix["rows"] / elapsed}}

    def traced(self, tracer) -> dict:
        self.t_start = time.monotonic()
        self._run(self.mix["trace_at_s"])
        ctx, _ = tracer.capture(lambda: self._run(time.monotonic() - self.t_start + self.mix["trace_s"]))
        self._run(self.seconds)
        return {"t_start": self.t_start, "attempted": self.count, "failed": 0, "trace": ctx}

    def release(self) -> None:
        del self.server

    def check(self, control=None) -> list:
        torch = self.torch
        rows = self.mix["rows"]
        idx = sorted(self.checked) if control else sorted(self.results)
        missing = len([i for i in self.checked if i < self.count and i not in self.results])
        if not idx:
            return compare.numbers({"failed": float(missing)}, self.mix["limits"])
        b = torch.from_numpy(np.concatenate([self.pool[int(self.offsets[i]): int(self.offsets[i]) + rows]
                                             for i in idx])).to(self.device)
        with precision(tf32=False):
            x_ref, z_ref = solve_rows(self.params, self.A, b)
        if control:
            with precision(tf32=True):
                x_p, z_p = solve_rows(self.params, self.A, b)
        else:
            x_p = torch.from_numpy(np.concatenate([self.results[i][0] for i in idx])).to(self.device)
            z_p = torch.from_numpy(np.concatenate([self.results[i][1] for i in idx])).to(self.device)
        values = {"failed": float(missing), "x_gap": compare.max_gap(x_p, x_ref), "z_gap": compare.max_gap(z_p, z_ref)}
        return compare.numbers(values, self.mix["limits"])
