"""Closed-loop training: the step ``fit`` builds
(``train/loop.make_train_step`` with the recipe's optimizer from
``train/loop._build_optimizer`` and the policy's forward), run step after
step with no sync inside the window; each step draws its own batch from
``step_generator(seed, i)``.

The recipe is the configuration's ``train``, with the mix's ``train``
over it (batch, loss). Set-up builds the one step object and its state,
with the optimizer's count at the mix's ``start_step`` (its moments
fresh), so that the steps run at the schedule's rate there and not at
the warmup's first rates (0, then lr / 500, ...); step i draws its batch
from ``step_generator(seed, start_step + i)``. Set-up runs the first
three steps through that object (the warm-up, and what the reference
follows) and hands the same object to the window. Mix parameters
besides: the traced sub-window (``trace_at_s``, ``trace_s``) and the
``limits``.

After the window the reference runs the three steps again from the same
parameters, count and the batches it draws itself, and the run compares
the three losses, the first gradient as the optimizer got it (from its
moments after one step), the norm of each leaf's change over the three
steps, and the change itself (reference/compare.py).
"""

from __future__ import annotations

import math
import statistics
import sys
import time

import numpy as np

from benchmark import harness, inputs
from benchmark.reference import compare, precision
from benchmark.reference.optim import B1, Int8Adam, decode
from benchmark.reference.solver import loss_and_grads
from benchmark.yardstick.roofline import leaf_eligible
from benchmark.yardstick.synthetic import draw_batch, step_generator

FIRST = 3  # steps the reference follows
REHEARSAL = {"config": {"m": 16, "n": 32, "K": 3},
             "mix": {"train": {"batch": 8}, "trace_at_s": 0.1, "trace_s": 0.2}}


class Workload:
    def __init__(self, cfg: dict, mix: dict, seed: int, seconds: float, device):
        self.cfg, self.mix, self.seed, self.seconds, self.device = cfg, mix, seed, seconds, device
        self.fault = None  # a planted fault (the tests): "unchanged", "half_batch"
        self.recipe = {**cfg["train"], **mix["train"]}

    def setup(self) -> None:
        import torch

        from dladmm_tpu_torch.models.api import select_forward
        from dladmm_tpu_torch.models.unroll import DLADMMParams
        from dladmm_tpu_torch.train import loop
        from dladmm_tpu_torch.utils.config import TrainConfig

        cfg, r = self.cfg, self.recipe
        final = r["layer_loss"] is None
        if self.device.type == "cuda":
            from dladmm_tpu_torch.ops import cuda_build

            srcs = ["unroll.cu", "qadam_int8.cu"] + (["unroll_bwd.cu"] if final else [])
            cuda_build.build_all([cuda_build.CSRC / s for s in srcs])
        self.torch = torch
        self.A = inputs.dictionary(cfg, self.seed, self.device)
        self.params = inputs.parameters(cfg, self.A, self.seed)
        t = TrainConfig(**r)
        m, n, K = cfg["m"], cfg["n"], cfg["K"]
        optimizer = loop._build_optimizer(t)
        forward_fn = select_forward(m, n, m, t.batch, kernel=t.kernel, need_trajectory=not final,
                                    device=self.device)[0]
        batch = t.batch // 2 if self.fault == "half_batch" else t.batch
        step = loop.make_train_step(optimizer, self.A, batch, cfg["sparsity_x"], cfg["sparsity_e"], None,
                                    loop._layer_weights(t.layer_loss, K, device=self.device), None, forward_fn,
                                    seed=self.seed)
        if self.fault == "unchanged":
            step = _unchanged(step)
        if self.fault == "flipped":
            step = _flipped(step)
        self.step = step
        state = loop.make_train_state(DLADMMParams(*self.params), optimizer)
        self.start = self.mix["start_step"]
        count = torch.full_like(state.opt_state.count, self.start)
        self.state = state._replace(opt_state=state.opt_state._replace(count=count), step=self.start)
        self.losses = []
        for i in range(FIRST):
            self._step(self.start + i)
            if i == 0:
                self.first_moments = [_copy(mu) for mu in self.state.opt_state.mu]
            self.losses.append(self.loss)
        self.after = [p.detach().clone() for p in self.state.params]
        self.i = self.start + FIRST

    def _step(self, i: int) -> None:
        with harness.span("bench.step"):
            self.state, self.loss = self.step(self.state, i)

    def _run(self, until: float) -> None:
        while time.monotonic() - self.t_start < until:
            self._step(self.i)
            self.i += 1
            self.stamps.append(time.monotonic())

    def measure(self) -> dict:
        self.t_start = time.monotonic()
        self.stamps = [self.t_start]
        self._run(self.seconds)
        harness.synchronize(self.device)
        elapsed = time.monotonic() - self.t_start
        steps = self.i - self.start - FIRST
        fifths = [round(1e3 * float(part[-1] - part[0]) / max(1, len(part) - 1), 3)
                  for part in np.array_split(np.array(self.stamps), 5)]
        print(f"train: {steps} steps in {elapsed:.3f} s; host ms a step by fifth of the window {fifths}",
              file=sys.stderr)
        ok = math.isfinite(float(self.loss))
        return {"t_start": self.t_start, "attempted": steps, "failed": 0 if ok else steps,
                "metrics": {"train_samples_per_s": steps * self.recipe["batch"] / elapsed}}

    def traced(self, tracer) -> dict:
        self.t_start = time.monotonic()
        self.stamps = [self.t_start]
        self._run(self.mix["trace_at_s"])
        ctx, _ = tracer.capture(lambda: self._run(time.monotonic() - self.t_start + self.mix["trace_s"]))
        ctx["batch"] = self.recipe["batch"]
        self._run(self.seconds)
        harness.synchronize(self.device)
        steps = self.i - self.start - FIRST
        return {"t_start": self.t_start, "attempted": steps, "failed": 0 if math.isfinite(float(self.loss)) else steps,
                "trace": ctx}

    def release(self) -> None:
        delta = [a - p for a, p in zip(self.after, self.params)]
        self.prog = {"losses": [float(v) for v in self.losses],
                     "first": [float(g.norm()) for g in self._first_grads()],
                     "change": [float(d.norm()) for d in delta], "delta": delta}
        del self.state, self.step, self.loss, self.losses, self.after, self.first_moments

    def _first_grads(self):
        """The first clipped gradient as the optimizer got it: its mu after
        one step over 1 - b1."""
        out = []
        for mu, p in zip(self.first_moments, self.params):
            if isinstance(mu, tuple):
                mu = decode(mu[0], mu[1], tuple(p.shape), leaf_eligible(tuple(p.shape)))
            out.append(mu.float() / (1 - B1))
        return out

    def reference(self, tf32: bool = False, half_batch: bool = False) -> dict:
        """The first three steps in the reference: losses, first gradient
        norms as its optimizer got them, each leaf's change and its norm,
        raw gradient norms."""
        torch, cfg, r = self.torch, self.cfg, self.recipe
        m, n = cfg["m"], cfg["n"]
        batch = r["batch"] // 2 if half_batch else r["batch"]
        params = [p.clone() for p in self.params]
        opt = Int8Adam(params, r["lr"], r["steps"], r["clip_norm"])
        opt.count = self.start
        out = {"losses": []}
        with precision(tf32):
            for i in range(FIRST):
                x, e = draw_batch(step_generator(self.seed, self.start + i), m, n, batch, cfg["sparsity_x"], cfg["sparsity_e"])
                x, e = x.to(self.device), e.to(self.device)
                b = x @ self.A.T + e
                value, grads = loss_and_grads(params, self.A, b, x, e, r["layer_loss"])
                opt.step(params, grads)
                if i == 0:
                    out["raw"] = [float(g.norm()) for g in grads]
                    out["first"] = [float((mu / (1 - B1)).norm()) for mu in opt.moments(params)[0]]
                out["losses"].append(float(value))
        out["delta"] = [a - p for a, p in zip(params, self.params)]
        out["change"] = [float(d.norm()) for d in out["delta"]]
        return out

    def readings(self, prog: dict, ref: dict) -> dict:
        median = sorted(ref["raw"])[len(ref["raw"]) // 2]
        moved = [g >= 1e-3 * median for g in ref["raw"]]
        leaves = {"grad": compare.leaf_gaps(prog["first"], ref["first"]),
                  "change": compare.leaf_gaps(prog["change"], ref["change"], moved),
                  "diff": compare.diff_gaps(prog["delta"], ref["delta"], moved)}
        self.last = {f"{k}_leaves": v for k, v in leaves.items()}
        return {"loss_gap": max(compare.rel_gap(a, b) for a, b in zip(prog["losses"], ref["losses"])),
                "grad_gap": statistics.median(leaves["grad"]),
                "change_gap": statistics.median(leaves["change"]),
                "change_diff": max(leaves["diff"])}

    def check(self, control=None) -> list:
        """The readings of the program (or, with ``control`` "tf32" or
        "half_batch", of the reference so computed in its place) against
        the reference's, each with its limit."""
        ref = self.reference()
        prog = self.prog if control is None else self.reference(tf32=control == "tf32",
                                                                 half_batch=control == "half_batch")
        return compare.numbers(self.readings(prog, ref), self.mix["limits"])


def _copy(q):
    """A copy of a moment as stored: (codes, scales) or a dense tensor."""
    if isinstance(q, tuple):
        return (q[0].clone(), q[1].clone())
    return q.clone()


def _unchanged(step):
    """The fault "a step that returns its state unchanged": the loss is
    the step's, the state the one it was given (copied first, as the
    optimizer updates in place)."""
    import copy

    def broken(state, i):
        kept = copy.deepcopy(state)
        return kept, step(state, i)[1]

    return broken


def _flipped(step):
    """A fault that keeps every norm: the step's change to the
    parameters, reversed (p0 - (p1 - p0))."""
    import torch

    def broken(state, i):
        before = [p.detach().clone() for p in state.params]
        state, loss = step(state, i)
        with torch.no_grad():
            for p, p0 in zip(state.params, before):
                p.copy_(2 * p0 - p)
        return state, loss

    return broken

