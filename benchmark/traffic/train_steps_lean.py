"""Closed-loop training whose state fills the card: ``train_steps``'
loop (the step ``fit`` builds, from ``train/loop._build_optimizer``,
``select_forward``, ``make_train_step`` and ``make_train_state``; the
optimizer's count at the mix's ``start_step``, its moments fresh; three
steps in set-up, then the window, each step's batch from
``step_generator(seed, start_step + i)``), with the recipe's fp32 Adam
and nothing on the card beside the program's own state:

- no second copy of the parameters: the state is built on the seed's
  parameters and set-up drops them; the reference rebuilds them from
  the seed after the window (their per-layer sums must come out equal);
- the first gradient as the optimizer got it is read at once, as the
  norm of each leaf's mu after the first step over 1 - b1, so no moment
  is cloned;
- the parameters after the first three steps go to host memory.

After ``release`` the reference (``reference/adam.py``, plain fp32
Adam at the constant rate) runs the three steps from the rebuilt
parameters on per-layer leaves, views of the stacks: autograd's select
backward on a stacked leaf would allocate the whole stack for every
layer. Changes and differences are read one layer at a time from the
host copies. The numbers compared are ``train_steps``'
(``reference/compare.py``): ``loss_gap``, ``grad_gap`` and
``change_gap`` (median leaf), ``change_diff`` (worst leaf of those whose
reference gradient is at least a thousandth of the median leaf's).
"""

from __future__ import annotations

import statistics

from benchmark import inputs
from benchmark.reference import compare, precision
from benchmark.reference.adam import Adam
from benchmark.reference.optim import B1
from benchmark.reference.solver import loss
from benchmark.traffic import train_steps
from benchmark.traffic.train_steps import FIRST, REHEARSAL  # noqa: F401
from benchmark.yardstick.synthetic import draw_batch, step_generator


class Workload(train_steps.Workload):
    def setup(self) -> None:
        import torch

        from dladmm_tpu_torch.models.api import select_forward
        from dladmm_tpu_torch.models.unroll import DLADMMParams
        from dladmm_tpu_torch.train import loop
        from dladmm_tpu_torch.utils.config import TrainConfig

        cfg, r = self.cfg, self.recipe
        if self.device.type == "cuda":
            from dladmm_tpu_torch.ops import cuda_build

            cuda_build.build_all([cuda_build.CSRC / s for s in ("unroll.cu", "unroll_bwd.cu")])
        self.torch = torch
        self.A = inputs.dictionary(cfg, self.seed, self.device)
        params = inputs.parameters(cfg, self.A, self.seed)
        self.sums = _sums(params)
        t = TrainConfig(**r)
        optimizer = loop._build_optimizer(t)
        forward_fn = select_forward(cfg["m"], cfg["n"], cfg["m"], t.batch, kernel=t.kernel, device=self.device)[0]
        batch = t.batch // 2 if self.fault == "half_batch" else t.batch
        step = loop.make_train_step(optimizer, self.A, batch, cfg["sparsity_x"], cfg["sparsity_e"], None, None,
                                    None, forward_fn, seed=self.seed)
        self.step = {"unchanged": _unchanged, "flipped": _flipped}.get(self.fault, lambda s: s)(step)
        state = loop.make_train_state(DLADMMParams(*params), optimizer)
        del params
        self.start = self.mix["start_step"]
        self.state = state._replace(opt_state=_at_count(state.opt_state, self.start), step=self.start)
        self.losses = []
        for i in range(FIRST):
            self._step(self.start + i)
            if i == 0:
                mu = _adam(self.state.opt_state).mu
                self.first = [v / (1 - B1) for v in _leaf_norms([leaf[k] for k in range(cfg["K"]) for leaf in mu])]
            self.losses.append(self.loss)
        self.after = [_host(p) for p in self.state.params]
        self.i = self.start + FIRST

    def release(self) -> None:
        self.prog = {"losses": [float(v) for v in self.losses], "first": self.first, "after": self.after}
        del self.state, self.step, self.loss, self.losses, self.after

    def _start(self):
        """The seed's parameters, rebuilt on the device; they must be the
        ones set-up built, bit for bit."""
        params = inputs.parameters(self.cfg, self.A, self.seed)
        if _sums(params) != self.sums:
            raise RuntimeError("the seed's parameters came out different when rebuilt")
        return params

    def reference(self, tf32: bool = False, half_batch: bool = False) -> dict:
        """The first three steps in the reference: losses, first gradient
        norms as its optimizer got them, raw gradient norms, and the
        parameters after them (on the host); the start (on the host) kept
        in ``self.begin``."""
        torch, cfg, r = self.torch, self.cfg, self.recipe
        m, n = cfg["m"], cfg["n"]
        batch = r["batch"] // 2 if half_batch else r["batch"]
        params = self._start()
        if not hasattr(self, "begin"):
            self.begin = [_host(p) for p in params]
        views = [[p[k] for p in params] for k in range(cfg["K"])]
        flat = [v for layer in views for v in layer]
        opt = Adam(flat, r["lr"], self.start)
        out = {"losses": []}
        with precision(tf32):
            for i in range(FIRST):
                x, e = draw_batch(step_generator(self.seed, self.start + i), m, n, batch, cfg["sparsity_x"],
                                  cfg["sparsity_e"])
                x, e = x.to(self.device), e.to(self.device)
                value, grads = _loss_and_layer_grads(views, self.A, x @ self.A.T + e, x, e)
                opt.step(flat, grads)
                if i == 0:
                    out["raw"] = _leaf_norms(grads)
                    out["first"] = [v / (1 - B1) for v in _leaf_norms(opt.mu)]
                del grads
                out["losses"].append(float(value))
        del opt, views, flat
        out["after"] = [_host(p) for p in params]
        return out

    def _changes(self, prog_after, ref_after):
        """Per leaf: the norms of the program's and the reference's change
        from the start, and of the difference of their results, read one
        layer at a time on the device."""
        torch, dev = self.torch, self.device
        sums = {"prog": [], "ref": [], "diff": []}
        for s, p, r in zip(self.begin, prog_after, ref_after):
            acc = {k: 0.0 for k in sums}
            for k in range(s.shape[0]):
                sk, pk, rk = s[k].to(dev), p[k].to(dev), r[k].to(dev)
                acc["prog"] += float(torch.linalg.vector_norm(pk - sk, dtype=torch.float64)) ** 2
                acc["ref"] += float(torch.linalg.vector_norm(rk - sk, dtype=torch.float64)) ** 2
                acc["diff"] += float(torch.linalg.vector_norm(pk - rk, dtype=torch.float64)) ** 2
            for k in sums:
                sums[k].append(acc[k] ** 0.5)
        return sums

    def readings(self, prog: dict, ref: dict) -> dict:
        changes = self._changes(prog["after"], ref["after"])
        median = sorted(ref["raw"])[len(ref["raw"]) // 2]
        moved = [g >= 1e-3 * median for g in ref["raw"]]
        scale = statistics.median(changes["ref"])
        leaves = {"grad": compare.leaf_gaps(prog["first"], ref["first"]),
                  "change": compare.leaf_gaps(changes["prog"], changes["ref"], moved),
                  "diff": [d / max(c, scale, 1e-30)
                           for d, c, keep in zip(changes["diff"], changes["ref"], moved) if keep]}
        self.last = {f"{k}_leaves": v for k, v in leaves.items()}
        return {"loss_gap": max(compare.rel_gap(a, b) for a, b in zip(prog["losses"], ref["losses"])),
                "grad_gap": statistics.median(leaves["grad"]),
                "change_gap": statistics.median(leaves["change"]),
                "change_diff": max(leaves["diff"])}


class _Stack(list):
    """A leaf's per-layer tensors, indexed as the stacked tensor they
    slice (reference/solver.unroll reads W[k], beta[k], W.shape[0] and
    beta.new_tensor)."""

    @property
    def shape(self):
        return (len(self),)

    def new_tensor(self, value):
        return self[0].new_tensor(value)


def _loss_and_layer_grads(views, A, b, x_star, e_star):
    """The final-layer loss (reference/solver.loss) on per-layer leaves
    (detached views of the stacks), and each leaf's gradient, layer after
    layer ([W1, W2, theta1, theta2, beta] of layer 0, then of layer 1, ...)."""
    import torch

    leaves = [[v.detach().requires_grad_() for v in layer] for layer in views]
    value = loss(tuple(_Stack(leaf) for leaf in zip(*leaves)), A, b, x_star, e_star, None)
    grads = torch.autograd.grad(value, [v for layer in leaves for v in layer])
    return value.detach(), [g.detach() for g in grads]


def _leaf_norms(per_layer) -> list:
    """The norm of each of the five leaves over its layers, from tensors
    ordered layer after layer."""
    import torch

    sq = [0.0] * 5
    for j, t in enumerate(per_layer):
        sq[j % 5] += float(torch.linalg.vector_norm(t, dtype=torch.float64)) ** 2
    return [v ** 0.5 for v in sq]


def _host(t):
    """A copy of ``t`` in host memory (a copy on the CPU too)."""
    return t.detach().to("cpu", copy=True)


def _sums(params) -> list:
    """Per leaf and layer, the fp64 sum: a fingerprint of the parameters."""
    import torch

    return [[float(torch.sum(p[k], dtype=torch.float64)) for k in range(p.shape[0])] for p in params]


def _at_count(tree, count: int):
    """The optimizer's state with every step count (a 0-d integer tensor:
    Adam's, the rate's) at ``count``."""
    import torch

    if torch.is_tensor(tree):
        return torch.full_like(tree, count) if tree.dim() == 0 and not tree.is_floating_point() else tree
    if isinstance(tree, tuple):
        kids = [_at_count(v, count) for v in tree]
        return type(tree)(*kids) if hasattr(tree, "_fields") else tuple(kids)
    return tree


def _adam(tree):
    """The Adam state (count, mu, nu) inside the optimizer's chain."""
    if hasattr(tree, "mu"):
        return tree
    for v in tree if isinstance(tree, tuple) else ():
        found = _adam(v)
        if found is not None:
            return found
    return None


def _unchanged(step):
    """The fault "a step that returns its state unchanged", with no copy
    of the state on the card: the parameters saved to the host before the
    step and written back after it, the moments (fresh, so zero) zeroed
    again, and the state passed in (its counts) returned."""
    import torch

    def broken(state, i):
        saved = [_host(p) for p in state.params]
        new, value = step(state, i)
        with torch.no_grad():
            for p, s in zip(new.params, saved):
                p.copy_(s)
            for moment in (_adam(new.opt_state).mu, _adam(new.opt_state).nu):
                for v in moment:
                    v.zero_()
        return state, value

    return broken


def _flipped(step):
    """A fault that keeps every norm: the step's change to the parameters
    reversed (p0 - (p1 - p0)), the start kept on the host and the
    reversal made one layer at a time."""
    import torch

    def broken(state, i):
        before = [_host(p) for p in state.params]
        state, value = step(state, i)
        with torch.no_grad():
            for p, p0 in zip(state.params, before):
                for k in range(p.shape[0]):
                    p[k].copy_(2 * p0[k].to(p.device) - p[k])
        return state, value

    return broken
