"""High-level solver API, the port of ``dladmm_tpu/models/solver.py``:

    solver = DLADMMSolver.create(A, K=15)   # LADMM-exact init
    solver = solver.fit(0, steps=2000)      # end-to-end training (int seed)
    x, e = solver.solve(b)                  # sparse code + corruption
    curve = solver.nmse_curve(b, x_star)    # NMSE(dB) per layer

A frozen dataclass over the parameters; ``fit`` returns a new solver.
It runs on A's device through the port's policy (models/api: serving's
route table ``inference_forward`` for solve, ``select_forward`` else):
on the card the l1/l1, B = I solver serves through the whole-unroll kernel,
takes its trajectories through the trajectory kernel, and trains through
the trajectory and backward kernels; a general elementwise prox serves
through the whole-unroll kernel's prox variant. General B and the
general proxes' trajectories and training run the plain loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import Tensor

from dladmm_tpu_torch.metrics.core import constraint_residual, per_layer_nmse_db
from dladmm_tpu_torch.models.api import inference_forward, select_forward
from dladmm_tpu_torch.models.unroll import DLADMMParams, dladmm_forward, init_dladmm_params


@dataclasses.dataclass(frozen=True, eq=False)
class DLADMMSolver:
    A: Tensor
    params: DLADMMParams
    B: Optional[Tensor] = None
    kernel: str = "auto"
    # Proximal operators (ops/prox.py registry names). Non-l1 pairs serve
    # through the whole-unroll kernel's prox variant where it has one, and
    # otherwise (and for trajectories and training) run the plain loop.
    prox_x: str = "l1"
    prox_z: str = "l1"
    prox_rho: float = 0.0

    @classmethod
    def create(
        cls,
        A: Tensor,
        B: Optional[Tensor] = None,
        K: int = 15,
        beta: float = 1.0,
        kernel: str = "auto",
        prox_x: str = "l1",
        prox_z: str = "l1",
        prox_rho: float = 0.0,
    ) -> "DLADMMSolver":
        return cls(
            A=A, params=init_dladmm_params(A, B, K=K, beta=beta), B=B,
            kernel=kernel, prox_x=prox_x, prox_z=prox_z, prox_rho=prox_rho,
        )

    @property
    def K(self) -> int:
        return self.params.K

    def _prox(self):
        """(prox_pair, cached layer step) of a general prox, or (None,
        None) for l1/l1; built once per instance."""
        cached = getattr(self, "_prox_cache", None)
        if cached is not None:
            return cached
        from dladmm_tpu_torch.ops.prox import get_prox, is_l1
        from dladmm_tpu_torch.ops.reference import make_cached_step

        pair = step = None
        if not is_l1(self.prox_x, self.prox_z, self.prox_rho):
            pair = (get_prox(self.prox_x, self.prox_rho), get_prox(self.prox_z, self.prox_rho))
            step = make_cached_step(*pair)
        object.__setattr__(self, "_prox_cache", (pair, step))
        return pair, step

    def _paths(self, S: int, need_trajectory: bool = False, training: bool = False):
        """(forward_fn, step_fn, description) for a batch of S rows, with
        the JAX package's raise rules for an explicit kernel. solve() at
        B = I takes serving's route (models/api.inference_forward);
        trajectories, training and a general B take select_forward's, a
        general prox there the plain loop."""
        pair, step = self._prox()
        if step is not None:
            if self.kernel == "pallas":
                raise ValueError(
                    f"kernel={self.kernel!r} is l1/l1-only; prox "
                    f"{self.prox_x}/{self.prox_z} uses the prox "
                    "megakernel (kernel='auto'/'megakernel') or the "
                    "plain loop (kernel='reference')"
                )
            if self.kernel == "megakernel" and (training or need_trajectory):
                raise ValueError(
                    "kernel='megakernel' with a general prox covers "
                    "solve() only (the prox megakernel has no backward/"
                    "trajectory variant); use kernel='auto' for "
                    "training and trajectories"
                )
        m, n = self.A.shape
        if self.B is None and not (need_trajectory or training):
            forward_fn, route, _ = inference_forward(
                m, m, self.kernel, self.A.dtype, prox_pair=pair, step_fn=step, device=self.A.device
            )
            return forward_fn, step, route
        forward_fn, _, route = select_forward(
            m, n, m if self.B is None else self.B.shape[1], S,
            kernel=self.kernel if step is None else "reference", need_trajectory=need_trajectory,
            identity_B=self.B is None, device=self.A.device,
        )
        return forward_fn, step, route

    @torch.no_grad()
    def solve(self, b: Tensor) -> Tuple[Tensor, Tensor]:
        """b (S, m) -> (x, z): sparse code + corruption estimate."""
        forward_fn, step_fn, _ = self._paths(b.shape[0])
        if forward_fn is not None:
            x, z, _ = forward_fn(self.params, self.A, b)
        else:
            x, z, _ = dladmm_forward(self.params, self.A, b, B=self.B, step_fn=step_fn)
        return x, z

    @torch.no_grad()
    def trajectory(self, b: Tensor):
        """Per-layer (x_k, z_k, lam_k) stacks, (K, S, .): the trajectory
        kernel for l1/l1 and B = I (no fit gate: it runs at every S),
        else the plain loop."""
        forward_fn, step_fn, _ = self._paths(b.shape[0], need_trajectory=True)
        if forward_fn is not None:
            return forward_fn(self.params, self.A, b)
        _, traj = dladmm_forward(self.params, self.A, b, B=self.B, capture_trajectory=True, step_fn=step_fn)
        return traj

    def nmse_curve(self, b: Tensor, x_star: Tensor) -> Tensor:
        tx, _, _ = self.trajectory(b)
        return per_layer_nmse_db(tx, x_star)

    def residual(self, b: Tensor) -> Tensor:
        x, z = self.solve(b)
        return constraint_residual(self.A, b, x, z, self.B)

    def fit(
        self,
        key: int,
        steps: int = 1000,
        batch: int = 64,
        lr: float = 1e-3,
        sparsity_x: float = 0.1,
        sparsity_e: float = 0.1,
        nonneg_x: bool = False,
    ) -> "DLADMMSolver":
        """End-to-end supervised training on synthetic data drawn from
        this solver's dictionary with plain fp32 Adam; returns a NEW
        solver. ``key`` is an int seed: step i draws its batch from
        ``data.synthetic.step_generator(key, i)`` (the JAX package's
        ``fold_in(key, i)``). nonneg_x: nonnegative ground-truth x*
        (pairs with prox_x='nonneg_l1')."""
        from dladmm_tpu_torch.train.loop import adam, make_train_state, make_train_step

        forward_fn, step_fn, _ = self._paths(batch, training=True)
        optimizer = adam(lr)
        step = make_train_step(
            optimizer, self.A, batch, sparsity_x, sparsity_e, self.B, None, step_fn, forward_fn,
            nonneg_x=nonneg_x, seed=int(key),
        )
        state = make_train_state(self.params, optimizer)
        for i in range(steps):
            state, _ = step(state, i)
        return dataclasses.replace(self, params=state.params)


__all__ = ["DLADMMSolver"]
