"""Adam with fp32 moments at a constant rate, in plain PyTorch, updating
its tensors in place: per element, mu = b1 mu + (1 - b1) g,
nu = b2 nu + (1 - b2) g^2, p -= lr (mu / c1) / (sqrt(nu / c2) + eps),
with c1, c2 the bias corrections of the new count (optax.adam, no clip).
Handed a layer's slice of each leaf at a time, it allocates that
slice's temporaries only."""

from __future__ import annotations

import torch

from benchmark.reference.optim import B1, B2, EPS


class Adam:
    """The optimizer over a list of tensors, its count at ``count``."""

    def __init__(self, params, lr: float, count: int = 0):
        self.lr, self.count = lr, count
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params, grads) -> None:
        self.count += 1
        c1, c2 = 1.0 - B1 ** self.count, 1.0 - B2 ** self.count
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            mu.mul_(B1).add_(g, alpha=1 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1 - B2)
            p.sub_(self.lr * (mu / c1) / (torch.sqrt(nu / c2) + EPS))
