"""Adam with int8 moments, global-norm clipping and the warmup-cosine
rate, in plain PyTorch.

The moments are stored as sqrt-companded int8: a leaf of >= 65536
elements whose last dim L has 128 <= L <= 1638 and >= 128 rows is kept
as (R, L) rows, each with its own absmax scale; every other leaf is
flattened, zero-padded and kept in blocks of 256 with one scale each.
A value y = x / scale is stored as round(127 sign(y) sqrt|y|) (half to
even) and read back as sign(c) c^2 scale with c = code / 127. The
update, per element, in fp32: g' = g s (s = min(1, clip / |g|), |g| the
norm over every leaf), mu = b1 mu + (1 - b1) g', nu = b2 nu +
(1 - b2) g'^2, p -= lr (mu / c1) / (sqrt(nu / c2) + eps), with c1, c2 the
bias corrections of the new count and lr the rate at the old one.
"""

from __future__ import annotations

import math

import torch

from benchmark.yardstick.roofline import leaf_eligible

B1, B2, EPS = 0.9, 0.999, 1e-8
BLOCK = 256


def warmup_cosine(count: int, peak: float, steps: int) -> float:
    """The rate at step ``count``: linear from 0 over max(1, steps // 20)
    steps, then a cosine to 0 at ``steps``; fp32 as the card computes it."""
    W = max(1, steps // 20)
    f = torch.float32
    c = torch.tensor(count, dtype=torch.int32)
    if count < W:
        frac = 1 - torch.clamp(c, 0, W).to(f) / torch.tensor(float(W), dtype=f)
        return float((0.0 - peak) * frac + peak)
    t = torch.clamp((c - W).to(f), max=float(steps - W))
    cosine = 0.5 * (1 + torch.cos(math.pi * t / torch.tensor(float(steps - W), dtype=f)))
    return float(peak * cosine)


def _codec(x, rows: bool):
    """(codes, scales) of x as rows (R, L) or flat 256-blocks."""
    blocks = x.reshape(-1, x.shape[-1]) if rows else torch.nn.functional.pad(
        x.reshape(-1), (0, (-x.numel()) % BLOCK)).reshape(-1, BLOCK)
    absmax = torch.amax(torch.abs(blocks), dim=1)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    y = blocks / scale[:, None]
    return torch.round(torch.sign(y) * torch.sqrt(torch.abs(y)) * 127.0).to(torch.int8), scale


def decode(codes, scale, shape, rows: bool):
    c = codes.to(torch.float32) * (1.0 / 127.0) if rows else codes.to(torch.float32) / 127.0
    y = torch.sign(c) * c * c * scale[:, None]
    return y.reshape(-1)[: math.prod(shape)].reshape(shape)


class Int8Adam:
    """The optimizer over a list of leaves; ``step`` updates them in place."""

    def __init__(self, params, lr: float, steps: int, clip: float):
        self.lr, self.steps, self.clip = lr, steps, clip
        self.count = 0
        self.rows = [leaf_eligible(tuple(p.shape)) for p in params]
        self.mu = [_codec(torch.zeros_like(p), r) for p, r in zip(params, self.rows)]
        self.nu = [_codec(torch.zeros_like(p), r) for p, r in zip(params, self.rows)]

    def moments(self, params):
        """The fp32 mu and nu each leaf's state holds."""
        return ([decode(*q, p.shape, r) for q, p, r in zip(self.mu, params, self.rows)],
                [decode(*q, p.shape, r) for q, p, r in zip(self.nu, params, self.rows)])

    @torch.no_grad()
    def step(self, params, grads):
        norm = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grads))
        s = min(1.0, self.clip / max(norm, 1e-16))
        lr = warmup_cosine(self.count, self.lr, self.steps)
        self.count += 1
        c1, c2 = 1.0 - B1 ** self.count, 1.0 - B2 ** self.count
        mus, nus = self.moments(params)
        for i, (p, g) in enumerate(zip(params, grads)):
            g = g * s
            mu = B1 * mus[i] + (1 - B1) * g
            nu = B2 * nus[i] + (1 - B2) * g * g
            p -= lr * ((mu / c1) / (torch.sqrt(nu / c2) + EPS))
            self.mu[i] = _codec(mu, self.rows[i])
            self.nu[i] = _codec(nu, self.rows[i])
