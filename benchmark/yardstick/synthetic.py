"""The synthetic generator's arithmetic.

Frozen copy of ``dladmm_tpu_torch/data/synthetic.py`` at commit 376d358
(``_generator``, ``step_generator``, ``draw_batch``): the reference draws
a training step's batch again from the step's seed with these, and must
get the program's rows bit for bit. ``bernoulli_gaussian_on`` is the
same draw on a device generator, for the benchmark's own inputs.
"""

from __future__ import annotations

import numpy as np
import torch


def _generator(seq: np.random.SeedSequence) -> torch.Generator:
    return torch.Generator().manual_seed(int(seq.generate_state(1, np.uint64)[0] >> 1))


def step_generator(seed: int, *index: int) -> torch.Generator:
    """The CPU generator of training step ``index``."""
    return _generator(np.random.SeedSequence(seed, spawn_key=(2, *index)))


def _bernoulli_gaussian(gen, shape, sparsity: float, dtype) -> torch.Tensor:
    support = torch.rand(shape, generator=gen) < sparsity
    vals = torch.randn(shape, generator=gen, dtype=dtype)
    return torch.where(support, vals, torch.zeros((), dtype=dtype))


def draw_batch(gen, m: int, n: int, batch: int, sparsity_x: float = 0.1, sparsity_e: float = 0.1,
               dtype=torch.float32):
    """(x* (batch, n), e* (batch, m)) on the CPU, in that order from ``gen``
    (B = I)."""
    x_star = _bernoulli_gaussian(gen, (batch, n), sparsity_x, dtype)
    return x_star, _bernoulli_gaussian(gen, (batch, m), sparsity_e, dtype)


def bernoulli_gaussian_on(gen: torch.Generator, shape, sparsity: float) -> torch.Tensor:
    """support ~ Bernoulli(sparsity), values ~ N(0, 1), fp32, drawn on the
    generator's device."""
    support = torch.rand(shape, generator=gen, device=gen.device) < sparsity
    vals = torch.randn(shape, generator=gen, device=gen.device)
    return torch.where(support, vals, torch.zeros((), device=gen.device))
