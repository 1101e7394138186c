"""Deterministic synthetic sparse-coding data from seeded torch.Generators.

The port of ``dladmm_tpu/data/synthetic.py``:
  * Gaussian dictionary A ~ N(0, 1), column-normalized.
  * Sparse codes x*: Bernoulli(support) x Gaussian(values).
  * Sparse corruption e*: Bernoulli x Gaussian (impulse noise).
  * Observations b = A x* + e*   (the l1/l1 benchmark has B = I, z = e).

Draws come from CPU ``torch.Generator``s and the results are moved to
the requested device, so a seed gives the same data on the CPU and on
the card. ``torch.Generator`` and ``jax.random`` give different numbers
from the same seed: at one config seed the port's dictionary is not the
JAX package's (ROADMAP.md §3). Tests that compare the two packages pass
numpy arrays across instead.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import Tensor


class SyntheticBatch(NamedTuple):
    b: Tensor  # (S, m) observations
    x_star: Tensor  # (S, n) ground-truth sparse code
    # Ground-truth z stream: the sparse corruption e* (S, m) when B = I,
    # or the sparse code z* (S, d) under a general z-dictionary B.
    e_star: Tensor


def _generator(seq: np.random.SeedSequence) -> torch.Generator:
    return torch.Generator().manual_seed(int(seq.generate_state(1, np.uint64)[0] >> 1))


def seed_keys(config):
    """The config seed's canonical 3-way split as fresh CPU generators:
    (g_dict, g_eval, g_train). Generators are stateful, so every call
    returns new ones; problem_matrices takes g_dict, training evals and
    the serving CLI's --demo take g_eval (so their NMSEs compare), and
    training steps take ``step_generator``."""
    return tuple(
        _generator(s)
        for s in np.random.SeedSequence(config.train.seed).spawn(3)
    )


def step_generator(seed: int, *index: int) -> torch.Generator:
    """The generator of training step ``index`` (and microbatch, under
    accumulation): a child of g_train's seed, so the data of a step
    depends on (seed, step) alone and a resumed run draws what the cold
    run drew (the JAX package's ``fold_in(k_train, i)``)."""
    return _generator(np.random.SeedSequence(seed, spawn_key=(2, *index)))


def make_dictionary(
    gen: torch.Generator, m: int, n: int, dtype=torch.float32, device=None
) -> Tensor:
    """Gaussian dictionary with unit-norm columns."""
    A = torch.randn((m, n), generator=gen, dtype=dtype)
    A = A / torch.linalg.vector_norm(A, dim=0, keepdim=True)
    return A.to(device) if device is not None else A


def load_array_spec(spec: str):
    """Load a numpy array from ``file.npy`` or ``file.npz[:key]`` (npz
    default key: 'b' if present, else the first array)."""
    path, _, key = spec.partition(":")
    data = np.load(path)
    if isinstance(data, np.ndarray):
        return data
    return data[key or ("b" if "b" in data.files else data.files[0])]


def problem_matrices(config, A: Optional[Tensor] = None, device=None):
    """Derive the problem's fixed matrices (A, B) from the config seed.

    A comes from g_dict; the general z-dictionary B (identity_B=False)
    from a child of g_dict's seed, so A is the same as in the identity-B
    presets at that seed. Pass A to keep a caller-supplied dictionary
    while still deriving B. ``device`` is where A and B go (the CPU when
    None; the serving CLI passes its resolved device).
    """
    p, t = config.problem, config.train
    dtype = getattr(torch, t.dtype)
    dict_seq = np.random.SeedSequence(t.seed).spawn(3)[0]
    if A is None:
        A = make_dictionary(_generator(dict_seq), p.m, p.n, dtype, device)
    B = None
    if not getattr(p, "identity_B", True):
        B = make_dictionary(
            _generator(dict_seq.spawn(1)[0]), p.m, p.d or p.m, dtype, device
        )
    return A, B


def _to_device(t: Tensor, device) -> Tensor:
    """Host draw -> ``device``. To a card through pinned memory without
    waiting: the copy is ordered on the current stream, so a training
    step that draws its batch never stalls the host on the device."""
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _bernoulli_gaussian(gen, shape, sparsity: float, dtype) -> Tensor:
    """support ~ Bernoulli(sparsity), values ~ N(0, 1)."""
    support = torch.rand(shape, generator=gen) < sparsity
    vals = torch.randn(shape, generator=gen, dtype=dtype)
    return torch.where(support, vals, torch.zeros((), dtype=dtype))


def make_batch(
    gen: torch.Generator,
    A: Tensor,
    batch: int,
    sparsity_x: float = 0.1,
    sparsity_e: float = 0.1,
    dtype=torch.float32,
    B: Optional[Tensor] = None,
    nonneg_x: bool = False,
) -> SyntheticBatch:
    """One batch of (b, x*, e*) with b = A x* + e*, on A's device.

    With a general z-dictionary B (m, d) the z stream is a sparse code
    z* (batch, d) and b = A x* + B z*. nonneg_x=True folds x*'s values
    to |N(0,1)|.
    """
    m, n = A.shape
    x_star, e_star = draw_batch(gen, m, n, batch, sparsity_x, sparsity_e, dtype,
                                None if B is None else B.shape[1], nonneg_x)
    x_star, e_star = _to_device(x_star, A.device), _to_device(e_star, A.device)
    b = x_star @ A.T + (e_star if B is None else e_star @ B.T)
    return SyntheticBatch(b=b, x_star=x_star, e_star=e_star)


def draw_batch(
    gen: torch.Generator,
    m: int,
    n: int,
    batch: int,
    sparsity_x: float = 0.1,
    sparsity_e: float = 0.1,
    dtype=torch.float32,
    d: Optional[int] = None,
    nonneg_x: bool = False,
):
    """make_batch's draw, on the CPU: (x* (batch, n), e* (batch, d or m)),
    in that order from ``gen``. A tensor-parallel rank forms b from its own
    columns of A (parallel/multihost.rank_batch)."""
    x_star = _bernoulli_gaussian(gen, (batch, n), sparsity_x, dtype)
    if nonneg_x:
        x_star = torch.abs(x_star)
    return x_star, _bernoulli_gaussian(gen, (batch, d or m), sparsity_e, dtype)
