"""The cells' inputs, made from ``--seed`` on the device: the dictionary
A, the solver's parameters, and pools of observations b = A x* + e*.

Every draw has its own stream, a child of the seed
(``numpy.random.SeedSequence(seed, spawn_key=(purpose,))``), so one seed
gives the same inputs whatever else a run draws, and the program gets
only the tensors and arrays made here.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.yardstick.synthetic import bernoulli_gaussian_on

DICT, PARAMS, POOL, ORDER, SAMPLE = 1, 2, 3, 4, 5


def child(seed: int, purpose: int) -> int:
    return int(np.random.SeedSequence(int(seed), spawn_key=(purpose,)).generate_state(1, np.uint64)[0] >> 1)


def generator(seed: int, purpose: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(child(seed, purpose))


def rng(seed: int, purpose: int) -> np.random.Generator:
    return np.random.default_rng(child(seed, purpose))


def dictionary(cfg: dict, seed: int, device) -> torch.Tensor:
    """A (m, n): Gaussian, unit-norm columns."""
    g = generator(seed, DICT, device)
    A = torch.randn((cfg["m"], cfg["n"]), generator=g, device=device)
    return A / torch.linalg.vector_norm(A, dim=0, keepdim=True)


def parameters(cfg: dict, A: torch.Tensor, seed: int) -> tuple:
    """(W1 (K, n, m), W2 (K, m, m), theta1 (K, n), theta2 (K, m), beta (K,)):
    the LADMM initialisation of A (W1 = A^T / L, W2 = I, theta1 = 1 / (beta L),
    theta2 = 1 / beta, beta = cfg's, L = |A|_2^2), every layer perturbed
    on its own by cfg["init"] (relative Gaussian noise on W1, Gaussian
    noise of spectral size ~2 w2_noise on W2, log-normal factors on the
    thresholds and beta), so the layers are untied as after training."""
    m, n, K, beta0 = cfg["m"], cfg["n"], cfg["K"], cfg["beta"]
    init = cfg["init"]
    dev = A.device
    g = generator(seed, PARAMS, dev)
    L = float(torch.linalg.svdvals(A)[0]) ** 2
    W1_0 = A.T / L
    W1 = W1_0 + init["w1_noise"] * float(W1_0.std()) * torch.randn((K, n, m), generator=g, device=dev)
    W2 = torch.eye(m, device=dev) + (init["w2_noise"] / m ** 0.5) * torch.randn((K, m, m), generator=g, device=dev)
    beta = beta0 * torch.exp(init["beta_log_sd"] * torch.randn((K,), generator=g, device=dev))
    th1 = torch.exp(init["theta_log_sd"] * torch.randn((K, n), generator=g, device=dev)) / (beta0 * L)
    th2 = torch.exp(init["theta_log_sd"] * torch.randn((K, m), generator=g, device=dev)) / beta0
    return tuple(t.contiguous() for t in (W1, W2, th1, th2, beta))


def observations(cfg: dict, A: torch.Tensor, seed: int, rows: int) -> torch.Tensor:
    """b (rows, m) = A x* + e* on A's device, x* and e* Bernoulli-Gaussian at
    cfg's sparsities (B = I). fp32 products with TF32 off."""
    g = generator(seed, POOL, A.device)
    x = bernoulli_gaussian_on(g, (rows, cfg["n"]), cfg["sparsity_x"])
    e = bernoulli_gaussian_on(g, (rows, cfg["m"]), cfg["sparsity_e"])
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return x @ A.T + e
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
