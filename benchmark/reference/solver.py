"""The K-layer D-LADMM unroll (l1/l1, B = I) and its training losses.

Xie et al., "Differentiable Linearized ADMM", ICML 2019, Eq. 8-10, for
min |x|_1 + |z|_1 s.t. Ax + z = b, with learned per-layer W1 (n, m),
W2 (m, m), thresholds theta1 (n,), theta2 (m,) and penalty beta:

    u      = A x + z - b + lam / beta
    x+     = shrink(x - W1 u, theta1)
    v      = A x+ + z - b + lam / beta
    z+     = shrink(z - W2 v, theta2)
    lam+   = lam + beta (A x+ + z+ - b)

from x = z = lam = 0. Thresholds are clamped at 0 and beta at 1e-6 where
used. Rows are batch-first; a matrix M is applied as ``v @ M.T``.
"""

from __future__ import annotations

import torch

BETA_MIN = 1e-6


def shrink(u, theta):
    zero = u.new_zeros(())
    return torch.sign(u) * torch.maximum(torch.abs(u) - torch.maximum(theta, zero), zero)


def unroll(params, A, b, trajectory: bool = False):
    """params = (W1 (K, n, m), W2 (K, m, m), theta1 (K, n), theta2 (K, m),
    beta (K,)); b (S, m). Returns (x, z, lam) after K layers, or with
    ``trajectory`` the (K, S, .) stacks of x and z."""
    W1, W2, th1, th2, beta = params
    S, m = b.shape
    n = A.shape[1]
    x = b.new_zeros((S, n))
    z = b.new_zeros((S, m))
    lam = b.new_zeros((S, m))
    xs, zs = [], []
    for k in range(W1.shape[0]):
        bk = torch.maximum(beta[k], beta.new_tensor(BETA_MIN))
        base = z - b + lam / bk
        x = shrink(x - (x @ A.T + base) @ W1[k].T, th1[k])
        ax = x @ A.T
        z = shrink(z - (ax + base) @ W2[k].T, th2[k])
        lam = lam + bk * (ax + z - b)
        if trajectory:
            xs.append(x)
            zs.append(z)
    if trajectory:
        return torch.stack(xs), torch.stack(zs)
    return x, z, lam


@torch.no_grad()
def solve_rows(params, A, b, block: int = 4096):
    """(x, z) of every row of b, in blocks of ``block`` rows."""
    xs, zs = [], []
    for i in range(0, b.shape[0], block):
        x, z, _ = unroll(params, A, b[i:i + block])
        xs.append(x)
        zs.append(z)
    return torch.cat(xs), torch.cat(zs)


def loss(params, A, b, x_star, e_star, layer_loss=None):
    """Mean squared error to the ground truth: of the final layer
    (``layer_loss`` None), or "uniform" deep supervision, 1/K of each
    layer's error."""
    if layer_loss is None:
        x, z, _ = unroll(params, A, b)
        return torch.mean((x - x_star) ** 2) + torch.mean((z - e_star) ** 2)
    if layer_loss != "uniform":
        raise ValueError(f"layer_loss {layer_loss!r}: None or 'uniform'")
    tx, tz = unroll(params, A, b, trajectory=True)
    K = tx.shape[0]
    per_layer = torch.mean((tx - x_star) ** 2, dim=(1, 2)) + torch.mean((tz - e_star) ** 2, dim=(1, 2))
    return torch.sum(per_layer) / K


def loss_and_grads(params, A, b, x_star, e_star, layer_loss=None):
    leaves = [p.detach().clone().requires_grad_() for p in params]
    value = loss(leaves, A, b, x_star, e_star, layer_loss)
    grads = torch.autograd.grad(value, leaves)
    return value.detach(), [g.detach() for g in grads]
