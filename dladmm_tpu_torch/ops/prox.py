"""Proximal-operator registry: general f/g instantiations of D-LADMM.

The port of ``dladmm_tpu/ops/prox.py``. Every operator has the
signature ``prox(u, theta) -> Tensor`` with theta the learned per-layer
threshold, clamped to >= 0 at use (as ops.reference.shrink).

  l1           prox of t*||w||_1                 sign(u) * max(|u|-t, 0)
  nonneg_l1    prox of t*||w||_1 + I(w >= 0)     max(u - t, 0)
  elastic_net  prox of t*||w||_1 + rho/2 ||w||^2 shrink(u, t) / (1 + rho)
  box          prox of I(|w_i| <= t_i)           clip(u, -t, t)
  group_l2     prox of t*||w||_2 (per sample)    u * max(1 - t/||u||_2, 0)

The four elementwise operators are templated into the CUDA whole-unroll
kernel (ops/csrc/unroll.cu); each carries a ``kernel_prox`` tag naming
its variant there. group_l2 needs a row reduction and stays off the
kernel (``kernel_exact`` is False for it, as in the JAX package), so
serving routes it to the plain loop.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import Tensor

from dladmm_tpu_torch.ops.reference import shrink

ProxFn = Callable[[Tensor, Tensor], Tensor]


def _clamp0(theta, like: Tensor) -> Tensor:
    return torch.clamp(torch.as_tensor(theta, dtype=like.dtype, device=like.device), min=0.0)


def prox_l1(u: Tensor, theta) -> Tensor:
    """Soft-threshold (= ops.reference.shrink)."""
    return shrink(u, theta)


def prox_nonneg_l1(u: Tensor, theta) -> Tensor:
    """One-sided shrink: prox of theta*||w||_1 + indicator(w >= 0)."""
    return torch.clamp(u - _clamp0(theta, u), min=0.0)


def prox_box(u: Tensor, theta) -> Tensor:
    """Projection onto the box [-theta, theta] (prox of its indicator)."""
    t = _clamp0(theta, u)
    return torch.minimum(torch.maximum(u, -t), t)


def prox_group_l2(u: Tensor, theta) -> Tensor:
    """Row-wise block soft-threshold: u * max(1 - theta/||u||_2, 0).

    The norm is over the feature axis (one group per sample). Safe norm
    as in the JAX package: zero rows go through sqrt(1) and then take
    the 0 branch, so autograd never sees sqrt's infinite slope at 0.
    """
    t = _clamp0(theta, u)
    sq = torch.sum(u * u, dim=-1, keepdim=True)
    pos = sq > 0.0
    norm = torch.sqrt(torch.where(pos, sq, torch.ones_like(sq)))
    scale = torch.where(
        pos, torch.clamp(1.0 - t / norm, min=0.0), torch.zeros_like(sq)
    )
    return u * scale


def make_prox_elastic_net(rho: float) -> ProxFn:
    """Prox of theta*||w||_1 + (rho/2)*||w||^2: shrink then 1/(1+rho)."""
    if rho < 0:
        raise ValueError(f"elastic_net rho must be >= 0, got {rho}")
    inv = 1.0 / (1.0 + rho)

    def prox(u: Tensor, theta) -> Tensor:
        return shrink(u, theta) * inv

    prox.kernel_prox = ("elastic_net", float(rho))
    return prox


# Kernel variants (ops/csrc/unroll.cu's Prox enum) of the elementwise
# operators. group_l2 has none: it stays on the plain loop.
prox_l1.kernel_prox = ("l1", 0.0)
prox_nonneg_l1.kernel_prox = ("nonneg_l1", 0.0)
prox_box.kernel_prox = ("box", 0.0)

_REGISTRY = {
    "l1": lambda rho: prox_l1,
    "nonneg_l1": lambda rho: prox_nonneg_l1,
    "elastic_net": make_prox_elastic_net,
    "box": lambda rho: prox_box,
    "group_l2": lambda rho: prox_group_l2,
}


def kernel_exact(prox_fn) -> bool:
    """True when the CUDA whole-unroll kernel has a variant of this prox
    (the four elementwise operators); False for group_l2 and for any
    callable the registry did not make."""
    return getattr(prox_fn, "kernel_prox", None) is not None


PROX_NAMES = tuple(sorted(_REGISTRY))


def get_prox(name: str, rho: float = 0.0) -> ProxFn:
    """Resolve a prox by registry name ('l1', 'nonneg_l1', 'elastic_net',
    'box', 'group_l2'). rho only affects 'elastic_net'."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown prox {name!r}; available: {', '.join(PROX_NAMES)}"
        ) from None
    return factory(rho)


def is_l1(prox_x: str, prox_z: str, rho: float = 0.0) -> bool:
    """True when the (prox_x, prox_z, rho) config is the reference l1/l1
    instantiation."""
    return (
        (prox_x == "l1" or (prox_x == "elastic_net" and rho == 0.0))
        and (prox_z == "l1" or (prox_z == "elastic_net" and rho == 0.0))
    )


def resolve_prox(p):
    """ProblemConfig -> (prox_x, prox_z) callables, or None for the
    reference l1/l1 instantiation (the JAX package keeps this in
    train/loop.py, which this slice does not port)."""
    px = getattr(p, "prox_x", "l1")
    pz = getattr(p, "prox_z", "l1")
    rho = getattr(p, "prox_rho", 0.0)
    if is_l1(px, pz, rho):
        return None
    return get_prox(px, rho), get_prox(pz, rho)


__all__ = [
    "ProxFn",
    "PROX_NAMES",
    "get_prox",
    "is_l1",
    "resolve_prox",
    "kernel_exact",
    "prox_l1",
    "prox_nonneg_l1",
    "prox_box",
    "prox_group_l2",
    "make_prox_elastic_net",
]
