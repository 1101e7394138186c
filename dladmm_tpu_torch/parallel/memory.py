"""Per-device memory audit and communication traffic model.

The port of ``dladmm_tpu/parallel/memory.py``: the same arithmetic, so
that an audit gives the JAX package's numbers for the same shapes
(tests/test_torch_memory.py). ``train/loop.fit_sharded`` runs
``audit_or_raise`` before it allocates anything, so a configuration that
does not fit fails with the memory math instead of an out-of-memory
error inside a step. ``step_traffic_bytes`` models the bytes a step's
collectives move per device (ring all-reduce 2(P-1)/P of the size,
all-gather and reduce-scatter (P-1)/P), the tensor-parallel rows
included.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# The JAX package's per-chip default: a TPU v5e's 16 GB of HBM. A TPU
# fact, kept only as the figure the CPU is audited against; on the card
# detect_hbm_bytes reads the device's own memory size.
DEFAULT_HBM_BYTES = 16e9
# Margin for temporaries, allocator slack and collective staging.
DEFAULT_HEADROOM = 0.10


def detect_hbm_bytes(device=None) -> float:
    """The memory of one device: ``total_memory`` of the CUDA device
    (``device``, default the current card), or DEFAULT_HBM_BYTES (the
    JAX package's TPU v5e figure) for the CPU. CLI callers override it
    with --hbm-gb (run.py -> fit_sharded(hbm_bytes=...))."""
    import torch

    dev = torch.device(device) if device is not None else None
    if dev is None:
        if not torch.cuda.is_available():
            return DEFAULT_HBM_BYTES
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type != "cuda":
        return DEFAULT_HBM_BYTES
    return float(torch.cuda.get_device_properties(dev).total_memory)


@dataclasses.dataclass(frozen=True)
class MemoryBreakdown:
    params: float  # fp32 masters, per device
    opt_moments: float  # Adam mu + nu, sharded like params
    compute_copy: float  # persistent low-precision copy (0 if fp32)
    dictionary: float  # A shard
    activations: float  # forward state + backward residuals estimate
    batch: float  # b, x_star, e_star shards

    @property
    def total(self) -> float:
        return (
            self.params
            + self.opt_moments
            + self.compute_copy
            + self.dictionary
            + self.activations
            + self.batch
        )

    def rows(self):
        return [
            ("params (fp32 masters)", self.params),
            ("Adam moments (2x)", self.opt_moments),
            ("compute-dtype copy", self.compute_copy),
            ("dictionary A shard", self.dictionary),
            ("activations + bwd residuals", self.activations),
            ("batch shards", self.batch),
        ]


def per_chip_bytes(
    m: int,
    n: int,
    K: int,
    batch: int,
    data_axis: int = 1,
    model_axis: int = 1,
    layout: str = "sharded_w2",
    dtype_bytes: int = 4,
    compute_dtype_bytes: Optional[int] = None,
    d: Optional[int] = None,
    opt_shard_degree: int = 1,
    moment_bytes: Optional[float] = None,
) -> MemoryBreakdown:
    """Bytes per device for one training step (d = m for B = I).

    Layouts: "sharded_w2" shards W1/theta1 over n and W2/theta2 over d
    along the model axis, "replicated_w2" keeps W2/theta2 whole; the
    moments follow their params. opt_shard_degree = data_axis under
    ZeRO-1 (each device keeps 1/D of the moments); moment_bytes is the
    stored moment's bytes an element (bf16 2, int8 about 1.02 with its
    scales). The activation term charges the carry entering each layer
    and the per-layer residual stacks (x S*n/T, z S*d, lam and Ax S*m,
    and 2 more S*m for u and v); m-sized state is charged in full."""
    d = m if d is None else d
    T, D = model_axis, data_axis
    S_l = max(1, batch // D)
    cb = compute_dtype_bytes or dtype_bytes

    w2_div = T if layout == "sharded_w2" else 1
    p_elems = (
        K * n * m / T  # W1
        + K * d * m / w2_div  # W2
        + K * n / T  # theta1
        + K * d / w2_div  # theta2
        + K  # beta
    )
    params = p_elems * dtype_bytes
    moments = (
        2 * p_elems * (moment_bytes or dtype_bytes)
        / max(1, opt_shard_degree)
    )
    copy = 0.0 if compute_dtype_bytes is None else p_elems * cb
    A_bytes = m * n / T * cb + (m * n / T * dtype_bytes if cb != dtype_bytes else 0)
    carry = S_l * (n / T + 2 * m + d) * cb
    acts = carry + K * S_l * (n / T + 4 * m + d) * cb
    batch_bytes = S_l * (m + d) * cb + S_l * n / T * cb  # b, z*, x* shards
    return MemoryBreakdown(
        params=params,
        opt_moments=moments,
        compute_copy=copy,
        dictionary=A_bytes,
        activations=acts,
        batch=batch_bytes,
    )


def audit_or_raise(
    m,
    n,
    K,
    batch,
    data_axis=1,
    model_axis=1,
    layout="sharded_w2",
    dtype_bytes=4,
    compute_dtype_bytes=None,
    hbm_bytes: float = DEFAULT_HBM_BYTES,
    headroom: float = DEFAULT_HEADROOM,
    print_fn=None,
    d=None,
    opt_shard_degree: int = 1,
    moment_bytes: Optional[float] = None,
) -> MemoryBreakdown:
    """Raise MemoryError unless the projected per-device footprint fits
    ``hbm_bytes`` less the headroom; return the breakdown, printed
    through print_fn when given. d: the width of a general B (default m)."""
    bd = per_chip_bytes(
        m,
        n,
        K,
        batch,
        data_axis,
        model_axis,
        layout,
        dtype_bytes,
        compute_dtype_bytes,
        d,
        opt_shard_degree,
        moment_bytes,
    )
    budget = hbm_bytes * (1 - headroom)
    if print_fn:
        for name, b in bd.rows():
            print_fn(f"  {name:<30} {b / 1e9:7.2f} GB")
        print_fn(
            f"  {'TOTAL per chip':<30} {bd.total / 1e9:7.2f} GB "
            f"(budget {budget / 1e9:.2f} GB = {hbm_bytes / 1e9:.0f} GB "
            f"- {headroom:.0%} headroom, layout={layout})"
        )
    if bd.total > budget:
        raise MemoryError(
            f"projected {bd.total / 1e9:.2f} GB/chip exceeds "
            f"{budget / 1e9:.2f} GB budget (HBM {hbm_bytes / 1e9:.0f} GB "
            f"- {headroom:.0%} headroom) for layout={layout}, mesh "
            f"{data_axis}x{model_axis}. Raise model_axis, shrink the "
            "batch, or use compute_dtype=bfloat16's smaller activations."
        )
    return bd


def step_traffic_bytes(
    m: int,
    n: int,
    K: int,
    batch: int,
    data_axis: int = 1,
    model_axis: int = 1,
    layout: str = "sharded_w2",
    dtype_bytes: int = 4,
    hosts: int = 1,
) -> dict:
    """Per-device bytes a training step moves, by collective.

    Tensor parallel, per layer: the psum of partial A products (S_l, m)
    (both layouts), the all-gather of z1's d-shard (sharded_w2), and
    their backward transposes. Data parallel: one all-reduce of the
    device's parameter shard per step; with the data axis outermost, only
    it crosses hosts."""
    T, D = model_axis, data_axis
    S_l = max(1, batch // D)
    f = dtype_bytes

    tp = {"psum_fwd": 0.0, "gather_fwd": 0.0, "bwd": 0.0}
    if T > 1:
        ring = (T - 1) / T
        psum_layer = 2 * ring * S_l * m * f
        tp["psum_fwd"] = K * psum_layer
        tp["bwd"] = K * psum_layer
        if layout == "sharded_w2":
            gather_layer = ring * S_l * m * f
            tp["gather_fwd"] = K * gather_layer
            tp["bwd"] += K * gather_layer  # reduce_scatter transpose

    grad_shard = per_chip_bytes(
        m, n, K, batch, D, T, layout, dtype_bytes
    ).params
    dp_allreduce = 2 * (D - 1) / D * grad_shard if D > 1 else 0.0

    ici_total = tp["psum_fwd"] + tp["gather_fwd"] + tp["bwd"]
    out = {
        "tp_ici_bytes_per_step": ici_total,
        "tp_detail": tp,
        "dp_grad_allreduce_bytes": dp_allreduce,
        "dp_crosses_dcn": hosts > 1 and D > 1,
        "layout": layout,
    }
    if hosts > 1 and D > 1:
        out["dcn_bytes_per_step"] = 2 * (hosts - 1) / hosts * grad_shard
    return out


__all__ = [
    "DEFAULT_HBM_BYTES",
    "DEFAULT_HEADROOM",
    "MemoryBreakdown",
    "audit_or_raise",
    "detect_hbm_bytes",
    "per_chip_bytes",
    "step_traffic_bytes",
]
