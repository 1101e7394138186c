"""Typed configs + presets, one per BASELINE.json config entry (SURVEY.md N11).

The port's own copy of ``dladmm_tpu/utils/config.py``: the dataclasses
and ``PRESETS`` are kept field for field identical (pinned by
tests/test_torch_unroll.py), so a config name means the same problem in
both packages. Training-only fields (optimizer, moments, sharding) are
carried for that parity; the fields whose path is not ported yet
(sharding, fused_adam, the XLA-side moment formats) raise where they
are read (train/loop.py, run.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    m: int = 250
    n: int = 500
    K: int = 15  # unroll depth / layer count
    beta: float = 1.0
    sparsity_x: float = 0.1
    sparsity_e: float = 0.1
    identity_B: bool = True  # benchmark fast path B = I (SURVEY.md §2 point 4)
    # Width of the general z-dictionary B (m, d) when identity_B=False
    # (None = m). fit() builds B as its own Gaussian unit-column
    # dictionary and the data becomes b = A x* + B z*.
    d: Optional[int] = None
    # Proximal operators for the x / z updates (ops/prox.py registry:
    # l1 | nonneg_l1 | elastic_net | box | group_l2). The paper states
    # D-LADMM for general f/g; "l1"/"l1" is the reference benchmark
    # instantiation and the only pair the fused Pallas kernels + manual
    # reverse-scan VJP cover — any other pair trains through the XLA
    # scan + autodiff (train/loop.py routing).
    prox_x: str = "l1"
    prox_z: str = "l1"
    # elastic_net curvature rho (prox of theta*|.|_1 + rho/2 |.|^2).
    prox_rho: float = 0.0
    # Generator: fold x* values to |N(0,1)| so the ground truth is
    # nonnegative (pairs with prox_x="nonneg_l1").
    nonneg_x: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch: int = 64
    steps: int = 2000
    lr: float = 2e-4
    eval_every: int = 200
    eval_batch: int = 256
    seed: int = 0
    # Per-layer loss weighting (SURVEY.md §2 point 6): None = final-layer
    # MSE only; "uniform" = deep supervision, equal gamma_k; "linear" =
    # final-heavy ramp gamma_k ∝ k. Measured in BASELINE.md.
    layer_loss: Optional[str] = None
    # None = constant lr; "cosine" = linear warmup (5%) + cosine decay to 0.
    lr_schedule: Optional[str] = None
    # Global-norm gradient clipping; None = off. Long training runs of
    # unrolled solvers can go spectrally unstable without it (a large
    # step on W1/beta can push the layer map's Lipschitz constant > 1,
    # after which the forward blows up in one step).
    clip_norm: Optional[float] = None
    # How clip_norm is applied: "global" = optax.clip_by_global_norm
    # (two passes over the grads: norm, then scale+Adam); "delayed" =
    # scale step i by step i-1's global norm (train/loop.py
    # delayed_clip_by_global_norm) — single-pass, so XLA fuses the norm
    # reduction into the Adam update sweep, shaving HBM traffic in the
    # optimizer phase (VERDICT r2 #4; measured in BASELINE.md).
    clip_mode: str = "global"
    # {auto|megakernel|pallas|reference} (SURVEY.md §9.1; models/api.py)
    kernel: str = "auto"
    # "bfloat16" runs the unroll in bf16 with fp32 master params/optimizer
    # (mixed precision); "float32" is full precision. Matmul MXU passes
    # are bf16 either way (TPU default precision).
    compute_dtype: str = "float32"
    # DLADMMParams fields kept at their LADMM init (not trained), e.g.
    # ("beta",) for the paper's fixed-penalty variant.
    freeze: tuple = ()
    dtype: str = "float32"
    # Backprop through the unroll: "auto" = hand-written reverse-scan VJP
    # (ops/unroll_vjp.py) when it applies (B=I, final-layer loss),
    # "xla" = XLA autodiff, "manual" = require the manual path.
    vjp: str = "auto"
    # "adam" = optax Adam (+ clip per clip_mode); "fused_adam" = the
    # Adam update runs INSIDE the manual reverse-scan backward, one
    # layer at a time (train/fused_adam.py) — the grad stacks never
    # round-trip HBM and the optimizer traffic overlaps the backward's
    # MXU work. Composes with general B, bf16, deep supervision,
    # freeze, and DP sharding; requires the XLA-scan forward
    # (kernel="auto") and, if clip_norm is set, clip_mode="delayed"
    # (exact global clipping is two-pass and cannot fuse).
    optimizer: str = "adam"
    # Storage precision of the Adam moments (train/qmoments.py):
    # "float32" = plain optax.adam; "bfloat16" halves / "int8"
    # (blockwise-companded) quarters the moment HBM traffic of the
    # bandwidth-bound optimizer sweep (DESIGN.md §9 step decomposition);
    # "bfloat16_sr" adds stochastic rounding to the bf16 moment writes
    # (unbiased EMA — removes round-to-nearest truncation bias).
    # "float32_pallas" / "bfloat16_pallas" / "int8_pallas" apply the
    # whole optimizer (clip-scale, Adam, master update, bf16 copy) in a
    # one-HBM-pass fused Pallas kernel (train/qadam_pallas.py) — the
    # int8 storage needs this: the XLA requant chain doesn't fuse.
    # Masters stay fp32 and update math runs fp32 either way. Quality
    # deltas at the benchmark recipes are measured in BASELINE.md.
    moment_dtype: str = "float32"
    # Gradient accumulation: the EFFECTIVE batch stays `batch`; each
    # update scans accum_steps microbatches of batch/accum_steps rows,
    # accumulating fp32 grads — effective batches beyond HBM become
    # trainable (activations exist per-microbatch). Single-device fit
    # only (compose with DP by raising data_axis instead).
    accum_steps: int = 1


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    data_axis: int = 1  # DP degree (1 = off)
    model_axis: int = 1  # TP degree (1 = off)
    multihost: bool = False
    # TP weight layout (parallel/collectives.py): "sharded_w2" shards
    # every weight + Adam moment over 'model' (fits tp_large per-chip
    # HBM); "replicated_w2" is the round-1 one-collective-per-layer
    # layout (W2/moments replicated — only viable at small m).
    layout: str = "sharded_w2"
    # ZeRO-1 / cross-replica weight-update sharding on DP-only meshes
    # (model_axis == 1): reduce-scatter grads, Adam on each chip's 1/D
    # slice against its moment shard, all-gather the updated params —
    # per-chip optimizer HBM and update traffic drop by data_axis, and
    # clip_norm becomes the EXACT single-pass global clip
    # (parallel/collectives.make_dp_zero1_train_step; PAPERS.md).
    zero1: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    name: str
    problem: ProblemConfig
    train: TrainConfig
    sharding: ShardingConfig = ShardingConfig()


PRESETS = {
    # Seconds-long CPU sanity config: verify an install / smoke-test a
    # pipeline end-to-end (train -> eval -> checkpoint -> serve) before
    # paying for a real recipe. Not a benchmark shape.
    "smoke": Config(
        name="smoke",
        problem=ProblemConfig(m=32, n=64, K=4),
        train=TrainConfig(
            batch=16,
            steps=60,
            lr=1e-3,
            eval_every=30,
            eval_batch=64,
            layer_loss="uniform",
        ),
    ),
    # BASELINE.json:7 — CPU-runnable PR1 reference config. Defaults are
    # the measured-best quality recipe (BASELINE.md): 10k cosine steps,
    # clipped, DEEP SUPERVISION (round 2: -17.5 dB / residual 0.020 vs
    # -16.5 / 0.036 with the final-layer loss; LADMM is -10.8 at K=15);
    # ~1 s of device time.
    # moment_dtype="int8_pallas" shipped default since round 5: seed-
    # replicated quality parity with fp32 moments at BOTH synthetic
    # shapes (3 seeds each — BASELINE.md round-5 table) at 4x smaller
    # optimizer moment state and a slightly faster clipped step.
    "synthetic_small": Config(
        name="synthetic_small",
        problem=ProblemConfig(m=250, n=500, K=15),
        train=TrainConfig(
            batch=64,
            steps=10000,
            lr=1e-3,
            lr_schedule="cosine",
            clip_norm=1.0,
            eval_every=1000,
            layer_loss="uniform",
            moment_dtype="int8_pallas",
        ),
    ),
    # BASELINE.json:8 — single-chip MXU saturation case. Deep
    # supervision default (round 2): -23.8 dB / residual 0.017 vs
    # LADMM's -14.1 at K=20 (~2 min of device time).
    # NOTE: peak lr above ~2e-4 destabilizes the unroll at this shape
    # (the layer map goes spectrally unstable) — see BASELINE.md.
    "synthetic_large": Config(
        name="synthetic_large",
        problem=ProblemConfig(m=1000, n=2000, K=20),
        train=TrainConfig(
            batch=1024,
            steps=10000,
            lr=2e-4,
            lr_schedule="cosine",
            clip_norm=1.0,
            eval_every=1000,
            layer_loss="uniform",
            moment_dtype="int8_pallas",  # see synthetic_small note
        ),
    ),
    # General-constraint config: Ax + Bz = b with a NON-identity z
    # dictionary B (m, d) — both streams are sparse codes. Exercises the
    # general recurrence end-to-end (XLA-scan forward + manual general-B
    # reverse-scan VJP, general LADMM baseline/metrics). CPU-runnable;
    # kept small because the general path is API surface, not a
    # reference benchmark (both paper benchmarks are B = I).
    "synthetic_general_b": Config(
        name="synthetic_general_b",
        problem=ProblemConfig(m=100, n=200, K=10, identity_B=False, d=150),
        train=TrainConfig(
            batch=64,
            steps=3000,
            lr=1e-3,
            lr_schedule="cosine",
            clip_norm=1.0,
            eval_every=500,
            layer_loss="uniform",
        ),
    ),
    # Nonnegative sparse coding: prox_x = one-sided shrink (prox of
    # ||x||_1 + indicator(x >= 0)) with half-normal ground-truth x*.
    # Exercises the general-prox surface (ops/prox.py) end-to-end on a
    # CPU-runnable shape — the net and the LADMM comparison curve both
    # run the nonneg prox, so the quality bar is like-for-like.
    "synthetic_nonneg": Config(
        name="synthetic_nonneg",
        problem=ProblemConfig(
            m=100, n=200, K=10, prox_x="nonneg_l1", nonneg_x=True
        ),
        train=TrainConfig(
            batch=64,
            steps=3000,
            lr=1e-3,
            lr_schedule="cosine",
            clip_norm=1.0,
            eval_every=500,
            layer_loss="uniform",
        ),
    ),
    # General-B, DATA-PARALLEL sharded: the general recurrence is
    # embarrassingly parallel over the batch, so fit_sharded runs the
    # per-shard general-B manual VJP inside shard_map with one loss/grad
    # psum (TP stays identity-B-only — its collective algebra assumes
    # z in R^m). CPU/virtual-mesh-runnable like tp_small.
    "general_b_dp": Config(
        name="general_b_dp",
        problem=ProblemConfig(m=100, n=200, K=10, identity_B=False, d=150),
        train=TrainConfig(
            batch=128,
            steps=200,
            lr=1e-3,
            lr_schedule="cosine",
            clip_norm=1.0,
            eval_every=50,
            layer_loss="uniform",
        ),
        sharding=ShardingConfig(data_axis=4),
    ),
    # CPU/virtual-mesh-runnable sharded smoke config (same code path as
    # tp_large at shapes a laptop or the 8-device virtual mesh can run).
    "tp_small": Config(
        name="tp_small",
        problem=ProblemConfig(m=256, n=512, K=8),
        train=TrainConfig(batch=128, steps=200, eval_every=50),
        sharding=ShardingConfig(data_axis=4, model_axis=2),
    ),
    # BASELINE.json:10 — TP block-partitioned dictionary. fp32 at TP=4
    # fits a v5e's HBM only with the sharded_w2 layout (~13.2 GB/chip —
    # parallel/memory.py audits at startup; the round-1 replicated-W2
    # layout needed ~25 GB and is refused).
    "tp_large": Config(
        name="tp_large",
        problem=ProblemConfig(m=8192, n=16384, K=20),
        train=TrainConfig(batch=256),
        sharding=ShardingConfig(model_axis=4),
    ),
    # Same acceptance shape with the full mixed-precision stack composed
    # into the TP step (persistent sharded bf16 copy): needs TP=8 for
    # the extra copy+activation bytes (~7.7 GB/chip).
    "tp_large_bf16": Config(
        name="tp_large_bf16",
        problem=ProblemConfig(m=8192, n=16384, K=20),
        train=TrainConfig(batch=256, compute_dtype="bfloat16"),
        sharding=ShardingConfig(model_axis=8),
    ),
    # BASELINE.json:11 — multi-host scenario-batched training. DP-only
    # mesh, so each chip's shard runs the full single-chip perf stack
    # (manual VJP + persistent-bf16 mixed precision — round 2; quality
    # parity measured in BASELINE.md "Mixed precision").
    "multihost": Config(
        name="multihost",
        problem=ProblemConfig(m=1000, n=2000, K=20),
        train=TrainConfig(batch=65536, compute_dtype="bfloat16"),
        sharding=ShardingConfig(data_axis=8, multihost=True),
    ),
}


def get_config(name: str, **overrides) -> Config:
    if name not in PRESETS:
        raise KeyError(
            f"unknown config {name!r}; available: {sorted(PRESETS)}"
        )
    cfg = PRESETS[name]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
