#!/usr/bin/env python3
"""Hardware smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``dladmm_tpu_torch``, no JAX) on the card and fails on
the first fault. Each phase prints one JSON line:

  1. device: the card, its power limit (nvidia-smi), TF32 switched off;
  2. build: nvcc builds every source of ops/csrc/ from the checkout, one
     nvcc per source, all started together (timed, ptxas report);
  3. kernel: the CUDA whole-unroll kernel (one persistent cooperative
     launch, ``unroll_persistent``) against its plain PyTorch version on
     the same inputs (perturbed LADMM-exact params) at synthetic_small
     (S = 1, 13, 64, 256 for l1/l1; nonneg_l1, box and elastic_net(0.3)
     as prox_x, then as prox_z, at S = 64; (K, 1) thresholds) and
     synthetic_large (S = 1024, K = 20) on the tile the plan picks and on
     the other; fails above 1e-4 * max(1, max|ref|); a second call must
     repeat bit for bit; the grid, tile, work items and barriers of each;
  4. slice: the serving CLI (``serve.main --config=synthetic_small
     --import-torch <LADMM-exact .pt> --demo 256``), then an
     InferenceServer with buckets up to 256 on requests of 1, 7, 64 and
     200 rows and 8 concurrent BatchingServer submits. Each of the two
     paths (CLI; servers) counts its kernel launches from 0 and reads
     them just after it ran, before any check re-solves; both must be
     > 0. The served NMSE must equal the port's classical LADMM at
     K = 15 within 0.01 dB (the LADMM-exact init makes them the same
     function);
  5. timing: median CUDA-event time of one solve, kernel and plain
     version in turns, beside the bound from the shapes, the host's
     enqueue and the plan; at synthetic_large S = 1024 also the kernel
     on the other tile, in the same turns, and the device time of both;
  6. profile: torch.profiler device time per kernel and the device's
     busy share, at the main path's shape (synthetic_small, S = 256);
  7. kernel_traj: the trajectory kernel (one persistent cooperative
     launch) against its plain version at synthetic_small S = 64, 256,
     3000 and synthetic_large S = 1024, with the Ax stack and without,
     same tolerance as phase 3; a second call must repeat bit for bit;
     its grid, work items per phase and barriers at each shape;
  8. kernel_int8: the int8 Adam sweep against its plain version on the
     W1 and W2 leaves of both presets, 3 chained steps in place from a
     non-zero state: masters within rtol 1e-6, codes within one step,
     dequantized moments within one code step; then kernel_step: the
     optimizer step ``adam_step`` (prologue + one sweep over all five
     leaves, per-row and flat-256 codecs) against ``adam_step_plain`` at
     both presets, 3 chained steps (check_step: scalars within 2 ulp,
     each step equal to the one-leaf sweeps run with its scalars, a
     second step repeating bit for bit);
  9. grads: one deep-supervision loss at synthetic_small S = 64, the
     kernel path (trajectory kernel + manual backward) against autograd
     through the plain loop, within 2e-5 of each leaf's largest gradient;
 10. slice_train: the training CLI ``run.main(["--config=synthetic_small",
     "--steps=300", "--ckpt-dir", tmp])``, both training kernels' counts
     set to 0 just before and read just after (both must be > 0), route
     cuda-trajectory-kernel, finite loss, final NMSE below LADMM's at
     K = 15, the optimizer step's count (``adam_step``) two a step; then ``serve.main --ckpt-dir tmp --demo 256`` serves the
     checkpoint at the trained run's final eval NMSE within 0.01 dB;
 11. timing_train: median CUDA-event ms of one training step by phase,
     kernel path and plain path in turns; each training kernel's ms
     beside its bound and its plain version's: the int8 step
     (timing_step: adam_step on the five leaves, its prologue's and
     sweep's device time each beside its bound, the host's enqueue), the
     one-leaf sweep on W1 + W2 and at synthetic_large (device time beside
     the bound), the trajectory kernel at
     synthetic_small S = 64, 256 and synthetic_large S = 1024 with its
     profiler device time, grid, work items per phase and barriers; the
     cost of one grid barrier at 132, 264 and 528 blocks;
 12. profile_train: torch.profiler over training steps at synthetic_small:
     device time per kernel, per phase (forward, backward loop,
     optimizer) and the busy share; the optimizer phase must hold the
     prologue and the sweep, once each a step, and no other device
     operation;
 13. kernel_bwd: the wave of the weight-gradient launch (its resident
     blocks a SM x SMs) that bwd_chunk_batch splits by; the backward
     kernel against its plain version on the
     trajectory kernel's stacks, with and without data grads, at
     synthetic_small S = 64 (whole batch; also (K, 1) thresholds with
     ties at theta = 0 and beta = 1e-6), S = 1024 with the policy's bs
     (the whole batch) and with bs = 128, synthetic_large S = 1024 and
     the smoke preset at S = 1024 (the chunked route's main path); fails
     above 2e-5 * max|leaf of the plain version|; a second call must
     repeat bit for bit;
 14. kernel_dense: the dense Adam sweep against its plain version on the
     W1 and W2 leaves of both presets in all four formats, 3 chained
     steps in place: masters within rtol 1e-6, round-to-nearest moments
     equal, SR moments a bf16 neighbour of the fp32 moment; SR unbiased
     over 64 seeds; then kernel_step (phase 8's check_step) for the four
     dense formats on all five leaves;
 15. slice_train_final: ``run.main(["--config=synthetic_small",
     "--layer-loss=none", "--moment-dtype=float32_pallas", "--steps=1000",
     "--ckpt-dir", tmp])`` with the trajectory, backward and optimizer-step
     counts set to 0 just before and read just after (each > 0; the step
     two a step), route
     cuda-whole-unroll-kernel, NMSE below LADMM's; its checkpoint served
     at its last eval's NMSE within 0.01 dB; then 20 steps at
     ``--batch=1024`` on the route bwd_chunk_batch picks (the whole
     batch at synthetic_small), and 20 steps of the smoke preset at
     ``--batch=1024``, whose chunked-route count must be > 0. (1000
     steps, not 300: after 300 steps of its cosine schedule the
     final-layer loss is still above LADMM in both packages, e.g. the
     JAX package's -9.96 dB against LADMM's -10.79 dB on the CPU);
 16. timing_train_final: median CUDA-event ms of a final-layer step by
     phase, in turns: the kernel path, the path before the backward
     kernel (trajectory kernel + plain reverse sweep) and the plain
     path; each new kernel beside its bound and its plain version, the
     dense steps (timing_step, fp32 and bf16 on the five leaves, fp32
     also beside torch.optim.Adam(fused=True) on them) and the one-leaf
     sweeps on W1 + W2; the backward
     with its profiler device time, grid, work items per phase and
     barriers at synthetic_small S = 64 and 1024 (both routes) and at
     the smoke preset's S = 1024 (both routes: the split the policy
     makes there, against the whole batch); the grid and work items are
     those the wrapper launched with (``last_plan``);
 17. profile_train_final: device time per phase and kernel, busy share;
     the optimizer phase held to the prologue and the dense sweep as in
     phase 12;
 18. kernel_int8_unroll: the int8 whole-unroll kernel (one persistent
     cooperative launch, ``int8_persistent``) against its plain version on
     the same quantized inputs (perturbed LADMM-exact params, a zero row)
     at synthetic_small S = 1, 13, 64, 256, 1024 and synthetic_large
     S = 1024 with K = 20: expected bit for bit, fails above
     1e-5 * max(1, max|ref|), prints the count of elements that differ
     and the plan (grid, tile, items, depth slices, barriers); a second
     call must repeat bit for bit, and a profiled solve must hold the one
     port kernel and no other device operation but a counters' memset;
 19. slice_serve_int8: ``serve.main --dtype=int8 --demo 256`` with
     --kernel=megakernel and auto, on the phase-10 checkpoint and on the
     LADMM-exact .pt, the int8 kernel's count set to 0 before and read
     after each (> 0), route cuda-int8-unroll-kernel, NMSE within 0.3 dB
     of the fp32 serve of the same requests; then an int8 InferenceServer
     (buckets up to 256) on 1, 7, 64 and 200 rows and 8 concurrent
     BatchingServer submits, counted the same way. Its answers equal the
     kernel route's plain version on the same rows within 1e-5 *
     max(1, max|ref|) and are within 1% relative Frobenius difference of
     the reference route (the scan's operation order, whose int8 codes
     differ somewhere at this shape: ROADMAP.md §3);
 20. kernel_layer: ``dladmm_forward(step_fn=fused_layer_step)`` against the
     plain loop and the whole-unroll kernel at synthetic_small S = 64, 256,
     3000 and synthetic_large S = 1024, tolerance TOL, a second forward
     bit for bit; the bf16-operand mode within 5% relative Frobenius
     error of the plain loop; the layer step's plan at each;
 21. train_layer: 20 final-layer steps at synthetic_small batch 64 through
     ``make_train_step(step_fn=fused_layer_step)``, the layer step's count
     from 0 (> 0), finite losses; one step's gradient within 2e-5 of each
     leaf's largest value of autograd through the plain loop;
 22. timing_serve_int8 / timing_layer: CUDA-event median ms of the int8
     kernel at synthetic_small S = 64, 256, 1024 and synthetic_large
     S = 1024, each with its profiler device time (one kernel a solve),
     host enqueue and plan, and of the layer step (one call, and the
     K-layer loop beside the plain loop and the whole-unroll kernel) at
     S = 256, each beside its plain version and bound; profiler device
     time of each, the layer step's host enqueue and plan;
 23. kernel_bf16: how far another summation order moves the bf16 plain
     version on the card (float64 products against cuBLAS, as measured
     on the CPU for BF16_TOL_ULPS); the bf16-storage serving kernel
     against its plain version (``unroll_forward_plain_bf16``: fp32
     arithmetic, each layer's stored state rounded to bf16) at
     synthetic_small S = 1, 13, 64, 256, 1024 on both tiles, S = 64 with
     nonneg_l1, box and elastic_net(0.3) as prox_x and as prox_z and with
     (K, 1) thresholds, synthetic_large S = 1024 (K = 20) on the plan's
     tile: each output within BF16_TOL_ULPS bf16 ulps of its largest
     magnitude, with the count of elements that differ; a second call
     bit for bit; the plan of each; the layer step on bf16 state at
     S = 256 (with and without bf16 operands) likewise, and its K-layer
     loop, counted from 0, equal to the whole-unroll kernel bit for bit;
 24. slice_bf16: ``serve.main --dtype=bfloat16 --demo 256`` on the
     LADMM-exact .pt and on the phase-10 checkpoint, the kernel's count
     from 0 around each bf16 run (> 0), route
     cuda-whole-unroll-bf16-kernel, x within 0.05 max|x| of the fp32
     serve of the same requests and NMSE within 0.05 dB (LADMM-exact) or
     0.25 dB (checkpoint) of it; then a bf16 InferenceServer (buckets up
     to 256) on 1, 7, 64 and 200 rows and 8 concurrent BatchingServer
     submits, counted the same way, held against the plain version and
     per-request solves;
 25. timing_bf16: CUDA-event median ms, profiler device time, host
     enqueue and plan of one bf16 and one fp32 solve in turns (and the
     bf16 plain version) at synthetic_small S = 64, 256, 1024 and
     synthetic_large S = 1024, each beside its bound; one layer step on
     bf16 state at S = 256 beside its plain version and the fp32 step;
 26. kernel_traj_bf16: the bf16 trajectory kernel (``traj_persistent`` on
     bf16 storage: the state fp32 between phases and layers, only the
     stack stores rounded) against ``trajectory_forward_plain_bf16`` at
     synthetic_small S = 64, 256 and synthetic_large S = 1024, with the Ax
     stack and without: each stack within TRAJ16_TOL_ULPS = 1 bf16 ulp of
     its largest magnitude, with the elements that differ; a second call
     bit for bit; launches counted apart from fp32's; the plan;
 27. kernel_bwd_bf16: the bf16 backward against ``unroll_bwd_plain_bf16``
     on the bf16 trajectory kernel's stacks, with and without data grads:
     synthetic_small S = 64 (whole batch; also (K, 1) thresholds with ties
     at theta = 0 and beta = 1e-6), S = 1024 with bs = 128, and the smoke
     preset at S = 1024 (the chunked route): each gradient within
     BWD16_TOL_ULPS = 2 bf16 ulps of its leaf's largest magnitude; a second
     call bit for bit;
 28. kernel_step_bf16: ``adam_step`` on bf16 gradients with the bf16
     compute copy, int8 and the four dense formats, both presets' five
     leaves, 3 chained steps: the state equal to the one-leaf sweeps' run
     on the widened gradients, held against the plain version as in
     phases 8 and 14, the copy equal bit for bit to the kernel's new master
     rounded, the clip scale within 2^-7 of step_scalars';
 29. slice_train_bf16: ``fit`` on synthetic_small with
     compute_dtype="bfloat16" (its forward from models/api.select_forward,
     as run.py builds it), recipe (a) (final-layer loss, float32_pallas,
     constant 2e-4, 600 steps) and (b) (the shipped recipe: deep
     supervision, int8_pallas, clip 1.0, cosine; 300 steps), each beside
     its fp32 twin on the same seed; every training kernel's count from 0
     around each run (each bf16 kernel of the path > 0, no fp32 training
     kernel but the eval's trajectory on the fp32 masters); (a) on the
     smoke preset at batch 1024 (the chunked route); finite losses, the
     final NMSE within 0.1 dB (a) / 0.2 dB (b) of fp32, (a) below LADMM at
     K = 15; the bf16 (a) checkpoint served at its last eval's NMSE within
     0.01 dB;
 30. timing_train_bf16: a step by phase, bf16 and fp32 in turns, (a) and
     (b) at synthetic_small batch 64 and (a) at synthetic_large batch
     1024; each bf16 kernel (trajectory and backward at synthetic_small
     S = 64 and synthetic_large S = 1024, the chunked backward, the step on
     bf16 gradients) beside its fp32 twin in turns: ms, profiler device µs
     (events where the profiler records nothing), its bound (2-byte
     storage) and its plain version; the optimizer phase of bf16 steps held
     to the prologue and one sweep a step;
 31. kernel_patch: rows 1, 2, 4 and 5 at the image benchmark's shape
     (m = 64, n = 256, the DCT dictionary; b the median-DC residuals of
     impulse-corrupted patches) at K = 15 and 8, S = 225, 961 and 3844
     (no multiple of the 32 or 64 tile): the whole-unroll and trajectory
     kernels within TOL of their plain versions, the backward within
     BWD_TOL on the route bwd_chunk_batch picks, on the whole batch and on
     forced slices of 128 rows; a second call bit for bit; each plan;
 32. slice_denoise: ``run_denoise.main`` (a) the full DCT run (400 steps,
     four 128 x 128 images, density 0.1), (b) --dict=learned, (c)
     --mode=inpaint --quick --density=0.3, (d) --layer-loss=uniform
     --quick, (e) --quick --save, then --load --input-image on a saved
     corrupted image (bit for bit with the in-process denoise_image);
     each path's kernels counted from 0 (each > 0, the backward on the
     policy's route, the optimizer step never); the mean PSNR gain over
     the CLI's test stream (its three images and the next, 200 in all)
     at least 28.3 (a), 28.7 (b) and 14.9 dB (c), observed pixels exact;
 33. slice_solver: DLADMMSolver on synthetic_small's dictionary: the
     untrained solve at LADMM's NMSE within 0.01 dB, nmse_curve and
     trajectory through the trajectory kernel, fit (300 steps at lr 1e-4)
     through the trajectory and backward kernels lowering the last layer's
     NMSE (its default lr's 300-step NMSE reported beside), a
     nonneg_l1 solve through the prox variant; each call counted from 0;
 34. slice_train_xla_moments: ``run --config=synthetic_small --steps=1000``
     with int8_pallas, int8, bfloat16 and bfloat16_sr (each XLA-side
     format within 0.2 dB of int8_pallas and below LADMM), bfloat16 with
     --clip-mode=delayed, ``fit`` in bf16 compute with bfloat16 moments,
     and int8 resumed from its step-500 checkpoint equal bit for bit to
     the uninterrupted run; counted from 0;
 35. timing_denoise: a train_denoiser step at S = 3844 by phase (CUDA
     events, profiler device µs by phase); rows 1, 2, 4 and 5 at the patch
     shape beside their plain versions and bounds; the optimizer phase of
     phase 34's steps (device µs, launches a step) for each XLA-side
     format beside int8_pallas;

 36. slice_train_fused: ``run --config=synthetic_small
     --optimizer=fused_adam --clip-mode=delayed --moment-dtype=float32
     --steps=1000`` (Adam inside the reverse sweep, plain PyTorch) beside
     the same run on the optax chain, counted from 0: NMSE within
     FUSED_NMSE_DB (0.05 dB) of each other, both below LADMM; ``fit`` with
     the fused optimizer in bf16 compute (300 steps) below LADMM; a run
     resumed from its step-100 checkpoint bit for bit;
     timing_train_fused: both steps' ms (in turns), device µs and device
     launches a step;
 37. kernel_greedy: rows 2 and 4 at depths K = 1, 2, 3 (S = 64 and 1024
     with bs = 128) against their plain versions, a second call bit for
     bit, their times at S = 64; slice_train_greedy: ``run
     --config=synthetic_small --greedy --steps=1000``, the kernels counted
     from 0 in every stage (the trajectory and backward kernels and the
     int8 step once a step), below LADMM;
 38. slice_dp: fit_sharded on synthetic_small over 2 gloo ranks sharing
     the card and over 1 NCCL rank (this script's ``--dp-worker``, one
     process a rank): the replicated step (int8 sweep), ZeRO-1 (the dense
     sweep on each rank's (rows, 256) slice, the exact clip) and the DP
     fused step, 3 steps each from a perturbed LADMM init against the
     single-process global-batch fit (losses rtol 1e-5; one NCCL rank bit
     for bit), each 2-rank step's params against the single-process step
     from the same state (rtol 5e-5 / atol 1e-6, int8 1e-3 * lr, outside
     Adam's eps region), the kernels counted on every rank; timing_dp:
     the DP step's ms beside the single-process step's;
 39. slice_general_b_dp: ``run --config=general_b_dp`` on its 4 gloo ranks
     (200 steps), below general LADMM;
 40. detect_hbm_bytes on the card; slice_multihost: the multihost preset at
     its shape (batch 65536 in bf16 over 8 ranks), 2 steps, where
     fit_sharded's audit passes with the card shared by the 8 ranks
     (else printed and skipped);
     slice_serve_sharded: ``serve --sharded --ckpt-dir`` (phase 36's
     checkpoint) in float32, bfloat16 and int8 at the unsharded serve's
     NMSE within 0.01 dB, and a ShardedInferenceServer of two parts on the
     card against InferenceServer (TOL; bf16 BF16_TOL_ULPS), counted from 0;
 41. slice_tp_parity: tensor parallelism at tp_small's shape (m = 256,
     n = 512, K = 8, batch 128) from a perturbed LADMM init on 4 gloo
     ranks sharing the card (``--dp-worker``), as 2x2 and 1x4, in both
     layouts: the gathered forward at TOL, the eval within 1e-4, every
     leaf's gradient within TP_GRAD_TOL of its scale and the losses at
     TP_LOSS_RTOL (bf16 with beta frozen: the JAX package's bf16 bound),
     each against the single-process plain path on the card;
 42. slice_tp_small: ``run --config=tp_small`` on its 8 ranks (200 steps):
     the last eval below the first and within TP_NMSE_DB of the
     single-process fit; resumed from its step-100 checkpoint within
     TP_RESUME_DB; the TP step's ms on each rank and its share in
     collectives;
 43. slice_tp_large: tp_large at full width on its 4 ranks: the audit with
     the card shared, the gathered sharded_forward of the LADMM init
     against the plain loop (TOL), ``run --config=tp_large --steps=2``
     (finite loss; each rank's peak memory beside the audit) and the
     step's ms; then tp_large_bf16 on 8 ranks for one step where its
     audit passes (else printed, reported as not run). The TP path
     launches no kernel (its products are torch.matmul);
 44. bench_timing: bench/timing.time_chained on row 1 at synthetic_small
     S = 256 (strict: the UNCALIBRATED fallback fails), beside the
     CUDA-event median and the profiler's device time;
 45. bench_roofline: ``bench.roofline.main`` at its three shapes, the plain
     loop and row 1 at each: every fraction at most 1.05, row 1's launches
     from 0 > 0;
 46. bench_serving: ``bench.serving.main --dtype=all --prox=nonneg_l1``
     (paper shape) and ``--shape=flagship --dtype=float32``: finite
     latencies, throughput = bucket / latency, rows 1, 1 bf16, 7 and 1
     with a prox each launched from 0 > 0 times;
 47. bench_profile_step: ``capture`` and ``summarize`` of the shipped,
     fused and qadam_int8 steps (12 each, synthetic_large batch 1024, bf16
     compute), in a process of their own (``--profile-worker``): each
     summary names its step's kernels, and each kernel's launches in the
     trace equal its wrapper's count;
 48. bench_comm / bench_scaling: ``bench.comm_model.main`` for every sharded
     preset; ``measure_dp_scaling`` at synthetic_small on 1 NCCL rank and
     on 2 gloo ranks sharing the card (under harness_validation_only), the
     kernels counted on rank 0;
 49. examples / profiling: ``python -m dladmm_tpu_torch.examples.quickstart``
     and ``.distributed`` on the card, each printing its line;
     ``utils/profiling.trace`` around one row-1 solve (in a process of
     its own) holds the kernel once; ``enable_nan_debug`` raises on ``torch.log(-x)`` and on a NaN row
     fed to row 1 (the wrapper's check), and is silent once off;

each with its wall time (bench_wall); then the kernels line, each entry
with ``launches_bench`` (its launches by phases 44-49; empty on the
``_patch`` and ``_greedy`` entries, whose shapes and depths no bench path
ran), and, last, the
ok line. Exits non-zero, with no
ok line, on any failure, when CUDA is not available, or when run
without the rest of the repository.

    python3 chip_smoke.py --sharded

builds every source and runs only phases 36-40, then their kernels
entries (rows 2 and 4 at greedy's depths, with every new path's
launches).

    python3 chip_smoke.py --tp

builds every source and runs only phases 41-43, then the ok line.

    python3 chip_smoke.py --bench

builds every source and runs only phases 44-49, then their launches and
the ok line.

    python3 chip_smoke.py --int8-turns

times only the int8 kernel as phase 22 does (no plain version), with
the ``dladmm_tpu_torch`` beside this file: a copy of this file in a
checkout of another commit times that commit's kernel, so that two
commits can be timed in turns on one card.

    python3 chip_smoke.py --bf16-turns

runs only phase 25: bf16 and fp32 serving (and the layer step) in
turns.

    python3 chip_smoke.py --bf16-train

builds every source and runs only phases 26-30 (bf16 training).

    python3 chip_smoke.py --denoise

builds every source and runs only phases 31-35 (the image benchmark, the
solver and the XLA-side moment formats), then their kernels entries.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

try:
    from dladmm_tpu_torch.bench.roofline import (
        STEP_SHAPES,
        _bound,
        bf16_bound,
        bf16_layer_bound,
        bound,
        bwd_bound,
        dense_bound,
        int8_bound,
        int8_serve_bound,
        layer_bound,
        step_bounds,
        traj_bound,
    )
    from dladmm_tpu_torch.bench.timing import median_ms
    from dladmm_tpu_torch.utils.profiling import (
        IncompleteProfile,
        back_to_back_ms,
        device_kernels,
        kernel_name,
        profile_fn,
        profile_marker,
        retry_incomplete,
    )
except ImportError as exc:  # this file alone, without the repository beside it
    print(f"chip_smoke: {exc}; run it from a checkout of the repository", file=sys.stderr)
    sys.exit(2)

TOL = 1e-4  # kernel vs plain: max|diff| <= TOL * max(1, max|ref|)
NMSE_TOL_DB = 0.01
SMALL = dict(m=250, n=500, K=15)  # synthetic_small (utils/config.py)
LARGE = dict(m=1000, n=2000, K=20)  # synthetic_large
SMOKE = dict(m=32, n=64, K=4)  # smoke: the chunked backward's main path at batch 1024


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def problem(torch, m: int, n: int, K: int, S: int, seed: int, device):
    """A, b and perturbed LADMM-exact params on the card. The
    perturbation is 0.05 N(0,1) scaled by each leaf's RMS, so every
    weight moves off the init while the unroll stays as stable as
    LADMM's (an absolute 0.05 grows x by orders of magnitude at these
    widths)."""
    from dladmm_tpu_torch.data.synthetic import make_batch, make_dictionary
    from dladmm_tpu_torch.models.unroll import DLADMMParams, init_dladmm_params

    g = torch.Generator().manual_seed(seed)
    A = make_dictionary(g, m, n)
    b = make_batch(g, A, S).b
    p0 = init_dladmm_params(A, K=K)
    leaves = [
        leaf + 0.05 * torch.randn(leaf.shape, generator=g) * leaf.pow(2).mean().sqrt()
        for leaf in p0
    ]
    return A.to(device), b.to(device), DLADMMParams(*leaves).to(device)


def compare(torch, got, want, label: str, names=("x", "z", "lam"), phase="kernel") -> float:
    if len(got) != len(want) or len(got) != len(names):
        raise AssertionError(f"{label}: {len(got)} outputs, plain version {len(want)}")
    errs = {}
    for name, k, p in zip(names, got, want):
        if not torch.isfinite(k).all():
            raise AssertionError(f"{label}: kernel {name} is not finite")
        err = float((k - p).abs().max())
        scale = max(1.0, float(p.abs().max()))
        errs[name] = err
        if not err <= TOL * scale:
            raise AssertionError(
                f"{label}: {name} max|diff| {err} > {TOL} * {scale}"
            )
    emit(phase, case=label, max_abs_err=errs)
    return max(errs.values())


def profile_unroll(torch, unroll_forward, S: int, m: int, n: int, K: int, reps: int = 5):
    """profile_fn over ``reps`` whole-unroll solves (the rest of the
    window is launch gaps)."""
    A, b, p = problem(torch, m=m, n=n, K=K, S=S, seed=11, device=torch.device("cuda", 0))
    return profile_fn(lambda: unroll_forward(b, A, *p), f"m={m} n={n} K={K} S={S}", reps)


def time_from(prof: dict) -> dict:
    """{"device_time_from": why} where profile_fn fell back to CUDA
    events, else {}."""
    return {k: prof[k] for k in ("device_time_from",) if k in prof}


def device_us(fn, config: str, prefix: str = "", **kw) -> dict:
    """{prefix + "device_us_per_call": µs} from profile_fn with its events
    fallback, and, where the profiler recorded nothing and back-to-back
    CUDA events gave the time, {prefix + "device_time_from": why}: the
    fields a report line carries."""
    prof = profile_fn(fn, config, events_fallback=True, **kw)
    return {prefix + k: v for k, v in ({"device_us_per_call": prof["device_us_per_call"]} | time_from(prof)).items()}


def launched_plan(wrapper, barriers=None) -> dict:
    """How the last launch of a persistent kernel's wrapper
    (``unroll_forward``, ``layer_step``, ``trajectory_forward`` or
    ``unroll_bwd``, which keep the plan they launched with in
    ``last_plan``) spread on this card: its grid (blocks of the
    cooperative launch), tile edge, the work items (tiles x depth slices)
    of each phase, its grid barriers; for the backward also the items of
    its weight-gradient launch (all K layers' gW1 and gW2 tiles x S
    slices). ``barriers``: the kernel's rule for its barriers from K
    (``schedule.barriers`` by default; the int8 kernel's is
    ``schedule.int8_barriers``)."""
    from dladmm_tpu_torch.ops import schedule

    occ, grid, splits, last = wrapper.last_plan
    if isinstance(last, int):  # the trajectory: K
        K, extra = last, {}
    else:  # the backward: its WeightSplit
        K = last.K
        extra = {"weight_launch_items": last.items, "weight_launch_s_slices": last.slices,
                 "launches_per_call": 3}
    return {"grid": grid, "resident_blocks_per_sm": occ[0], "sms": occ[1],
            "tile": next(iter(splits.values())).tile,
            "items_per_phase": {k: sp.items for k, sp in splits.items()},
            "tiles_per_phase": {k: sp.tiles for k, sp in splits.items()},
            "depth_slices_per_phase": {k: sp.slices for k, sp in splits.items()},
            "barriers_per_call": (barriers or schedule.barriers)(K), **extra}


@contextlib.contextmanager
def serve_tile(tile: int):
    """The serving kernel's wrappers launch the ``tile`` kernel inside,
    whatever ops/schedule.serve_tile would choose (the tile comparison)."""
    from dladmm_tpu_torch.ops import schedule

    plan = schedule.serve_plan
    schedule.serve_plan = lambda *a: schedule.make_serve_plan(*a, tile=tile)
    try:
        yield
    finally:
        schedule.serve_plan = plan


def host_enqueue_us(torch, fn, calls: int = 50) -> float:
    """Host µs a call of fn takes to return (its enqueue), over back-to-
    back calls that the card runs behind it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def barrier_cost(torch, card: str) -> dict:
    """Phase 11: the cost of one grid barrier of a cooperative launch
    (cooperative_groups' grid sync) at the grids the persistent kernels
    use: the median time of 1001 barriers less that of 1, over 1000; and
    the CUDA-event time of one launch with 1 barrier, from an idle card."""
    import ctypes

    from dladmm_tpu_torch.ops import cuda_build
    from dladmm_tpu_torch.ops.cuda_unroll import SRC

    fn = cuda_build.entry(SRC, "dladmm_grid_barrier_probe", [ctypes.c_int] * 3 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream

    def run(grid, iters):
        cuda_build.check(SRC, fn(grid, iters, 0, stream), "grid barrier probe")

    us, launch_ms = {}, {}
    for grid in (132, 264, 528):
        run(grid, 1001)
        launch_ms[grid], many = median_ms([lambda: run(grid, 1), lambda: run(grid, 1001)], 11)
        us[grid] = (many - launch_ms[grid]) / 1000 * 1e3
    emit("barrier_cost", us_per_barrier_by_grid=us, one_launch_ms_by_grid=launch_ms, card=card)
    return us


# The int8 sweep's leaves, (R, L) views: W1 (K, n, m) and W2 (K, m, m).
INT8_LEAVES = {
    "synthetic_small": [(15 * 500, 250), (15 * 250, 250)],
    "synthetic_large": [(20 * 2000, 1000), (20 * 1000, 1000)],
}


def int8_state(torch, tqa, R: int, L: int, seed: int, device):
    """A master, non-zero per-row int8 moments and 3 gradients."""
    g = torch.Generator(device=device).manual_seed(seed)
    rand = lambda scale: scale * torch.randn((R, L), generator=g, device=device)  # noqa: E731
    master = rand(0.05)
    mu = tqa.quantize_rows(rand(1e-2))
    nu = tqa.quantize_rows(rand(3e-2) ** 2)
    return master, mu, nu, [rand(1e-2) for _ in range(3)]


def check_int8(torch, tqa, device) -> float:
    """Phase 8: kernel and plain version, 3 chained in-place steps."""
    max_err = 0.0
    for config, leaves in INT8_LEAVES.items():
        for name, (R, L) in zip(("W1", "W2"), leaves):
            master, mu, nu, grads = int8_state(torch, tqa, R, L, seed=R + L, device=device)
            ref = (master.clone(), tqa.QTensor(mu.codes.clone(), mu.scale.clone()),
                   tqa.QTensor(nu.codes.clone(), nu.scale.clone()))
            for i, grad in enumerate(grads):
                cf = float(i + 2)
                scal = torch.tensor([1 - 0.9 ** cf, 1 - 0.999 ** cf, 1e-3, 0.8], device=device)
                tqa.adam_int8_rows(grad, master, mu, nu, scal)
                tqa.adam_int8_rows_plain(grad, *ref, scal)
            torch.cuda.synchronize()
            err = float((master - ref[0]).abs().max())
            if not (master - ref[0]).abs().le(1e-6 * ref[0].abs() + 1e-9).all():
                raise AssertionError(f"int8 sweep {config} {name}: master max|diff| {err}")
            detail = {"master_max_abs_err": err}
            for mname, got, want in (("mu", mu, ref[1]), ("nu", nu, ref[2])):
                code_diff = int((got.codes.int() - want.codes.int()).abs().max())
                if code_diff > 1:
                    raise AssertionError(f"int8 sweep {config} {name} {mname}: codes differ by {code_diff}")
                if not torch.allclose(got.scale, want.scale, rtol=1e-6, atol=0):
                    raise AssertionError(f"int8 sweep {config} {name} {mname}: scales differ")
                step = (2 * 127 + 1) / 127**2 * torch.maximum(got.scale, want.scale)[:, None]
                deq = (tqa.dequantize_rows(got) - tqa.dequantize_rows(want)).abs()
                if not deq.le(step * (1 + 1e-6)).all():
                    raise AssertionError(f"int8 sweep {config} {name} {mname}: more than one code step apart")
                detail[f"{mname}_max_code_diff"] = code_diff
                detail[f"{mname}_max_dequant_err"] = float(deq.max())
            emit("kernel_int8", case=f"{config} {name} R={R} L={L}", steps=3, **detail)
            max_err = max(max_err, err)
    return max_err


# -- the optimizer step: prologue + one sweep over every leaf (adam_step) -----


def check_step(torch, tqa, device, fmts) -> float:
    """Phases 8 and 14: adam_step (prologue + one sweep) on the five leaves
    of synthetic_small and synthetic_large, 3 chained steps with the
    warmup-cosine rate and clip 1.0. Each step: the scalars within 2 ulp of
    step_scalars', the count and seeds equal; the state equal to the
    one-leaf sweeps' run with the kernel's scalars from the state before it
    (step_checks.check_against_one_leaf: masters and moments bit for bit,
    SR too; the flat int8 leaves, which the one-leaf path sweeps with the
    plain version, within one code step); and held against the plain
    version's step from that state (step_checks.plain_step_diff). A second
    first step from the same state repeats bit for bit. Returns the
    largest master difference from the plain version."""
    from dladmm_tpu_torch.train import step_checks as sc

    max_err = 0.0
    sched = tqa.WarmupCosine(0.0, 1e-2, 2, 40)
    for fmt in fmts:
        for config, shapes in STEP_SHAPES.items():
            params, mu, nu, grads = sc.step_state(shapes, fmt, seed=len(config) + len(fmt), device=device)
            again = sc.clone_state(params, mu, nu)
            count = torch.tensor(1, dtype=torch.int32, device=device)
            detail = {"scal_max_ulps": 0, "clipped": [], "plain": []}
            for step, g in enumerate(grads):
                label = f"step {fmt} {config} {step}"
                pre = sc.clone_state(params, mu, nu)
                old = count
                count, scal, seeds = tqa.adam_step(g, params, mu, nu, count, fmt, sched, 1.0)
                pscal, pcount = tqa.step_scalars(g, old, sched, 1.0)
                pseeds = tqa.step_seeds(pcount, fmt, len(shapes))
                one = sc.clone_state(*pre)
                sc.one_leaf_step(fmt, g, *one, scal, seeds)
                if step == 0:
                    tqa.adam_step(g, *again, old, fmt, sched, 1.0)
                torch.cuda.synchronize()
                ulps = sc.scal_ulps(scal, pscal)
                if not torch.equal(count, pcount) or int(count) != int(old) + 1 or ulps > 2:
                    raise AssertionError(f"{label}: count {int(count)}, scal {scal.tolist()} "
                                         f"vs plain {pscal.tolist()} ({ulps} ulps)")
                if seeds is not None and not torch.equal(seeds, pseeds):
                    raise AssertionError(f"{label}: seeds differ")
                sc.check_against_one_leaf(fmt, (params, mu, nu), one, label)
                if step == 0 and not sc.same_state((params, mu, nu), again):
                    raise AssertionError(f"{label}: a second step from the same state differs")
                plain = sc.plain_step_diff(fmt, g, pre, (params, mu, nu), scal, seeds, label)
                detail["scal_max_ulps"] = max(detail["scal_max_ulps"], ulps)
                detail["clipped"].append(float(scal[3]) < 1.0)
                detail["plain"].append(plain)
                max_err = max(max_err, plain["master_max_abs_err"])
                del pre, one
            emit("kernel_step", case=f"{fmt} {config} five leaves", steps=3, repeats_bit_for_bit=True, **detail)
            del params, mu, nu, grads, again
    return max_err


def check_grads(torch, device):
    """Phase 9: the deep-supervision gradient through the kernels against
    autograd through the plain loop, synthetic_small S = 64."""
    from dladmm_tpu_torch.data.synthetic import make_batch
    from dladmm_tpu_torch.models.unroll import DLADMMParams, dladmm_forward
    from dladmm_tpu_torch.ops.cuda_traj import make_unrolled_trajectory
    from dladmm_tpu_torch.train.loop import _layer_weights, weighted_trajectory_mse

    A, b, p = problem(torch, S=64, seed=9, device=device, **SMALL)
    data = make_batch(torch.Generator().manual_seed(9), A, 64)
    w = _layer_weights("uniform", SMALL["K"], device=device)
    grads = []
    for kernel in (True, False):
        leaves = [t.detach().clone().requires_grad_() for t in p]
        q = DLADMMParams(*leaves)
        if kernel:
            tx, tz, _ = make_unrolled_trajectory()(q, A, data.b)
        else:
            _, (tx, tz, _) = dladmm_forward(q, A, data.b, capture_trajectory=True)
        loss = weighted_trajectory_mse(tx, tz, data.x_star, data.e_star, w)
        grads.append(torch.autograd.grad(loss, leaves))
    torch.cuda.synchronize()
    errs = {}
    for name, g, want in zip(DLADMMParams._fields, *grads):
        scale = float(want.abs().max())
        err = float((g - want).abs().max())
        if not (g - want).abs().le(2e-5 * want.abs() + 2e-5 * scale).all():
            raise AssertionError(f"grad {name}: max|diff| {err}, scale {scale}")
        errs[name] = {"max_abs_err": err, "scale": scale}
    emit("grads", case="synthetic_small S=64 deep supervision", grads=errs)


def train_slice(torch, device, unroll_forward, tmp):
    """Phase 10: the training CLI on the card, its checkpoint written to
    ``tmp`` (phase 19 serves it again), then serving it. Returns the
    launch counts of the training run and of the serving."""
    from dladmm_tpu_torch.ops import cuda_traj
    from dladmm_tpu_torch.run import main as run_main
    from dladmm_tpu_torch.serve import main as serve_main
    from dladmm_tpu_torch.train import qadam_cuda

    log = Path(tmp) / "log.jsonl"
    out = io.StringIO()
    cuda_traj.trajectory_forward.launches = 0
    qadam_cuda.adam_step.launches = 0
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = run_main(["--config=synthetic_small", "--steps=300", "--ckpt-dir", tmp,
                       "--log-jsonl", str(log)])
    wall = time.monotonic() - t0
    launches = {"trajectory_forward": cuda_traj.trajectory_forward.launches,
                "adam_step": qadam_cuda.adam_step.launches}
    if rc != 0:
        raise AssertionError(f"run.main returned {rc}")
    lines = out.getvalue().splitlines()
    summary = json.loads([ln for ln in lines if ln.startswith("{")][-1])
    record = json.loads(log.read_text().splitlines()[-1])
    if summary["route"] != "cuda-trajectory-kernel" or min(launches.values()) < 1:
        raise AssertionError(f"training did not go through both kernels: {summary['route']!r}, {launches}")
    if launches["adam_step"] != 2 * 300:
        raise AssertionError(f"the optimizer launched {launches['adam_step']} kernels in 300 steps, not 2 a step")
    if not (math.isfinite(record["loss"]) and math.isfinite(summary["final_nmse_db"])):
        raise AssertionError(f"training diverged: {record}")
    if not summary["final_nmse_db"] < summary["ladmm_nmse_db_at_K"]:
        raise AssertionError(f"trained NMSE {summary['final_nmse_db']} does not beat LADMM {summary['ladmm_nmse_db_at_K']}")
    emit("slice_train", summary=summary, last_record=record, launches=launches, wall_s=wall,
         table=[ln for ln in lines if ln[:5].strip().isdigit()])

    out = io.StringIO()
    unroll_forward.launches = 0
    with contextlib.redirect_stdout(out):
        rc = serve_main(["--config=synthetic_small", "--ckpt-dir", tmp, "--demo", "256"])
    serve_launches = unroll_forward.launches
    served = json.loads(out.getvalue().strip().splitlines()[-1])
    if rc != 0 or served["route"] != "cuda-whole-unroll-kernel" or serve_launches < 1:
        raise AssertionError(f"serving the checkpoint: rc {rc}, route {served['route']!r}, {serve_launches} launches")
    if not abs(served["nmse_db"] - summary["final_nmse_db"]) <= NMSE_TOL_DB:
        raise AssertionError(f"served NMSE {served['nmse_db']} dB != trained {summary['final_nmse_db']} dB")
    emit("slice_train_serve", serve=served, trained_nmse_db=summary["final_nmse_db"], launches=serve_launches)
    return launches, serve_launches


def train_setup(torch, device):
    """synthetic_small's training step pieces on the card, from the LADMM
    init: the dictionary, the deep-supervision weights, the kernel
    forward, the int8 optimizer and a fresh state."""
    from dladmm_tpu_torch.data.synthetic import problem_matrices
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.ops.cuda_traj import make_unrolled_trajectory
    from dladmm_tpu_torch.train.loop import _build_optimizer, _layer_weights, make_train_state
    from dladmm_tpu_torch.utils.config import get_config

    cfg = get_config("synthetic_small")
    A, _ = problem_matrices(cfg, device=device)
    opt = _build_optimizer(cfg.train)
    state = make_train_state(init_dladmm_params(A, K=cfg.problem.K), opt)
    return cfg, A, _layer_weights("uniform", cfg.problem.K, device=device), make_unrolled_trajectory(), opt, state


PHASES = ("data", "forward", "backward", "optimizer")


class ProfiledPhases:
    """phased_step's ``mark`` for a profile: each phase runs inside a
    ``phase.<name>`` record_function range that ends after a device sync,
    so every kernel of a phase, launched from any thread (the backward
    runs on autograd's device thread), starts inside its phase's range."""

    def __init__(self, torch):
        self.torch = torch
        self.open = None

    def __call__(self, k: int) -> None:
        from torch.profiler import record_function

        if self.open is not None:
            self.torch.cuda.synchronize()
            self.open.__exit__(None, None, None)
            self.open = None
        if k < len(PHASES):
            self.open = record_function(f"phase.{PHASES[k]}")
            self.open.__enter__()


def phased_step(torch, A, w, fwd, opt, state, i, plain=False, mark=None):
    """One training step of train/loop.make_train_step (batch 64 from
    step_generator(0, i), deep supervision, int8 optimizer), split into
    data, forward, backward and optimizer; ``mark(k)`` is called at the
    start of phase k and ``mark(4)`` at the end (CUDA events, or
    ProfiledPhases). plain=True runs the plain counterpart: autograd
    through the plain loop and the optimizer's functional plain path
    (QAdamFused.update); an optimizer without a fused step (the XLA-side
    moment formats, train/qmoments.py) takes its functional path always."""
    from dladmm_tpu_torch.data.synthetic import make_batch, step_generator
    from dladmm_tpu_torch.models.unroll import DLADMMParams, dladmm_forward
    from dladmm_tpu_torch.train.loop import TrainState, apply_updates, weighted_trajectory_mse

    mark = mark or (lambda k: None)
    mark(0)
    data = make_batch(step_generator(0, i), A, 64)
    leaves = [p.detach().requires_grad_() for p in state.params]
    q = DLADMMParams(*leaves)
    mark(1)
    if plain:
        _, (tx, tz, _) = dladmm_forward(q, A, data.b, capture_trajectory=True)
    else:
        tx, tz, _ = fwd(q, A, data.b)
    loss = weighted_trajectory_mse(tx, tz, data.x_star, data.e_star, w)
    mark(2)
    grads = DLADMMParams(*torch.autograd.grad(loss, leaves))
    mark(3)
    if plain or not hasattr(opt, "fused_apply"):
        with torch.no_grad():
            updates, opt_state = opt.update(grads, state.opt_state, state.params)
            params = apply_updates(state.params, updates)
    else:
        params, opt_state, _ = opt.fused_apply(grads, state.opt_state, state.params)
    mark(4)
    return TrainState(params, opt_state, state.step + 1), loss


def time_train(torch, device, card):
    """Phase 11: one training step, kernel and plain paths in turns, and
    each training kernel beside its bound and its plain version."""
    from dladmm_tpu_torch.ops.cuda_traj import trajectory_forward, trajectory_forward_plain
    from dladmm_tpu_torch.train import qadam_cuda as tqa

    cfg, A, w, fwd, opt, state = train_setup(torch, device)
    states = {"kernel": state, "plain": train_setup(torch, device)[-1]}
    phases = {k: [] for k in states}
    walls = {k: [] for k in states}
    for rep in range(24):
        for kind in (("kernel", "plain") if rep % 2 == 0 else ("plain", "kernel")):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[kind], _ = phased_step(torch, A, w, fwd, opt, states[kind], rep,
                                          plain=kind == "plain", mark=lambda k: ev[k].record())
            ev[4].synchronize()
            walls[kind].append((time.perf_counter() - t0) * 1e3)
            if rep >= 4:  # warm-up
                phases[kind].append([ev[j].elapsed_time(ev[j + 1]) for j in range(4)])
    step = {}
    for kind in states:
        arr = np.array(phases[kind])
        step[kind] = {
            "step_ms": float(np.median(arr.sum(axis=1))),
            "host_wall_ms": float(np.median(walls[kind][4:])),
            "data_ms": float(np.median(arr[:, 0])), "forward_ms": float(np.median(arr[:, 1])),
            "backward_ms": float(np.median(arr[:, 2])), "optimizer_ms": float(np.median(arr[:, 3])),
        }
    emit("timing_train", config="synthetic_small batch 64 deep supervision int8", step=step, steps=20, card=card)

    timings, plans = {}, {}
    with torch.no_grad():
        for label, shape, S, reps in (("synthetic_small", SMALL, 64, 31), ("synthetic_small", SMALL, 256, 21),
                                      ("synthetic_large", LARGE, 1024, 5)):
            A_, b, p = problem(torch, S=S, seed=21, device=device, **shape)
            fns = [lambda: trajectory_forward(b, A_, *p, with_tax=True),
                   lambda: trajectory_forward_plain(b, A_, *p, with_tax=True)]
            for _ in range(2):
                for fn in fns:
                    fn()
            ms, plain_ms = median_ms(fns, reps)
            bms, by = traj_bound(S, with_tax=True, **shape)
            prof = profile_fn(fns[0], f"{label} S={S} with_tax")
            enqueue_us = host_enqueue_us(torch, fns[0])
            plan = launched_plan(trajectory_forward)
            if S == 64:
                timings["trajectory_forward"] = (ms, plain_ms, bms, by)
                plans["trajectory_forward"] = plan
            emit("timing_train_kernel", kernel="trajectory_forward", config=f"{label} S={S} with_tax",
                 kernel_ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                 device_us_per_call=prof["device_us_per_call"], device_kernels=prof["per_call"],
                 host_enqueue_us=enqueue_us, **plan, card=card)
            del A_, b, p, fns

    leaves = INT8_LEAVES["synthetic_small"]
    st = [int8_state(torch, tqa, R, L, seed=R, device=device) for R, L in leaves]
    pl = [(m_.clone(), tqa.QTensor(mu.codes.clone(), mu.scale.clone()),
           tqa.QTensor(nu.codes.clone(), nu.scale.clone()), g) for m_, mu, nu, g in st]
    scal = torch.tensor([0.5, 0.05, 1e-3, 0.9], device=device)

    def sweep(plain):
        for master, mu, nu, grads in (pl if plain else st):
            fn = tqa.adam_int8_rows_plain if plain else tqa.adam_int8_rows
            fn(grads[0], master, mu, nu, scal)

    ms, plain_ms = median_ms([lambda: sweep(False), lambda: sweep(True)], 31)
    bms, by = int8_bound(leaves)
    emit("timing_train_kernel", kernel="adam_int8_rows", config="synthetic_small W1+W2 (2 one-leaf launches)",
         kernel_ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
         **device_us(lambda: sweep(False), "int8 W1+W2"), card=card)
    for R, L in INT8_LEAVES["synthetic_large"]:
        master, mu, nu, grads = int8_state(torch, tqa, R, L, seed=R, device=device)
        fn = lambda: tqa.adam_int8_rows(grads[0], master, mu, nu, scal)  # noqa: E731
        ms_l = median_ms([fn], 11)[0]
        bms_l = int8_bound([(R, L)])[0]
        dev = device_us(fn, f"synthetic_large R={R} L={L}")
        emit("timing_train_kernel", kernel="adam_int8_rows", config=f"synthetic_large R={R} L={L} (one launch)",
             kernel_ms=ms_l, **dev, bound_ms=bms_l, bound_by="bytes",
             device_share_of_bound=bms_l * 1e3 / dev["device_us_per_call"], card=card)
        del master, mu, nu, grads
    timings["adam_step@int8"] = time_step(torch, tqa, device, card, "int8")
    return step, timings, plans


def time_step(torch, tqa, device, card, fmt: str, library: bool = False) -> dict:
    """adam_step on synthetic_small's five leaves (the recipe's rate and
    clip) beside adam_step_plain and, with ``library``, one
    torch.optim.Adam(fused=True) step on the same five leaves, in turns;
    then the profiler's device time of the prologue and of the sweep, each
    beside its bound, and the host's enqueue. Returns the kernels line's
    numbers: bound_ms is the step's one-pass bound (step_bounds "step");
    the two launches' own bound stands beside it."""
    from dladmm_tpu_torch.train import step_checks as sc

    shapes = STEP_SHAPES["synthetic_small"]
    params, mu, nu, grads = sc.step_state(shapes, fmt, seed=41, device=device)
    plain = sc.clone_state(params, mu, nu)
    sched = tqa.WarmupCosine(0.0, 1e-2, 15, 300)
    count = torch.tensor(20, dtype=torch.int32, device=device)
    fns = [lambda: tqa.adam_step(grads[0], params, mu, nu, count, fmt, sched, 1.0),
           lambda: tqa.adam_step_plain(grads[0], *plain, count, fmt, sched, 1.0)]
    if library:
        ps = [torch.nn.Parameter(p.clone()) for p in params]
        for prm, g in zip(ps, grads[0]):
            prm.grad = g.clone()
        opt = torch.optim.Adam(ps, lr=1e-3, fused=True)
        fns.append(opt.step)
    for fn in fns:
        fn()
    times = median_ms(fns, 31)
    bounds = step_bounds(shapes, fmt)
    warm = profile_fn(fns[0], f"adam_step {fmt} synthetic_small five leaves")
    # Cold: each step after writing 128 MB, so that its leaves come from
    # device memory, as in a training step, and not from the 50 MB L2.
    flush = torch.empty(32 << 20, device=device)
    cold = profile_fn(lambda: (flush.zero_(), fns[0]()), f"adam_step {fmt} after an L2 flush")
    out = {"ms": times[0], "plain_ms": times[1], "library_ms": times[2] if library else None,
           "bound_ms": bounds["step"][0], "bound_by": bounds["step"][1],
           "two_launches_bound_ms": bounds["two_launches"][0],
           "host_enqueue_us": host_enqueue_us(torch, fns[0]), "elements": bounds["elements"]}
    for label, prof in (("warm", warm), ("cold", cold)):
        out[f"{label}_kernels"] = prof["per_call"]
        for part, key in (("prologue", "adam_prologue"), ("sweep", "sweep")):
            # µs a launch: the profiler may drop some of a window's launches
            hits = [v for k, v in prof["per_call"].items() if key in k]
            calls = sum(v["calls"] for v in hits)
            us = sum(v["us"] for v in hits) / calls if calls else None
            out[f"{part}_{label}_device_us"] = us
            out[f"{part}_bound_us"] = bounds[part][0] * 1e3
            out[f"{part}_bound_by"] = bounds[part][1]
            out[f"{part}_{label}_share_of_bound"] = bounds[part][0] * 1e3 / us if us else None
        parts = [out[f"{p}_{label}_device_us"] for p in ("prologue", "sweep")]
        out[f"{label}_device_us"] = sum(parts) if None not in parts else None
    emit("timing_step", kernel="adam_step", config=f"{fmt} synthetic_small five leaves (2 launches)",
         library="torch.optim.Adam(fused=True)" if library else None, **out, card=card)
    return out


def device_us_by_phase(torch, prof, steps: int):
    """Device time per step of each phase of ProfiledPhases-marked steps,
    and each phase's device operations by name (µs and calls a step):
    each kernel, memset or copy goes to the phase whose host range holds
    its start. The profiler also mirrors each range onto the device
    timeline as an annotation spanning its kernels; those spans are not
    device work and are left out, as are runtime API calls."""
    ranges = [(e.time_range.start, e.time_range.end, e.name[len("phase."):])
              for e in prof.events()
              if e.name.startswith("phase.") and e.device_type.name == "CPU"]
    per = {name: 0.0 for name in PHASES}
    ops = {name: {} for name in PHASES}
    for e in prof.events():
        if e.device_type.name != "CUDA" or e.name.startswith(("phase.", "cuda")) or "spin_kernel" in e.name:
            continue
        hit = [name for t0, t1, name in ranges if t0 <= e.time_range.start <= t1]
        phase = hit[0] if hit else "data"
        per[phase] += e.time_range.elapsed_us() / steps
        op = ops[phase].setdefault(kernel_name(e.name), {"us": 0.0, "calls": 0.0})
        op["us"] += e.time_range.elapsed_us() / steps
        op["calls"] += 1 / steps
    return per, ops


def optimizer_phase(torch, run, sweep: str):
    """Device time a step by phase of 3 ProfiledPhases-marked steps
    (``run(mark)``) in one profiler session, and the optimizer phase's
    device operations, held to the step's two port kernels: the prologue
    and the sweep ``sweep``, each recorded once a step, and no other
    device operation; adam_step's count two a step. The profiler on the
    card has been seen to leave a launch out of its records (PERF.md §7):
    a session whose optimizer phase misses a launch of the two kernels is
    profiled again (retry_incomplete); a session that holds any other
    device operation fails at once. Returns the by-phase µs and the
    optimizer's operations (µs and launches a step) of the first complete
    session. Steps on fp32 or on bf16 gradients alike (adam_step.launches
    and launches_bf16)."""
    from torch.profiler import ProfilerActivity, profile

    from dladmm_tpu_torch.train import qadam_cuda

    steps = 3
    count = lambda: qadam_cuda.adam_step.launches + qadam_cuda.adam_step.launches_bf16  # noqa: E731

    def session():
        before = count()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profile_marker()
            run(ProfiledPhases(torch))
        launches = count() - before
        by_phase, ops = device_us_by_phase(torch, prof, steps)
        ops = ops["optimizer"]
        swept = [name for name in ops if name.startswith(sweep)]
        others = [name for name in ops if name != "adam_prologue" and not name.startswith(sweep)]
        if others or len(swept) > 1 or launches != 2 * steps or any(v["calls"] > 1 + 1e-9 for v in ops.values()):
            raise AssertionError(f"the optimizer phase ran {ops} ({launches} adam_step launches in {steps} steps), "
                                 f"not the prologue and {sweep}, once each a step")
        if not ("adam_prologue" in ops and swept and all(abs(v["calls"] - 1) < 1e-9 for v in ops.values())):
            raise IncompleteProfile(f"the optimizer phase recorded {ops}, not the prologue and {sweep} once a step")
        return by_phase, {"ops_per_step": ops, "adam_step_launches_per_step": launches / steps,
                          "device_us_per_step": sum(v["us"] for v in ops.values())}

    (by_phase, opt), sessions = retry_incomplete(session, "optimizer phase")
    return by_phase, opt | {"sessions": sessions}


def profile_train(torch, device, steps: int = 5):
    """Phase 12: torch.profiler over kernel-path training steps: device
    time per kernel by name, grouped by kernel, and the busy share of the
    CUDA-event window; then 3 steps with a sync after each phase for the
    device time of each phase (data, forward, backward loop, optimizer)."""
    from torch.profiler import ProfilerActivity, profile

    cfg, A, w, fwd, opt, state = train_setup(torch, device)
    for i in range(3):
        state, _ = phased_step(torch, A, w, fwd, opt, state, i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profile_marker()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(steps):
            state, _ = phased_step(torch, A, w, fwd, opt, state, 3 + i)
        stop.record()
        torch.cuda.synchronize()
    window_us = start.elapsed_time(stop) * 1e3
    kernels = device_kernels(prof, steps)
    busy_us = sum(v["us"] for v in kernels.values()) * steps
    groups = {"trajectory kernel (traj_persistent)": 0.0, "optimizer step (adam_prologue, qadam_int8_sweep)": 0.0,
              "other (backward loop, loss, data)": 0.0}
    for name, v in kernels.items():
        key = ("trajectory kernel (traj_persistent)" if "traj_persistent" in name else
               "optimizer step (adam_prologue, qadam_int8_sweep)" if "adam_prologue" in name or "qadam_int8" in name
               else "other (backward loop, loss, data)")
        groups[key] += v["us"]
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["us"])[:15])

    def run(mark):
        nonlocal state
        for i in range(3):
            state, _ = phased_step(torch, A, w, fwd, opt, state, 3 + steps + i, mark=mark)

    by_phase, opt_ops = optimizer_phase(torch, run, "qadam_int8_sweep")
    emit("profile_train", config="synthetic_small batch 64 deep supervision int8", steps=steps,
         window_ms_per_step=window_us / steps / 1e3, device_busy_share=busy_us / window_us,
         device_us_per_step_by_group=groups, device_us_per_step_by_phase=by_phase,
         optimizer_phase=opt_ops, top_kernels=top, distinct_kernels=len(kernels))


# -- the final-layer training slice (phases 13-17) ---------------------------


def bwd_case(torch, m: int, n: int, K: int, S: int, seed: int, device, scalar_theta=False, ties=False):
    """Problem, the trajectory kernel's stacks (with tAx) and random
    final-state cotangents. scalar_theta: (K, 1) thresholds. ties:
    theta1 of layer 1 zero on every other coordinate, beta of layer 0 at
    its floor 1e-6 (layer 0 reads lam = 0, so the tie leaves the scales
    as they are)."""
    from dladmm_tpu_torch.ops.cuda_traj import trajectory_forward

    A, b, p = problem(torch, m=m, n=n, K=K, S=S, seed=seed, device=device)
    if scalar_theta:
        p = p._replace(theta1=p.theta1.mean(dim=1, keepdim=True), theta2=p.theta2.mean(dim=1, keepdim=True))
    if ties:
        p.theta1[1, ::2] = 0.0
        p.beta[0] = 1e-6
    with torch.no_grad():
        traj = trajectory_forward(b, A, *p, with_tax=True)
    g = torch.Generator(device=device).manual_seed(seed)
    cts = (torch.randn((S, n), generator=g, device=device), torch.randn((S, m), generator=g, device=device),
           0.1 * torch.randn((S, m), generator=g, device=device))
    return A, b, p, traj, cts


BWD_TOL = 2e-5  # kernel vs plain: max|diff| <= BWD_TOL * max|plain leaf| (tests/test_pallas_bwd.py)


def check_bwd(torch, device):
    """Phase 13: the backward kernel against its plain version on the
    trajectory kernel's stacks, with and without data grads. Returns the
    largest absolute difference of each route."""
    from dladmm_tpu_torch.ops.cuda_bwd import bwd_chunk_batch, unroll_bwd, unroll_bwd_plain, weight_wave

    wave = weight_wave(device)
    emit("kernel_bwd_policy", weight_launch_wave=wave, note="bwd_weights' resident blocks a SM x SMs")

    def policy(shape, S):
        return bwd_chunk_batch(shape["m"], shape["n"], shape["m"], S, shape["K"], wave)

    cases = [
        ("synthetic_small", SMALL, 64, None, {}),
        ("synthetic_small", SMALL, 64, None, {"scalar_theta": True, "ties": True}),
        ("synthetic_small", SMALL, 1024, policy(SMALL, 1024), {}),
        ("synthetic_small", SMALL, 1024, 128, {"ties": True}),
        ("synthetic_large", LARGE, 1024, policy(LARGE, 1024), {}),
        ("smoke", SMOKE, 1024, policy(SMOKE, 1024), {"ties": True}),
    ]
    errs = {"whole": 0.0, "chunked": 0.0}
    for label, shape, S, bs, kw in cases:
        A, b, p, traj, cts = bwd_case(torch, S=S, seed=S + 5, device=device, **shape, **kw)
        route = "chunked" if bs is not None and bs < S else "whole"
        for data_grads in (True, False):
            with torch.no_grad():
                got = unroll_bwd(b, A, *p, *traj, *cts, bs=bs, data_grads=data_grads)
                want = unroll_bwd_plain(b, A, *p, *traj, *cts, data_grads=data_grads)
            torch.cuda.synchronize()
            detail = compare_grads(torch, got, want, f"bwd {label} S={S} bs={bs}")
            errs[route] = max(errs[route], *(v["max_abs_err"] for v in detail.values()))
            emit("kernel_bwd", case=f"{label} S={S} bs={bs} {kw or ''}".strip(), route=route,
                 data_grads=data_grads, grads=detail)
        with torch.no_grad():
            again = unroll_bwd(b, A, *p, *traj, *cts, bs=bs, data_grads=False)
        if not all(torch.equal(g, w) for g, w in zip(got[0], again[0])):
            raise AssertionError(f"bwd {label} S={S} bs={bs}: a second call differs")
        emit("kernel_bwd", case=f"{label} S={S} bs={bs}", route=route, repeats_bit_for_bit=True,
             **launched_plan(unroll_bwd))
        del A, b, p, traj, cts, got, want, again
    return errs


DENSE_LEAVES = {
    "synthetic_small": [(15, 500, 250), (15, 250, 250)],  # W1 (K, n, m), W2 (K, m, m)
    "synthetic_large": [(20, 2000, 1000), (20, 1000, 1000)],
}


def dense_state(torch, tqa, shape, fmt: str, seed: int, device):
    """A master, non-zero moments in the format's dtypes and 3 gradients."""
    mu_dt, nu_dt, _, _ = tqa.DENSE_FMTS[fmt]
    g = torch.Generator(device=device).manual_seed(seed)
    rand = lambda scale: scale * torch.randn(shape, generator=g, device=device)  # noqa: E731
    return rand(0.05), rand(1e-2).to(mu_dt), (rand(3e-2) ** 2).to(nu_dt), [rand(1e-2) for _ in range(3)]


def dense_scal(torch, i: int, device):
    cf = float(i + 2)
    return torch.tensor([1 - 0.9**cf, 1 - 0.999**cf, 1e-3, 0.8], device=device)


def check_dense(torch, tqa, device) -> float:
    """Phase 14: the dense sweep against its plain version on the W1 and
    W2 leaves of both presets, every format, 3 chained steps in place
    from a non-zero state, each step held against the plain fp32 step
    from the kernel's state before it: masters within rtol 1e-6;
    round-to-nearest moments equal to the plain version's; SR moments a
    bf16 neighbour of the plain fp32 moment. Then SR's bias over 64
    seeds on synthetic_small W2. Returns the largest master difference."""
    from dladmm_tpu_torch.train.step_checks import bf16_neighbours

    max_err = 0.0
    for fmt, (_, _, sr_mu, sr_nu) in tqa.DENSE_FMTS.items():
        for config, leaves in DENSE_LEAVES.items():
            for name, shape in zip(("W1", "W2"), leaves):
                master, mu, nu, grads = dense_state(torch, tqa, shape, fmt, seed=sum(shape), device=device)
                detail = {"master_max_abs_err": 0.0}
                for i, grad in enumerate(grads):
                    scal = dense_scal(torch, i, device)
                    ref = [master.clone(), mu.to(torch.float32, copy=True), nu.to(torch.float32, copy=True)]
                    tqa.adam_dense_rows_plain(grad, *ref, scal, "float32")
                    tqa.adam_dense_rows(grad, master, mu, nu, scal, fmt,
                                        torch.tensor(7 + i, dtype=torch.int32, device=device))
                    torch.cuda.synchronize()
                    err = float((master - ref[0]).abs().max())
                    if not (master - ref[0]).abs().le(1e-6 * ref[0].abs() + 1e-9).all():
                        raise AssertionError(f"dense {fmt} {config} {name} step {i}: master max|diff| {err}")
                    detail["master_max_abs_err"] = max(detail["master_max_abs_err"], err)
                    for mname, got, want, sr in (("mu", mu, ref[1], sr_mu), ("nu", nu, ref[2], sr_nu)):
                        if got.dtype == torch.float32:
                            ok = torch.equal(got, want)
                        elif sr:
                            lo, hi = bf16_neighbours(want)
                            ok = bool(((got.float() == lo) | (got.float() == hi)).all())
                        else:
                            ok = torch.equal(got, want.to(torch.bfloat16))
                        if not ok:
                            raise AssertionError(f"dense {fmt} {config} {name} step {i}: {mname} differs")
                max_err = max(max_err, detail["master_max_abs_err"])
                emit("kernel_dense", case=f"{fmt} {config} {name} {shape}", steps=3, **detail)
                del master, mu, nu, grads
    # SR is unbiased: the mean over 64 seeds of one step from one state.
    shape, seeds = DENSE_LEAVES["synthetic_small"][1], 64
    for fmt in ("bfloat16_sr", "bfloat16_sr_mu"):
        _, _, sr_mu, sr_nu = tqa.DENSE_FMTS[fmt]
        master, mu, nu, grads = dense_state(torch, tqa, shape, fmt, seed=5, device=device)
        scal = dense_scal(torch, 0, device)
        ref = [master.clone(), mu.to(torch.float32, copy=True), nu.to(torch.float32, copy=True)]
        tqa.adam_dense_rows_plain(grads[0], *ref, scal, "float32")
        totals = [torch.zeros(shape, dtype=torch.float64, device=device) for _ in range(2)]
        for s in range(seeds):
            st = [master.clone(), mu.clone(), nu.clone()]
            tqa.adam_dense_rows(grads[0], *st, scal, fmt, torch.tensor(s, dtype=torch.int32, device=device))
            totals[0] += st[1].double()
            totals[1] += st[2].double()
        stats = {}
        for mname, total, want, sr in (("mu", totals[0], ref[1], sr_mu), ("nu", totals[1], ref[2], sr_nu)):
            if not sr:
                continue
            lo, hi = bf16_neighbours(want)
            step = (hi - lo).double().abs()
            frac = torch.where(step > 0, (want.double().abs() - lo.double().abs()) / step, torch.zeros_like(step))
            err = total / seeds - want.double()
            # per value: within 6 standard errors of the widest draw (step / 2)
            if not (err.abs() <= 6 * step / 2 / seeds ** 0.5 + 1e-30).all():
                raise AssertionError(f"dense {fmt} {mname}: a value's SR mean is off by > 6 sigma")
            # the sum over all values, with each value's own variance: z within 4
            z = float(err.sum() / (step.pow(2) * frac * (1 - frac) / seeds).sum().sqrt())
            if not abs(z) <= 4.0:
                raise AssertionError(f"dense {fmt} {mname}: SR biased, z = {z}")
            stats[mname] = {"z": z, "mean_abs_err": float(err.abs().mean())}
        emit("kernel_dense_sr", case=f"{fmt} synthetic_small W2 {shape}", seeds=seeds, unbiased=stats)
    return max_err


def train_final_slice(torch, device, unroll_forward):
    """Phase 15: the final-layer training CLI on the card, its checkpoint
    served, then a short batch-1024 run on the chunked route. Returns
    the counts of the 1000-step run, of its serving, and of the
    batch-1024 run."""
    from dladmm_tpu_torch.ops import cuda_bwd, cuda_traj
    from dladmm_tpu_torch.run import main as run_main
    from dladmm_tpu_torch.serve import main as serve_main
    from dladmm_tpu_torch.train import qadam_cuda

    argv = ["--config=synthetic_small", "--layer-loss=none", "--moment-dtype=float32_pallas"]

    def counts():
        return {"trajectory_forward": cuda_traj.trajectory_forward.launches,
                "unroll_bwd": cuda_bwd.unroll_bwd.launches["whole"],
                "unroll_bwd_chunked": cuda_bwd.unroll_bwd.launches["chunked"],
                "adam_step": qadam_cuda.adam_step.launches}

    def run(extra, config="synthetic_small"):
        out = io.StringIO()
        cuda_traj.trajectory_forward.launches = 0
        cuda_bwd.reset_launches()
        qadam_cuda.adam_step.launches = 0
        t0 = time.monotonic()
        with contextlib.redirect_stdout(out):
            rc = run_main([f"--config={config}", *argv[1:], *extra])
        wall, launches = time.monotonic() - t0, counts()
        if rc != 0:
            raise AssertionError(f"run.main {extra} returned {rc}")
        lines = out.getvalue().splitlines()
        summary = json.loads([ln for ln in lines if ln.startswith("{")][-1])
        if summary["route"] != "cuda-whole-unroll-kernel":
            raise AssertionError(f"final-layer training took route {summary['route']!r}")
        if not (math.isfinite(summary["final_nmse_db"]) and math.isfinite(summary["final_residual"])):
            raise AssertionError(f"training diverged: {summary}")
        return summary, launches, wall, lines

    with tempfile.TemporaryDirectory() as tmp:
        log = Path(tmp) / "log.jsonl"
        summary, launches, wall, lines = run(["--steps=1000", "--ckpt-dir", tmp, "--log-jsonl", str(log)])
        record = json.loads(log.read_text().splitlines()[-1])
        if min(launches["trajectory_forward"], launches["unroll_bwd"], launches["adam_step"]) < 1:
            raise AssertionError(f"final-layer training did not go through all three kernels: {launches}")
        if launches["adam_step"] != 2 * 1000:
            raise AssertionError(f"the optimizer launched {launches['adam_step']} kernels in 1000 steps, not 2 a step")
        if not math.isfinite(record["loss"]):
            raise AssertionError(f"training loss is not finite: {record}")
        if not summary["final_nmse_db"] < summary["ladmm_nmse_db_at_K"]:
            raise AssertionError(f"trained NMSE {summary['final_nmse_db']} does not beat LADMM {summary['ladmm_nmse_db_at_K']}")
        emit("slice_train_final", summary=summary, last_record=record, launches=launches, wall_s=wall,
             table=[ln for ln in lines if ln[:5].strip().isdigit()])
        out = io.StringIO()
        unroll_forward.launches = 0
        with contextlib.redirect_stdout(out):
            rc = serve_main(["--config=synthetic_small", "--ckpt-dir", tmp, "--demo", "256"])
        serve_launches = unroll_forward.launches
    served = json.loads(out.getvalue().strip().splitlines()[-1])
    if rc != 0 or served["route"] != "cuda-whole-unroll-kernel" or serve_launches < 1:
        raise AssertionError(f"serving the checkpoint: rc {rc}, route {served['route']!r}, {serve_launches} launches")
    if not abs(served["nmse_db"] - summary["final_nmse_db"]) <= NMSE_TOL_DB:
        raise AssertionError(f"served NMSE {served['nmse_db']} dB != trained {summary['final_nmse_db']} dB")
    emit("slice_train_final_serve", serve=served, trained_nmse_db=summary["final_nmse_db"], launches=serve_launches)

    # Batch 1024 takes the route bwd_chunk_batch picks: the whole batch at
    # synthetic_small, whose 15 layers' weight-gradient tiles fill a wave.
    wave = cuda_bwd.weight_wave(device)
    split = cuda_bwd.bwd_chunk_batch(SMALL["m"], SMALL["n"], SMALL["m"], 1024, SMALL["K"], wave)
    taken, other = ("unroll_bwd_chunked", "unroll_bwd") if split else ("unroll_bwd", "unroll_bwd_chunked")
    big, big_launches, big_wall, _ = run(["--steps=20", "--batch=1024"])
    if big_launches[taken] < 1 or big_launches[other] != 0:
        raise AssertionError(f"the batch-1024 run did not take the policy's route ({taken}): {big_launches}")
    emit("slice_train_final_1024", summary=big, launches=big_launches, wall_s=big_wall, route=taken)
    # The chunked route's main path: the smoke preset (4 layers, m=32,
    # n=64: 12 weight-gradient tiles, under a wave) at batch 1024.
    small, chunk_launches, chunk_wall, _ = run(["--steps=20", "--batch=1024"], config="smoke")
    if chunk_launches["unroll_bwd_chunked"] < 1 or chunk_launches["unroll_bwd"] != 0:
        raise AssertionError(f"the smoke batch-1024 run did not take the chunked route: {chunk_launches}")
    emit("slice_train_final_chunked", config="smoke", summary=small, launches=chunk_launches, wall_s=chunk_wall,
         bs=cuda_bwd.bwd_chunk_batch(32, 64, 32, 1024, 4, wave))
    return launches, serve_launches, big_launches, chunk_launches


def final_setup(torch, device):
    """synthetic_small's final-layer training pieces on the card, from the
    LADMM init: the dictionary, the float32_pallas optimizer, a state."""
    import dataclasses

    from dladmm_tpu_torch.data.synthetic import problem_matrices
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.train.loop import _build_optimizer, make_train_state
    from dladmm_tpu_torch.utils.config import get_config

    cfg = get_config("synthetic_small")
    t = dataclasses.replace(cfg.train, layer_loss=None, moment_dtype="float32_pallas")
    A, _ = problem_matrices(cfg, device=device)
    opt = _build_optimizer(t)
    return A, opt, make_train_state(init_dladmm_params(A, K=cfg.problem.K), opt)


FINAL_MODES = ("kernel", "plain_bwd", "plain")


def phased_step_final(torch, A, opt, state, i, mode="kernel", mark=None):
    """One final-layer training step (batch 64 from step_generator(0, i),
    MSE of the final x and z, float32_pallas), split into data, forward,
    backward and optimizer as ``phased_step``. mode "kernel": the port's
    path (make_unrolled_forward: trajectory kernel, backward kernel;
    the dense sweep). "plain_bwd": the trajectory kernel, the plain reverse
    sweep (bwd_from_carries) on its stacks, the same sweep: the path
    before the backward kernel. "plain": autograd through the plain loop
    and the optimizer's functional plain path (QAdamFused.update)."""
    from dladmm_tpu_torch.data.synthetic import make_batch, step_generator
    from dladmm_tpu_torch.models.unroll import DLADMMParams, dladmm_forward
    from dladmm_tpu_torch.ops.cuda_traj import trajectory_forward
    from dladmm_tpu_torch.ops.cuda_unroll import make_unrolled_forward
    from dladmm_tpu_torch.ops.unroll_vjp import bwd_from_carries, shifted_residuals
    from dladmm_tpu_torch.train.loop import TrainState, apply_updates

    mark = mark or (lambda k: None)
    mark(0)
    data = make_batch(step_generator(0, i), A, 64)
    leaves = [p.detach().requires_grad_() for p in state.params]
    q = DLADMMParams(*leaves)
    mark(1)
    if mode == "kernel":
        x, z, _ = make_unrolled_forward()(q, A, data.b)
    elif mode == "plain_bwd":
        with torch.no_grad():
            traj = trajectory_forward(data.b, A, *state.params, with_tax=True)
        x, z, lam = (t[-1].clone().requires_grad_() for t in traj[:3])
    else:
        x, z, _ = dladmm_forward(q, A, data.b)
    loss = torch.mean((x - data.x_star) ** 2) + torch.mean((z - data.e_star) ** 2)
    mark(2)
    if mode == "plain_bwd":
        gx, gz = torch.autograd.grad(loss, (x, z))
        gp = bwd_from_carries(state.params, A, data.b, shifted_residuals(*traj), (gx, gz, torch.zeros_like(lam)),
                              data_grads=False)[0]
        grads = DLADMMParams(*(g.reshape(p.shape) for g, p in zip(gp, state.params)))
    else:
        grads = DLADMMParams(*torch.autograd.grad(loss, leaves))
    mark(3)
    if mode == "plain":
        with torch.no_grad():
            updates, opt_state = opt.update(grads, state.opt_state)
            params = apply_updates(state.params, updates)
    else:
        params, opt_state, _ = opt.fused_apply(grads, state.opt_state, state.params)
    mark(4)
    return TrainState(params, opt_state, state.step + 1), loss


def time_train_final(torch, device, card):
    """Phase 16: one final-layer step by phase, the three modes in turns;
    then the backward kernel (both routes) and the dense sweep beside
    their bounds, their plain versions and, for the fp32 sweep, the
    library's fused Adam on the same leaves."""
    from dladmm_tpu_torch.ops.cuda_bwd import unroll_bwd, unroll_bwd_plain
    from dladmm_tpu_torch.train import qadam_cuda as tqa

    A = final_setup(torch, device)[0]
    opts, states = {}, {}
    for mode in FINAL_MODES:
        _, opts[mode], states[mode] = final_setup(torch, device)
    phases = {k: [] for k in FINAL_MODES}
    walls = {k: [] for k in FINAL_MODES}
    for rep in range(24):
        for mode in (FINAL_MODES if rep % 2 == 0 else FINAL_MODES[::-1]):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[mode], _ = phased_step_final(torch, A, opts[mode], states[mode], rep, mode,
                                                mark=lambda k: ev[k].record())
            ev[4].synchronize()
            walls[mode].append((time.perf_counter() - t0) * 1e3)
            if rep >= 4:  # warm-up
                phases[mode].append([ev[j].elapsed_time(ev[j + 1]) for j in range(4)])
    step = {}
    for mode in FINAL_MODES:
        arr = np.array(phases[mode])
        step[mode] = {
            "step_ms": float(np.median(arr.sum(axis=1))),
            "host_wall_ms": float(np.median(walls[mode][4:])),
            "data_ms": float(np.median(arr[:, 0])), "forward_ms": float(np.median(arr[:, 1])),
            "backward_ms": float(np.median(arr[:, 2])), "optimizer_ms": float(np.median(arr[:, 3])),
        }
    emit("timing_train_final", config="synthetic_small batch 64 final-layer loss float32_pallas",
         step=step, steps=20, card=card)

    timings, plans = {}, {}
    for name, label, shape, S, bs in (
            ("unroll_bwd", "synthetic_small", SMALL, 64, None),
            ("unroll_bwd@1024_chunked", "synthetic_small", SMALL, 1024, 128),
            ("unroll_bwd@1024_whole", "synthetic_small", SMALL, 1024, None),
            ("unroll_bwd@smoke1024_chunked", "smoke", SMOKE, 1024, 128),
            ("unroll_bwd@smoke1024_whole", "smoke", SMOKE, 1024, None)):
        A_, b, p, traj, cts = bwd_case(torch, S=S, seed=S + 31, device=device, **shape)
        with torch.no_grad():
            fns = [lambda: unroll_bwd(b, A_, *p, *traj, *cts, bs=bs), lambda: unroll_bwd_plain(b, A_, *p, *traj, *cts)]
            for _ in range(2):  # warm-up
                for fn in fns:
                    fn()
            ms, plain_ms = median_ms(fns, 21)
            prof = profile_fn(fns[0], f"{label} S={S} bs={bs}")
        bms, by = bwd_bound(S, **shape)
        enqueue_us = host_enqueue_us(torch, fns[0])
        timings[name] = (ms, plain_ms, bms, by, None)
        plans[name] = launched_plan(unroll_bwd)
        emit("timing_train_final_kernel", kernel=name, config=f"{label} S={S} bs={bs}",
             kernel_ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
             device_us_per_call=prof["device_us_per_call"], device_kernels=prof["per_call"],
             host_enqueue_us=enqueue_us, **plans[name], card=card)
        del A_, b, p, traj, cts, fns

    leaves = DENSE_LEAVES["synthetic_small"]
    elems = sum(int(np.prod(s)) for s in leaves)
    scal = torch.tensor([0.5, 0.05, 1e-3, 0.9], device=device)
    for fmt in ("float32", "bfloat16"):
        kern = [dense_state(torch, tqa, s, fmt, seed=sum(s), device=device) for s in leaves]
        plain = [(m_.clone(), mu.clone(), nu.clone(), g) for m_, mu, nu, g in kern]

        def sweep(plain_version, kern=kern, plain=plain, fmt=fmt):
            for master, mu, nu, grads in (plain if plain_version else kern):
                fn = tqa.adam_dense_rows_plain if plain_version else tqa.adam_dense_rows
                fn(grads[0], master, mu, nu, scal, fmt)

        fns = [lambda: sweep(False), lambda: sweep(True)]
        library = None
        if fmt == "float32":
            # The yardstick: one fused-Adam step of the library on the same two leaves.
            ps = [torch.nn.Parameter(m_.clone()) for m_, _, _, _ in kern]
            for prm, (_, _, _, g) in zip(ps, kern):
                prm.grad = g[0].clone()
            library = torch.optim.Adam(ps, lr=1e-3, fused=True)
            library.step()
            fns.append(library.step)
        for fn in fns:
            fn()
        times = median_ms(fns, 31)
        bms, by = dense_bound(elems, fmt)
        library_ms = times[2] if library is not None else None
        emit("timing_train_final_kernel", kernel="adam_dense_rows",
             config=f"{fmt} synthetic_small W1+W2 (2 one-leaf launches)",
             kernel_ms=times[0], plain_ms=times[1], library_ms=library_ms, library="torch.optim.Adam(fused=True)",
             bound_ms=bms, bound_by=by,
             **device_us(fns[0], f"dense {fmt} W1+W2"), card=card)
        del kern, plain, fns, library
    for fmt in ("float32", "bfloat16"):
        timings[f"adam_step@{fmt}"] = time_step(torch, tqa, device, card, fmt, library=fmt == "float32")
    return step, timings, plans


def profile_train_final(torch, device, steps: int = 5):
    """Phase 17: torch.profiler over final-layer kernel-path steps: device
    time per kernel and per group, the busy share of the CUDA-event
    window; then 3 steps with a sync after each phase for the device
    time of each phase."""
    from torch.profiler import ProfilerActivity, profile

    A, opt, state = final_setup(torch, device)
    for i in range(3):
        state, _ = phased_step_final(torch, A, opt, state, i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profile_marker()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(steps):
            state, _ = phased_step_final(torch, A, opt, state, 3 + i)
        stop.record()
        torch.cuda.synchronize()
    window_us = start.elapsed_time(stop) * 1e3
    kernels = device_kernels(prof, steps)
    busy_us = sum(v["us"] for v in kernels.values()) * steps
    groups = {"trajectory kernel (traj_persistent)": 0.0,
              "backward kernel (bwd_chain, bwd_weights, finish)": 0.0,
              "optimizer step (adam_prologue, qadam_dense_sweep)": 0.0, "other (loss, data, copies)": 0.0}
    for name, v in kernels.items():
        key = ("trajectory kernel (traj_persistent)" if "traj_persistent" in name else
               "backward kernel (bwd_chain, bwd_weights, finish)"
               if any(k in name for k in ("bwd_chain", "bwd_weights", "finish")) else
               "optimizer step (adam_prologue, qadam_dense_sweep)"
               if "adam_prologue" in name or "qadam_dense" in name else
               "other (loss, data, copies)")
        groups[key] += v["us"]
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["us"])[:15])

    def run(mark):
        nonlocal state
        for i in range(3):
            state, _ = phased_step_final(torch, A, opt, state, 3 + steps + i, mark=mark)

    by_phase, opt_ops = optimizer_phase(torch, run, "qadam_dense_sweep")
    emit("profile_train_final", config="synthetic_small batch 64 final-layer loss float32_pallas", steps=steps,
         window_ms_per_step=window_us / steps / 1e3, device_busy_share=busy_us / window_us,
         device_us_per_step_by_group=groups, device_us_per_step_by_phase=by_phase,
         optimizer_phase=opt_ops, top_kernels=top, distinct_kernels=len(kernels))


# -- int8 serving and the per-layer fused step (phases 18-22) ---------------

INT8_TOL = 1e-5  # int8 kernel vs plain: expected bit for bit; fail above INT8_TOL * max(1, max|ref|)
INT8_NMSE_DB = 0.3  # int8 against fp32 serving of the same requests (tests/test_serve.py:283-285)


def int8_case(torch, shape, S: int, seed: int, device):
    """b (with an all-zero row, as a padded bucket has) and the quantized
    perturbed LADMM-exact net and dictionary on the card."""
    from dladmm_tpu_torch.ops.quantized import quantize_params

    A, b, p = problem(torch, S=S, seed=seed, device=device, **shape)
    if S > 1:
        b[S // 2] = 0.0
    return b, *quantize_params(p, A)


def int8_plan(int8_unroll_forward) -> dict:
    """The plan of the int8 kernel's last launch (launched_plan), with its
    depth slices' length in bytes."""
    from dladmm_tpu_torch.ops import schedule

    return {**launched_plan(int8_unroll_forward, schedule.int8_barriers),
            "slice_bytes_per_phase": {k: sp.length for k, sp in int8_unroll_forward.last_plan[2].items()}}


def one_kernel_a_solve(per_call: dict, label: str) -> None:
    """A profiled int8 solve must hold the one port kernel (int8_persistent)
    and no other device operation but a counters' memset."""
    port = {k: v for k, v in per_call.items() if "int8_persistent" in k}
    other = {k: v for k, v in per_call.items() if k not in port and "Memset" not in k}
    if len(port) != 1 or other or not all(v["calls"] <= 1.0 for v in per_call.values()):
        raise AssertionError(f"int8 {label}: a solve ran {per_call}, not one int8_persistent launch")


def check_int8_unroll(torch, device) -> float:
    """Phase 18: the int8 kernel against its plain version on the same
    quantized inputs; prints the count of elements that differ at all,
    the plan, and checks that a second call repeats bit for bit and that
    a profiled solve is one kernel."""
    from dladmm_tpu_torch.ops.cuda_int8 import int8_unroll_forward, int8_unroll_forward_plain

    max_err = 0.0
    cases = [("synthetic_small", SMALL, S) for S in (1, 13, 64, 256, 1024)] + [("synthetic_large", LARGE, 1024)]
    for label, shape, S in cases:
        b, qp, qd = int8_case(torch, shape, S, seed=S + 40, device=device)
        with torch.no_grad():
            got = int8_unroll_forward(b, qp, qd)
            plan = int8_plan(int8_unroll_forward)
            want = int8_unroll_forward_plain(b, qp, qd)
            again = int8_unroll_forward(b, qp, qd)
        torch.cuda.synchronize()
        errs, differ = {}, {}
        for name, g, w in zip(("x", "z", "lam"), got, want):
            if tuple(g.shape) != tuple(w.shape) or not torch.isfinite(g).all():
                raise AssertionError(f"int8 {label} S={S}: {name} {tuple(g.shape)} or not finite")
            errs[name] = float((g - w).abs().max())
            differ[name] = int((g != w).sum())
            scale = max(1.0, float(w.abs().max()))
            if not errs[name] <= INT8_TOL * scale:
                raise AssertionError(f"int8 {label} S={S}: {name} max|diff| {errs[name]} > {INT8_TOL} * {scale}")
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"int8 {label} S={S}: a second call differs")
        prof = profile_fn(lambda: int8_unroll_forward(b, qp, qd), f"int8 {label} S={S}", reps=3)
        one_kernel_a_solve(prof["per_call"], f"{label} S={S}")
        emit("kernel_int8_unroll", case=f"{label} S={S}", max_abs_err=errs, elements_differing=differ,
             elements=sum(g.numel() for g in got), repeats_bit_for_bit=True,
             device_ops_per_solve=prof["per_call"], **plan)
        max_err = max(max_err, *errs.values())
        del b, qp, qd, got, want, again
    return max_err


def serve_json(serve_main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve_main(argv)
    if rc != 0:
        raise AssertionError(f"serve.main {argv} returned {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def serve_int8_slice(torch, device, sources, params, A):
    """Phase 19: serve --dtype=int8 --demo 256 with --kernel=megakernel
    and auto on each checkpoint source, the int8 kernel's count from 0
    around each, NMSE within 0.3 dB of the fp32 serve of the same
    requests; then an int8 InferenceServer (buckets up to 256) on 1, 7,
    64 and 200 rows and 8 concurrent BatchingServer submits. Returns the
    counts by path."""
    from dladmm_tpu_torch.ops.cuda_int8 import int8_unroll_forward, int8_unroll_forward_plain
    from dladmm_tpu_torch.serve import BatchingServer, InferenceServer
    from dladmm_tpu_torch.serve import main as serve_main

    launches = {}
    for label, src in sources.items():
        base = ["--config=synthetic_small", *src, "--demo", "256"]
        fp32 = serve_json(serve_main, base)
        for kernel in ("megakernel", "auto"):
            int8_unroll_forward.launches = 0
            got = serve_json(serve_main, base + ["--dtype=int8", f"--kernel={kernel}"])
            n = launches[f"serve_cli {label} {kernel}"] = int8_unroll_forward.launches
            if got["route"] != "cuda-int8-unroll-kernel" or n < 1:
                raise AssertionError(f"int8 serving of {label} ({kernel}) did not go through the kernel: "
                                     f"route {got['route']!r}, {n} launches")
            delta = got["nmse_db"] - fp32["nmse_db"]
            if not abs(delta) <= INT8_NMSE_DB:
                raise AssertionError(f"int8 NMSE {got['nmse_db']} dB is {delta} dB from fp32 {fp32['nmse_db']} dB")
            emit("slice_serve_int8", source=label, kernel=kernel, serve=got, fp32_nmse_db=fp32["nmse_db"],
                 delta_db=delta, launches=n)

    # The servers' path, counted from 0: 9 bucket warm-ups, 4 solves and
    # the batched dispatches.
    int8_unroll_forward.launches = 0
    server = InferenceServer(params, A, max_batch=256, dtype="int8", device=device)
    rng = np.random.default_rng(1)
    rows = (1, 7, 64, 200)
    reqs = [torch.from_numpy(rng.normal(size=(r, A.shape[0])).astype(np.float32)).to(device) for r in rows]
    with torch.no_grad():
        solved = [server.solve(r) for r in reqs]
    small = [rng.normal(size=(s, A.shape[0])).astype(np.float32) for s in (1, 3, 5, 8, 13, 21, 34, 55)]
    front = BatchingServer(server, max_delay_ms=5.0)
    try:
        with ThreadPoolExecutor(len(small)) as clients:  # 8 concurrent submits
            futs = list(clients.map(front.submit, small))
        batched = [f.result(timeout=120) for f in futs]
    finally:
        front.close()
    launches["servers"] = int8_unroll_forward.launches
    if launches["servers"] < 1 or set(server.routes.values()) != {"cuda-int8-unroll-kernel"}:
        raise AssertionError(f"the int8 servers' path: routes {server.routes}, {launches['servers']} launches")
    # Checks, not counted: the kernel route's plain version on the same rows
    # (bit for bit expected), and the reference route (the scan's order:
    # its int8 codes differ somewhere, ROADMAP.md §3, so only reported
    # and held to 1% relative Frobenius difference).
    reference = InferenceServer(params, A, max_batch=256, dtype="int8", kernel="reference", device=device)
    with torch.no_grad():
        for r, (x, z) in zip(reqs, solved):
            xw, zw, _ = int8_unroll_forward_plain(r, *server._operands)
            xr, zr = reference.solve(r)
            torch.cuda.synchronize()
            detail = {}
            for name, g_, w_, r_ in (("x", x, xw, xr), ("z", z, zw, zr)):
                err = float((g_ - w_).abs().max())
                if not err <= INT8_TOL * max(1.0, float(w_.abs().max())):
                    raise AssertionError(f"int8 InferenceServer rows={len(r)} {name}: {err}")
                rel = float((g_ - r_).norm() / max(float(r_.norm()), 1e-30))
                if not rel <= 1e-2:
                    raise AssertionError(f"int8 InferenceServer rows={len(r)} {name}: {rel} from the reference route")
                detail[name] = {"max_abs_err": err, "elements_differing": int((g_ != w_).sum()),
                                "reference_route_max_abs_diff": float((g_ - r_).abs().max()),
                                "reference_route_rel_frobenius": rel}
            emit("slice_server_int8", rows=len(r), bucket=server._bucket_for(len(r)),
                 route=server.routes[server._bucket_for(len(r))], detail=detail)
        for r, (xb, zb) in zip(small, batched):
            xs, zs = server.solve(r)
            if not (np.array_equal(xb, xs.cpu().numpy()) and np.array_equal(zb, zs.cpu().numpy())):
                raise AssertionError(f"int8 BatchingServer rows={len(r)} != per-request solve")
    emit("slice_servers_int8", requests=len(small), launches=launches["servers"])
    return launches


def check_layer(torch, device) -> float:
    """Phase 20: dladmm_forward(step_fn=fused_layer_step) against the plain
    loop and the whole-unroll kernel, a second forward bit for bit; the
    bf16-operand mode within 5% relative Frobenius error of the plain
    loop. Returns the largest difference from the plain loop."""
    from dladmm_tpu_torch.models.unroll import dladmm_forward
    from dladmm_tpu_torch.ops.cuda_layer import fused_layer_step, layer_step, make_fused_step
    from dladmm_tpu_torch.ops.cuda_unroll import unroll_forward

    bf16_step = make_fused_step(matmul_dtype=torch.bfloat16)
    max_err = 0.0
    for label, shape, S in (("synthetic_small", SMALL, 64), ("synthetic_small", SMALL, 256),
                            ("synthetic_small", SMALL, 3000), ("synthetic_large", LARGE, 1024)):
        A, b, p = problem(torch, S=S, seed=S + 60, device=device, **shape)
        with torch.no_grad():
            got = dladmm_forward(p, A, b, step_fn=fused_layer_step)
            again = dladmm_forward(p, A, b, step_fn=fused_layer_step)
            plan = launched_plan(layer_step)
            plain = dladmm_forward(p, A, b)
            whole = unroll_forward(b, A, *p)
            bf = dladmm_forward(p, A, b, step_fn=bf16_step)
        torch.cuda.synchronize()
        case = f"{label} S={S}"
        max_err = max(max_err, compare(torch, got, plain, f"{case} vs plain loop", phase="kernel_layer"))
        compare(torch, got, whole, f"{case} vs whole-unroll kernel", phase="kernel_layer")
        if not all(torch.equal(g, w) for g, w in zip(got, again)):
            raise AssertionError(f"layer step {case}: a second forward differs")
        emit("kernel_layer", case=case, repeats_bit_for_bit=True, **plan)
        rel = {}
        for name, g, w in zip(("x", "z", "lam"), bf, plain):
            rel[name] = float((g - w).norm() / (w.norm() + 1e-9))
            if not (torch.isfinite(g).all() and rel[name] < 0.05):
                raise AssertionError(f"bf16 operands {case}: {name} relative error {rel[name]}")
        emit("kernel_layer", case=f"{case} bf16 operands vs fp32 plain loop", rel_frobenius=rel)
        del A, b, p, got, again, plain, whole, bf
    return max_err


def mask_flips(torch, params, A, b):
    """Per layer, the elements whose shrink mask (zero or not, in x and z)
    differs between the plain loop and the fused step's forward."""
    from dladmm_tpu_torch.ops.cuda_layer import fused_layer_step
    from dladmm_tpu_torch.ops.reference import dladmm_layer_step_cached

    flips = []
    with torch.no_grad():
        S, m = b.shape
        plain = [torch.zeros((S, A.shape[1]), device=b.device)] + [torch.zeros_like(b) for _ in range(3)]
        fused = [t.clone() for t in plain]
        for k in range(params.K):
            plain = list(dladmm_layer_step_cached(A, None, b, *plain, plain[1], params.layer(k)))[:4]
            fused = list(fused_layer_step(A, None, b, *fused, fused[1], params.layer(k)))[:4]
            flips.append(sum(int(((p != 0) != (f != 0)).sum()) for p, f in zip(plain[:2], fused[:2])))
    return flips


def train_layer(torch, device):
    """Phase 21: 20 final-layer steps at synthetic_small batch 64 through
    make_train_step(step_fn=fused_layer_step), the layer step's count
    from 0; then one step's gradient against autograd through the plain
    loop within 2e-5 of each leaf's largest value, at phase 9's params
    (perturbed LADMM-exact, S = 64). At the trained state the difference
    is reported, not held: there a threshold can fall within rounding of
    an element, so the two fp32 forwards can zero different elements (a
    mask flip, counted here) and no fp32 gradient is within 2e-5 of the
    fp64 one (1e-3 measured, PERF.md). Returns the count."""
    from dladmm_tpu_torch.data.synthetic import make_batch, step_generator
    from dladmm_tpu_torch.models.unroll import DLADMMParams
    from dladmm_tpu_torch.ops import cuda_layer
    from dladmm_tpu_torch.train.loop import loss_fn, make_train_step

    A, opt, state = final_setup(torch, device)
    step = make_train_step(opt, A, 64, step_fn=cuda_layer.fused_layer_step)
    cuda_layer.layer_step.launches = 0
    t0 = time.monotonic()
    losses = []
    for i in range(20):
        state, loss = step(state, i)
        losses.append(float(loss))
    wall, launches = time.monotonic() - t0, cuda_layer.layer_step.launches
    if not all(math.isfinite(v) for v in losses) or launches < 1:
        raise AssertionError(f"fused-step training: losses {losses}, {launches} launches")

    def grads(params, A_, data):
        out = []
        for kw in (dict(step_fn=cuda_layer.fused_layer_step), dict(vjp="xla")):
            leaves = [t.detach().clone().requires_grad_() for t in params]
            loss = loss_fn(DLADMMParams(*leaves), A_, data.b, data.x_star, data.e_star, **kw)
            out.append(torch.autograd.grad(loss, leaves))
        torch.cuda.synchronize()
        return out

    A9, _, p9 = problem(torch, S=64, seed=9, device=device, **SMALL)
    data9 = make_batch(torch.Generator().manual_seed(9), A9, 64)
    errs = {}
    for name, g, want in zip(DLADMMParams._fields, *grads(p9, A9, data9)):
        scale = float(want.abs().max())
        err = float((g - want).abs().max())
        if not (g - want).abs().le(2e-5 * want.abs() + 2e-5 * scale).all():
            raise AssertionError(f"fused-step grad {name}: max|diff| {err}, scale {scale}")
        errs[name] = {"max_abs_err": err, "scale": scale}
    data = make_batch(step_generator(0, 20), A, 64)
    trained = {name: float((g - w).abs().max()) / float(w.abs().max())
               for name, g, w in zip(DLADMMParams._fields, *grads(state.params, A, data))}
    emit("train_layer", config="synthetic_small batch 64 final-layer loss float32_pallas, step_fn=fused_layer_step",
         steps=20, losses=losses, wall_s=wall, launches=launches, grads_phase9_params=errs,
         trained_state_grad_diff_over_scale=trained, trained_state_mask_flips=mask_flips(torch, state.params, A, data.b),
         phase9_params_mask_flips=mask_flips(torch, p9, A9, data9.b))
    return launches


INT8_SHAPES = [("synthetic_small", SMALL, 64), ("synthetic_small", SMALL, 256), ("synthetic_small", SMALL, 1024),
               ("synthetic_large", LARGE, 1024)]


def time_int8(torch, device, card, plain: bool = True):
    """The int8 kernel at INT8_SHAPES: CUDA-event median ms of one call
    from an idle card (beside its plain version, in turns, with
    ``plain``), back-to-back ms, host enqueue, the profiler's device µs
    a launch and launches recorded a solve (it has recorded fewer int8
    launches than ran: PERF.md §7), the plan where the wrapper keeps one.
    Returns ({key: (ms, plain_ms, bound_ms, bound_by), key + ("detail",):
    {...}}, profiles)."""
    from dladmm_tpu_torch.ops.cuda_int8 import int8_unroll_forward, int8_unroll_forward_plain

    timings, profiles = {}, []
    with torch.no_grad():
        for label, shape, S in INT8_SHAPES:
            large = label == "synthetic_large"
            b, qp, qd = int8_case(torch, shape, S, seed=S + 80, device=device)
            fns = [lambda: int8_unroll_forward(b, qp, qd)]
            if plain:
                fns.append(lambda: int8_unroll_forward_plain(b, qp, qd))
            for fn in fns:  # warm-up
                fn()
            ms, *plain_ms = median_ms(fns, 9 if large else 21)
            bms, by = int8_serve_bound(S, **shape)
            prof = profile_fn(fns[0], f"{label} S={S}")
            ops = prof["per_call"]
            detail = {"back_to_back_ms": back_to_back_ms(fns[0], calls=5 if large else 20),
                      "host_enqueue_us": host_enqueue_us(torch, fns[0], calls=10 if large else 50),
                      "device_us_per_launch": {k: v["us"] / v["calls"] for k, v in ops.items()},
                      "launches_recorded_per_solve": {k: v["calls"] for k, v in ops.items()}}
            if getattr(int8_unroll_forward, "last_plan", None) is not None:
                one_kernel_a_solve(ops, f"{label} S={S}")
                detail["device_us_per_call"] = sum(detail["device_us_per_launch"].values())
                detail.update(int8_plan(int8_unroll_forward))
            key = ("int8", S) if not large else ("int8_large", S)
            timings[key] = (ms, plain_ms[0] if plain_ms else None, bms, by)
            timings[key + ("detail",)] = detail
            emit("timing_serve_int8", config=label, S=S, kernel_ms=ms, plain_ms=timings[key][1], bound_ms=bms,
                 bound_by=by, **detail, card=card)
            profiles.append(prof)
            del b, qp, qd, fns
    return timings, profiles


def time_int8_and_layer(torch, device, card):
    """Phase 22: the int8 kernel at synthetic_small S = 64, 256, 1024 and
    synthetic_large S = 1024, and the layer step (one call, and the
    K-layer forward through it) at S = 256, each beside its plain version
    and its bound, in turns; the int8 kernel's device time, host enqueue
    and plan at each S; a profiler pass of the layer step."""
    from dladmm_tpu_torch.models.unroll import dladmm_forward
    from dladmm_tpu_torch.ops.cuda_layer import fused_layer_step, layer_step, layer_step_plain
    from dladmm_tpu_torch.ops.cuda_unroll import unroll_forward

    timings, int8_profiles = time_int8(torch, device, card)
    with torch.no_grad():
        S = 256
        A, b, p = problem(torch, S=S, seed=S + 90, device=device, **SMALL)
        m, n = SMALL["m"], SMALL["n"]
        g = torch.Generator(device=device).manual_seed(5)
        state = [torch.randn(shape, generator=g, device=device) for shape in ((S, n), (S, m), (S, m), (S, m))]
        one = (b, A, *state, p.W1[3], p.W2[3], p.theta1[3].contiguous(), p.theta2[3].contiguous(),
               p.beta[3:4].contiguous())
        fns = [lambda: layer_step(*one), lambda: layer_step_plain(*one)]
        for fn in fns:
            fn()
        ms, plain_ms = median_ms(fns, 31)
        bms, by = layer_bound(S, m, n)
        timings[("layer", S)] = (ms, plain_ms, bms, by)
        timings["layer_detail"] = {
            "host_enqueue_us": host_enqueue_us(torch, fns[0]),
            **device_us(fns[0], f"synthetic_small S={S} one layer"),
            **launched_plan(layer_step)}
        emit("timing_layer", kernel="layer_step", config=f"synthetic_small S={S}, one call (one layer)",
             kernel_ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, **timings["layer_detail"], card=card)
        loops = [lambda: dladmm_forward(p, A, b, step_fn=fused_layer_step), lambda: dladmm_forward(p, A, b),
                 lambda: unroll_forward(b, A, *p)]
        for fn in loops:
            fn()
        loop_ms, plain_loop_ms, whole_ms = median_ms(loops, 21)
        bms, by = bound(S, **SMALL)
        emit("timing_layer", kernel="fused-step loop", config=f"synthetic_small S={S}, K=15 calls",
             kernel_ms=loop_ms, plain_ms=plain_loop_ms, whole_unroll_kernel_ms=whole_ms, bound_ms=bms, bound_by=by,
             host_enqueue_us=host_enqueue_us(torch, loops[0], calls=10), card=card)
        layer_profile = profile_fn(lambda: dladmm_forward(p, A, b, step_fn=fused_layer_step),
                                   "synthetic_small S=256 fused-step loop", events_fallback=True)
    for prof in int8_profiles:
        emit("profile_serve_int8", **prof)
    emit("profile_layer", **layer_profile)
    return timings


# -- bf16 serving and the layer step on bf16 state (phases 23-25) -----------

# bf16 kernel against its plain version (ops/cuda_unroll.unroll_forward_plain_bf16,
# ops/cuda_layer.layer_step_plain): max|diff| of each output within
# BF16_TOL_ULPS bf16 ulps of its largest magnitude, 2^(floor(log2 max|ref|) - 7).
# Both compute in fp32 and round the stored state to bf16, but the kernel's
# split-K sums run in another order than torch's products, so a stored value
# near a rounding boundary can round the other way and the flip travels on
# through the later layers. bf16_order_spread measures how far one change of
# summation order moves the plain version (products in float64 rounded to
# fp32, against fp32 @): measured on the CPU at synthetic_small S = 256, 1.0
# (x), 1.0 (z), 1.625 (lam) ulps, and at synthetic_large S = 1024, 1.0, 0.766
# and 3.0 ulps (half of lam's elements differ). The tolerance is four times
# the largest, 3 ulps: the kernel's order and torch's each stand off the
# float64 sum, so their difference can reach twice the spread, and twice
# that again is the margin.
BF16_TOL_ULPS = 12.0
BF16_NMSE_DB_EXACT = 0.05  # LADMM-exact params: bf16 against fp32 serving (emulated: 0.0012 dB)
BF16_NMSE_DB = 0.25  # a trained checkpoint: the JAX package's contract (tests/test_serve.py:78)
BF16_X_FRAC = 0.05  # |x_bf16 - x_fp32| against max|x_fp32| (tests/test_serve.py:72)


def bf16_ulp(ref) -> float:
    """One bf16 ulp at ref's largest magnitude."""
    top = float(ref.abs().max())
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def bf16_case(torch, shape, S: int, seed: int, device):
    """problem()'s A, b and params, cast to bf16 (the serving cast)."""
    from dladmm_tpu_torch.models.unroll import DLADMMParams

    A, b, p = problem(torch, S=S, seed=seed, device=device, **shape)
    return A.bfloat16(), b.bfloat16(), DLADMMParams(*(t.bfloat16() for t in p))


@contextlib.contextmanager
def products_in_fp64():
    """The plain versions' products (ops/reference.apply_dict) in float64,
    rounded to the operands' type: another order of summation."""
    from dladmm_tpu_torch.ops import reference

    plain = reference.apply_dict
    reference.apply_dict = lambda v, M: (v.double() @ M.double().T).to(v.dtype)
    try:
        yield
    finally:
        reference.apply_dict = plain


def bf16_diff(got, want, names=("x", "z", "lam", "Ax")) -> dict:
    """{output: (max|diff| in bf16 ulps of max|ref|, elements differing,
    max|diff|)} of two results of one dtype (bf16, or fp32 for gbeta)."""
    out = {}
    for name, g, w in zip(names, got, want):
        if tuple(g.shape) != tuple(w.shape) or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {tuple(g.shape)} {g.dtype} against {tuple(w.shape)} {w.dtype}")
        d = (g.float() - w.float()).abs()
        err = float(d.max())
        out[name] = (err / max(bf16_ulp(w.float()), 1e-30), int((d > 0).sum()), err)
    return out


def bf16_order_spread(torch, device) -> dict:
    """How far one change of summation order moves the bf16-storage plain
    version: its products in float64 rounded to fp32 against fp32 @ (on the
    card, cuBLAS), at synthetic_small S = 256 and synthetic_large S = 1024."""
    from dladmm_tpu_torch.ops.cuda_unroll import unroll_forward_plain_bf16

    spread = {}
    for label, shape, S in (("synthetic_small", SMALL, 256), ("synthetic_large", LARGE, 1024)):
        A, b, p = bf16_case(torch, shape, S, seed=S + 100, device=device)
        with torch.no_grad():
            want = unroll_forward_plain_bf16(b, A, *p)
            with products_in_fp64():
                got = unroll_forward_plain_bf16(b, A, *p)
        spread[f"{label} S={S}"] = bf16_diff(got, want)
        del A, b, p, want, got
    return spread


def compare_bf16(torch, got, want, label: str, phase: str = "kernel_bf16") -> float:
    """Each bf16 output of a kernel against its plain version within
    BF16_TOL_ULPS ulps of its largest magnitude; prints the ulps, the
    elements that differ at all and max|diff|. Returns the largest
    max|diff|."""
    for g in got:
        if g.dtype != torch.bfloat16 or not torch.isfinite(g.float()).all():
            raise AssertionError(f"{label}: an output is {g.dtype} or not finite")
    diff = bf16_diff(got, want)
    for name, (ulps, _, err) in diff.items():
        if not ulps <= BF16_TOL_ULPS:
            raise AssertionError(f"{label}: {name} max|diff| {err} is {ulps} bf16 ulps > {BF16_TOL_ULPS}")
    emit(phase, case=label, ulps_of_max={k: v[0] for k, v in diff.items()},
         elements_differing={k: v[1] for k, v in diff.items()}, elements={k: g.numel() for k, g in zip(diff, got)},
         max_abs_err={k: v[2] for k, v in diff.items()}, tolerance_ulps=BF16_TOL_ULPS)
    return max(v[2] for v in diff.values())


def check_bf16_kernel(torch, device):
    """Phase 23: the bf16-storage serving kernel against its plain version
    (unroll_forward_plain_bf16) at synthetic_small S = 1, 13, 64, 256, 1024
    (l1/l1 on both tiles), S = 64 with each other prox as prox_x and as
    prox_z and with (K, 1) thresholds, and synthetic_large S = 1024 on the
    plan's tile; a second call must repeat bit for bit; then the layer
    step on bf16 state at S = 256 (one call, with and without bf16
    operands) and its K-layer loop, counted from 0, which must equal the
    whole-unroll kernel bit for bit (both read each layer's stored bf16
    state, with the same plan). Also the summation-order spread on the
    card (bf16_order_spread with cuBLAS). Returns (max|diff| of the
    serving kernel, of the layer step, the loop's launches)."""
    from dladmm_tpu_torch.models.unroll import dladmm_forward
    from dladmm_tpu_torch.ops.cuda_layer import fused_layer_step, layer_step, layer_step_plain
    from dladmm_tpu_torch.ops.cuda_unroll import unroll_forward, unroll_forward_plain_bf16

    emit("kernel_bf16_order_spread", products="float64 rounded to fp32 against cuBLAS fp32",
         spread_ulps_elements_max_abs=bf16_order_spread(torch, device), tolerance_ulps=BF16_TOL_ULPS)

    def case(label, A, b, p, tile=0, **kw):
        with serve_tile(tile) if tile else contextlib.nullcontext():
            got = unroll_forward(b, A, *p, **kw)
            plan = launched_plan(unroll_forward)
            again = unroll_forward(b, A, *p, **kw)
        want = unroll_forward_plain_bf16(b, A, *p, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"bf16 {label}: a second call differs")
        err = compare_bf16(torch, got, want, label)
        emit("kernel_bf16", case=label, repeats_bit_for_bit=True, **plan)
        return err

    serve_err = 0.0
    with torch.no_grad():
        for S in (1, 13, 64, 256, 1024):
            A, b, p = bf16_case(torch, SMALL, S, seed=S + 200, device=device)
            for tile in (32, 64):
                serve_err = max(serve_err, case(f"synthetic_small S={S} l1/l1 tile {tile}", A, b, p, tile))
        A, b, p = bf16_case(torch, SMALL, 64, seed=264, device=device)
        for prox in ("nonneg_l1", "box", "elastic_net"):
            rho = 0.3 if prox == "elastic_net" else 0.0
            serve_err = max(serve_err, case(f"synthetic_small S=64 {prox}(rho={rho})/l1", A, b, p,
                                            prox_x=prox, rho=rho))
            serve_err = max(serve_err, case(f"synthetic_small S=64 l1/{prox}(rho={rho})", A, b, p,
                                            prox_z=prox, rho=rho))
        scalar = p._replace(theta1=p.theta1[:, :1].contiguous(), theta2=p.theta2[:, 1:2].contiguous())
        serve_err = max(serve_err, case("synthetic_small S=64 l1/l1 (K, 1) thresholds", A, b, scalar))
        A, b, p = bf16_case(torch, LARGE, 1024, seed=1224, device=device)
        serve_err = max(serve_err, case("synthetic_large S=1024 l1/l1", A, b, p))
        del A, b, p, scalar

        S, m, n = 256, SMALL["m"], SMALL["n"]
        A, b, p = bf16_case(torch, SMALL, S, seed=456, device=device)
        g = torch.Generator(device=device).manual_seed(6)
        state = [torch.randn(shape, generator=g, device=device).bfloat16() for shape in ((S, n), (S, m), (S, m), (S, m))]
        one = (b, A, *state, p.W1[3], p.W2[3], p.theta1[3].contiguous(), p.theta2[3].contiguous(),
               p.beta[3:4].float())
        layer_err = 0.0
        for md in (None, torch.bfloat16):
            got = layer_step(*one, matmul_dtype=md)
            again = layer_step(*one, matmul_dtype=md)
            want = layer_step_plain(*one, matmul_dtype=md)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"bf16 layer step (matmul_dtype={md}): a second call differs")
            label = f"layer step, bf16 state, synthetic_small S={S}" + (", bf16 operands" if md else "")
            layer_err = max(layer_err, compare_bf16(torch, got, want, label))
            emit("kernel_bf16", case=label, repeats_bit_for_bit=True, **launched_plan(layer_step))
        layer_step.launches = 0
        loop = dladmm_forward(p, A, b, step_fn=fused_layer_step)
        launches = layer_step.launches
        whole = unroll_forward(b, A, *p)
        torch.cuda.synchronize()
        if launches != SMALL["K"]:
            raise AssertionError(f"the bf16 fused-step loop launched the layer step {launches} times")
        layer_err = max(layer_err, compare_bf16(torch, loop, unroll_forward_plain_bf16(b, A, *p),
                                                f"fused-step loop, bf16, synthetic_small S={S} K={SMALL['K']}"))
        if not all(torch.equal(x, y) for x, y in zip(loop, whole)):
            raise AssertionError("the bf16 fused-step loop differs from the bf16 whole-unroll kernel")
        emit("kernel_bf16", case="fused-step loop against the whole-unroll kernel", equal_bit_for_bit=True,
             launches=launches)
    return serve_err, layer_err, launches


def serve_bf16_slice(torch, device, sources, params, A):
    """Phase 24: ``serve --dtype=bfloat16 --demo 256`` on each checkpoint
    source, the serving kernel's count from 0 just before and read just
    after each bf16 run, beside the fp32 serve of the same requests: route
    cuda-whole-unroll-bf16-kernel, x within BF16_X_FRAC of max|x_fp32|,
    NMSE within BF16_NMSE_DB_EXACT (LADMM-exact) or BF16_NMSE_DB (the
    phase-10 checkpoint) of fp32; then a bf16 InferenceServer (buckets up
    to 256) on 1, 7, 64 and 200 rows and 8 concurrent BatchingServer
    submits, counted the same way, their answers held against the plain
    version and the batched ones against per-request solves. Returns the
    counts by path."""
    from dladmm_tpu_torch.ops.cuda_unroll import unroll_forward, unroll_forward_plain_bf16
    from dladmm_tpu_torch.serve import BatchingServer, InferenceServer
    from dladmm_tpu_torch.serve import main as serve_main

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, src in sources.items():
            base = ["--config=synthetic_small", *src, "--demo", "256"]
            out32, out16 = Path(tmp) / "fp32.npz", Path(tmp) / "bf16.npz"
            fp32 = serve_json(serve_main, base + ["--out", str(out32)])
            unroll_forward.launches = 0
            got = serve_json(serve_main, base + ["--dtype=bfloat16", "--out", str(out16)])
            n = launches[f"serve_cli {label}"] = unroll_forward.launches
            if got["route"] != "cuda-whole-unroll-bf16-kernel" or got["dtype"] != "bfloat16" or n < 1:
                raise AssertionError(f"bf16 serving of {label} did not go through the bf16 kernel: "
                                     f"route {got['route']!r}, {n} launches")
            x32, x16 = np.load(out32)["x"], np.load(out16)["x"]
            x_gap = float(np.abs(x16 - x32).max()) / max(float(np.abs(x32).max()), 1e-9)
            delta = got["nmse_db"] - fp32["nmse_db"]
            limit = BF16_NMSE_DB_EXACT if label == "LADMM-exact .pt" else BF16_NMSE_DB
            if not (x_gap <= BF16_X_FRAC and abs(delta) <= limit):
                raise AssertionError(f"bf16 serving of {label}: x {x_gap} of max|x| from fp32, NMSE "
                                     f"{got['nmse_db']} dB is {delta} dB from fp32 {fp32['nmse_db']} dB")
            emit("slice_bf16", source=label, serve=got, fp32_nmse_db=fp32["nmse_db"], delta_db=delta,
                 limit_db=limit, x_max_diff_over_max_x=x_gap, launches=n)

    # The servers' path, counted from 0: 9 bucket warm-ups, 4 solves and
    # the batched dispatches.
    unroll_forward.launches = 0
    server = InferenceServer(params, A, max_batch=256, dtype=torch.bfloat16, device=device)
    rng = np.random.default_rng(2)
    reqs = [torch.from_numpy(rng.normal(size=(r, A.shape[0])).astype(np.float32)).to(device) for r in (1, 7, 64, 200)]
    with torch.no_grad():
        solved = [server.solve(r) for r in reqs]
    small = [rng.normal(size=(s, A.shape[0])).astype(np.float32) for s in (1, 3, 5, 8, 13, 21, 34, 55)]
    front = BatchingServer(server, max_delay_ms=5.0)
    try:
        with ThreadPoolExecutor(len(small)) as clients:  # 8 concurrent submits
            futs = list(clients.map(front.submit, small))
        batched = [f.result(timeout=120) for f in futs]
    finally:
        front.close()
    launches["servers"] = unroll_forward.launches
    if launches["servers"] < 1 or set(server.routes.values()) != {"cuda-whole-unroll-bf16-kernel"}:
        raise AssertionError(f"the bf16 servers' path: routes {server.routes}, {launches['servers']} launches")
    # Checks, not counted. A bucket's plan (its depth split) depends on the
    # bucket, so a row's sums run in another order in another bucket: the
    # bf16 tolerance, not equality.
    with torch.no_grad():
        for r, (x, z) in zip(reqs, solved):
            xw, zw, _ = unroll_forward_plain_bf16(r.bfloat16(), server.A, *server.params)
            torch.cuda.synchronize()
            compare_bf16(torch, (x, z), (xw, zw), f"InferenceServer rows={len(r)} bucket={server._bucket_for(len(r))}",
                         phase="slice_server_bf16")
        for r, (xb, zb) in zip(small, batched):
            if xb.dtype != np.float32:
                raise AssertionError(f"bf16 BatchingServer returned {xb.dtype}")
            xs, zs = server.solve(r)
            compare_bf16(torch, (torch.from_numpy(xb).bfloat16(), torch.from_numpy(zb).bfloat16()),
                         (xs.cpu(), zs.cpu()), f"BatchingServer rows={len(r)} against a per-request solve",
                         phase="slice_server_bf16")
    emit("slice_servers_bf16", requests=len(small), launches=launches["servers"])
    return launches


def time_bf16(torch, device, card):
    """Phase 25: at synthetic_small S = 64, 256, 1024 and synthetic_large
    S = 1024, the CUDA-event median ms of one bf16 solve, one fp32 solve
    of the same params and one call of the bf16 plain version, in turns,
    each with its profiler device time, host enqueue and plan; then one
    layer step on bf16 state at S = 256 beside its plain version and the
    fp32 step. Returns {key: {...}}."""
    from dladmm_tpu_torch.models.unroll import DLADMMParams
    from dladmm_tpu_torch.ops.cuda_layer import layer_step, layer_step_plain
    from dladmm_tpu_torch.ops.cuda_unroll import unroll_forward, unroll_forward_plain_bf16

    out = {}
    with torch.no_grad():
        for label, shape, S in INT8_SHAPES:
            large = label == "synthetic_large"
            A, b, p = problem(torch, S=S, seed=S + 300, device=device, **shape)
            A16, b16, p16 = A.bfloat16(), b.bfloat16(), DLADMMParams(*(t.bfloat16() for t in p))
            fns = [lambda: unroll_forward(b16, A16, *p16), lambda: unroll_forward(b, A, *p),
                   lambda: unroll_forward_plain_bf16(b16, A16, *p16)]
            for _ in range(2):  # warm-up
                for fn in fns:
                    fn()
            ms16, ms32, plain_ms = median_ms(fns, 9 if large else 21)
            # The card's time a call, in turns (bf16, fp32, fp32, bf16, ...):
            # back-to-back launches, which the host enqueues faster than the
            # card runs them, so neither the enqueue nor the profiler counts.
            b2b = {"bf16": [], "fp32": []}
            for turn in range(4):
                for name in (("bf16", "fp32") if turn % 2 == 0 else ("fp32", "bf16")):
                    fn = fns[0] if name == "bf16" else fns[1]
                    b2b[name].append(back_to_back_ms(fn, calls=5 if large else 20, rounds=1))
            rows = {}
            for name, fn, (bms, by) in (("bf16", fns[0], bf16_bound(S, **shape)), ("fp32", fns[1], bound(S, **shape))):
                fn()
                rows[name] = {"ms": ms16 if name == "bf16" else ms32, "bound_ms": bms, "bound_by": by,
                              "back_to_back_ms": float(np.median(b2b[name])), "back_to_back_ms_turns": b2b[name],
                              **device_us(fn, f"{name} {label} S={S}"),
                              "host_enqueue_us": host_enqueue_us(torch, fn, calls=10 if large else 50),
                              **launched_plan(unroll_forward)}
            rows["bf16"]["plain_ms"] = plain_ms
            out[(label, S)] = rows
            emit("timing_bf16", config=label, S=S, bf16=rows["bf16"], fp32=rows["fp32"],
                 bf16_over_fp32_device=rows["bf16"]["device_us_per_call"] / rows["fp32"]["device_us_per_call"],
                 bf16_over_fp32_back_to_back=rows["bf16"]["back_to_back_ms"] / rows["fp32"]["back_to_back_ms"],
                 card=card)
            del A, b, p, A16, b16, p16, fns
        S, m, n = 256, SMALL["m"], SMALL["n"]
        A, b, p = problem(torch, S=S, seed=S + 390, device=device, **SMALL)
        g = torch.Generator(device=device).manual_seed(7)
        state = [torch.randn(shape, generator=g, device=device) for shape in ((S, n), (S, m), (S, m), (S, m))]
        one32 = (b, A, *state, p.W1[3], p.W2[3], p.theta1[3].contiguous(), p.theta2[3].contiguous(),
                 p.beta[3:4].contiguous())
        one16 = tuple(t.bfloat16() for t in one32[:-1]) + (one32[-1],)
        fns = [lambda: layer_step(*one16), lambda: layer_step(*one32), lambda: layer_step_plain(*one16)]
        for fn in fns:
            fn()
        ms16, ms32, plain_ms = median_ms(fns, 31)
        b2b = {0: [], 1: []}
        for turn in range(4):
            for i in ((0, 1) if turn % 2 == 0 else (1, 0)):
                b2b[i].append(back_to_back_ms(fns[i], rounds=1))
        bms, by = bf16_layer_bound(S, m, n)
        fns[0]()
        out["layer"] = {"ms": ms16, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "fp32_ms": ms32,
                        "back_to_back_ms": float(np.median(b2b[0])), "fp32_back_to_back_ms": float(np.median(b2b[1])),
                        "fp32_bound_ms": layer_bound(S, m, n)[0],
                        **device_us(fns[0], f"bf16 layer step S={S}"),
                        **device_us(fns[1], f"fp32 layer step S={S}", prefix="fp32_"),
                        "host_enqueue_us": host_enqueue_us(torch, fns[0])}
        fns[0]()
        out["layer"].update(launched_plan(layer_step))
        emit("timing_bf16", kernel="layer_step", config=f"synthetic_small S={S}, one call (one layer), bf16 state",
             **out["layer"], card=card)
    return out


# -- bf16 training (phases 26-30) ---------------------------------------------

# The bf16 trajectory kernel against its plain version: each stack within
# this many bf16 ulps of its largest magnitude. The state stays fp32, so
# another summation order moves a stored value by at most the one
# rounding it meets: one ulp of that value, at most one of the largest.
TRAJ16_TOL_ULPS = 1.0
# The bf16 backward kernel against unroll_bwd_plain_bf16: each gradient
# within this many bf16 ulps of its leaf's largest magnitude. Each is
# rounded once on output (one ulp at most); the activations it rounds on
# the way (gp2, gAx1, gp1) may round the other way after another fp32
# summation order, moving a sum by a fraction of an ulp more.
BWD16_TOL_ULPS = 2.0
# The step on bf16 gradients: the clip scale of the kernel (fp64 leaf sums)
# and of the plain version (fp32 leaf sums), each leaf's sum then rounded
# to bf16: where one rounds the other way, the total moves by at most one
# bf16 step of that sum and its rounding by one more, the norm by half of
# both; held at 2^-7. The kernel's own rule is held to equality apart
# (step_checks.clip_scale_diff).
STEP16_SCALE_REL = 2.0 ** -7


def check_traj_bf16(torch, device) -> float:
    """Phase 26: the bf16 trajectory kernel (``traj_persistent`` on bf16
    storage: fp32 state, rounded stack stores) against
    trajectory_forward_plain_bf16 at synthetic_small S = 64, 256 and
    synthetic_large S = 1024, with and without the Ax stack: each stack
    within TRAJ16_TOL_ULPS; a second call bit for bit; its launches counted
    in launches_bf16 only; the plan. Returns the largest max|diff|."""
    from dladmm_tpu_torch.ops.cuda_traj import trajectory_forward, trajectory_forward_plain_bf16

    worst = 0.0
    with torch.no_grad():
        for label, shape, S in (("synthetic_small", SMALL, 64), ("synthetic_small", SMALL, 256),
                                ("synthetic_large", LARGE, 1024)):
            A, b, p = bf16_case(torch, shape, S, seed=S + 17, device=device)
            for with_tax in (True, False):
                n32, n16 = trajectory_forward.launches, trajectory_forward.launches_bf16
                got = trajectory_forward(b, A, *p, with_tax=with_tax)
                again = trajectory_forward(b, A, *p, with_tax=with_tax)
                want = trajectory_forward_plain_bf16(b, A, *p, with_tax=with_tax)
                torch.cuda.synchronize()
                if trajectory_forward.launches != n32 or trajectory_forward.launches_bf16 != n16 + 2:
                    raise AssertionError("bf16 trajectory launches not counted apart from fp32 ones")
                names = ("tx", "tz", "tlam", "tax")[: len(want)]
                for g in got:
                    if g.dtype != torch.bfloat16 or not torch.isfinite(g.float()).all():
                        raise AssertionError(f"traj bf16 {label} S={S}: a stack is {g.dtype} or not finite")
                diff = bf16_diff(got, want, names)
                for name, (ulps, _, err) in diff.items():
                    if not ulps <= TRAJ16_TOL_ULPS:
                        raise AssertionError(f"traj bf16 {label} S={S} with_tax={with_tax}: {name} "
                                             f"{ulps} bf16 ulps > {TRAJ16_TOL_ULPS}")
                    worst = max(worst, err)
                if not all(torch.equal(g, w) for g, w in zip(got, again)):
                    raise AssertionError(f"traj bf16 {label} S={S} with_tax={with_tax}: a second call differs")
                emit("kernel_traj_bf16", case=f"{label} S={S} with_tax={with_tax}",
                     ulps_of_max={k: v[0] for k, v in diff.items()},
                     elements_differing={k: v[1] for k, v in diff.items()},
                     elements={k: g.numel() for k, g in zip(names, got)},
                     max_abs_err={k: v[2] for k, v in diff.items()}, tolerance_ulps=TRAJ16_TOL_ULPS,
                     repeats_bit_for_bit=True, **launched_plan(trajectory_forward))
                del got, again, want
            del A, b, p
    return worst


def bwd16_case(torch, shape, S: int, seed: int, device, scalar_theta=False, ties=False):
    """bwd_case in bf16: the params, A and b cast to bf16 (ties set after
    the cast, so that they hold in bf16), the bf16 trajectory kernel's
    stacks and bf16 cotangents."""
    from dladmm_tpu_torch.ops.cuda_traj import trajectory_forward

    A, b, p = bf16_case(torch, shape, S, seed=seed, device=device)
    if scalar_theta:
        p = p._replace(theta1=p.theta1.float().mean(dim=1, keepdim=True).bfloat16(),
                       theta2=p.theta2.float().mean(dim=1, keepdim=True).bfloat16())
    if ties:
        p.theta1[1, ::2] = 0.0
        p.beta[0] = 1e-6
    with torch.no_grad():
        traj = trajectory_forward(b, A, *p, with_tax=True)
    g = torch.Generator(device=device).manual_seed(seed)
    n, m = shape["n"], shape["m"]
    cts = (torch.randn((S, n), generator=g, device=device).bfloat16(),
           torch.randn((S, m), generator=g, device=device).bfloat16(),
           (0.1 * torch.randn((S, m), generator=g, device=device)).bfloat16())
    return A, b, p, traj, cts


def check_bwd_bf16(torch, device) -> dict:
    """Phase 27: the bf16 backward kernel against unroll_bwd_plain_bf16 on
    the bf16 trajectory kernel's stacks, with and without data grads:
    synthetic_small S = 64 (whole batch; also (K, 1) thresholds with ties
    at theta = 0 and beta = 1e-6), S = 1024 with bs = 128, and the smoke
    preset at S = 1024 on the policy's split (the chunked route); each
    gradient within BWD16_TOL_ULPS bf16 ulps of its leaf's largest
    magnitude, with the elements that differ; a second call bit for bit;
    launches counted in launches_bf16 only. Returns the largest max|diff|
    of each route."""
    from dladmm_tpu_torch.models.unroll import DLADMMParams
    from dladmm_tpu_torch.ops.cuda_bwd import bwd_chunk_batch, unroll_bwd, unroll_bwd_plain_bf16, weight_wave

    wave = weight_wave(device, bf16=True)
    emit("kernel_bwd_bf16", weight_wave=wave, fp32_weight_wave=weight_wave(device))
    cases = [
        ("synthetic_small", SMALL, 64, None, {}),
        ("synthetic_small", SMALL, 64, None, {"scalar_theta": True, "ties": True}),
        ("synthetic_small", SMALL, 1024, 128, {}),
        ("smoke", SMOKE, 1024, bwd_chunk_batch(SMOKE["m"], SMOKE["n"], SMOKE["m"], 1024, SMOKE["K"], wave),
         {"ties": True}),
    ]
    errs = {"whole": 0.0, "chunked": 0.0}
    names = (*DLADMMParams._fields, "gA", "gb")
    for label, shape, S, bs, kw in cases:
        A, b, p, traj, cts = bwd16_case(torch, shape, S, seed=S + 23, device=device, **kw)
        route = "chunked" if bs is not None and bs < S else "whole"
        for data_grads in (True, False):
            n32, n16 = dict(unroll_bwd.launches), dict(unroll_bwd.launches_bf16)
            with torch.no_grad():
                got = unroll_bwd(b, A, *p, *traj, *cts, bs=bs, data_grads=data_grads)
                want = unroll_bwd_plain_bf16(b, A, *p, *traj, *cts, bs=bs, data_grads=data_grads)
            torch.cuda.synchronize()
            if unroll_bwd.launches != n32 or unroll_bwd.launches_bf16[route] != n16[route] + 1:
                raise AssertionError("bf16 backward launches not counted apart from fp32 ones")
            pairs = [(nm, g, w) for nm, g, w in zip(names, (*got[0], *got[1:]), (*want[0], *want[1:]))
                     if g is not None or w is not None]
            for nm, g, w in pairs:
                if g is None or w is None or not torch.isfinite(g.float()).all():
                    raise AssertionError(f"bwd bf16 {label} S={S}: {nm} missing or not finite")
            diff = bf16_diff([g for _, g, _ in pairs], [w for _, _, w in pairs], [nm for nm, _, _ in pairs])
            for nm, (ulps, _, err) in diff.items():
                if not ulps <= BWD16_TOL_ULPS:
                    raise AssertionError(f"bwd bf16 {label} S={S} bs={bs}: {nm} {ulps} bf16 ulps > {BWD16_TOL_ULPS}")
                errs[route] = max(errs[route], err)
            emit("kernel_bwd_bf16", case=f"{label} S={S} bs={bs} {kw or ''}".strip(), route=route,
                 data_grads=data_grads, ulps_of_max={k: v[0] for k, v in diff.items()},
                 elements_differing={k: v[1] for k, v in diff.items()},
                 elements={nm: g.numel() for nm, g, _ in pairs},
                 max_abs_err={k: v[2] for k, v in diff.items()}, tolerance_ulps=BWD16_TOL_ULPS,
                 dtypes={nm: str(g.dtype) for nm, g, _ in pairs})
        with torch.no_grad():
            again = unroll_bwd(b, A, *p, *traj, *cts, bs=bs, data_grads=False)
        if not all(torch.equal(g, w) for g, w in zip(got[0], again[0])):
            raise AssertionError(f"bwd bf16 {label} S={S} bs={bs}: a second call differs")
        emit("kernel_bwd_bf16", case=f"{label} S={S} bs={bs}", route=route, repeats_bit_for_bit=True,
             **launched_plan(unroll_bwd))
        del A, b, p, traj, cts, got, want, again
    return errs


def check_step_bf16(torch, tqa, device) -> dict:
    """Phase 28: adam_step on bf16 gradient leaves with the bf16 compute
    copy, int8 and the four dense formats, on the five leaves of
    synthetic_small and synthetic_large, 3 chained steps (warmup-cosine,
    clip 1.0) from phase 8's state with its gradients rounded to bf16:
    each step's state equal bit for bit to the one-leaf sweeps' run on the
    widened gradients with the step's scalars (the flat int8 leaves within
    a code step), and held against the plain version's step as in phases 8
    and 14 (step_checks.plain_step_diff); the copy equal bit for bit to
    the kernel's new master rounded to nearest; [c1, c2, lr] within 2 fp32
    ulps of step_scalars' and the clip scale within STEP16_SCALE_REL of
    it (the bf16 norm), and equal to the scale of the prologue's rule
    computed apart, which the fp32 norm's scale fails
    (step_checks.clip_scale_diff); launches counted in launches_bf16
    only; a second first step bit for bit. Returns each format's largest
    master difference from the plain version."""
    from dladmm_tpu_torch.train import step_checks as sc

    max_err = {}
    sched = tqa.WarmupCosine(0.0, 1e-2, 2, 40)
    for fmt in ("int8", *tqa.DENSE_FMTS):
        for config, shapes in STEP_SHAPES.items():
            params, mu, nu, grads32 = sc.step_state(shapes, fmt, seed=len(config) + len(fmt) + 1, device=device)
            grads = [type(g)(*(t.bfloat16() for t in g)) for g in grads32]
            copy = type(params)(*(torch.empty_like(t, dtype=torch.bfloat16) for t in params))
            again = sc.clone_state(params, mu, nu)
            copy2 = type(params)(*(torch.empty_like(t, dtype=torch.bfloat16) for t in params))
            count = torch.tensor(1, dtype=torch.int32, device=device)
            detail = {"scal_max_ulps": 0, "clip_scale_rel": 0.0, "clip_scale_rule_rel": 0.0,
                      "fp32_norm_clip_scale_rel": [], "near_boundary": [], "clipped": [], "plain": []}
            for step, g in enumerate(grads):
                label = f"step bf16 {fmt} {config} {step}"
                pre = sc.clone_state(params, mu, nu)
                old = count
                n32, n16 = tqa.adam_step.launches, tqa.adam_step.launches_bf16
                count, scal, seeds = tqa.adam_step(g, params, mu, nu, count, fmt, sched, 1.0, copy=copy)
                if tqa.adam_step.launches != n32 or tqa.adam_step.launches_bf16 != n16 + 2:
                    raise AssertionError(f"{label}: bf16 steps not counted apart from fp32 ones")
                pscal, pcount = tqa.step_scalars(g, old, sched, 1.0)
                one = sc.clone_state(*pre)
                sc.one_leaf_step(fmt, [t.float() for t in g], *one, scal, seeds)
                if step == 0:
                    tqa.adam_step(g, *again, old, fmt, sched, 1.0, copy=copy2)
                torch.cuda.synchronize()
                ulps = sc.scal_ulps(scal[:3], pscal[:3])
                rel = abs(float(scal[3]) - float(pscal[3])) / float(pscal[3])
                if not torch.equal(count, pcount) or ulps > 2 or not rel <= STEP16_SCALE_REL:
                    raise AssertionError(f"{label}: count {int(count)}, scal {scal.tolist()} vs plain "
                                         f"{pscal.tolist()} ({ulps} ulps, clip scale {rel} relative)")
                rule = sc.clip_scale_diff(g, 1.0, float(scal[3]), label)
                sc.check_against_one_leaf(fmt, (params, mu, nu), one, label)
                if not all(torch.equal(c, t.to(torch.bfloat16)) for c, t in zip(copy, params)):
                    raise AssertionError(f"{label}: the copy is not the new master rounded")
                if step == 0 and not (sc.same_state((params, mu, nu), again)
                                      and all(torch.equal(a, b) for a, b in zip(copy, copy2))):
                    raise AssertionError(f"{label}: a second step from the same state differs")
                plain = sc.plain_step_diff(fmt, g, pre, (params, mu, nu), scal, seeds, label)
                detail["scal_max_ulps"] = max(detail["scal_max_ulps"], ulps)
                detail["clip_scale_rel"] = max(detail["clip_scale_rel"], rel)
                detail["clip_scale_rule_rel"] = max(detail["clip_scale_rule_rel"], rule["rel"])
                detail["fp32_norm_clip_scale_rel"].append(rule["fp32_norm_rel"])
                detail["near_boundary"].append(rule["near_boundary"])
                detail["clipped"].append(float(scal[3]) < 1.0)
                detail["plain"].append(plain)
                max_err[fmt] = max(max_err.get(fmt, 0.0), plain["master_max_abs_err"])
                del pre, one
            emit("kernel_step_bf16", case=f"{fmt} {config} five leaves", steps=3, copy_is_rounded_master=True,
                 repeats_bit_for_bit=True, **detail)
            del params, mu, nu, grads, grads32, again, copy, copy2
    return max_err


# The two bf16 training recipes of the slice on synthetic_small: (a) the
# final-layer loss at constant 2e-4 (BASELINE.md:125,210: the JAX
# package's bf16 quality record, -11.52 against fp32's -11.54 dB at 600
# steps), (b) the shipped recipe (deep supervision, int8 moments, clip
# 1.0, cosine) at 300 steps. The limit of each on |bf16 - fp32| NMSE on
# the same seed.
BF16_RECIPES = {
    "a": (dict(steps=600, lr=2e-4, lr_schedule=None, clip_norm=None, layer_loss=None,
               moment_dtype="float32_pallas", eval_every=600), 0.1),
    "b": (dict(steps=300, layer_loss="uniform", moment_dtype="int8_pallas", clip_norm=1.0,
               lr_schedule="cosine", eval_every=300), 0.2),
}


def reset_training_counts() -> None:
    """Every training kernel's launch count, fp32 and bf16, and the
    whole-unroll kernel's (run_denoise and the solver serve through it),
    set to 0."""
    from dladmm_tpu_torch.ops import cuda_bwd, cuda_traj, cuda_unroll
    from dladmm_tpu_torch.train import qadam_cuda

    cuda_traj.trajectory_forward.launches = cuda_traj.trajectory_forward.launches_bf16 = 0
    cuda_bwd.reset_launches()
    qadam_cuda.adam_step.launches = qadam_cuda.adam_step.launches_bf16 = 0
    cuda_unroll.unroll_forward.launches = 0


def training_counts() -> dict:
    from dladmm_tpu_torch.ops import cuda_bwd, cuda_traj, cuda_unroll
    from dladmm_tpu_torch.train import qadam_cuda

    return {"unroll_forward": cuda_unroll.unroll_forward.launches,
            "trajectory_forward": cuda_traj.trajectory_forward.launches,
            "trajectory_forward_bf16": cuda_traj.trajectory_forward.launches_bf16,
            **{f"unroll_bwd_{r}": v for r, v in cuda_bwd.unroll_bwd.launches.items()},
            **{f"unroll_bwd_{r}_bf16": v for r, v in cuda_bwd.unroll_bwd.launches_bf16.items()},
            "adam_step": qadam_cuda.adam_step.launches, "adam_step_bf16": qadam_cuda.adam_step.launches_bf16}


def train_bf16_slice(torch, device, tmp) -> dict:
    """Phase 29: bf16 training through the entry points a user calls:
    ``fit`` on synthetic_small with compute_dtype="bfloat16", its forward
    built as run.py builds it (models/api.select_forward), for recipe (a)
    and (b), then the same on fp32 from the same seed. Every training
    kernel's count is set to 0 just before each run and read just after:
    a bf16 run launches the bf16 trajectory kernel once a step, (a) the
    bf16 backward kernel once a step, the bf16 step twice a step, and no
    fp32 training kernel (the fp32 trajectory kernel only at the eval,
    which runs on the fp32 masters); an fp32 run launches no bf16 kernel.
    Finite losses; the final NMSE, residual and the gap to fp32 (within
    the recipe's limit), (a) below the port's LADMM at K = 15; the bf16 (a)
    run's checkpoint (``tmp``) served by ``serve.main --ckpt-dir`` at its
    last eval's NMSE within 0.01 dB. Returns {recipe: the bf16 run's
    results and launches}."""
    import dataclasses

    from dladmm_tpu_torch.models.api import select_forward
    from dladmm_tpu_torch.serve import main as serve_main
    from dladmm_tpu_torch.train.loop import fit
    from dladmm_tpu_torch.utils.config import get_config

    base = get_config("synthetic_small")
    p = base.problem
    out = {}
    for recipe, (train, limit) in BF16_RECIPES.items():
        results = {}
        for cd in ("bfloat16", "float32"):
            cfg = dataclasses.replace(base, train=dataclasses.replace(base.train, compute_dtype=cd, **train))
            t = cfg.train
            fwd, _, route = select_forward(p.m, p.n, p.m, t.batch, need_trajectory=t.layer_loss is not None,
                                           device=device, dtype=cd)
            ckpt = tmp if (cd == "bfloat16" and recipe == "a") else None
            reset_training_counts()
            t0 = time.monotonic()
            _, hist = fit(cfg, forward_fn=fwd, ckpt_dir=ckpt, device=device)
            wall = time.monotonic() - t0
            counts = training_counts()
            last = hist[-1]
            if not all(math.isfinite(h["loss"]) and math.isfinite(h["nmse_db"]) for h in hist):
                raise AssertionError(f"bf16 slice ({recipe}) {cd}: not finite: {hist[-1]}")
            steps, evals = t.steps, len(hist)
            if cd == "bfloat16":
                want = {"trajectory_forward_bf16": steps, "trajectory_forward": evals,
                        "unroll_bwd_whole_bf16": steps if recipe == "a" else 0, "adam_step_bf16": 2 * steps}
                moved = {k: v for k, v in counts.items() if k not in want and v}
            else:
                want = {"trajectory_forward": steps + evals, "unroll_bwd_whole": steps if recipe == "a" else 0,
                        "adam_step": 2 * steps}
                moved = {k: v for k, v in counts.items() if k not in want and v}
            if any(counts[k] != v for k, v in want.items()) or moved:
                raise AssertionError(f"bf16 slice ({recipe}) {cd}: launches {counts}, expected {want} and no other")
            results[cd] = {"final_nmse_db": last["nmse_db"], "final_residual": last["residual"],
                           "last_loss": last["loss"], "ladmm_nmse_db_at_K": last["curves"]["ladmm_curve_db"][-1],
                           "route": route, "launches": counts, "fit_wall_s": wall}
        gap = results["bfloat16"]["final_nmse_db"] - results["float32"]["final_nmse_db"]
        if not abs(gap) <= limit:
            raise AssertionError(f"bf16 slice ({recipe}): NMSE {results['bfloat16']['final_nmse_db']} dB, "
                                 f"fp32 {results['float32']['final_nmse_db']} dB: gap {gap} > {limit}")
        if recipe == "a" and not results["bfloat16"]["final_nmse_db"] < results["bfloat16"]["ladmm_nmse_db_at_K"]:
            raise AssertionError(f"bf16 slice (a): NMSE {results['bfloat16']['final_nmse_db']} does not beat "
                                 f"LADMM {results['bfloat16']['ladmm_nmse_db_at_K']}")
        emit("slice_train_bf16", recipe=recipe, config="synthetic_small batch 64", train=train,
             bf16=results["bfloat16"], fp32=results["float32"], gap_db=gap, limit_db=limit)
        out[recipe] = results["bfloat16"]
    # The chunked route's main path: recipe (a) at the smoke preset's batch
    # 1024, where bwd_chunk_batch splits the weight gradients.
    smoke = get_config("smoke")
    cfg = dataclasses.replace(smoke, train=dataclasses.replace(
        smoke.train, compute_dtype="bfloat16", batch=1024, steps=20, eval_every=20, layer_loss=None,
        moment_dtype="float32_pallas", lr=2e-4, lr_schedule=None, clip_norm=None))
    sp = smoke.problem
    fwd, _, route = select_forward(sp.m, sp.n, sp.m, 1024, device=device, dtype="bfloat16")
    reset_training_counts()
    _, hist = fit(cfg, forward_fn=fwd, device=device)
    counts = training_counts()
    if counts["unroll_bwd_chunked_bf16"] != 20 or counts["unroll_bwd_whole_bf16"] or counts["unroll_bwd_chunked"] \
            or not math.isfinite(hist[-1]["loss"]):
        raise AssertionError(f"smoke batch 1024 bf16: {counts}, {hist[-1]}")
    emit("slice_train_bf16", recipe="a on smoke batch 1024 (chunked backward)", route=route, launches=counts,
         final_nmse_db=hist[-1]["nmse_db"], last_loss=hist[-1]["loss"])
    out["chunked"] = {"launches": counts}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_main(["--config=synthetic_small", "--ckpt-dir", tmp, "--demo", "256"])
    served = json.loads(buf.getvalue().strip().splitlines()[-1])
    trained = out["a"]["final_nmse_db"]
    if rc != 0 or served["route"] != "cuda-whole-unroll-kernel" or not abs(served["nmse_db"] - trained) <= NMSE_TOL_DB:
        raise AssertionError(f"serving the bf16 checkpoint: rc {rc}, {served}, trained {trained} dB")
    emit("slice_train_bf16_serve", serve=served, trained_nmse_db=trained)
    return out


def phased_step_bf16(torch, A, A16, opt, state, i, recipe, bf16, mark=None, batch=64):
    """One training step of recipe (a) or (b) (``batch`` rows from
    step_generator(0, i)), split into data, forward, backward and
    optimizer as ``phased_step``: in bf16 on the state's compute copy (b
    cast each step, A16 once), the fused step rewriting the copy; or the
    fp32 twin on the masters."""
    from dladmm_tpu_torch.data.synthetic import make_batch, step_generator
    from dladmm_tpu_torch.models.unroll import DLADMMParams
    from dladmm_tpu_torch.ops.cuda_traj import make_unrolled_trajectory
    from dladmm_tpu_torch.ops.cuda_unroll import make_unrolled_forward
    from dladmm_tpu_torch.train.loop import TrainState, _layer_weights, weighted_trajectory_mse

    mark = mark or (lambda k: None)
    mark(0)
    data = make_batch(step_generator(0, i), A, batch)
    b = data.b.to(torch.bfloat16) if bf16 else data.b
    src = state.compute_params if bf16 else state.params
    leaves = [t.detach().requires_grad_() for t in src]
    q = DLADMMParams(*leaves)
    mark(1)
    if recipe == "a":
        x, z, _ = make_unrolled_forward()(q, A16 if bf16 else A, b)
        loss = torch.mean((x - data.x_star) ** 2) + torch.mean((z - data.e_star) ** 2)
    else:
        tx, tz, _ = make_unrolled_trajectory()(q, A16 if bf16 else A, b)
        w = _layer_weights("uniform", len(state.params.beta), device=A.device)
        loss = weighted_trajectory_mse(tx, tz, data.x_star, data.e_star, w)
    mark(2)
    grads = DLADMMParams(*torch.autograd.grad(loss, leaves))
    mark(3)
    params, opt_state, cp = opt.fused_apply(grads, state.opt_state, state.params,
                                            torch.bfloat16 if bf16 else None, state.compute_params)
    mark(4)
    return TrainState(params, opt_state, state.step + 1, cp), loss


def bf16_setup(torch, device, recipe, bf16, shape=None):
    """Dictionary, its bf16 cast, the recipe's optimizer and a fresh state
    (with the compute copy for bf16) at synthetic_small (or ``shape``)."""
    import dataclasses

    from dladmm_tpu_torch.data.synthetic import make_dictionary
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.train.loop import _build_optimizer, make_train_state
    from dladmm_tpu_torch.utils.config import get_config

    shape = shape or SMALL
    base = get_config("synthetic_small").train
    t = dataclasses.replace(base, **BF16_RECIPES[recipe][0])
    A = make_dictionary(torch.Generator().manual_seed(0), shape["m"], shape["n"]).to(device)
    opt = _build_optimizer(t)
    state = make_train_state(init_dladmm_params(A, K=shape["K"]), opt, torch.bfloat16 if bf16 else None)
    return A, A.bfloat16(), opt, state


def time_train_bf16(torch, device, card) -> dict:
    """Phase 30: bf16 training beside fp32, in turns. (1) A step by phase
    (CUDA events, median of 20 after 4 warm-ups), bf16 and fp32 in turns,
    recipe (a) and (b) at synthetic_small batch 64, and (a) at
    synthetic_large batch 1024 (6 after 2). (2) Each bf16 kernel beside
    its fp32 twin, in turns: CUDA-event ms, the profiler's device µs a
    call (``profile_fn(events_fallback=True)``), the bound (stacks and
    gradients at 2 bytes) and the bf16 plain version's ms: the trajectory
    kernel (with tAx) and the backward at synthetic_small S = 64 and
    synthetic_large S = 1024, the chunked backward at the smoke preset's
    S = 1024 and synthetic_small S = 1024 (bs = 128), the step on bf16
    gradients with the copy (int8 and float32, the prologue's and the
    sweep's device µs). (3) The optimizer phase of bf16 steps held to the
    prologue and one sweep a step (optimizer_phase), with the device µs
    a step by phase. Returns the kernels line's numbers."""
    from dladmm_tpu_torch.ops.cuda_bwd import unroll_bwd, unroll_bwd_plain_bf16
    from dladmm_tpu_torch.ops.cuda_traj import trajectory_forward, trajectory_forward_plain_bf16
    from dladmm_tpu_torch.train import qadam_cuda as tqa

    out = {"step": {}}
    for recipe, shape, label, reps, warm in (("a", SMALL, "synthetic_small batch 64", 24, 4),
                                             ("b", SMALL, "synthetic_small batch 64", 24, 4),
                                             ("a", LARGE, "synthetic_large batch 1024", 8, 2)):
        S = 1024 if shape is LARGE else 64
        runs = {}
        for kind in ("bf16", "fp32"):
            A, A16, opt, state = bf16_setup(torch, device, recipe, kind == "bf16", shape)
            runs[kind] = [A, A16, opt, state]
        phases = {k: [] for k in runs}
        for rep in range(reps):
            for kind in (("bf16", "fp32") if rep % 2 == 0 else ("fp32", "bf16")):
                A, A16, opt, state = runs[kind]
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
                torch.cuda.synchronize()
                runs[kind][3], _ = phased_step_bf16(torch, A, A16, opt, state, rep, recipe, kind == "bf16",
                                                    mark=lambda k: ev[k].record(), batch=S)
                ev[4].synchronize()
                if rep >= warm:
                    phases[kind].append([ev[j].elapsed_time(ev[j + 1]) for j in range(4)])
        step = {}
        for kind in runs:
            arr = np.array(phases[kind])
            step[kind] = {"step_ms": float(np.median(arr.sum(axis=1))), "data_ms": float(np.median(arr[:, 0])),
                          "forward_ms": float(np.median(arr[:, 1])), "backward_ms": float(np.median(arr[:, 2])),
                          "optimizer_ms": float(np.median(arr[:, 3]))}
        key = f"{recipe} {label}"
        out["step"][key] = step
        emit("timing_train_bf16", recipe=recipe, config=label, step=step, steps=reps - warm,
             bf16_over_fp32_step=step["bf16"]["step_ms"] / step["fp32"]["step_ms"], card=card)
        del runs

    def turns(name, config, fn16, fn32, plain16, bound16, bound32, reps):
        for fn in (fn16, fn32, plain16):
            fn()
        ms16, ms32, plain_ms = median_ms([fn16, fn32, plain16], reps)
        b2b = {"bf16": [], "fp32": []}
        for turn in range(4):
            for kind in (("bf16", "fp32") if turn % 2 == 0 else ("fp32", "bf16")):
                b2b[kind].append(back_to_back_ms(fn16 if kind == "bf16" else fn32, calls=5, rounds=1))
        dev16 = profile_fn(fn16, f"bf16 {name} {config}", events_fallback=True)
        dev32 = profile_fn(fn32, f"fp32 {name} {config}", events_fallback=True)
        # µs a launch of each kernel: the profiler may drop some of a window's launches
        per_launch = lambda prof: {k: v["us"] / v["calls"] for k, v in prof["per_call"].items() if v["calls"]}  # noqa: E731
        row = {"ms": ms16, "plain_ms": plain_ms, "bound_ms": bound16[0], "bound_by": bound16[1],
               "device_us_per_call": dev16["device_us_per_call"], "device_kernels": dev16["per_call"],
               "device_us_per_launch": per_launch(dev16),
               "back_to_back_ms": float(np.median(b2b["bf16"])), "host_enqueue_us": host_enqueue_us(torch, fn16),
               **time_from(dev16),
               "fp32": {"ms": ms32, "device_us_per_call": dev32["device_us_per_call"], "bound_ms": bound32[0],
                        "device_us_per_launch": per_launch(dev32),
                        "back_to_back_ms": float(np.median(b2b["fp32"])), **time_from(dev32)}}
        emit("timing_train_bf16_kernel", kernel=name, config=config, **row,
             bf16_over_fp32_device=row["device_us_per_call"] / row["fp32"]["device_us_per_call"], card=card)
        return row

    with torch.no_grad():
        for label, shape, S in (("synthetic_small", SMALL, 64), ("synthetic_large", LARGE, 1024)):
            A, b, p = problem(torch, S=S, seed=S + 41, device=device, **shape)
            A16, b16, p16 = A.bfloat16(), b.bfloat16(), type(p)(*(t.bfloat16() for t in p))
            reps = 21 if S == 64 else 7
            row = turns("trajectory_forward", f"{label} S={S} with_tax",
                        lambda: trajectory_forward(b16, A16, *p16, with_tax=True),
                        lambda: trajectory_forward(b, A, *p, with_tax=True),
                        lambda: trajectory_forward_plain_bf16(b16, A16, *p16, with_tax=True),
                        traj_bound(S, with_tax=True, itemsize=2, **shape), traj_bound(S, with_tax=True, **shape), reps)
            row.update(launched_plan(trajectory_forward))
            out[("trajectory_forward", label, S)] = row
            del A, b, p, A16, b16, p16
        for name, label, shape, S, bs in (("unroll_bwd", "synthetic_small", SMALL, 64, None),
                                          ("unroll_bwd", "synthetic_large", LARGE, 1024, None),
                                          ("unroll_bwd_chunked", "synthetic_small", SMALL, 1024, 128),
                                          ("unroll_bwd_chunked", "smoke", SMOKE, 1024, 128)):
            A, b, p, traj, cts = bwd16_case(torch, shape, S, seed=S + 43, device=device)
            A32, b32, p32, traj32, cts32 = A.float(), b.float(), type(p)(*(t.float() for t in p)), \
                [t.float() for t in traj], [t.float() for t in cts]
            row = turns(name, f"{label} S={S} bs={bs}",
                        lambda: unroll_bwd(b, A, *p, *traj, *cts, bs=bs),
                        lambda: unroll_bwd(b32, A32, *p32, *traj32, *cts32, bs=bs),
                        lambda: unroll_bwd_plain_bf16(b, A, *p, *traj, *cts, bs=bs),
                        bwd_bound(S, itemsize=2, **shape), bwd_bound(S, **shape), 21 if S == 64 else 7)
            row.update(launched_plan(unroll_bwd))
            out[(name, label, S)] = row
            del A, b, p, traj, cts, A32, b32, p32, traj32, cts32

    from dladmm_tpu_torch.train import step_checks as sc

    shapes = STEP_SHAPES["synthetic_small"]
    sched = tqa.WarmupCosine(0.0, 1e-2, 15, 300)
    for fmt in ("int8", "float32"):
        params, mu, nu, grads = sc.step_state(shapes, fmt, seed=43, device=device)
        g16 = type(grads[0])(*(t.bfloat16() for t in grads[0]))
        copy = type(params)(*(torch.empty_like(t, dtype=torch.bfloat16) for t in params))
        twin = sc.clone_state(params, mu, nu)
        plain = sc.clone_state(params, mu, nu)
        pcopy = type(params)(*(torch.empty_like(t, dtype=torch.bfloat16) for t in params))
        count = torch.tensor(20, dtype=torch.int32, device=device)
        fn16 = lambda: tqa.adam_step(g16, params, mu, nu, count, fmt, sched, 1.0, copy=copy)  # noqa: E731
        fn32 = lambda: tqa.adam_step(grads[0], *twin, count, fmt, sched, 1.0)  # noqa: E731
        plain16 = lambda: tqa.adam_step_plain(g16, *plain, count, fmt, sched, 1.0, copy=pcopy)  # noqa: E731
        bounds = step_bounds(shapes, fmt)  # bf16 g (2 B less) and the copy (2 B more): the same bytes
        row = turns("adam_step", f"{fmt} synthetic_small five leaves, bf16 gradients + copy", fn16, fn32, plain16,
                    bounds["step"], bounds["step"], 31)
        # the prologue reads g once: 2 bytes an element in bf16
        part_bounds = {"prologue": _bound(2 * bounds["elements"], 2 * bounds["elements"] + 16),
                       "sweep": bounds["sweep"]}
        for part, key in (("prologue", "adam_prologue"), ("sweep", "sweep")):
            hits = [v for k, v in row["device_kernels"].items() if key in k]
            calls = sum(v["calls"] for v in hits)
            row[f"{part}_device_us"] = sum(v["us"] for v in hits) / calls if calls else None
            row[f"{part}_bound_us"] = part_bounds[part][0] * 1e3
        out[("adam_step", fmt)] = row
        del params, mu, nu, grads, g16, copy, twin, plain, pcopy

    for recipe, sweep in (("a", "qadam_dense_sweep"), ("b", "qadam_int8_sweep")):
        A, A16, opt, state = bf16_setup(torch, device, recipe, True)
        for i in range(3):
            state, _ = phased_step_bf16(torch, A, A16, opt, state, i, recipe, True)
        box = [state]

        def run(mark, box=box, A=A, A16=A16, opt=opt, recipe=recipe):
            for i in range(3):
                box[0], _ = phased_step_bf16(torch, A, A16, opt, box[0], 3 + i, recipe, True, mark=mark)

        by_phase, opt_ops = optimizer_phase(torch, run, sweep)
        out[("profile", recipe)] = {"device_us_per_step_by_phase": by_phase, "optimizer_phase": opt_ops}
        emit("profile_train_bf16", recipe=recipe, config="synthetic_small batch 64, bf16",
             device_us_per_step_by_phase=by_phase, optimizer_phase=opt_ops, card=card)
        del A, A16, opt, state, box
    return out


# -- the image benchmark, the solver and the XLA-side moments (phases 31-35) --

PATCH = dict(m=64, n=256)  # run_denoise: 8 x 8 patches, the 16 x 16 DCT atoms
# (K, S): the full run (K = 15) and --quick (K = 8) at S = 225 (one 64 x 64
# image), 961 (one 128 x 128: the served test image) and 3844 (the four
# training images); no S is a multiple of the 32 or 64 tile.
PATCH_CASES = ((15, 225), (15, 961), (15, 3844), (8, 225), (8, 961), (8, 3844))
# The quality gates of phase 32 (mean PSNR gain, dB), held on the mean
# over the CLI's own test stream: its three images and the next ones, to
# DENOISE_EVAL_IMAGES in all (module docstring, phase 32).
DENOISE_GATES = {"dct": 28.3, "learned": 28.7, "inpaint": 14.9}
DENOISE_EVAL_IMAGES = 200
FIT_LR = 1e-4  # phase 33's DLADMMSolver.fit learning rate (solver_slice)
XLA_FORMATS = ("int8", "bfloat16", "bfloat16_sr")
XLA_NMSE_DB = 0.2  # an XLA-side format's final NMSE against int8_pallas's


def patch_case(torch, K: int, S: int, seed: int, device):
    """The image benchmark's shape on the card: the DCT dictionary, b the
    median-DC residuals of 8 x 8 patches of impulse-corrupted synthetic
    images (S = 225: one 64 x 64 image; 961: one 128 x 128; 3844: four),
    and LADMM-exact params perturbed as problem()'s."""
    from dladmm_tpu_torch.data.dictionary import dct_dictionary
    from dladmm_tpu_torch.data.images import extract_patches, patch_dc, salt_pepper, synthetic_image
    from dladmm_tpu_torch.models.unroll import DLADMMParams, init_dladmm_params

    size, count = {225: (64, 1), 961: (128, 1), 3844: (128, 4)}[S]
    g = torch.Generator(device=device).manual_seed(seed)
    A = dct_dictionary(device=device)
    patches = torch.cat([extract_patches(salt_pepper(g, synthetic_image(size, device=device), 0.1))
                         for _ in range(count)])
    b = (patches - patch_dc(patches)).contiguous()
    gc = torch.Generator().manual_seed(seed)
    p0 = init_dladmm_params(A.cpu(), K=K)
    leaves = [leaf + 0.05 * torch.randn(leaf.shape, generator=gc) * leaf.pow(2).mean().sqrt() for leaf in p0]
    return A, b, DLADMMParams(*leaves).to(device)


def compare_grads(torch, got, want, label: str) -> dict:
    """Each gradient (the params', gA, gb) of a backward kernel against its
    plain version: finite, the same shape, within BWD_TOL of the plain
    leaf's largest magnitude. Returns {name: (max|diff|, scale)}."""
    from dladmm_tpu_torch.models.unroll import DLADMMParams

    detail = {}
    for name, g, w in zip((*DLADMMParams._fields, "gA", "gb"), (*got[0], *got[1:]), (*want[0], *want[1:])):
        if w is None or g is None:
            if (w is None) != (g is None):
                raise AssertionError(f"{label}: {name} returned by one side only")
            continue
        if tuple(g.shape) != tuple(w.shape) or not torch.isfinite(g).all():
            raise AssertionError(f"{label}: {name} {tuple(g.shape)} or not finite")
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        if not err <= BWD_TOL * scale:
            raise AssertionError(f"{label}: {name} max|diff| {err} > {BWD_TOL} * {scale}")
        detail[name] = {"max_abs_err": err, "scale": scale}
    return detail


def check_patch(torch, device) -> dict:
    """Phase 31: rows 1, 2, 4 and 5 at the image benchmark's shape (m = 64,
    n = 256, the DCT dictionary) for each of PATCH_CASES against their
    plain versions: the whole-unroll and trajectory kernels within TOL,
    the backward within BWD_TOL on the route bwd_chunk_batch picks, on the
    whole batch, and on slices of 128 rows (forced, where 128 < S); each
    call a second time, bit for bit; the plan of each. Returns the largest
    absolute difference of each row."""
    from dladmm_tpu_torch.ops.cuda_bwd import bwd_chunk_batch, unroll_bwd, unroll_bwd_plain, weight_wave
    from dladmm_tpu_torch.ops.cuda_traj import trajectory_forward, trajectory_forward_plain
    from dladmm_tpu_torch.ops.cuda_unroll import unroll_forward, unroll_forward_plain

    wave = weight_wave(device)
    errs = {"unroll_forward": 0.0, "trajectory_forward": 0.0, "whole": 0.0, "chunked": 0.0}
    for K, S in PATCH_CASES:
        label = f"patch m=64 n=256 K={K} S={S}"
        A, b, p = patch_case(torch, K, S, seed=S + K, device=device)
        with torch.no_grad():
            got = unroll_forward(b, A, *p)
            want = unroll_forward_plain(b, A, *p)
            again = unroll_forward(b, A, *p)
            torch.cuda.synchronize()
            errs["unroll_forward"] = max(errs["unroll_forward"], compare(torch, got, want, label, phase="kernel_patch"))
            if not all(torch.equal(g, w) for g, w in zip(got, again)):
                raise AssertionError(f"{label}: the whole-unroll kernel's second call differs")
            emit("kernel_patch", kernel="unroll_forward", case=label, repeats_bit_for_bit=True,
                 **launched_plan(unroll_forward))
            traj = trajectory_forward(b, A, *p, with_tax=True)
            want = trajectory_forward_plain(b, A, *p, with_tax=True)
            again = trajectory_forward(b, A, *p, with_tax=True)
            torch.cuda.synchronize()
            errs["trajectory_forward"] = max(errs["trajectory_forward"], compare(
                torch, traj, want, label, names=("tx", "tz", "tlam", "tax"), phase="kernel_patch"))
            if not all(torch.equal(g, w) for g, w in zip(traj, again)):
                raise AssertionError(f"{label}: the trajectory kernel's second call differs")
            emit("kernel_patch", kernel="trajectory_forward", case=label, repeats_bit_for_bit=True,
                 **launched_plan(trajectory_forward))
            gen = torch.Generator(device=device).manual_seed(S)
            cts = [torch.randn(t[-1].shape, generator=gen, device=device) for t in traj[:3]]
            want = unroll_bwd_plain(b, A, *p, *traj, *cts, data_grads=True)
            policy = bwd_chunk_batch(PATCH["m"], PATCH["n"], PATCH["m"], S, K, wave)
            for bs in dict.fromkeys((policy, None, 128 if 128 < S else None)):
                route = "chunked" if bs is not None and bs < S else "whole"
                case = f"{label} bs={bs}" + (" (the policy's)" if bs == policy else "")
                got = unroll_bwd(b, A, *p, *traj, *cts, bs=bs, data_grads=True)
                again = unroll_bwd(b, A, *p, *traj, *cts, bs=bs, data_grads=True)
                torch.cuda.synchronize()
                detail = compare_grads(torch, got, want, f"bwd {case}")
                errs[route] = max(errs[route], *(v["max_abs_err"] for v in detail.values()))
                if not all(torch.equal(g, w) for g, w in zip((*got[0], *got[1:]), (*again[0], *again[1:]))):
                    raise AssertionError(f"bwd {case}: a second call differs")
                emit("kernel_patch", kernel="unroll_bwd", case=case, route=route, policy_bs=policy, grads=detail,
                     repeats_bit_for_bit=True, **launched_plan(unroll_bwd))
        del A, b, p, traj, want, got, again, cts
    return errs


def run_json(main, argv):
    """(last JSON line, stdout lines, host seconds) of a CLI's main(argv);
    a non-zero return fails."""
    out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    wall = time.monotonic() - t0
    if rc != 0:
        raise AssertionError(f"{main.__module__}.main {argv} returned {rc}")
    lines = out.getvalue().splitlines()
    return json.loads([ln for ln in lines if ln.startswith("{")][-1]), lines, wall


def denoise_gains(torch, net: str, size: int, mode: str, density: float, seed: int, count: int, device):
    """PSNR gains (dB, unrounded) of a saved denoiser on the CLI's test
    stream of --seed ``seed`` continued to ``count`` images: the first
    three are the CLI's own (run_denoise._apply_or_benchmark). In inpaint
    mode the observed pixels must come back exactly."""
    from dladmm_tpu_torch.data.images import synthetic_image
    from dladmm_tpu_torch.metrics.core import psnr
    from dladmm_tpu_torch.run_denoise import _corrupt, child_seeds, denoise_image, load_denoiser

    params, A = load_denoiser(net, device)
    g = torch.Generator(device=device).manual_seed(child_seeds(seed)[1])
    clean = synthetic_image(size, device=device)
    gains, rounded = [], []
    for i in range(count):
        noisy, mask = _corrupt(g, clean, mode, density)
        recon = denoise_image(params, A, noisy, mask=mask)
        if mask is not None and not torch.equal(recon[mask > 0], noisy[mask > 0]):
            raise AssertionError(f"{net}: image {i}: an observed pixel did not pass through exactly")
        pd, pn = float(psnr(recon, clean)), float(psnr(noisy, clean))
        gains.append(pd - pn)
        rounded.append(round(pd, 2) - round(pn, 2))
    return gains, rounded


def denoise_slice(torch, device, tmp) -> dict:
    """Phase 32: ``run_denoise.main`` on the card through the paths a user
    calls, each path's kernel counts set to 0 just before it and read just
    after (each of its kernels > 0, each route as bwd_chunk_batch picks):
    (a) the full DCT run, (b) --dict=learned, (c) --mode=inpaint --quick
    --density=0.3, (d) --layer-loss=uniform --quick (the trajectory kernel
    with the plain reverse sweep: no backward kernel), (e) --quick --save,
    then --load --input-image on a saved corrupted image, whose output must
    equal the in-process denoise_image bit for bit. Quality gates
    (DENOISE_GATES, the JAX package's gains less 0.47-0.54 dB): the mean
    gain over the CLI's test stream continued to DENOISE_EVAL_IMAGES
    images (the CLI's three first; a mean of three swings by dB with one
    image whose impulses cluster where few patches cover, PERF.md §7).
    Returns {path: results and launches}."""
    from dladmm_tpu_torch.data.images import synthetic_image
    from dladmm_tpu_torch.ops.cuda_bwd import bwd_chunk_batch, weight_wave
    from dladmm_tpu_torch.run_denoise import _corrupt, denoise_image, load_denoiser
    from dladmm_tpu_torch.run_denoise import main as denoise_main

    wave = weight_wave(device)
    paths = {
        "dct": (["--save"], dict(K=15, S=3844, steps=400, size=128, mode="denoise", density=0.1, tests=3)),
        "learned": (["--dict=learned", "--save"], dict(K=15, S=3844, steps=400, size=128, mode="denoise",
                                                       density=0.1, tests=3)),
        "inpaint": (["--mode=inpaint", "--quick", "--density=0.3", "--save"],
                    dict(K=8, S=450, steps=60, size=64, mode="inpaint", density=0.3, tests=3)),
        "layer_loss_uniform": (["--layer-loss=uniform", "--quick", "--save"],
                               dict(K=8, S=450, steps=60, size=64, mode="denoise", density=0.1, tests=3)),
        "quick_save": (["--quick", "--save"], dict(K=8, S=450, steps=60, size=64, mode="denoise", density=0.1,
                                                   tests=3)),
    }
    out = {}
    for name, (argv, spec) in paths.items():
        net = str(Path(tmp) / f"{name}.npz")
        reset_training_counts()
        summary, _, wall = run_json(denoise_main, [*argv, net])
        counts = {k: v for k, v in training_counts().items() if v}
        bs = bwd_chunk_batch(PATCH["m"], PATCH["n"], PATCH["m"], spec["S"], spec["K"], wave)
        route = "chunked" if bs is not None and bs < spec["S"] else "whole"
        want = {"trajectory_forward": spec["steps"], "unroll_forward": spec["tests"]}
        if name != "layer_loss_uniform":  # deep supervision: the plain reverse sweep
            want[f"unroll_bwd_{route}"] = spec["steps"]
        if counts != want or summary["route"] != "cuda-whole-unroll-kernel":
            raise AssertionError(f"run_denoise {name}: launches {counts}, expected {want}; route {summary['route']!r}")
        cli_gain = summary["mean_psnr_gain_db"]
        gains, rounded = denoise_gains(torch, net, spec["size"], spec["mode"], spec["density"], 0,
                                       DENOISE_EVAL_IMAGES if name in DENOISE_GATES else 3, device)
        first = [r["psnr_denoised_db"] - r["psnr_noisy_db"] for r in summary["results"]]
        if not np.allclose(rounded[:3], first, atol=1e-9):
            raise AssertionError(f"run_denoise {name}: the saved net's first test images {rounded[:3]} "
                                 f"are not the CLI's {first}")
        mean = float(np.mean(gains))
        if not all(math.isfinite(v) for v in gains) or not cli_gain > 0:
            raise AssertionError(f"run_denoise {name}: gains {gains[:3]}..., CLI mean {cli_gain}")
        gate = DENOISE_GATES.get(name)
        if gate is not None and not mean >= gate:
            raise AssertionError(f"run_denoise {name}: mean gain {mean} dB over {len(gains)} images < {gate} dB "
                                 f"(the CLI's three: {cli_gain} dB)")
        out[name] = {"summary": summary, "launches": counts, "bwd_route": route, "bs": bs, "wall_s": wall,
                     "cli_mean_gain_db": cli_gain, "mean_gain_db": mean, "images": len(gains),
                     "gain_db_p10": float(np.percentile(gains, 10)), "gain_db_min": float(np.min(gains)),
                     "gate_db": gate}
        emit("slice_denoise", path=name, argv=argv, **out[name])

    # (e) the saved --quick net restores a saved corrupted image through the CLI
    net = str(Path(tmp) / "quick_save.npz")
    g = torch.Generator(device=device).manual_seed(7)
    noisy, _ = _corrupt(g, synthetic_image(64, device=device), "denoise", 0.1)
    inp, rec = Path(tmp) / "noisy.npy", Path(tmp) / "recon.npy"
    np.save(inp, noisy.cpu().numpy())
    reset_training_counts()
    summary, _, _ = run_json(denoise_main, ["--load", net, "--input-image", str(inp), "--output-image", str(rec)])
    counts = {k: v for k, v in training_counts().items() if v}
    params, A = load_denoiser(net, device)
    direct = denoise_image(params, A, noisy).cpu().numpy()
    if counts != {"unroll_forward": 1} or summary["shape"] != [64, 64]:
        raise AssertionError(f"run_denoise --load --input-image: {summary}, launches {counts}")
    if not np.array_equal(np.load(rec), direct):
        raise AssertionError("run_denoise --load --input-image differs from the in-process denoise_image")
    out["load_input_image"] = {"summary": summary, "launches": counts, "bit_for_bit": True}
    emit("slice_denoise", path="load_input_image", **out["load_input_image"])
    return out


def solver_slice(torch, device) -> dict:
    """Phase 33: DLADMMSolver on synthetic_small's dictionary on the card,
    each call's kernels counted from 0: the untrained solve (whole-unroll
    kernel) equals the port's classical LADMM at K = 15 within 0.01 dB;
    nmse_curve and trajectory run the trajectory kernel (the curve's last
    layer is the solve's NMSE); fit for 300 steps at lr FIT_LR (trajectory
    and backward kernels, once a step each) lowers the last layer's NMSE;
    a nonneg_l1 solver serves through the whole-unroll kernel's prox
    variant (within TOL of its plain version, x >= 0). fit's default lr
    (1e-3, constant) first raises this loss from the LADMM-exact init at
    this shape, as the JAX package's final-layer loss does (-9.96 dB on the CPU
    against LADMM's -10.79 at 300 steps; phase 15 trains 1000 for it): its
    300-step NMSE is reported beside. Returns each call's launches."""
    from dladmm_tpu_torch.baselines.ladmm import ladmm_run
    from dladmm_tpu_torch.data.synthetic import make_batch, problem_matrices, seed_keys
    from dladmm_tpu_torch.metrics.core import nmse_db
    from dladmm_tpu_torch.models import DLADMMSolver
    from dladmm_tpu_torch.ops.cuda_unroll import unroll_forward_plain
    from dladmm_tpu_torch.utils.config import get_config

    cfg = get_config("synthetic_small")
    A, _ = problem_matrices(cfg, device=device)
    demo = make_batch(seed_keys(cfg)[1], A, 256)
    solver = DLADMMSolver.create(A, K=15)
    launches = {}

    def counted(name, fn):
        reset_training_counts()
        result = fn()
        torch.cuda.synchronize()
        launches[name] = {k: v for k, v in training_counts().items() if v}
        return result

    x, _ = counted("solve", lambda: solver.solve(demo.b))
    with torch.no_grad():
        xl, _, _ = ladmm_run(A, demo.b, iters=15, beta=cfg.problem.beta)
    solve_db, ladmm_db = float(nmse_db(x, demo.x_star)), float(nmse_db(xl, demo.x_star))
    curve0 = counted("nmse_curve", lambda: solver.nmse_curve(demo.b, demo.x_star))
    traj = counted("trajectory", lambda: solver.trajectory(demo.b))
    trained = counted("fit", lambda: solver.fit(0, steps=300, batch=64, lr=FIT_LR))
    curve1 = trained.nmse_curve(demo.b, demo.x_star)
    default_lr_db = float(solver.fit(0, steps=300, batch=64).nmse_curve(demo.b, demo.x_star)[-1])
    nonneg = DLADMMSolver.create(A, K=15, prox_x="nonneg_l1")
    xn, zn = counted("solve_nonneg_l1", lambda: nonneg.solve(demo.b))
    with torch.no_grad():
        want = unroll_forward_plain(demo.b, A, *nonneg.params, prox_x="nonneg_l1")
    torch.cuda.synchronize()
    err = compare(torch, (xn, zn), want[:2], "solver nonneg_l1 S=256", names=("x", "z"), phase="slice_solver")
    expect = {"solve": {"unroll_forward": 1}, "nmse_curve": {"trajectory_forward": 1},
              "trajectory": {"trajectory_forward": 1},
              "fit": {"trajectory_forward": 300, "unroll_bwd_whole": 300},
              "solve_nonneg_l1": {"unroll_forward": 1}}
    if launches != expect:
        raise AssertionError(f"the solver's calls launched {launches}, expected {expect}")
    if not abs(solve_db - ladmm_db) <= NMSE_TOL_DB or not abs(float(curve0[-1]) - solve_db) <= NMSE_TOL_DB:
        raise AssertionError(f"untrained solve {solve_db} dB, curve {float(curve0[-1])} dB, LADMM {ladmm_db} dB")
    if tuple(traj[0].shape) != (15, 256, cfg.problem.n) or not float(curve1[-1]) < float(curve0[-1]):
        raise AssertionError(f"fit did not lower the last layer's NMSE: {float(curve0[-1])} -> {float(curve1[-1])}")
    if not float(xn.min()) >= 0.0:
        raise AssertionError("the nonneg_l1 solver returned a negative x")
    result = {"solve_nmse_db": solve_db, "ladmm_nmse_db": ladmm_db, "curve_untrained_db": curve0.tolist(),
              "curve_trained_db": curve1.tolist(), "fit_lr": FIT_LR, "default_lr_trained_db": default_lr_db,
              "nonneg_max_abs_err": err, "launches": launches}
    emit("slice_solver", config="synthetic_small A, demo batch 256", **result)
    return result


def xla_moments_slice(torch, device, tmp) -> dict:
    """Phase 34: ``run --config=synthetic_small --steps=1000`` (the shipped
    recipe: deep supervision, clip 1.0, cosine) with --moment-dtype
    int8_pallas, then int8, bfloat16 and bfloat16_sr (the XLA-side
    formats, plain PyTorch: no optimizer kernel), each with the training
    counts from 0 (the trajectory kernel once a step and at the eval; the
    optimizer step two a step for int8_pallas and none for the others);
    each XLA-side format's final NMSE within XLA_NMSE_DB of int8_pallas's
    and below LADMM at K = 15. Then bfloat16 with --clip-mode=delayed,
    and ``fit`` with compute_dtype="bfloat16" and bfloat16 moments (the
    bf16 trajectory kernel, bf16 gradients widened by the optimizer),
    each below LADMM. Then int8 through ``fit`` with checkpoints every
    500 steps: a run resumed from its step-500 checkpoint (QTensor
    moments) ends where the uninterrupted one ends, bit for bit, at the
    CLI's int8 run's NMSE within 0.01 dB. Returns {run: results and
    launches}."""
    import dataclasses
    import shutil

    from dladmm_tpu_torch.models.api import select_forward
    from dladmm_tpu_torch.run import main as run_main
    from dladmm_tpu_torch.train.loop import fit
    from dladmm_tpu_torch.utils.config import get_config

    base = ["--config=synthetic_small", "--steps=1000"]
    out = {}

    def cli(name, extra, want):
        reset_training_counts()
        summary, lines, wall = run_json(run_main, [*base, *extra])
        counts = {k: v for k, v in training_counts().items() if v}
        if counts != want or summary["route"] != "cuda-trajectory-kernel":
            raise AssertionError(f"run {extra}: launches {counts}, expected {want}; route {summary['route']!r}")
        if not math.isfinite(summary["final_nmse_db"]) or not summary["final_nmse_db"] < summary["ladmm_nmse_db_at_K"]:
            raise AssertionError(f"run {extra}: NMSE {summary['final_nmse_db']} against LADMM "
                                 f"{summary['ladmm_nmse_db_at_K']}")
        out[name] = {"summary": summary, "launches": counts, "wall_s": wall}
        return summary

    ref = cli("int8_pallas", ["--moment-dtype=int8_pallas"], {"trajectory_forward": 1001, "adam_step": 2000})
    for fmt in XLA_FORMATS:
        got = cli(fmt, [f"--moment-dtype={fmt}"], {"trajectory_forward": 1001})
        gap = got["final_nmse_db"] - ref["final_nmse_db"]
        out[fmt]["gap_to_int8_pallas_db"] = gap
        if not abs(gap) <= XLA_NMSE_DB:
            raise AssertionError(f"--moment-dtype={fmt}: NMSE {got['final_nmse_db']} dB, int8_pallas "
                                 f"{ref['final_nmse_db']} dB: gap {gap} > {XLA_NMSE_DB}")
        emit("slice_train_xla_moments", run=fmt, **out[fmt])
    emit("slice_train_xla_moments", run="int8_pallas", **out["int8_pallas"])
    cli("bfloat16_delayed", ["--moment-dtype=bfloat16", "--clip-mode=delayed"], {"trajectory_forward": 1001})
    out["bfloat16_delayed"]["gap_to_int8_pallas_db"] = (out["bfloat16_delayed"]["summary"]["final_nmse_db"]
                                                       - ref["final_nmse_db"])
    emit("slice_train_xla_moments", run="bfloat16 --clip-mode=delayed", **out["bfloat16_delayed"])

    cfg = get_config("synthetic_small")
    p = cfg.problem

    def fit_run(train, ckpt=None, resume=False):
        c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, steps=1000, **train))
        fwd, _, route = select_forward(p.m, p.n, p.m, c.train.batch, need_trajectory=True, device=device,
                                       dtype=c.train.compute_dtype)
        reset_training_counts()
        t0 = time.monotonic()
        params, hist = fit(c, forward_fn=fwd, ckpt_dir=ckpt, resume=resume, device=device)
        return params, hist, {k: v for k, v in training_counts().items() if v}, route, time.monotonic() - t0

    _, hist, counts, route, wall = fit_run({"compute_dtype": "bfloat16", "moment_dtype": "bfloat16"})
    last = hist[-1]
    if counts != {"trajectory_forward_bf16": 1000, "trajectory_forward": 1} or \
            not last["nmse_db"] < last["curves"]["ladmm_curve_db"][-1]:
        raise AssertionError(f"fit bf16 compute, bfloat16 moments: {counts}, NMSE {last['nmse_db']}")
    out["fit_bf16_compute"] = {"final_nmse_db": last["nmse_db"], "final_residual": last["residual"],
                               "gap_to_int8_pallas_db": last["nmse_db"] - ref["final_nmse_db"],
                               "launches": counts, "route": route, "wall_s": wall}
    emit("slice_train_xla_moments", run="fit compute_dtype=bfloat16, moment_dtype=bfloat16",
         **out["fit_bf16_compute"])

    cold, warm = Path(tmp) / "cold", Path(tmp) / "warm"
    full, hist, counts, _, wall = fit_run({"moment_dtype": "int8", "eval_every": 500}, ckpt=str(cold))
    warm.mkdir()
    shutil.copy(cold / "step_500.pt", warm / "step_500.pt")
    resumed, rhist, rcounts, _, rwall = fit_run({"moment_dtype": "int8", "eval_every": 500}, ckpt=str(warm),
                                                resume=True)
    if [h["step"] for h in rhist] != [1000] or rcounts != {"trajectory_forward": 501}:
        raise AssertionError(f"resume from step 500: {[h['step'] for h in rhist]}, launches {rcounts}")
    if not all(torch.equal(a, b) for a, b in zip(resumed, full)):
        raise AssertionError("the run resumed from step 500 does not end where the uninterrupted run ends")
    if not abs(hist[-1]["nmse_db"] - out["int8"]["summary"]["final_nmse_db"]) <= NMSE_TOL_DB:
        raise AssertionError(f"fit int8 {hist[-1]['nmse_db']} dB != the CLI's {out['int8']['summary']['final_nmse_db']}")
    out["resume_int8"] = {"final_nmse_db": rhist[-1]["nmse_db"], "bit_for_bit": True, "launches": rcounts,
                          "uninterrupted_launches": counts, "wall_s": rwall}
    emit("slice_train_xla_moments", run="int8 resumed from step 500", **out["resume_int8"])
    return out


def phased_denoise_step(torch, A, images, gen, opt, state, lw=None, mark=None):
    """One train_denoiser step (run_denoise.py), split into data (corrupt
    and patchify the four images), forward (denoise_loss), backward and
    optimizer (plain fp32 Adam), as ``phased_step``."""
    from dladmm_tpu_torch.models.unroll import DLADMMParams
    from dladmm_tpu_torch.run_denoise import _make_patch_batch, denoise_loss
    from dladmm_tpu_torch.train.loop import _apply

    mark = mark or (lambda k: None)
    mark(0)
    b, tr, tn = _make_patch_batch(gen, images, 0.1, 8, 4)
    leaves = [p.detach().requires_grad_() for p in state.params]
    mark(1)
    loss = denoise_loss(DLADMMParams(*leaves), A, b, tr, tn, lw)
    mark(2)
    grads = DLADMMParams(*torch.autograd.grad(loss, leaves))
    mark(3)
    state = _apply(opt, state, grads)
    mark(4)
    return state, loss


def time_phases(torch, step, reps: int = 24, warm: int = 4) -> dict:
    """Median CUDA-event ms of each phase of ``step(mark)`` over ``reps``
    steps after ``warm``, and the host's wall ms a step."""
    phases, walls = [], []
    for rep in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(lambda k: ev[k].record())
        ev[4].synchronize()
        if rep >= warm:
            walls.append((time.perf_counter() - t0) * 1e3)
            phases.append([ev[j].elapsed_time(ev[j + 1]) for j in range(4)])
    arr = np.array(phases)
    return {"step_ms": float(np.median(arr.sum(axis=1))), "host_wall_ms": float(np.median(walls)),
            **{f"{name}_ms": float(np.median(arr[:, j])) for j, name in enumerate(PHASES)}}


def time_denoise(torch, device, card) -> dict:
    """Phase 35: (1) one train_denoiser step at S = 3844 (K = 15, the full
    run) by phase: CUDA events, and the profiler's device µs by phase and
    by kernel; (2) rows 1, 2, 4 and 5 at the patch shape: CUDA-event ms
    beside the plain version (in turns), profiler device µs, the bound,
    host enqueue and plan; (3) the optimizer phase of phase 34's steps:
    device µs and launches a step of each XLA-side format beside
    int8_pallas (the prologue and one sweep). Returns the kernels' timings."""
    from torch.profiler import ProfilerActivity, profile

    from dladmm_tpu_torch.data.dictionary import dct_dictionary
    from dladmm_tpu_torch.data.images import synthetic_image
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.ops.cuda_bwd import bwd_chunk_batch, unroll_bwd, unroll_bwd_plain, weight_wave
    from dladmm_tpu_torch.ops.cuda_traj import trajectory_forward, trajectory_forward_plain
    from dladmm_tpu_torch.ops.cuda_unroll import unroll_forward, unroll_forward_plain
    from dladmm_tpu_torch.train.loop import _build_optimizer, adam, make_train_state

    A = dct_dictionary(device=device)
    images = [synthetic_image(128, device=device) for _ in range(4)]
    opt = adam(1e-3)  # train_denoiser's
    state = make_train_state(init_dladmm_params(A, K=15), opt)
    gen = torch.Generator(device=device).manual_seed(0)

    def step(mark=None):
        nonlocal state
        state, _ = phased_denoise_step(torch, A, images, gen, opt, state, mark=mark)

    by_events = time_phases(torch, step)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profile_marker()
        for _ in range(3):
            step(ProfiledPhases(torch))
    by_phase, ops = device_us_by_phase(torch, prof, 3)
    top = {ph: dict(sorted(v.items(), key=lambda kv: -kv[1]["us"])[:6]) for ph, v in ops.items()}
    emit("timing_denoise", config="train_denoiser step, DCT, K=15, S=3844 (4 images of 128^2)", step=by_events,
         device_us_per_step_by_phase=by_phase, device_ops_per_step={ph: round(sum(v["calls"] for v in o.values()), 3)
                                                                    for ph, o in ops.items()},
         top_ops_by_phase=top, card=card)

    wave = weight_wave(device)
    timings = {}
    cases = (("unroll_forward", 15, 961, None), ("unroll_forward", 15, 225, None),
             ("trajectory_forward", 15, 3844, None), ("trajectory_forward", 8, 450, None),
             ("unroll_bwd", 15, 225, None), ("unroll_bwd", 15, 3844, None),
             ("unroll_bwd_chunked", 15, 3844, "policy"), ("unroll_bwd_chunked", 8, 450, "policy"))
    for name, K, S, bs in cases:
        A_, b, p = patch_case(torch, K, 3844 if S == 450 else S, seed=S + 41, device=device)
        if S == 450:
            b = b[:450].contiguous()  # --quick: two 64 x 64 images' worth of patches
        with torch.no_grad():
            if name == "unroll_forward":
                fns = [lambda: unroll_forward(b, A_, *p), lambda: unroll_forward_plain(b, A_, *p)]
                bms, by = bound(S, K=K, **PATCH)
            elif name == "trajectory_forward":
                fns = [lambda: trajectory_forward(b, A_, *p, with_tax=True),
                       lambda: trajectory_forward_plain(b, A_, *p, with_tax=True)]
                bms, by = traj_bound(S, K=K, with_tax=True, **PATCH)
            else:
                traj = trajectory_forward(b, A_, *p, with_tax=True)
                g = torch.Generator(device=device).manual_seed(S)
                cts = [torch.randn(t[-1].shape, generator=g, device=device) for t in traj[:3]]
                if bs == "policy":
                    bs = bwd_chunk_batch(PATCH["m"], PATCH["n"], PATCH["m"], S, K, wave)
                fns = [lambda: unroll_bwd(b, A_, *p, *traj, *cts, bs=bs),
                       lambda: unroll_bwd_plain(b, A_, *p, *traj, *cts)]
                bms, by = bwd_bound(S, K=K, **PATCH)
            for _ in range(2):
                for fn in fns:
                    fn()
            ms, plain_ms = median_ms(fns, 15)
            prof = profile_fn(fns[0], f"{name} K={K} S={S}", events_fallback=True)
            plan = launched_plan({"unroll_forward": unroll_forward, "trajectory_forward": trajectory_forward}.get(
                name, unroll_bwd))
            key = f"{name} K={K} S={S}" + (f" bs={bs}" if name.startswith("unroll_bwd") else "")
            timings[(name, K, S)] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                                     "device_us_per_call": prof["device_us_per_call"], "bs": bs,
                                     "host_enqueue_us": host_enqueue_us(torch, fns[0], calls=20), **plan}
            emit("timing_denoise_kernel", kernel=key, kernel_ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                 device_us_per_call=prof["device_us_per_call"], **time_from(prof), device_kernels=prof["per_call"],
                 **plan, card=card)
        del A_, b, p, fns

    import dataclasses

    from dladmm_tpu_torch.utils.config import get_config

    cfg = get_config("synthetic_small")
    _, A_s, w, fwd, _, _ = train_setup(torch, device)
    opt_phase = {}
    for fmt in ("int8_pallas", *XLA_FORMATS):
        opt_f = _build_optimizer(dataclasses.replace(cfg.train, moment_dtype=fmt))
        st = make_train_state(init_dladmm_params(A_s, K=cfg.problem.K), opt_f)
        i = 0

        def one(mark=None, opt_f=opt_f):
            nonlocal st, i
            st, _ = phased_step(torch, A_s, w, fwd, opt_f, st, i, mark=mark)
            i += 1

        events = time_phases(torch, one, reps=16)

        def run(mark):
            for _ in range(3):
                one(mark)

        if fmt == "int8_pallas":
            by_phase, opt_ops = optimizer_phase(torch, run, "qadam_int8_sweep")
        else:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                profile_marker()
                run(ProfiledPhases(torch))
            by_phase, ops = device_us_by_phase(torch, prof, 3)
            opt_ops = {"device_us_per_step": by_phase["optimizer"],
                       "launches_per_step": sum(v["calls"] for v in ops["optimizer"].values()),
                       "ops_per_step": dict(sorted(ops["optimizer"].items(), key=lambda kv: -kv[1]["us"])[:8])}
        opt_phase[fmt] = {"step_by_events": events, "device_us_per_step_by_phase": by_phase, "optimizer": opt_ops}
        emit("timing_xla_moments", moment_dtype=fmt, config="synthetic_small batch 64 deep supervision",
             **opt_phase[fmt], card=card)
    return timings, opt_phase


def patch_entries(errs: dict, denoise: dict, solver: dict, timings: dict) -> list:
    """The kernels line's entries of rows 1, 2, 4 and 5 at the image
    benchmark's shape (phases 31-35): launches from each new path's run
    counted from 0, the main path's first (run_denoise's full DCT run; for
    the whole-batch backward, which no run_denoise path takes at its
    batches, DLADMMSolver.fit)."""
    def by_path(key):
        paths = {f"run_denoise {k}": v["launches"].get(key, 0) for k, v in denoise.items()}
        paths.update({f"DLADMMSolver.{k}": v.get(key, 0) for k, v in solver["launches"].items()})
        return paths

    rows = (
        ("unroll_forward", "unroll_forward", "dladmm_tpu/ops/pallas_unroll.py:36", "unroll_forward",
         ("unroll_forward", 15, 961), "run_denoise (full DCT run): the three test images",
         denoise["dct"]["launches"]["unroll_forward"]),
        ("trajectory_forward", "trajectory_forward", "dladmm_tpu/ops/pallas_unroll.py:266", "trajectory_forward",
         ("trajectory_forward", 15, 3844), "run_denoise (full DCT run): 400 training steps",
         denoise["dct"]["launches"]["trajectory_forward"]),
        ("unroll_bwd", "unroll_bwd_whole", "dladmm_tpu/ops/pallas_bwd.py:56", "whole",
         ("unroll_bwd", 15, 225), "DLADMMSolver.fit (synthetic_small A, 300 steps at batch 64)",
         solver["launches"]["fit"]["unroll_bwd_whole"]),
        ("unroll_bwd_chunked", "unroll_bwd_chunked", "dladmm_tpu/ops/pallas_bwd.py:356", "chunked",
         ("unroll_bwd_chunked", 15, 3844), "run_denoise (full DCT run): 400 training steps",
         denoise["dct"]["launches"]["unroll_bwd_chunked"]),
    )
    source = {"unroll_bwd": "dladmm_tpu_torch/ops/csrc/unroll_bwd.cu",
              "unroll_bwd_chunked": "dladmm_tpu_torch/ops/csrc/unroll_bwd.cu"}
    entries = []
    for name, count_key, replaces, err_key, tkey, main_path, launches in rows:
        t = dict(timings[tkey])
        entries.append({
            "name": f"{name}_patch", "route": "cuda", "source": source.get(name, "dladmm_tpu_torch/ops/csrc/unroll.cu"),
            "replaces": replaces, "launches": launches, "main_path": main_path,
            "launches_by_path": by_path(count_key), "max_abs_err": errs[err_key],
            "ms": t.pop("ms"), "plain_ms": t.pop("plain_ms"), "bound_ms": t.pop("bound_ms"),
            "bound_by": t.pop("bound_by"), "library_ms": None,
            "shape": f"m=64 n=256 K={tkey[1]} S={tkey[2]}", **t,
        })
    return entries


def denoise_phases(torch, dev, card) -> list:
    """Phases 31-35 in order; returns their kernels-line entries."""
    patch_errs = check_patch(torch, dev)
    with tempfile.TemporaryDirectory() as tmp:
        denoise = denoise_slice(torch, dev, tmp)
    solver = solver_slice(torch, dev)
    with tempfile.TemporaryDirectory() as tmp:
        xla_moments_slice(torch, dev, tmp)
    timings, _ = time_denoise(torch, dev, card)
    return patch_entries(patch_errs, denoise, solver, timings)


# -- fused_adam, greedy, data parallelism, sharded serving (phases 36-40) ----

FUSED_NMSE_DB = 0.05  # fused_adam against the optax delayed-clip run at 1000 steps
GREEDY_DEPTHS = (1, 2, 3)
# DP against the single-process global-batch fit, 3 steps from a perturbed
# LADMM init (dp_init), at the JAX package's tolerances
# (tests/test_distributed.py): losses rtol 1e-5, params rtol 5e-5 / atol
# 1e-6; with int8 moments atol 1e-3 * lr a step (a last-bit gradient
# difference can move one code by one step). Each step is held from a
# common state (dp_per_step): over several steps Adam, which divides each
# gradient by its own RMS, carries the halves' last-bit differences into
# elements whose moments cancel, and runs drift apart (2.4% of W1 beyond
# the tolerance after 3 steps on the CPU at this shape). As in the CPU
# tests (tests/test_torch_distributed.py), elements in Adam's eps region
# are held within 1e-2 * lr and must be fewer than 5% of a leaf; here the
# region is a step's gradient below 10 eps (not zero), not the CPU tests'
# 100 eps: synthetic_small's gradients are smaller (5.1% of W1 and 17% of
# W2 lie below 100 eps, 0.5% and 1.8% below 10 eps), and the elements
# beyond the tolerance lie below 0.5 eps. The 3-step runs' differences
# are reported beside.
DP_LOSS_RTOL = 1e-5
DP_PARAM_RTOL, DP_PARAM_ATOL = 5e-5, 1e-6
DP_INT8_ATOL_PER_STEP = 1e-3  # x lr
DP_EPS_REGION = 10 * 1e-8  # a step's |gradient| below 10 Adam eps
DP_PERTURB = 0.02  # dp_init: x each leaf's mean |value|, as the CPU tests


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def fused_slice(torch, device, card, tmp) -> dict:
    """Phase 36: ``run --config=synthetic_small --optimizer=fused_adam
    --clip-mode=delayed --moment-dtype=float32 --steps=1000`` (with
    --ckpt-dir: phase 40 serves it) beside the same run on the optax chain
    (the delayed clip, fp32 moments; the trajectory kernel), each with the
    training counts from 0: final NMSE within FUSED_NMSE_DB of each other
    and both below LADMM at K = 15. Then ``fit`` with the fused optimizer
    in bf16 compute (300 steps), below LADMM; a fused run of 200 steps
    resumed from its step-100 checkpoint ends bit for bit where the
    uninterrupted one ends; and the
    fused step's and the optax step's ms by CUDA events (in turns), device
    µs and device launches a step."""
    import dataclasses
    import shutil

    from dladmm_tpu_torch.run import main as run_main
    from dladmm_tpu_torch.train.loop import fit
    from dladmm_tpu_torch.utils.config import get_config

    base = ["--config=synthetic_small", "--clip-mode=delayed", "--moment-dtype=float32", "--steps=1000"]
    out = {}
    for name, extra, route in (
        ("fused", ["--optimizer=fused_adam", "--ckpt-dir", str(Path(tmp) / "fused")],
         "manual reverse sweep + fused Adam-in-backward"),
        ("optax_delayed", [], "cuda-trajectory-kernel"),
    ):
        reset_training_counts()
        summary, _, wall = run_json(run_main, [*base, *extra])
        counts = nonzero(training_counts())
        if summary["route"] != route or not summary["final_nmse_db"] < summary["ladmm_nmse_db_at_K"]:
            raise AssertionError(f"run {extra}: route {summary['route']!r}, NMSE {summary['final_nmse_db']} "
                                 f"against LADMM {summary['ladmm_nmse_db_at_K']}")
        out[name] = {"summary": summary, "launches": counts, "wall_s": wall}
    # The fused step runs no kernel; its evals the trajectory kernel once.
    if out["fused"]["launches"] != {"trajectory_forward": 1} or \
            out["optax_delayed"]["launches"] != {"trajectory_forward": 1001}:
        raise AssertionError(f"launches: fused {out['fused']['launches']}, optax {out['optax_delayed']['launches']}")
    gap = out["fused"]["summary"]["final_nmse_db"] - out["optax_delayed"]["summary"]["final_nmse_db"]
    out["gap_db"] = gap
    if not abs(gap) <= FUSED_NMSE_DB:
        raise AssertionError(f"fused_adam {out['fused']['summary']['final_nmse_db']} dB against the delayed-clip "
                             f"chain {out['optax_delayed']['summary']['final_nmse_db']} dB: gap {gap}")
    emit("slice_train_fused", **out)

    cfg = get_config("synthetic_small")
    fused_train = dict(optimizer="fused_adam", clip_mode="delayed", moment_dtype="float32")

    def fit_run(ckpt=None, resume=False, **train):
        c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **fused_train, **train))
        reset_training_counts()
        t0 = time.monotonic()
        params, hist = fit(c, ckpt_dir=ckpt, resume=resume, device=device)
        return params, hist, nonzero(training_counts()), time.monotonic() - t0

    _, hist, counts, wall = fit_run(steps=300, compute_dtype="bfloat16")
    last = hist[-1]
    if not (math.isfinite(last["nmse_db"]) and last["nmse_db"] < last["curves"]["ladmm_curve_db"][-1]):
        raise AssertionError(f"fused bf16: NMSE {last['nmse_db']}")
    out["bf16"] = {"final_nmse_db": last["nmse_db"], "final_residual": last["residual"], "launches": counts,
                   "steps": 300, "wall_s": wall}
    emit("slice_train_fused", run="fit compute_dtype=bfloat16, 300 steps", **out["bf16"])

    cold, warm = Path(tmp) / "fused_cold", Path(tmp) / "fused_warm"
    full, hist, _, _ = fit_run(ckpt=str(cold), steps=200, eval_every=100)
    warm.mkdir()
    shutil.copy(cold / "step_100.pt", warm / "step_100.pt")
    resumed, rhist, rcounts, rwall = fit_run(ckpt=str(warm), resume=True, steps=200, eval_every=100)
    if [h["step"] for h in rhist] != [200] or not all(torch.equal(a, b) for a, b in zip(resumed, full)):
        raise AssertionError("the fused run resumed from step 100 does not end where the uninterrupted run ends")
    out["resume"] = {"bit_for_bit": True, "final_nmse_db": rhist[-1]["nmse_db"], "launches": rcounts,
                     "wall_s": rwall}
    emit("slice_train_fused", run="resumed from step 100 of 200", **out["resume"])
    out["timing"] = time_fused(torch, device, card)
    return out


def time_fused(torch, device, card) -> dict:
    """Phase 36's timing: one fused step (plain PyTorch: the forward loop,
    the reverse sweep with Adam in it) and one step of the optax chain
    with the delayed clip (the trajectory kernel and the manual sweep),
    synthetic_small batch 64 deep supervision, in turns: median CUDA-event
    ms, the profiler's device µs and device launches a step."""
    import dataclasses

    from dladmm_tpu_torch.data.synthetic import problem_matrices
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.ops.cuda_traj import make_unrolled_trajectory
    from dladmm_tpu_torch.train.fused_adam import make_fused_adam_state, make_fused_adam_step
    from dladmm_tpu_torch.train.loop import _build_optimizer, _layer_weights, _lr_of, make_train_state, make_train_step
    from dladmm_tpu_torch.utils.config import get_config

    cfg = get_config("synthetic_small")
    p = cfg.problem
    t = dataclasses.replace(cfg.train, clip_mode="delayed", moment_dtype="float32")
    A, _ = problem_matrices(cfg, device=device)
    w = _layer_weights("uniform", p.K, device=device)
    init = init_dladmm_params(A, K=p.K)
    fused = make_fused_adam_step(A, t.batch, p.sparsity_x, p.sparsity_e, w, _lr_of(t), clip_norm=t.clip_norm)
    opt = _build_optimizer(t)
    optax_step = make_train_step(opt, A, t.batch, p.sparsity_x, p.sparsity_e, layer_weights=w,
                                 forward_fn=make_unrolled_trajectory())
    states = {"fused": make_fused_adam_state(init, t.clip_norm), "optax": make_train_state(init, opt)}
    steps = {"fused": fused, "optax": optax_step}
    i = {"fused": 0, "optax": 0}

    def one(name):
        def run():  # profile_fn runs it under no_grad; the optax step takes a gradient
            with torch.enable_grad():
                states[name], _ = steps[name](states[name], i[name])
            i[name] += 1
        return run

    fns = [one("fused"), one("optax")]
    for _ in range(3):
        for fn in fns:
            fn()
    ms = median_ms(fns, 24)
    out = {}
    for name, fn, m_ in zip(("fused", "optax"), fns, ms):
        prof = profile_fn(fn, f"{name} step", reps=3, events_fallback=True)
        out[name] = {"ms": m_, "device_us_per_step": prof["device_us_per_call"],
                     "device_launches_per_step": sum(v["calls"] for v in prof["per_call"].values()),
                     "device_busy_share": prof.get("device_busy_share"), **time_from(prof)}
    emit("timing_train_fused", config="synthetic_small batch 64 deep supervision, clip 1.0 delayed, fp32 moments",
         **out, card=card)
    return out


def check_greedy_depths(torch, device, card) -> dict:
    """Phase 37 (kernels): rows 2 and 4 at the prefix depths greedy's
    first stages run, K = 1, 2, 3 (the persistent plans were sized at
    K >= 4), at synthetic_small S = 64 (the stage batch) and S = 1024
    (the backward's chunked route, bs = 128): the trajectory kernel within
    TOL of its plain version, the backward within BWD_TOL of each leaf, a
    second call bit for bit; then each at S = 64 timed beside its plain
    version and its bound. Returns the errors and timings."""
    from dladmm_tpu_torch.ops.cuda_bwd import unroll_bwd, unroll_bwd_plain
    from dladmm_tpu_torch.ops.cuda_traj import trajectory_forward, trajectory_forward_plain

    errs = {"traj": 0.0, "bwd": 0.0}
    timings = {}
    for K in GREEDY_DEPTHS:
        for S, bs in ((64, None), (1024, 128)):
            A, b, p, traj, cts = bwd_case(torch, m=SMALL["m"], n=SMALL["n"], K=K, S=S, seed=K * 7 + S,
                                          device=device, ties=K > 1)
            with torch.no_grad():
                want = trajectory_forward_plain(b, A, *p, with_tax=True)
                errs["traj"] = max(errs["traj"], compare(torch, traj, want, f"greedy depth K={K} S={S}",
                                                         names=("tx", "tz", "tlam", "tax"), phase="kernel_greedy"))
                again = trajectory_forward(b, A, *p, with_tax=True)
                got = unroll_bwd(b, A, *p, *traj, *cts, bs=bs, data_grads=False)
                want = unroll_bwd_plain(b, A, *p, *traj, *cts, data_grads=False)
                twice = unroll_bwd(b, A, *p, *traj, *cts, bs=bs, data_grads=False)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w_) for g, w_ in zip(traj, again)) or \
                    not all(torch.equal(g, w_) for g, w_ in zip(got[0], twice[0])):
                raise AssertionError(f"greedy depth K={K} S={S}: a second call differs")
            detail = compare_grads(torch, got, want, f"bwd greedy depth K={K} S={S} bs={bs}")
            errs["bwd"] = max(errs["bwd"], *(v["max_abs_err"] for v in detail.values()))
            emit("kernel_greedy", K=K, S=S, bs=bs, grads=detail, traj_plan=launched_plan(trajectory_forward),
                 bwd_plan=launched_plan(unroll_bwd))
            if S == 64:
                fns = [lambda: trajectory_forward(b, A, *p, with_tax=True),
                       lambda: trajectory_forward_plain(b, A, *p, with_tax=True),
                       lambda: unroll_bwd(b, A, *p, *traj, *cts), lambda: unroll_bwd_plain(b, A, *p, *traj, *cts)]
                with torch.no_grad():
                    ms = median_ms(fns, 21)
                timings[("trajectory_forward", K)] = (ms[0], ms[1], *traj_bound(S, SMALL["m"], SMALL["n"], K,
                                                                                 with_tax=True))
                timings[("unroll_bwd", K)] = (ms[2], ms[3], *bwd_bound(S, m=SMALL["m"], n=SMALL["n"], K=K))
                emit("timing_greedy", K=K, S=S, trajectory_ms=ms[0], trajectory_plain_ms=ms[1],
                     trajectory_bound=timings[("trajectory_forward", K)][2:], bwd_ms=ms[2], bwd_plain_ms=ms[3],
                     bwd_bound=timings[("unroll_bwd", K)][2:], card=card)
            del A, b, p, traj, cts, got, want, twice, again
    return {"errs": errs, "timings": timings}


class StageCounts:
    """run.py's JsonlLogger, which also reads the training counts at each
    record and sets them to 0 again: each greedy stage's launches, and
    then the fine-tune's."""

    records: list = []

    def __init__(self, path=None, mirror_stdout=True):
        self.records = StageCounts.records
        reset_training_counts()

    def __call__(self, record):
        self.records.append({**record, "launches": nonzero(training_counts())})
        reset_training_counts()


def greedy_slice(torch, device) -> dict:
    """Phase 37 (path): ``run --config=synthetic_small --greedy
    --steps=1000``, the kernels counted from 0 in every stage (run.py's
    logger, swapped for one that reads the counts at each record): each of
    the 15 stages (33 steps on its prefix, the final-state route) launches
    the trajectory and backward kernels and the int8 optimizer step once a
    step; the fine-tune (505 steps, deep supervision) the trajectory
    kernel and the step; the final NMSE below LADMM at K = 15."""
    from dladmm_tpu_torch.run import main as run_main
    from dladmm_tpu_torch.utils import logging as ulog

    StageCounts.records = []
    real = ulog.JsonlLogger
    ulog.JsonlLogger = StageCounts
    try:
        summary, _, wall = run_json(run_main, ["--config=synthetic_small", "--greedy", "--steps=1000"])
    finally:
        ulog.JsonlLogger = real
    stages = [r for r in StageCounts.records if "stage" in r]
    if len(stages) != 15:
        raise AssertionError(f"greedy: {len(stages)} stage records")
    for r in stages:
        want = {"trajectory_forward": 33, "unroll_bwd_whole": 33, "adam_step": 66}
        if r["launches"] != want:
            raise AssertionError(f"greedy stage {r['stage']}: launches {r['launches']}, expected {want}")
    if not (summary["route"].startswith("greedy") and summary["final_nmse_db"] < summary["ladmm_nmse_db_at_K"]):
        raise AssertionError(f"greedy: {summary}")
    ft = [r["launches"] for r in StageCounts.records if "stage" not in r]
    out = {"summary": summary, "wall_s": wall, "stage_launches": {r["stage"]: r["launches"] for r in stages},
           "finetune_launches": ft}
    emit("slice_train_greedy", **out)
    return out


def dp_config(data_axis: int = 2, **train):
    """synthetic_small over ``data_axis`` ranks for a 3-step comparison:
    the shipped recipe (deep supervision, clip 1.0, int8_pallas) at a
    constant lr (the cosine schedule's warmup starts at lr 0), an eval
    after every step (its loss is the history's)."""
    import dataclasses

    from dladmm_tpu_torch.utils.config import ShardingConfig, get_config

    cfg = get_config("synthetic_small")
    zero1 = train.pop("zero1", False)
    base = dict(steps=3, eval_every=1, lr_schedule=None)
    base.update(train)
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **base),
                               sharding=ShardingConfig(data_axis=data_axis, zero1=zero1))


def dp_init(cfg):
    """The DP comparison's start: the LADMM init of cfg's A, each leaf
    plus DP_PERTURB x its mean |value| x N(0, 1) from numpy's seed 0 (the
    CPU tests' perturbation), built on the CPU so that every rank and the
    single-process fit start from the same numbers. At the exact LADMM
    init many gradients cancel (W1 = A^T / L), and Adam divides each by
    its own RMS."""
    from dladmm_tpu_torch.data.synthetic import problem_matrices
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

    rng = np.random.default_rng(0)
    leaves = [v.numpy() for v in init_dladmm_params(problem_matrices(cfg)[0], K=cfg.problem.K)]
    return params_from_numpy(*(
        v + DP_PERTURB * np.abs(v).mean() * rng.normal(size=v.shape).astype(np.float32) for v in leaves))


def dp_eps_region(cfg, job, params, step: int, device) -> list:
    """Per leaf (on the CPU), the elements in Adam's eps region of the
    job's update at ``step`` (0-based) from ``params``: the single-process
    gradient on that step's global batch, scaled by the exact clip where
    the job clips so (the delayed clip's scale is 1 while the norm stays
    under the clip, as here), not zero and below DP_EPS_REGION."""
    from dladmm_tpu_torch.data.synthetic import make_batch, problem_matrices, step_generator
    from dladmm_tpu_torch.models.api import select_forward
    from dladmm_tpu_torch.train.loop import _layer_weights, _value_and_grad, global_norm

    p, t = cfg.problem, cfg.train
    A = problem_matrices(cfg, device=device)[0]
    data = make_batch(step_generator(t.seed, step), A, t.batch, p.sparsity_x, p.sparsity_e)
    fwd = select_forward(p.m, p.n, p.m, t.batch, need_trajectory=True, device=device)[0]
    _, g = _value_and_grad(type(params)(*(v.to(device) for v in params)),
                           (A, data.b, data.x_star, data.e_star, None,
                            _layer_weights(t.layer_loss, p.K, device=device)), dict(forward_fn=fwd))
    scale = 1.0
    if t.clip_norm and job != "fused":
        scale = min(1.0, t.clip_norm / float(global_norm(g)))
    return [((v.abs() * scale > 0) & (v.abs() * scale < DP_EPS_REGION)).cpu() for v in g]


def dp_close(got, want, init, eps_region, lr, atol, what, check: bool = True) -> dict:
    """got against want, leaf by leaf (CPU tensors): where ``eps_region``
    (a mask a leaf) is given, its elements within 1e-2 * lr and under 5%
    of the leaf; the rest within DP_PARAM_RTOL and ``atol``. Returns the
    largest difference and the largest difference over the norm of the
    leaf's update from ``init``; check=False only reports them."""
    import torch

    diff, rel = 0.0, 0.0
    for i, (name, g, w, i0) in enumerate(zip(("W1", "W2", "theta1", "theta2", "beta"), got, want, init)):
        g, w, i0 = g.double(), w.double(), i0.double()
        d = (g - w).abs()
        diff, rel = max(diff, float(d.max())), max(rel, float((g - w).norm() / (w - i0).norm()))
        if not check:
            continue
        mask = torch.zeros_like(d, dtype=torch.bool) if eps_region is None else eps_region[i]
        if not float(mask.double().mean()) < 5e-2:
            raise AssertionError(f"{what} {name}: {int(mask.sum())} elements in the eps region")
        if mask.any() and float(d[mask].max()) > 1e-2 * lr:
            raise AssertionError(f"{what} {name}: eps region {float(d[mask].max())} apart")
        keep = ~mask
        bad = d[keep] > atol + DP_PARAM_RTOL * w[keep].abs()
        if bad.any():
            raise AssertionError(f"{what} {name}: {int(bad.sum())} of {int(keep.sum())} elements beyond rtol "
                                 f"{DP_PARAM_RTOL} / atol {atol}, largest {float(d[keep].max())}")
    return {"max_param_diff": diff, "param_diff_of_update": rel}


def zero1_one_rank(opt_state, total: int, rows: int):
    """A ZeRO-1 checkpoint's whole-vector fused-sweep state ((R, 256)
    moment leaves, zero past ``total``) laid out for one rank's ``rows``
    rows: the same flat vector, padded or cut. Per-row leaves (int8
    scales) have no such layout, and raise."""
    import torch

    if isinstance(opt_state, dict):
        return {k: zero1_one_rank(v, total, rows) for k, v in opt_state.items()}
    if isinstance(opt_state, list):
        return [zero1_one_rank(v, total, rows) for v in opt_state]
    if not isinstance(opt_state, torch.Tensor) or opt_state.ndim == 0:
        return opt_state
    if opt_state.ndim != 2 or opt_state.shape[1] != 256:
        raise ValueError(f"a ZeRO-1 state leaf of shape {tuple(opt_state.shape)} has no one-rank layout")
    flat = opt_state.reshape(-1)
    if flat[total:].any():
        raise AssertionError("the ZeRO-1 state's padding is not zero")
    out = torch.zeros(rows * 256, dtype=flat.dtype)
    out[:total] = flat[:total]
    return out.reshape(rows, 256)


def dp_per_step(torch, job: str, ck_dir, tmp, device) -> list:
    """Each step of a 2-rank run (its checkpoints in ``ck_dir``, one a
    step) against the single-process global-batch step from the same
    state: fit_sharded at data_axis = 1 in this process (equal to fit bit
    for bit: the one-NCCL-rank check), from dp_init for step 1 and
    resumed from the 2-rank run's checkpoint of the step before for the
    others (a ZeRO-1 state laid out again by zero1_one_rank). The params
    held by dp_close with the JAX package's one-step tolerances (int8:
    1e-3 * lr). Returns dp_close's figures a step."""
    import dataclasses

    from dladmm_tpu_torch.parallel.collectives import BLOCK, _zero1_padded
    from dladmm_tpu_torch.train.loop import fit_sharded

    cfg = dp_config(data_axis=1, **dict(DP_JOBS[job]))
    t = cfg.train
    init = dp_init(cfg)
    total = sum(v.numel() for v in init)
    atol = DP_INT8_ATOL_PER_STEP * t.lr if t.moment_dtype == "int8_pallas" else DP_PARAM_ATOL
    out = []
    prev = list(init)
    for i in range(1, t.steps + 1):
        ref_dir = Path(tmp) / f"ref_{job}_{i}"
        ref_dir.mkdir()
        if i > 1:
            data = torch.load(Path(ck_dir) / f"step_{i - 1}.pt", weights_only=True)
            if job == "zero1":
                data["opt_state"] = zero1_one_rank(data["opt_state"], total,
                                                   _zero1_padded(total, 1, True) // BLOCK)
            torch.save(data, ref_dir / f"step_{i - 1}.pt")
        with contextlib.redirect_stdout(io.StringIO()):  # its memory audit
            ref, _ = fit_sharded(dataclasses.replace(cfg, train=dataclasses.replace(t, steps=i)), init_params=init,
                                 ckpt_dir=str(ref_dir), resume=i > 1, device=device)
        got = list(torch.load(Path(ck_dir) / f"step_{i}.pt", weights_only=True)["params"].values())
        eps = dp_eps_region(cfg, job, type(init)(*prev), i - 1, device)
        out.append({**dp_close(got, [v.cpu() for v in ref], prev, eps, t.lr, atol, f"2 ranks {job} step {i}"),
                    "eps_region_elements": [int(m.sum()) for m in eps]})
        prev = got
    return out


DP_JOBS = {
    "dp": {},
    "zero1": dict(zero1=True, moment_dtype="float32_pallas"),
    "fused": dict(optimizer="fused_adam", clip_mode="delayed", moment_dtype="float32"),
}


def dp_worker(out_dir: str, jobs: str) -> int:
    """One rank of a spawned run (``chip_smoke.py --dp-worker DIR JOBS``,
    the env:// variables set by spawn_ranks): each job in turn with this
    rank's training counts and peak memory from 0, the results in
    DIR/rank<r>.pt."""
    import torch

    from dladmm_tpu_torch.parallel.multihost import initialize_distributed, process_index, world_size

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = initialize_distributed()
    res = {"device": str(dev), "world": world_size()}
    import torch.distributed as dist

    res["backend"] = dist.get_backend()
    for job in jobs.split(","):
        reset_training_counts()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.monotonic()
        if job == "tp_parity":
            res[job] = tp_parity_job(torch, dev)
        elif job == "tp_small":
            res[job] = tp_small_job(torch, dev, out_dir)
        elif job == "tp_small_time":
            res[job] = time_tp_step(torch, dev, "tp_small", warm=3, steps=20)
        elif job in ("tp_large", "tp_large_bf16"):
            res[job] = tp_large_job(torch, dev, out_dir, job)
        elif job in DP_JOBS:
            from dladmm_tpu_torch.train.loop import fit_sharded

            cfg = dp_config(data_axis=world_size(), **dict(DP_JOBS[job]))
            ck = str(Path(out_dir) / f"ck_{job}")
            params, hist = fit_sharded(cfg, init_params=dp_init(cfg), ckpt_dir=ck)
            res[job] = {"params": [p.cpu() for p in params], "losses": [h["loss"] for h in hist],
                        "nmse_db": hist[-1]["nmse_db"], "ckpt_dir": ck}
        elif job == "time":
            res[job] = time_dp_step(torch, dev)
        else:  # a CLI run: run.main with these arguments
            from dladmm_tpu_torch.run import main as run_main

            argv = {"general_b_dp": ["--config=general_b_dp"],
                    "multihost": ["--config=multihost", "--steps=2"]}[job]
            if process_index() == 0:
                summary, lines, _ = run_json(run_main, argv)
                res[job] = {"summary": summary, "audit": [ln for ln in lines if "GB" in ln]}
            elif run_main(argv) != 0:  # rank 0 alone prints the summary
                raise AssertionError(f"run.main {argv} failed on rank {process_index()}")
        if dev.type == "cuda":
            torch.cuda.synchronize()
            res.setdefault("peak_gb", {})[job] = torch.cuda.max_memory_allocated(dev) / 1e9
        res.setdefault("launches", {})[job] = nonzero(training_counts())
        res.setdefault("wall_s", {})[job] = time.monotonic() - t0
    torch.save(res, Path(out_dir) / f"rank{process_index()}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def time_dp_step(torch, dev) -> dict:
    """The data-parallel step of fit_sharded on this rank (synthetic_small
    recipe, batch 64 over the ranks, the trajectory kernel at the per-rank
    batch, one all-reduce, the int8 sweep): median CUDA-event ms a step
    over 20 after 3, each rank its own; with one rank and no group, the
    single-process step on the global batch (make_train_step)."""
    import torch.distributed as dist

    from dladmm_tpu_torch.data.synthetic import SyntheticBatch, make_batch, problem_matrices, step_generator
    from dladmm_tpu_torch.models.api import select_forward
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.parallel import collectives as coll
    from dladmm_tpu_torch.parallel.mesh import make_mesh
    from dladmm_tpu_torch.train.loop import _build_optimizer, _layer_weights, make_train_state, make_train_step

    cfg = dp_config(data_axis=dist.get_world_size() if dist.is_initialized() else 1)
    p, t = cfg.problem, cfg.train
    D = cfg.sharding.data_axis
    A, _ = problem_matrices(cfg, device=dev)
    w = _layer_weights(t.layer_loss, p.K, device=dev)
    opt = _build_optimizer(t)
    fwd = select_forward(p.m, p.n, p.m, t.batch // D, need_trajectory=True, device=dev)[0]
    state = make_train_state(init_dladmm_params(A, K=p.K), opt)
    if dist.is_initialized():
        mesh = make_mesh(data=D)
        step = coll.make_dp_train_step(opt, mesh, layer_weights=w, forward_fn=fwd)
        r = mesh.rank

        def one(i):
            data = make_batch(step_generator(t.seed, i), A, t.batch)
            n = t.batch // D
            return step(state, A, SyntheticBatch(*(v[r * n: (r + 1) * n] for v in data)))
    else:
        inner = make_train_step(opt, A, t.batch, layer_weights=w, forward_fn=fwd)

        def one(i):
            return inner(state, i)
    times = []
    for i in range(23):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = one(i)
        stop.record()
        stop.synchronize()
        if i >= 3:
            times.append(start.elapsed_time(stop))
    return {"ms": float(np.median(times)), "ranks": D}


def spawn_ranks(D: int, jobs: str, tmp: str, timeout: int = 600) -> list:
    """Start D ranks of this script (``--dp-worker``) through
    parallel/multihost.spawn_ranks (env://, the rendezvous store held by
    this process, a deadline; the one card shared: gloo by
    parallel/mesh.pick_backend; one rank: NCCL); return their results in
    rank order and rank 0's output. A rank that fails, or a spawn past its
    deadline, fails the phase with the ranks' output."""
    from dladmm_tpu_torch.parallel.multihost import spawn_ranks as spawn

    out_dir = Path(tmp) / f"dp_{D}_{jobs.replace(',', '_')}"
    out_dir.mkdir()
    logs = spawn([sys.executable, str(Path(__file__).resolve()), "--dp-worker", str(out_dir), jobs], D,
                 timeout=timeout)
    import torch

    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(D)], logs[0]


def dp_slice(torch, device, card, tmp) -> dict:
    """Phase 38: data parallelism on the card. fit_sharded on
    synthetic_small over two gloo ranks sharing the one card (dp: the
    recipe's int8 sweep; zero1: ZeRO-1 with the exact clip, the dense
    sweep on each rank's (rows, 256) slice; fused: the DP fused step),
    each's 3 steps from dp_init against the single-process global-batch
    fit (losses within DP_LOSS_RTOL, params by dp_close); then
    data_axis = 1 on NCCL (one rank, its own card): bit for bit; the kernels
    counted on every rank; the DP step's ms beside the single-process
    step's (two ranks on one card measure correctness and overhead, not
    scaling)."""
    import dataclasses

    from dladmm_tpu_torch.models.api import select_forward
    from dladmm_tpu_torch.train.loop import fit

    out = {}
    jobs = ",".join([*DP_JOBS, "time"])
    for D in (2, 1):
        t0 = time.monotonic()
        ranks, log = spawn_ranks(D, jobs, tmp)
        backend = ranks[0]["backend"]
        if backend != ("gloo" if D > 1 else "nccl"):
            raise AssertionError(f"{D} rank(s) on one card: backend {backend}")
        out[D] = {"backend": backend, "spawn_wall_s": time.monotonic() - t0,
                  "launches_per_rank": [r["launches"] for r in ranks], "peak_gb_per_rank": [r["peak_gb"] for r in ranks],
                  "step_ms_per_rank": [r["time"]["ms"] for r in ranks]}
        for job, train in DP_JOBS.items():
            cfg = dp_config(data_axis=1, **dict(train))
            cfg = dataclasses.replace(cfg, sharding=dataclasses.replace(cfg.sharding, zero1=False))
            p = cfg.problem
            fwd = None if job == "fused" else select_forward(p.m, p.n, p.m, cfg.train.batch, need_trajectory=True,
                                                             device=device)[0]
            reset_training_counts()
            init = dp_init(cfg)
            params, hist = fit(cfg, forward_fn=fwd, init_params=init, device=device)
            single_counts = nonzero(training_counts())
            got = ranks[0][job]
            np.testing.assert_allclose(got["losses"], [h["loss"] for h in hist], rtol=DP_LOSS_RTOL,
                                       err_msg=f"{D} ranks {job} losses")
            params = [v.cpu() for v in params]
            if D == 1 and not all(torch.equal(g, w_) for g, w_ in zip(got["params"], params)):
                raise AssertionError(f"1 NCCL rank {job}: params differ from the single-process fit")
            # The 3 steps run on: reported (each step is held from a common state below).
            close = dp_close(got["params"], params, init, None, cfg.train.lr, 0.0, "", check=False)
            per_step = dp_per_step(torch, job, got["ckpt_dir"], tmp, device) if D > 1 else None
            for r, rk in enumerate(ranks):
                lc = rk["launches"][job]  # the step's forward (not fused), the evals, the sweep (not fused)
                if lc.get("trajectory_forward", 0) < 4 or lc.get("adam_step", 0) != (0 if job == "fused" else 6):
                    raise AssertionError(f"{D} ranks {job} rank {r}: launches {lc}")
            out[D][job] = {"losses": got["losses"], "after_3_steps": close, "per_step": per_step,
                           "single_launches": single_counts, "nmse_db": got["nmse_db"]}
            emit("slice_dp", ranks=D, backend=backend, job=job, **out[D][job],
                 launches_per_rank=[rk["launches"][job] for rk in ranks])
    single = time_dp_step(torch, device)
    out["single_step_ms"] = single["ms"]
    emit("timing_dp", single_process_step_ms=single["ms"], two_gloo_ranks_one_card_step_ms=out[2]["step_ms_per_rank"],
         one_nccl_rank_step_ms=out[1]["step_ms_per_rank"],
         note="D ranks share one card: correctness and overhead, not scaling", card=card)
    return out


def general_b_dp_slice(torch, tmp) -> dict:
    """Phase 39: ``run --config=general_b_dp`` (200 steps, the general-B
    plain loop and manual sweep on every rank) over its 4 gloo ranks on
    the one card: the final NMSE below general LADMM at K = 10."""
    t0 = time.monotonic()
    ranks, _ = spawn_ranks(4, "general_b_dp", tmp)
    summary = ranks[0]["general_b_dp"]["summary"]
    if summary["mesh"] != "4x1" or not summary["final_nmse_db"] < summary["ladmm_nmse_db_at_K"]:
        raise AssertionError(f"general_b_dp: {summary}")
    out = {"summary": summary, "wall_s": time.monotonic() - t0, "launches_per_rank": [r["launches"] for r in ranks]}
    emit("slice_general_b_dp", **out)
    return out


def multihost_slice(torch, device, card, tmp) -> dict:
    """Phase 40 (training): the multihost preset at its shape (m = 1000,
    n = 2000, K = 20, batch 65536 in bf16 over 8 ranks, each drawing its
    own 8192 rows), 2 steps, where fit_sharded's own audit passes: each
    rank against the card's memory (parallel/memory.detect_hbm_bytes)
    shared by the 8 ranks on it (parallel/multihost.ranks_per_card);
    else printed and skipped. Each rank's kernels counted (the bf16
    trajectory and backward kernels)."""
    from dladmm_tpu_torch.parallel.memory import detect_hbm_bytes
    from dladmm_tpu_torch.parallel.multihost import ranks_per_card
    from dladmm_tpu_torch.train.loop import sharded_audit
    from dladmm_tpu_torch.utils.config import get_config

    hbm = detect_hbm_bytes(device)
    cfg = get_config("multihost")
    s = cfg.sharding
    sharing = ranks_per_card(device, s.data_axis)
    out = {"hbm_bytes": hbm, "total_memory": torch.cuda.get_device_properties(device).total_memory,
           "ranks": s.data_axis, "ranks_per_card": sharing}
    try:
        bd = sharded_audit(cfg, hbm / sharing)
    except MemoryError as e:
        emit("slice_multihost", skipped=str(e), **out)
        return out
    out["audit_per_rank_bytes"] = bd.total
    t0 = time.monotonic()
    ranks, _ = spawn_ranks(s.data_axis, "multihost", tmp, timeout=900)
    summary = ranks[0]["multihost"]["summary"]
    if summary["mesh"] != "8x1" or not math.isfinite(summary["final_nmse_db"]):
        raise AssertionError(f"multihost: {summary}")
    for r, rk in enumerate(ranks):
        lc = rk["launches"]["multihost"]
        if not (lc.get("trajectory_forward_bf16", 0) >= 2 and sum(v for k, v in lc.items() if "bwd" in k) >= 2):
            raise AssertionError(f"multihost rank {r}: launches {lc}")
    out.update(summary=summary, wall_s=time.monotonic() - t0, launches_per_rank=[r["launches"] for r in ranks],
               peak_gb_per_rank=[r["peak_gb"]["multihost"] for r in ranks], audit=ranks[0]["multihost"]["audit"])
    emit("slice_multihost", **out, card=card)
    return out


def sharded_serve_slice(torch, device, ckpt: str) -> dict:
    """Phase 40 (serving): ``serve --sharded --ckpt-dir`` on phase 36's
    fused checkpoint in float32, bfloat16 and int8 (every visible card: one
    part here), each beside the unsharded serve: NMSE within NMSE_TOL_DB;
    then a ShardedInferenceServer of two parts on the one card against
    InferenceServer on the same 200 rows (fp32 and int8 within TOL, bf16
    within BF16_TOL_ULPS bf16 ulps), each path's kernel counted from 0."""
    from dladmm_tpu_torch.ops import cuda_int8, cuda_unroll
    from dladmm_tpu_torch.parallel.mesh import make_mesh
    from dladmm_tpu_torch.serve import InferenceServer, ShardedInferenceServer
    from dladmm_tpu_torch.serve import main as serve_main
    from dladmm_tpu_torch.utils.checkpoint import latest_step_dir, load_params

    def counts():
        return {"unroll_forward": cuda_unroll.unroll_forward.launches,
                "int8_unroll_forward": cuda_int8.int8_unroll_forward.launches}

    def reset():
        cuda_unroll.unroll_forward.launches = cuda_int8.int8_unroll_forward.launches = 0

    out = {}
    for dtype in ("float32", "bfloat16", "int8"):
        res = {}
        for sharded in (False, True):
            reset()
            argv = ["--config=synthetic_small", "--ckpt-dir", ckpt, "--demo", "256", f"--dtype={dtype}"]
            summary, _, _ = run_json(serve_main, [*argv, "--sharded"] if sharded else argv)
            res[sharded] = (summary, nonzero(counts()))
        if not res[True][0]["sharded"] or not res[True][1] or \
                not abs(res[True][0]["nmse_db"] - res[False][0]["nmse_db"]) <= NMSE_TOL_DB:
            raise AssertionError(f"serve --sharded --dtype={dtype}: {res[True]} against {res[False]}")
        out[f"cli_{dtype}"] = {"sharded": res[True][0], "launches": res[True][1],
                               "unsharded_nmse_db": res[False][0]["nmse_db"]}
        emit("slice_serve_sharded", dtype=dtype, **out[f"cli_{dtype}"])
    params, A, _ = load_params(latest_step_dir(ckpt), device)
    mesh = make_mesh(data=2, devices=[device, device])
    b = torch.from_numpy(np.random.default_rng(3).normal(size=(200, A.shape[0])).astype(np.float32)).to(device)
    for dtype in (None, "bfloat16", "int8"):
        reset()
        server = ShardedInferenceServer(params, A, mesh, max_batch=256, dtype=dtype)
        x, z = server.solve(b)
        torch.cuda.synchronize()
        launches = nonzero(counts())
        xw, zw = InferenceServer(params, A, max_batch=256, dtype=dtype, device=device).solve(b)
        errs = {}
        for name, g_, w_ in (("x", x, xw), ("z", z, zw)):
            g_, w_ = g_.float(), w_.float()
            err = float((g_ - w_).abs().max())
            tol = BF16_TOL_ULPS * bf16_ulp(w_) if dtype == "bfloat16" else TOL * max(1.0, float(w_.abs().max()))
            if not err <= tol:
                raise AssertionError(f"ShardedInferenceServer {dtype} {name}: {err} > {tol}")
            errs[name] = err
        if not launches:
            raise AssertionError(f"ShardedInferenceServer {dtype}: no kernel launched")
        out[f"server_{dtype or 'float32'}"] = {"max_abs_err": errs, "launches": launches, "parts": 2,
                                               "route": server.routes[server.buckets[-1]]}
        emit("slice_serve_sharded", server="ShardedInferenceServer, 2 parts on one card", dtype=dtype or "float32",
             **out[f"server_{dtype or 'float32'}"])
    return out


def sharded_phases(torch, dev, card) -> tuple:
    """Phases 36-40 in order; returns (their results, their kernels-line
    entries: rows 2 and 4 at greedy's depths, every new path's launches)."""
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        res["fused"] = fused_slice(torch, dev, card, tmp)
        res["greedy_kernels"] = check_greedy_depths(torch, dev, card)
        res["greedy"] = greedy_slice(torch, dev)
        res["dp"] = dp_slice(torch, dev, card, tmp)
        res["general_b_dp"] = general_b_dp_slice(torch, tmp)
        emit("detect_hbm_bytes", bytes=__import__("dladmm_tpu_torch.parallel.memory", fromlist=["x"])
             .detect_hbm_bytes(dev), card=card)
        res["multihost"] = multihost_slice(torch, dev, card, tmp)
        res["serve"] = sharded_serve_slice(torch, dev, str(Path(tmp) / "fused"))
    return res, sharded_entries(res)


def sharded_entries(res: dict) -> list:
    """The kernels line's entries of phases 36-40: rows 2 and 4 at the
    greedy depths (launches from ``run --greedy``'s stages, times at
    K = 1 beside the other depths), each with every new path's launches."""
    gk, greedy, dp = res["greedy_kernels"], res["greedy"], res["dp"]
    stage = greedy["stage_launches"]

    def per_rank(D, job, key):
        return [lc[job].get(key, 0) for lc in dp[D]["launches_per_rank"]]

    def entry(name, key, source, replaces, err, tkey):
        ms, plain_ms, bms, by = gk["timings"][(tkey, 1)]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(s[key] for s in stage.values()),
            "main_path": "run --config=synthetic_small --greedy --steps=1000: its 15 stages",
            "launches_by_path": {
                "greedy stages": {k: s.get(key, 0) for k, s in stage.items()},
                "greedy fine-tune": [f.get(key, 0) for f in greedy["finetune_launches"]],
                **{f"fit_sharded {job}, 2 gloo ranks (per rank)": per_rank(2, job, key) for job in DP_JOBS},
                **{f"fit_sharded {job}, 1 NCCL rank": per_rank(1, job, key) for job in DP_JOBS},
                "general_b_dp (per rank)": [lc["general_b_dp"].get(key, 0)
                                            for lc in res["general_b_dp"]["launches_per_rank"]],
                "multihost (per rank)": [lc["multihost"].get(key + "_bf16", 0) if key != "unroll_bwd_whole" else
                                         sum(v for k, v in lc["multihost"].items() if "bwd" in k)
                                         for lc in res["multihost"].get("launches_per_rank", [])],
            },
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "shape": "synthetic_small K=1 S=64",
            "other_depths": {f"K={K}": dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"), gk["timings"][(tkey, K)]))
                             for K in GREEDY_DEPTHS[1:]},
        }

    return [
        entry("trajectory_forward_greedy", "trajectory_forward", "dladmm_tpu_torch/ops/csrc/unroll.cu",
              "dladmm_tpu/ops/pallas_unroll.py:266", gk["errs"]["traj"], "trajectory_forward"),
        entry("unroll_bwd_greedy", "unroll_bwd_whole", "dladmm_tpu_torch/ops/csrc/unroll_bwd.cu",
              "dladmm_tpu/ops/pallas_bwd.py:56", gk["errs"]["bwd"], "unroll_bwd"),
    ]


def new_path_launches(res: dict) -> dict:
    """Launches of phases 36-40's paths for the rows whose main-path entry
    is an earlier phase's: the optimizer sweeps (DP per rank, the ZeRO-1
    shard, greedy) and serving (sharded)."""
    dp = res["dp"]
    srv = res["serve"]
    return {
        "adam_step": {"greedy stages": sum(s.get("adam_step", 0) for s in res["greedy"]["stage_launches"].values()),
                      **{f"fit_sharded {job}, 2 gloo ranks (per rank)": [lc[job].get("adam_step", 0)
                                                                          for lc in dp[2]["launches_per_rank"]]
                         for job in DP_JOBS}},
        "unroll_forward": {k: v["launches"].get("unroll_forward", 0) for k, v in srv.items()},
        "int8_unroll_forward": {k: v["launches"].get("int8_unroll_forward", 0) for k, v in srv.items()},
    }


# -- tensor parallelism (phases 41-43) --------------------------------------------

TP_MESHES = ((2, 2), (1, 4))  # phase 41: both on 4 gloo ranks sharing the card
TP_LAYOUTS = ("sharded_w2", "replicated_w2")
TP_GRAD_TOL = 2e-5  # x a leaf's largest |gradient| (ROADMAP.md §3, orders of summation)
TP_LOSS_RTOL = 1e-5
TP_BF16_LOSS = (0.05, 1e-3)  # the JAX package's bf16 bound: |loss - ref| < 5% |ref| + 1e-3
TP_NMSE_DB = 0.05  # tp_small on its 8 ranks against the single-process fit (FUSED_NMSE_DB's rule)
TP_RESUME_DB = 1e-4  # the run resumed from step 100 against the uninterrupted one
TP_STEP_CASES = {"fp32": (False, None, ()), "deep": (True, None, ()),
                 "bf16_freeze": (False, "bfloat16", ("beta",))}  # (deep supervision, compute dtype, freeze)


def tp_problem(torch, device):
    """Phase 41's inputs at tp_small's shape (m = 256, n = 512, K = 8,
    batch 128): the preset's A, its LADMM init perturbed as dp_init does
    (numpy seed 0), and step 0's batch, all built on the CPU so that
    every rank and the single-process references start from the same
    numbers; on ``device``."""
    from dladmm_tpu_torch.data.synthetic import make_batch, problem_matrices, step_generator
    from dladmm_tpu_torch.utils.config import get_config

    cfg = get_config("tp_small")
    A = problem_matrices(cfg)[0]
    batch = make_batch(step_generator(cfg.train.seed, 0), A, cfg.train.batch)
    return cfg, A.to(device), dp_init(cfg).to(device), type(batch)(*(v.to(device) for v in batch))


def tp_parity_job(torch, dev) -> dict:
    """Phase 41 on one rank of 4: on each mesh of TP_MESHES and each
    layout, sharded_forward (gathered whole), make_sharded_eval, the raw
    gradients of the final-layer and deep-supervision losses (gathered
    whole) and one step of each TP_STEP_CASES (its loss, the params
    after it gathered whole), all on CPU tensors."""
    from dladmm_tpu_torch.models.unroll import DLADMMParams
    from dladmm_tpu_torch.parallel import collectives as coll
    from dladmm_tpu_torch.parallel.mesh import gather_params_tp, make_mesh, model_slice, shard_params_tp
    from dladmm_tpu_torch.train import loop

    cfg, A, whole, batch = tp_problem(torch, dev)
    K, lr = cfg.problem.K, 1e-3
    out = {}
    for d, t in TP_MESHES:
        for layout in TP_LAYOUTS:
            mesh = make_mesh(data=d, model=t)
            A_t = model_slice(A, mesh).contiguous()
            n = batch.b.shape[0] // d
            rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
            local = type(batch)(batch.b[rows], model_slice(batch.x_star[rows], mesh).contiguous(), batch.e_star[rows])
            shards = shard_params_tp(whole, mesh, layout)
            split = layout == "sharded_w2"
            x, z, lam = coll.sharded_forward(mesh, shards, A_t, local.b, layout)
            res = {"forward": [coll.gather_blocks(mesh, v, s).cpu() for v, s in ((x, True), (z, split), (lam, split))],
                   "eval": coll.make_sharded_eval(mesh, layout)(shards, A_t, local)}
            for deep in (False, True):
                lw = torch.full((K,), 1.0 / K, device=dev) if deep else None
                loss, grads = coll._tp_value_and_grad(coll._TP(mesh), shards, A_t, local.b, local.x_star,
                                                      local.e_star, layout, lw)
                stacked = DLADMMParams(*(torch.stack(gs) for gs in zip(*grads)))
                res[f"grads_{'deep' if deep else 'final'}"] = (
                    float(loss), [v.cpu() for v in gather_params_tp(stacked, mesh, layout)])
            for case, (deep, cd, freeze) in TP_STEP_CASES.items():
                dt = None if cd is None else getattr(torch, cd)
                opt = loop.adam(lr)
                state = loop.make_train_state(shards, opt, dt)
                lw = torch.full((K,), 1.0 / K, device=dev) if deep else None
                step = coll.make_sharded_train_step(opt, mesh, layout, dt, freeze, lw)
                state, loss = step(state, A_t if dt is None else A_t.to(dt), local)
                res[case] = {"loss": float(loss), "params": [v.cpu() for v in gather_params_tp(state.params, mesh,
                                                                                               layout)]}
            out[f"{d}x{t} {layout}"] = res
    return out


def tp_parity_slice(torch, device, card, tmp) -> dict:
    """Phase 41: tensor parallelism at tp_small's shape on 4 gloo ranks
    sharing the card (spawn_ranks, job tp_parity), as 2x2 and as 1x4, in
    both layouts, against the single-process plain path on the card on
    the same inputs (tp_problem): the gathered forward at TOL, the eval's
    curve, nmse_db_z and residual within 1e-4, every leaf's gradient
    within TP_GRAD_TOL of its largest value (autograd through the plain
    loop, vjp="xla") and the losses at TP_LOSS_RTOL, for the final-layer
    loss and deep supervision; one step of each: its loss at TP_LOSS_RTOL
    (bf16 with beta frozen: within the JAX package's bf16 bound of the
    plain bf16 loss, beta unchanged, W1 moved). The TP path launches no
    kernel (its products are torch.matmul): the ranks' counts are
    printed."""
    from dladmm_tpu_torch.models.unroll import DLADMMParams, dladmm_forward
    from dladmm_tpu_torch.train import loop

    t0 = time.monotonic()
    reset_training_counts()
    ranks, _ = spawn_ranks(4, "tp_parity", tmp)
    spawn_s = time.monotonic() - t0
    cfg, A, whole, batch = tp_problem(torch, device)
    K = cfg.problem.K
    with torch.no_grad():
        fwd = dladmm_forward(whole, A, batch.b)
    ev = loop.evaluate(whole, A, batch, use_kernel=False)
    refs = {}
    for deep in (False, True):
        lw = torch.full((K,), 1.0 / K, device=device) if deep else None
        refs[deep] = loop._value_and_grad(whole, (A, batch.b, batch.x_star, batch.e_star, None, lw), {"vjp": "xla"})
    bf16_loss, _ = loop._value_and_grad(loop._cast(whole, torch.bfloat16),
                                        (A.bfloat16(), batch.b.bfloat16(), batch.x_star, batch.e_star, None, None),
                                        {"vjp": "xla"})
    out = {"spawn_wall_s": spawn_s, "launches_per_rank": [r["launches"]["tp_parity"] for r in ranks]}
    for key, got in ranks[0]["tp_parity"].items():
        rec = {"forward_err": compare(torch, [v.to(device) for v in got["forward"]], fwd, f"tp {key} forward",
                                      phase="tp_forward")}
        for name in ("nmse_db", "nmse_db_z", "residual"):
            if not abs(got["eval"][name] - ev[name]) <= 1e-4:
                raise AssertionError(f"tp {key} eval {name}: {got['eval'][name]} against {ev[name]}")
        if not np.allclose(got["eval"]["nmse_curve_db"], ev["nmse_curve_db"], rtol=0, atol=1e-4):
            raise AssertionError(f"tp {key} eval curve: {got['eval']['nmse_curve_db']} against {ev['nmse_curve_db']}")
        for deep in (False, True):
            loss, grads = got[f"grads_{'deep' if deep else 'final'}"]
            want_loss, want = refs[deep]
            rel = {}
            for name, g, w in zip(DLADMMParams._fields, grads, want):
                rel[name] = float((g.to(device) - w).abs().max()) / float(w.abs().max())
                if not rel[name] <= TP_GRAD_TOL:
                    raise AssertionError(f"tp {key} deep={deep} gradient {name}: {rel[name]} of its scale")
            if not abs(loss - float(want_loss)) <= TP_LOSS_RTOL * abs(float(want_loss)):
                raise AssertionError(f"tp {key} deep={deep} loss {loss} against {float(want_loss)}")
            rec[f"grad_rel_err_{'deep' if deep else 'final'}"] = rel
        for case, (deep, cd, _) in TP_STEP_CASES.items():
            loss = got[case]["loss"]
            if cd is None:
                want_loss = float(refs[deep][0])
                ok = abs(loss - want_loss) <= TP_LOSS_RTOL * abs(want_loss)
            else:
                want_loss = float(bf16_loss)
                ok = abs(loss - want_loss) < TP_BF16_LOSS[0] * abs(want_loss) + TP_BF16_LOSS[1]
                p = got[case]["params"]
                ok = ok and torch.equal(p[4], whole.beta.cpu()) and not torch.equal(p[0], whole.W1.cpu())
            if not ok:
                raise AssertionError(f"tp {key} step {case}: loss {loss} against {want_loss}")
            rec[f"step_{case}_loss"] = (loss, want_loss)
        out[key] = rec
        emit("slice_tp_parity", mesh=key, **rec)
    if any(lc for lc in out["launches_per_rank"]):
        raise AssertionError(f"the TP path launched a kernel: {out['launches_per_rank']}")
    emit("slice_tp_parity_summary", ranks=4, backend=ranks[0]["backend"], spawn_wall_s=spawn_s, card=card)
    return out


def time_tp_step(torch, dev, config: str, warm: int, steps: int) -> dict:
    """The TP step of fit_sharded for preset ``config`` on this rank: the
    LADMM init's slices, batches drawn beforehand; host ms a step between
    device synchronisations (median over ``steps`` after ``warm``), then
    as many steps with every collective timed (CollectiveTimer): the
    share of the step spent in collectives."""
    import torch.distributed as dist

    from dladmm_tpu_torch.data.synthetic import make_batch, problem_matrices, step_generator
    from dladmm_tpu_torch.parallel import collectives as coll
    from dladmm_tpu_torch.parallel.mesh import make_mesh, model_slice
    from dladmm_tpu_torch.train.loop import TrainState, _build_optimizer, _cast, _layer_weights
    from dladmm_tpu_torch.utils.config import get_config

    cfg = get_config(config)
    p, t, s = cfg.problem, cfg.train, cfg.sharding
    mesh = make_mesh(data=s.data_axis, model=s.model_axis)
    A = problem_matrices(cfg, device=dev)[0]
    cd = torch.bfloat16 if t.compute_dtype == "bfloat16" else None
    A_t = model_slice(A, mesh).contiguous()
    params = coll.init_params_tp(A, p.K, mesh, s.layout, p.beta)
    opt = _build_optimizer(t)
    state = TrainState(params, opt.init(params), 0, None if cd is None else _cast(params, cd))
    del params
    lw = _layer_weights(t.layer_loss, p.K, device=dev)
    n = t.batch // s.data_axis
    rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)

    def batch(i):
        d = make_batch(step_generator(t.seed, i), A, t.batch)
        return type(d)(d.b[rows], model_slice(d.x_star[rows], mesh).contiguous(), d.e_star[rows])

    batches = [batch(i) for i in range(warm + steps)]
    del A
    A_c = A_t if cd is None else A_t.to(cd)
    out = {}
    for label, timer in (("plain", None), ("timed", coll.CollectiveTimer())):
        step = coll.make_sharded_train_step(opt, mesh, s.layout, cd, tuple(t.freeze), lw, timer=timer)
        times = []
        for i, bt in enumerate(batches):
            if i == warm and timer is not None:
                timer.seconds, timer.calls = 0.0, 0
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, loss = step(state, A_c, bt)
            torch.cuda.synchronize(dev)
            if i >= warm:
                times.append(time.perf_counter() - t0)
        out[f"step_ms_{label}"] = 1e3 * float(np.median(times))
        if timer is not None:
            out["collective_share"] = timer.seconds / sum(times)
            out["collectives_per_step"] = timer.calls / steps
    out["loss"] = float(loss)
    out["ranks"] = dist.get_world_size()
    return out


def tp_small_job(torch, dev, out_dir) -> dict:
    """Phase 42 on one rank of 8: ``run --config=tp_small`` (its 200
    steps, checkpoints at every eval, the evals logged by rank 0), then,
    the step-150 and step-200 checkpoints removed, the same run resumed
    from step 100."""
    import os

    import torch.distributed as dist

    from dladmm_tpu_torch.run import main as run_main

    ck, log = Path(out_dir) / "ck_tp_small", Path(out_dir) / "tp_small.jsonl"
    res = {}
    for label, extra in (("cold", ["--log-jsonl", str(log)]), ("resumed", ["--resume"])):
        argv = ["--config=tp_small", "--ckpt-dir", str(ck), *extra]
        if dist.get_rank() == 0:
            res[label] = run_json(run_main, argv)[0]
        elif run_main(argv) != 0:
            raise AssertionError(f"run.main {argv} failed on rank {dist.get_rank()}")
        dist.barrier()
        if label == "cold" and dist.get_rank() == 0:
            for step in (150, 200):
                os.remove(ck / f"step_{step}.pt")
        dist.barrier()
    if dist.get_rank() == 0:
        res["evals"] = [json.loads(ln) for ln in log.read_text().splitlines()]
    return res


def tp_large_job(torch, dev, out_dir, config: str) -> dict:
    """Phase 43 on one rank: for tp_large, sharded_forward of the LADMM
    init on phase 43's batch (tp_large_b.pt beside out_dir), gathered
    whole on rank 0; then ``run --config=<config> --steps=N`` (2 for tp_large, 1
    for tp_large_bf16) with this rank's peak memory from a reset; then,
    for tp_large, the step's time (time_tp_step: 1 warm, 2 timed)."""
    import torch.distributed as dist

    from dladmm_tpu_torch.data.synthetic import problem_matrices
    from dladmm_tpu_torch.parallel import collectives as coll
    from dladmm_tpu_torch.parallel.mesh import make_mesh, model_slice
    from dladmm_tpu_torch.run import main as run_main
    from dladmm_tpu_torch.utils.config import get_config

    res = {}
    if config == "tp_large":
        cfg = get_config(config)
        s = cfg.sharding
        mesh = make_mesh(data=s.data_axis, model=s.model_axis)
        A = problem_matrices(cfg, device=dev)[0]
        params = coll.init_params_tp(A, cfg.problem.K, mesh, s.layout, cfg.problem.beta)
        b = torch.load(Path(out_dir).parent / "tp_large_b.pt", weights_only=True).to(dev)
        x, z, lam = coll.sharded_forward(mesh, params, model_slice(A, mesh).contiguous(), b, s.layout)
        split = s.layout == "sharded_w2"
        whole = [coll.gather_blocks(mesh, v, sp) for v, sp in ((x, True), (z, split), (lam, split))]
        if dist.get_rank() == 0:
            res["forward"] = [v.cpu() for v in whole]
        del A, params, b, x, z, lam, whole
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    log = Path(out_dir) / f"{config}.jsonl"
    argv = [f"--config={config}", f"--steps={2 if config == 'tp_large' else 1}", "--log-jsonl", str(log)]
    if dist.get_rank() == 0:
        res["summary"], lines, res["wall_s"] = run_json(run_main, argv)
        res["audit"] = [ln for ln in lines if "GB" in ln]
        res["evals"] = [json.loads(ln) for ln in log.read_text().splitlines()]
    elif run_main(argv) != 0:
        raise AssertionError(f"run.main {argv} failed on rank {dist.get_rank()}")
    torch.cuda.synchronize(dev)
    res["run_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    if config == "tp_large":
        torch.cuda.empty_cache()
        res["time"] = time_tp_step(torch, dev, config, warm=1, steps=2)
    return res


def tp_small_slice(torch, device, card, tmp) -> dict:
    """Phase 42: ``run --config=tp_small`` through the ranks of a
    torch.distributed run (8 gloo ranks sharing the card, spawn_ranks),
    200 steps: the last eval's NMSE below the first's and within
    TP_NMSE_DB of the single-process ``fit`` of the preset (the kernels'
    route the CLI picks at batch 128, counted from 0); the run resumed
    from its step-100 checkpoint ends within TP_RESUME_DB of the
    uninterrupted one; the TP step's ms on each rank and the share of it
    in collectives (time_tp_step)."""
    from dladmm_tpu_torch.models.api import select_forward
    from dladmm_tpu_torch.train.loop import fit
    from dladmm_tpu_torch.utils.config import get_config

    cfg = get_config("tp_small")
    p = cfg.problem
    reset_training_counts()
    t0 = time.monotonic()
    fwd = select_forward(p.m, p.n, p.m, cfg.train.batch, device=device)[0]
    _, hist = fit(cfg, forward_fn=fwd, device=device)
    single = {"nmse_db": hist[-1]["nmse_db"], "wall_s": time.monotonic() - t0,
              "launches": nonzero(training_counts())}
    t0 = time.monotonic()
    ranks, _ = spawn_ranks(8, "tp_small,tp_small_time", tmp, timeout=900)
    got = ranks[0]["tp_small"]
    evals = got["evals"]
    cold, resumed = got["cold"], got["resumed"]
    gap = cold["final_nmse_db"] - single["nmse_db"]
    out = {"spawn_wall_s": time.monotonic() - t0, "mesh": cold["mesh"], "route": cold["route"],
           "evals_nmse_db": [(e["step"], e["nmse_db"]) for e in evals], "final_nmse_db": cold["final_nmse_db"],
           "single_process": single, "gap_db": gap, "resumed_final_nmse_db": resumed["final_nmse_db"],
           "ladmm_nmse_db_at_K": cold["ladmm_nmse_db_at_K"], "fit_wall_s": cold["fit_wall_s"],
           "step_ms_per_rank": [r["tp_small_time"]["step_ms_plain"] for r in ranks],
           "step_ms_timed_per_rank": [r["tp_small_time"]["step_ms_timed"] for r in ranks],
           "collective_share_per_rank": [r["tp_small_time"]["collective_share"] for r in ranks],
           "collectives_per_step": ranks[0]["tp_small_time"]["collectives_per_step"],
           "peak_gb_per_rank": [r.get("peak_gb", {}).get("tp_small") for r in ranks],
           "launches_per_rank": [r["launches"]["tp_small"] for r in ranks], "card": card}
    emit("slice_tp_small", **out)
    if cold["mesh"] != "4x2" or not evals[-1]["nmse_db"] < evals[0]["nmse_db"]:
        raise AssertionError(f"tp_small: the last eval is not below the first: {out['evals_nmse_db']}")
    if not abs(gap) <= TP_NMSE_DB:
        raise AssertionError(f"tp_small: {cold['final_nmse_db']} dB on 8 ranks, the single-process fit "
                             f"{single['nmse_db']} dB: a gap of {gap} dB")
    if not abs(resumed["final_nmse_db"] - cold["final_nmse_db"]) <= TP_RESUME_DB:
        raise AssertionError(f"tp_small resumed from step 100: {resumed['final_nmse_db']} against "
                             f"{cold['final_nmse_db']}")
    return out


def tp_large_slice(torch, device, card, tmp) -> dict:
    """Phase 43: tp_large at full width (m = 8192, n = 16384, K = 20,
    batch 256) on its 4 ranks sharing the card: fit_sharded's audit of one
    rank against the card's memory shared by the 4, printed; the
    single-process plain forward (kernel="reference": the plain loop) of
    the LADMM init on step 0's batch, run here first, against
    sharded_forward's x, z and lam gathered whole (TOL); ``run
    --config=tp_large --steps=2`` (finite loss, each rank's peak memory
    beside the audit) and the TP step's ms; then tp_large_bf16 on 8
    ranks for one step where its audit passes with the card shared by 8,
    else its audit printed and the run reported as not run."""
    from dladmm_tpu_torch.data.synthetic import make_batch, problem_matrices, step_generator
    from dladmm_tpu_torch.models.unroll import dladmm_forward, init_dladmm_params
    from dladmm_tpu_torch.parallel.memory import detect_hbm_bytes
    from dladmm_tpu_torch.train.loop import sharded_audit
    from dladmm_tpu_torch.utils.config import get_config

    hbm = detect_hbm_bytes(device)
    out = {"hbm_bytes": hbm}
    cfg = get_config("tp_large")
    p, t = cfg.problem, cfg.train
    audit = []
    bd = sharded_audit(cfg, hbm / 4, audit.append)
    out["audit_lines"], out["audit_per_rank_gb"] = audit, bd.total / 1e9
    t0 = time.monotonic()
    A = problem_matrices(cfg, device=device)[0]
    params = init_dladmm_params(A, K=p.K, beta=p.beta)
    b = make_batch(step_generator(t.seed, 0), A, t.batch).b
    with torch.no_grad():
        want = dladmm_forward(params, A, b)
    torch.cuda.synchronize(device)
    out["reference_forward_wall_s"] = time.monotonic() - t0
    torch.save(b.cpu(), Path(tmp) / "tp_large_b.pt")
    want = [v.cpu() for v in want]
    del A, params, b
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    ranks, _ = spawn_ranks(4, "tp_large", tmp, timeout=1200)
    got = ranks[0]["tp_large"]
    out["forward_err"] = compare(torch, got["forward"], want, "tp_large sharded_forward, 1x4", phase="tp_forward")
    summary, evals = got["summary"], got["evals"]
    out.update(spawn_wall_s=time.monotonic() - t0, summary=summary, losses=[e["loss"] for e in evals],
               run_wall_s=got["wall_s"], run_peak_gb_per_rank=[r["tp_large"]["run_peak_gb"] for r in ranks],
               run_audit=got["audit"], time_per_rank=[r["tp_large"]["time"] for r in ranks],
               launches_per_rank=[r["launches"]["tp_large"] for r in ranks], card=card)
    emit("slice_tp_large", **out)
    if summary["mesh"] != "1x4" or not all(math.isfinite(v) for v in out["losses"]):
        raise AssertionError(f"tp_large: {summary}, losses {out['losses']}")
    bf = get_config("tp_large_bf16")
    audit16 = []
    try:
        bd16 = sharded_audit(bf, hbm / 8, audit16.append)
    except MemoryError as e:
        emit("slice_tp_large_bf16", not_run=str(e), audit_lines=audit16, card=card)
        return out
    t0 = time.monotonic()
    ranks, _ = spawn_ranks(8, "tp_large_bf16", tmp, timeout=1200)
    got = ranks[0]["tp_large_bf16"]
    bf16 = {"audit_lines": audit16, "audit_per_rank_gb": bd16.total / 1e9, "summary": got["summary"],
            "losses": [e["loss"] for e in got["evals"]], "run_wall_s": got["wall_s"],
            "spawn_wall_s": time.monotonic() - t0,
            "run_peak_gb_per_rank": [r["tp_large_bf16"]["run_peak_gb"] for r in ranks], "card": card}
    emit("slice_tp_large_bf16", **bf16)
    if got["summary"]["mesh"] != "1x8" or not all(math.isfinite(v) for v in bf16["losses"]):
        raise AssertionError(f"tp_large_bf16: {got['summary']}")
    out["bf16"] = bf16
    return out


def tp_phases(torch, dev, card) -> dict:
    """Phases 41-43 in order. The ranks share the card with this process:
    its cached blocks are released first, and what it still holds is
    printed."""
    res = {}
    torch.cuda.empty_cache()
    emit("tp_parent_memory", allocated_gb=torch.cuda.memory_allocated(dev) / 1e9,
         reserved_gb=torch.cuda.memory_reserved(dev) / 1e9)
    with tempfile.TemporaryDirectory() as tmp:
        res["parity"] = tp_parity_slice(torch, dev, card, tmp)
        res["small"] = tp_small_slice(torch, dev, card, tmp)
        res["large"] = tp_large_slice(torch, dev, card, tmp)
    return res


# -- the benchmarking tools, the examples and profiling (phases 44-49) --------

BENCH_FRAC_MAX = 1.05  # a roofline fraction above this means a wrong count or clock
# The serving kernel variants of phase 46, by the route the rows name.
SERVE_VARIANTS = {"cuda-whole-unroll-kernel": "row 1", "cuda-whole-unroll-bf16-kernel": "row 1 bf16",
                  "cuda-int8-unroll-kernel": "row 7", "cuda-whole-unroll-kernel-prox": "row 1 prox"}
# The kernels phase 47's steps must launch (trace and wrappers).
PROFILE_KERNELS = {"shipped": {"trajectory_forward", "unroll_bwd"}, "fused": set(),
                   "qadam_int8": {"trajectory_forward", "unroll_bwd", "adam_step"}}
EXAMPLES = {"quickstart": "served 10 solves", "distributed": "sharded serving: 200 solves"}


def quiet_json(main, argv):
    """(parsed stdout, seconds) of a bench CLI's main(argv), its stderr
    progress swallowed; a non-zero return fails."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"{main.__module__}.main {argv} returned {rc}: {err.getvalue()[-2000:]}")
    return json.loads(out.getvalue()), time.monotonic() - t0


def bench_timing(torch, dev, card) -> dict:
    """Phase 44: bench/timing.time_chained on row 1 at synthetic_small
    S = 256 (strict: the UNCALIBRATED fallback fails), beside the CUDA-event
    median of one solve and the profiler's device time; the kernel's
    launches over the chains counted from 0."""
    import warnings

    from dladmm_tpu_torch.bench.timing import time_chained
    from dladmm_tpu_torch.ops.cuda_unroll import unroll_forward

    A, b, p = problem(torch, S=256, seed=7, device=dev, **SMALL)
    with torch.no_grad():
        unroll_forward.launches = 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            slope_s = time_chained(lambda c: b + 1e-12 * unroll_forward(c, A, *p)[2], b, iters=64, strict=True)
        launches = unroll_forward.launches
        if caught or not (math.isfinite(slope_s) and slope_s > 0):
            raise AssertionError(f"time_chained on row 1: {slope_s} s, warnings {[str(w.message) for w in caught]}")
        fn = lambda: unroll_forward(b, A, *p)  # noqa: E731
        fn()
        (events_ms,) = median_ms([fn], 31)
        dev = device_us(fn, "synthetic_small S=256")
    bms, by = bound(256, **SMALL)
    emit("bench_timing", config="synthetic_small S=256", chained_ms=slope_s * 1e3, events_median_ms=events_ms,
         **dev, bound_ms=bms, bound_by=by, launches=launches, card=card)
    return {"unroll_forward": launches}


def bench_roofline(torch, card) -> dict:
    """Phase 45: roofline.main at its three shapes, the plain loop and row 1
    at each; every fraction at most BENCH_FRAC_MAX, every time finite and
    positive, row 1's launches from 0 > 0 at each shape."""
    from dladmm_tpu_torch.bench import roofline

    results, wall = quiet_json(roofline.main, [])
    launches = 0
    for res in results:
        for row in res["paths"]:
            fracs = {k: row[k] for k in ("frac_of_fp32_peak", "frac_of_memory_bound", "frac_of_roofline")}
            if not (math.isfinite(row["time_us"]) and row["time_us"] > 0) or any(
                    not (0 < f <= BENCH_FRAC_MAX) for f in fracs.values()):
                raise AssertionError(f"roofline {res['shape']} {row['path']}: time {row['time_us']} us, {fracs}")
            if row["path"] == "megakernel":
                if row["launches"] < 1:
                    raise AssertionError(f"roofline {res['shape']}: row 1 launched no time")
                launches += row["launches"]
        emit("bench_roofline", shape=res["shape"], flops_g=res["flops_g"], ideal_min_hbm_mb=res["ideal_min_hbm_mb"],
             time_from=res["time_from"], paths=res["paths"], card=card)
    return {"unroll_forward": launches, "wall_s": wall}


def bench_serving(torch, card) -> dict:
    """Phase 46: serving.main --dtype=all --prox=nonneg_l1 at the paper
    shape, and --shape=flagship --dtype=float32: every row a finite,
    positive latency and throughput = bucket / latency; each kernel variant
    (rows 1, 1 bf16, 7 and 1 with a prox) present, and each row on a
    kernel launched from 0 > 0 times."""
    from dladmm_tpu_torch.bench import serving

    paper, wall_paper = quiet_json(serving.main, ["--dtype=all", "--prox=nonneg_l1", "--iters=16"])
    flagship, wall_flag = quiet_json(serving.main, ["--shape=flagship", "--dtype=float32", "--iters=8"])
    launches = {v: 0 for v in SERVE_VARIANTS.values()}
    for table in [*paper, flagship]:
        for row in table["buckets"]:
            t = row["latency_us"] * 1e-6
            if not (math.isfinite(t) and t > 0) or not math.isclose(row["throughput_solves_per_s"],
                                                                     row["bucket"] / t, rel_tol=1e-9):
                raise AssertionError(f"serving {table['shape']} {row}")
            variant = SERVE_VARIANTS.get(row["route"])
            if row["route"].startswith("cuda-") and (variant is None or not row["launches"]):
                raise AssertionError(f"serving {table['shape']} {row['route']}: {row['launches']} launches")
            if variant:
                launches[variant] += row["launches"]
        emit("bench_serving", shape=table["shape"], dtype=table["dtype"], prox_x=table.get("prox_x"),
             dispatch_overhead_ms=table["dispatch_overhead_ms"], latency_from=table["latency_from"],
             buckets=table["buckets"], card=card)
    missing = [v for v, n in launches.items() if n < 1]
    if missing:
        raise AssertionError(f"serving: no row ran {missing}")
    return {"launches": launches, "wall_s": wall_paper + wall_flag}


def profile_worker(out_path: str, jobs: str) -> int:
    """Phase 47's captures and phase 49's trace in a process of their own
    (``chip_smoke.py --profile-worker OUT JOBS``): late in this script's
    long process the profiler has been seen to leave one step's kernels
    out of every session, and then to record no device activity at all
    (PERF.md §6); a young process records them. Each job is a
    profile_step step (profile_job) or ``trace`` (traced_solve), each
    session of it run again where it missed a launch
    (retry_incomplete); the results go to OUT as JSON."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    res = {}
    for job in jobs.split(","):
        session = (lambda: traced_solve(torch, dev)) if job == "trace" else (lambda: profile_job(dev, job))
        result, sessions = retry_incomplete(session, f"profile worker {job}")
        res[job] = result | {"sessions": sessions}
    Path(out_path).write_text(json.dumps(res))
    return 0


def profile_job(dev, which: str) -> dict:
    """One session of phase 47's step ``which``: profile_step.capture (12
    steps at synthetic_large batch 1024, bf16 compute), then summarize.
    The summary must name the port's kernels the step launched
    (PROFILE_KERNELS); a kernel whose launches in the trace differ from
    its wrapper's count over the traced steps raises IncompleteProfile."""
    import shutil

    from dladmm_tpu_torch.bench.profile_step import capture, summarize

    trace_dir, steps = capture(12, which, device=dev)
    try:
        summary = summarize(trace_dir, steps)
    finally:
        shutil.rmtree(trace_dir)
    kernels = summary["kernels"]
    if set(kernels) != PROFILE_KERNELS[which]:
        raise AssertionError(f"profile_step {which}: kernels {kernels}, expected {PROFILE_KERNELS[which]}")
    if not all(k["trace_launches"] == k["wrapper_launches"] for k in kernels.values()):
        raise IncompleteProfile(f"profile_step {which}: trace and wrapper launches {kernels}")
    return summary


def run_profile_worker(jobs: str, timeout: int = 900) -> dict:
    """profile_worker's results for ``jobs``; its report lines are printed
    here, and a failure fails the phase with its output."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "profile.json"
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--profile-worker", str(path), jobs],
                             capture_output=True, text=True, timeout=timeout)
        for ln in run.stdout.splitlines():
            if ln.startswith('{"phase"'):
                print(ln, flush=True)
        if run.returncode != 0:
            raise AssertionError(f"profile worker {jobs}: exit {run.returncode}\n{run.stderr[-4000:]}")
        return json.loads(path.read_text())


def bench_profile_step(card) -> dict:
    """Phase 47: the three steps' captures and summaries, in a process of
    their own (profile_worker, profile_job): each summary names the port's
    kernels its step launched, and each kernel's launches in the trace
    equal its wrapper's count over the traced steps. The wrappers' counts
    (all bf16) are returned for the kernels line."""
    from dladmm_tpu_torch.bench.profile_step import STEPS

    bf16_key = {"trajectory_forward": "trajectory_forward_bf16", "unroll_bwd": "unroll_bwd_bf16",
                "adam_step": "adam_step_bf16"}
    summaries = run_profile_worker(",".join(STEPS))
    out = {}
    for which in STEPS:
        summary = summaries[which]
        kernels = summary["kernels"]
        emit("bench_profile_step", step=which, steps=summary["steps_profiled"], lane=summary["lane"],
             marker_recorded=summary["marker_recorded"], step_total_us=summary["step_total_us"],
             leaf_op_us_per_step=summary["leaf_op_us_per_step"], top_ops=summary["top_ops"][:10],
             kernels=kernels, sessions=summary["sessions"], card=card)
        out[which] = {bf16_key[name]: k["wrapper_launches"] for name, k in kernels.items()}
    return out


def bench_comm_scaling(torch, card) -> dict:
    """Phase 48: comm_model for every sharded preset (both layouts, every
    field finite), then scaling at synthetic_small (batch 64 a rank) on 1
    rank (NCCL, its measured fields a result) and on 2 ranks sharing the
    card (gloo, its fields under harness_validation_only); each rank 0
    launched the trajectory and backward kernels."""
    from dladmm_tpu_torch.bench import comm_model
    from dladmm_tpu_torch.bench.scaling import measure_dp_scaling
    from dladmm_tpu_torch.utils.config import PRESETS

    rows, _ = quiet_json(comm_model.main, [])
    sharded = [n for n, c in PRESETS.items() if c.sharding.data_axis * c.sharding.model_axis > 1 or c.sharding.multihost]
    if sorted({r["config"] for r in rows}) != sorted(sharded) or len(rows) != 2 * len(sharded):
        raise AssertionError(f"comm_model: rows {[(r['config'], r['layout']) for r in rows]}")
    for r in rows:
        vals = [r["per_chip_gb"], r["per_chip_tflops_per_step"], *r["model_step_ms"].values(),
                r["scaling_efficiency_no_overlap"]]
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"comm_model {r['config']} {r['layout']}: {r}")
    emit("bench_comm", rows=rows)
    t0 = time.monotonic()
    scaling = measure_dp_scaling([(1, 1), (2, 1)], timeout=600)
    wall = time.monotonic() - t0
    one, two = scaling
    if one["backend"] != "nccl" or "step_ms" not in one or two["backend"] != "gloo" or \
            "harness_validation_only" not in two or "step_ms" in two:
        raise AssertionError(f"scaling: {scaling}")
    for row in scaling:
        fields = row.get("harness_validation_only", row)
        if not (math.isfinite(fields["step_ms"]) and fields["step_ms"] > 0) or not all(
                row["launches_rank0"].get(k, 0) > 0 for k in ("trajectory_forward", "unroll_bwd")):
            raise AssertionError(f"scaling {row['mesh']}: {row}")
    emit("bench_scaling", rows=scaling, wall_s=wall, card=card)
    return {f"{row['mesh']} {row['backend']} (rank 0)": row["launches_rank0"] for row in scaling}


def traced_solve(torch, dev) -> dict:
    """utils/profiling.trace around one row-1 solve at synthetic_small
    S = 256, read back by profile_step.summarize: the kernel must be in
    the trace once. A trace that recorded no device kernel at all (the
    profiler's empty windows, PERF.md §7) raises IncompleteProfile."""
    from dladmm_tpu_torch.bench.profile_step import summarize
    from dladmm_tpu_torch.ops.cuda_unroll import unroll_forward
    from dladmm_tpu_torch.utils import profiling

    A, b, p = problem(torch, S=256, seed=5, device=dev, **SMALL)
    with torch.no_grad():
        unroll_forward(b, A, *p)
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            unroll_forward.launches = 0
            with profiling.trace(tmp):
                unroll_forward(b, A, *p)
            with open(Path(tmp) / profiling.TRACE_FILE) as f:
                cats = {}
                for e in json.load(f)["traceEvents"]:
                    cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
            traced = summarize(tmp, 1)
    if traced["lane"] != "device":
        raise IncompleteProfile(f"profiling.trace around one row-1 solve: no device event, events by category {cats}")
    kernels = traced["kernels"]
    if kernels.get("unroll_forward", {}).get("trace_launches") != 1 or unroll_forward.launches != 1:
        raise AssertionError(f"profiling.trace around one row-1 solve: {kernels}, {unroll_forward.launches} "
                             f"launches, events by category {cats}")
    return {"kernels": kernels, "top_ops": traced["top_ops"]}


def examples_profiling(torch, dev, card) -> dict:
    """Phase 49: both examples run on the card as subprocesses, at once,
    and each prints its line; meanwhile utils/profiling.trace around one
    row-1 solve, in a process of its own (profile_worker, traced_solve),
    gives a trace that holds the kernel once; and here, with
    enable_nan_debug(True), torch.log(-x) on the card and a NaN row of b
    fed to row 1 raise FloatingPointError (the second from the kernel
    wrapper's check); off again, nothing is checked and no mode stays
    pushed."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    from dladmm_tpu_torch.ops.cuda_unroll import unroll_forward
    from dladmm_tpu_torch.utils import profiling

    root = Path(__file__).resolve().parent
    t0 = time.monotonic()
    procs = {name: subprocess.Popen([sys.executable, "-m", f"dladmm_tpu_torch.examples.{name}"], cwd=str(root),
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name in EXAMPLES}
    try:
        traced = run_profile_worker("trace")["trace"]
        A, b, p = problem(torch, S=256, seed=5, device=dev, **SMALL)
        lap = profiling.StepTimer().lap(sync_on=b)
        nan_b = b.clone()
        nan_b[3] = float("nan")
        x = torch.ones(8, device=dev)
        raised = {}
        profiling.enable_nan_debug(True)
        try:
            for case, fn, says in (("aten", lambda: torch.log(-x), "aten.log"),
                                   ("row 1", lambda: unroll_forward(nan_b, A, *p), "the kernel of unroll_forward")):
                try:
                    with torch.no_grad():
                        fn()
                    torch.cuda.synchronize()
                except FloatingPointError as e:
                    raised[case] = str(e)
                    if says not in str(e):
                        raise AssertionError(f"enable_nan_debug {case}: raised {e}") from None
                else:
                    raise AssertionError(f"enable_nan_debug: {case} made a NaN and nothing raised")
        finally:
            profiling.enable_nan_debug(False)
        if _get_current_dispatch_mode() is not None or not bool(torch.isnan(torch.log(-x)).all()):
            raise AssertionError("enable_nan_debug(False) left a mode pushed")
        emit("profiling", trace=traced, step_timer_lap_s=lap, nan_debug_raised=raised, card=card)
        for name, proc in procs.items():
            log = proc.communicate(timeout=900)[0]
            if proc.returncode != 0 or EXAMPLES[name] not in log:
                raise AssertionError(f"example {name}: exit {proc.returncode}\n{log[-4000:]}")
            emit("examples", example=name, expected=EXAMPLES[name],
                 lines=[ln for ln in log.splitlines() if not ln.startswith(" ")][-6:],
                 wall_s=time.monotonic() - t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    return {"profiling.trace": 1}


def bench_phases(torch, dev, card) -> dict:
    """Phases 44-49 in order, each one's wall time printed; returns the
    launches of each port kernel by bench path, keyed as the kernels
    line's entries."""
    walls, res = {}, {}
    for name, run in (("bench_timing", lambda: bench_timing(torch, dev, card)),
                      ("bench_roofline", lambda: bench_roofline(torch, card)),
                      ("bench_serving", lambda: bench_serving(torch, card)),
                      ("bench_profile_step", lambda: bench_profile_step(card)),
                      ("bench_comm_scaling", lambda: bench_comm_scaling(torch, card)),
                      ("examples_profiling", lambda: examples_profiling(torch, dev, card))):
        t0 = time.monotonic()
        res[name] = run()
        walls[name] = time.monotonic() - t0
        emit("bench_wall", bench_phase=name, seconds=walls[name])
    prof, serve = res["bench_profile_step"], res["bench_serving"]["launches"]
    by_step = lambda key: {f"profile_step {w}": c.get(key, 0) for w, c in prof.items() if c.get(key)}  # noqa: E731
    scaling = lambda key: {f"scaling {mesh}": c.get(key, 0)  # noqa: E731
                           for mesh, c in res["bench_comm_scaling"].items() if c.get(key)}
    launches = {
        "unroll_forward": {"bench_timing": res["bench_timing"]["unroll_forward"],
                           "bench_roofline": res["bench_roofline"]["unroll_forward"],
                           "bench_serving fp32": serve["row 1"], "bench_serving prox": serve["row 1 prox"],
                           "profiling.trace": res["examples_profiling"]["profiling.trace"]},
        "unroll_forward_bf16": {"bench_serving bf16": serve["row 1 bf16"]},
        "int8_unroll_forward": {"bench_serving int8": serve["row 7"]},
        "trajectory_forward": scaling("trajectory_forward"),
        "trajectory_forward_bf16": by_step("trajectory_forward_bf16"),
        "unroll_bwd": scaling("unroll_bwd"),
        "unroll_bwd_bf16": by_step("unroll_bwd_bf16"),
        "adam_int8_rows_bf16": by_step("adam_step_bf16"),
    }
    emit("bench_phases", wall_s=walls, launches_bench=launches, card=card)
    return launches


def build_phase() -> None:
    """Phase 2: nvcc builds every source of ops/csrc/ from this checkout,
    one nvcc per source, all started together; each source's ptxas report
    (registers, spills) is printed."""
    from dladmm_tpu_torch.ops import cuda_build

    sources = sorted(cuda_build.CSRC.glob("*.cu"))
    t0 = time.monotonic()
    builds = cuda_build.build_all(sources)
    for name, (lib_path, built, secs) in builds.items():
        log = Path(str(lib_path) + ".log")
        ptxas = ([ln.strip() for ln in log.read_text().splitlines()
                  if "registers" in ln or "spill" in ln or "Compiling entry function" in ln]
                 if log.exists() else [])
        emit("build", source=name, seconds=secs, built_now=built, library=lib_path.name, ptxas=ptxas)
    emit("build_all", seconds=time.monotonic() - t0, sources=len(builds))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs the card",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--dp-worker"]:
        return dp_worker(*sys.argv[2:4])
    if sys.argv[1:2] == ["--profile-worker"]:
        return profile_worker(*sys.argv[2:4])
    if sys.argv[1:] == ["--sharded"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = card_line()
        print(card, flush=True)
        build_phase()
        _, entries = sharded_phases(torch, torch.device("cuda", 0), card)
        print(json.dumps({"kernels": entries}), flush=True)
        return 0
    if sys.argv[1:] == ["--tp"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = card_line()
        print(card, flush=True)
        build_phase()
        tp_phases(torch, torch.device("cuda", 0), card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0
    if sys.argv[1:] == ["--bench"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = card_line()
        print(card, flush=True)
        build_phase()
        print(json.dumps({"launches_bench": bench_phases(torch, torch.device("cuda", 0), card)}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0
    if sys.argv[1:] == ["--int8-turns"]:
        card = card_line()
        print(card, flush=True)
        time_int8(torch, torch.device("cuda", 0), card, plain=False)
        return 0
    if sys.argv[1:] == ["--bf16-train"]:
        from dladmm_tpu_torch.train import qadam_cuda

        torch.backends.cuda.matmul.allow_tf32 = False
        card = card_line()
        print(card, flush=True)
        build_phase()
        dev = torch.device("cuda", 0)
        check_traj_bf16(torch, dev)
        check_bwd_bf16(torch, dev)
        check_step_bf16(torch, qadam_cuda, dev)
        with tempfile.TemporaryDirectory() as tmp:
            train_bf16_slice(torch, dev, tmp)
        time_train_bf16(torch, dev, card)
        return 0
    if sys.argv[1:] == ["--denoise"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = card_line()
        print(card, flush=True)
        build_phase()
        print(json.dumps({"kernels": denoise_phases(torch, torch.device("cuda", 0), card)}), flush=True)
        return 0
    if sys.argv[1:] == ["--bf16-turns"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        card = card_line()
        print(card, flush=True)
        time_bf16(torch, torch.device("cuda", 0), card)
        return 0
    from dladmm_tpu_torch.baselines.ladmm import ladmm_run
    from dladmm_tpu_torch.data.synthetic import make_batch, problem_matrices, seed_keys
    from dladmm_tpu_torch.metrics.core import nmse_db
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.ops.cuda_unroll import unroll_forward, unroll_forward_plain
    from dladmm_tpu_torch.serve import BatchingServer, InferenceServer
    from dladmm_tpu_torch.serve import main as serve_main
    from dladmm_tpu_torch.utils.config import get_config
    from dladmm_tpu_torch.utils.torch_compat import save_torch

    dev = torch.device("cuda", 0)
    # Checkpoints that later phases serve again; removed at the end.
    work = tempfile.TemporaryDirectory()
    ckpt10 = Path(work.name) / "train"
    ckpt10.mkdir()
    # 1. device. The plain version's products must be full fp32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda, tf32=False)

    # 2. build, from the sources in this checkout: one nvcc per source.
    build_phase()

    # 3. kernel against its plain version, on the card; a second call must
    # repeat bit for bit.
    def check_unroll(label, A, b, p, **kw):
        got = unroll_forward(b, A, *p, **kw)
        want = unroll_forward_plain(b, A, *p, **kw)
        again = unroll_forward(b, A, *p, **kw)
        torch.cuda.synchronize()
        err = compare(torch, got, want, label)
        if not all(torch.equal(g, w) for g, w in zip(got, again)):
            raise AssertionError(f"{label}: a second call differs")
        emit("kernel", case=label, repeats_bit_for_bit=True, **launched_plan(unroll_forward))
        return err

    max_err = 0.0
    with torch.no_grad():
        for S in (1, 13, 64, 256):
            A, b, p = problem(torch, S=S, seed=S, device=dev, **SMALL)
            max_err = max(max_err, check_unroll(f"synthetic_small S={S} l1/l1", A, b, p))
        A, b, p = problem(torch, S=64, seed=64, device=dev, **SMALL)
        for prox in ("nonneg_l1", "box", "elastic_net"):
            rho = 0.3 if prox == "elastic_net" else 0.0
            max_err = max(max_err, check_unroll(f"synthetic_small S=64 {prox}(rho={rho})/l1", A, b, p,
                                                prox_x=prox, rho=rho))
            max_err = max(max_err, check_unroll(f"synthetic_small S=64 l1/{prox}(rho={rho})", A, b, p,
                                                prox_z=prox, rho=rho))
        scalar = p._replace(theta1=p.theta1.mean(dim=1, keepdim=True), theta2=p.theta2.mean(dim=1, keepdim=True))
        max_err = max(max_err, check_unroll("synthetic_small S=64 l1/l1 (K, 1) thresholds", A, b, scalar))
        A, b, p = problem(torch, S=1024, seed=1024, device=dev, **LARGE)
        max_err = max(max_err, check_unroll("synthetic_large S=1024 l1/l1", A, b, p))
        other = 64 if launched_plan(unroll_forward)["tile"] == 32 else 32  # the tile the plan did not pick
        with serve_tile(other):
            max_err = max(max_err, check_unroll(f"synthetic_large S=1024 l1/l1 tile {other}", A, b, p))
        del A, b, p, scalar

    # 4. the slice: the serving CLI and the servers, LADMM-exact params.
    cfg = get_config("synthetic_small")
    A_cfg, _ = problem_matrices(cfg, device=dev)
    params = init_dladmm_params(A_cfg, K=cfg.problem.K, beta=cfg.problem.beta)
    demo = make_batch(seed_keys(cfg)[1], A_cfg, 256)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "ladmm_exact.pt"
        save_torch(params, ckpt)
        unroll_forward.launches = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = serve_main([
                "--config=synthetic_small", "--import-torch", str(ckpt),
                "--demo", "256",
            ])
        cli_launches = unroll_forward.launches
    if rc != 0:
        raise AssertionError(f"serve.main returned {rc}")
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    with torch.no_grad():
        xl, _, _ = ladmm_run(A_cfg, demo.b, iters=cfg.problem.K, beta=cfg.problem.beta)
    ladmm_db = float(nmse_db(xl, demo.x_star))
    if summary["route"] != "cuda-whole-unroll-kernel" or cli_launches < 1:
        raise AssertionError(
            f"serving did not go through the CUDA kernel: route "
            f"{summary['route']!r}, {cli_launches} launches"
        )
    if not abs(summary["nmse_db"] - ladmm_db) <= NMSE_TOL_DB:
        raise AssertionError(
            f"served NMSE {summary['nmse_db']} dB != LADMM {ladmm_db} dB"
        )
    emit("slice_cli", serve=summary, ladmm_nmse_db=ladmm_db, launches=cli_launches)

    # The servers' path, counted from 0: 9 bucket warm-ups, 4 solves and
    # the batched dispatches (the plain version's checks do not count).
    unroll_forward.launches = 0
    server = InferenceServer(params, A_cfg, max_batch=256, device=dev)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for rows in (1, 7, 64, 200):
            req = torch.from_numpy(rng.normal(size=(rows, A_cfg.shape[0])).astype(np.float32)).to(dev)
            x, z = server.solve(req)
            xw, zw, _ = unroll_forward_plain(req, A_cfg, *server.params)
            torch.cuda.synchronize()
            for name, g_, w_ in (("x", x, xw), ("z", z, zw)):
                err = float((g_ - w_).abs().max())
                if not err <= TOL * max(1.0, float(w_.abs().max())):
                    raise AssertionError(f"InferenceServer rows={rows} {name}: {err}")
            emit("slice_server", rows=rows, bucket=server._bucket_for(rows),
                 route=server.routes[server._bucket_for(rows)],
                 max_abs_err=float((x - xw).abs().max()))
    reqs = [rng.normal(size=(s, A_cfg.shape[0])).astype(np.float32) for s in (1, 3, 5, 8, 13, 21, 34, 55)]
    front = BatchingServer(server, max_delay_ms=5.0)
    try:
        with ThreadPoolExecutor(len(reqs)) as clients:  # 8 concurrent submits
            futs = list(clients.map(front.submit, reqs))
        batched = [f.result(timeout=120) for f in futs]
    finally:
        front.close()
    server_launches = unroll_forward.launches
    if server_launches < 1:
        raise AssertionError("the servers' path launched the CUDA kernel no time")
    for r, (xb, zb) in zip(reqs, batched):  # re-solves: checks, not counted
        xs, zs = server.solve(r)
        if not (np.allclose(xb, xs.cpu().numpy(), rtol=1e-5, atol=1e-6)
                and np.allclose(zb, zs.cpu().numpy(), rtol=1e-5, atol=1e-6)):
            raise AssertionError(f"BatchingServer rows={len(r)} != per-request solve")
    emit("slice_servers", requests=len(reqs), launches=server_launches)

    # 5. timing at the main path's shape and the other presets'; at
    # synthetic_large also the tile the plan did not pick, in the same turns.
    timings, serve_detail = {}, {}
    with torch.no_grad():
        for label, shape, S in (
            ("synthetic_small", SMALL, 64),
            ("synthetic_small", SMALL, 256),
            ("synthetic_large", LARGE, 1024),
        ):
            A, b, p = problem(torch, S=S, seed=7, device=dev, **shape)
            reps = 9 if label == "synthetic_large" else 31
            fns = [lambda: unroll_forward(b, A, *p), lambda: unroll_forward_plain(b, A, *p)]
            fns[0]()
            plan = launched_plan(unroll_forward)
            other = 64 if plan["tile"] == 32 else 32

            def on_other_tile():
                with serve_tile(other):
                    unroll_forward(b, A, *p)

            if label == "synthetic_large":
                fns.append(on_other_tile)
            for _ in range(2):  # warm-up
                for fn in fns:
                    fn()
            ms, plain_ms, *other_ms = median_ms(fns, reps)
            bms, by = bound(S, **shape)
            timings[(label, S)] = (ms, plain_ms, bms, by)
            detail = {"host_enqueue_us": host_enqueue_us(torch, fns[0]),
                      **device_us(fns[0], f"{label} S={S}"),
                      **plan}
            if other_ms:
                detail.update(other_tile=other, other_tile_ms=other_ms[0],
                              other_tile_device_us_per_call=profile_fn(
                                  on_other_tile, f"{label} S={S} tile {other}")["device_us_per_call"])
            serve_detail[(label, S)] = detail
            emit("timing", config=label, S=S, kernel_ms=ms, plain_ms=plain_ms,
                 bound_ms=bms, bound_by=by, reps=reps, **detail, card=card)
            del A, b, p, fns
    # 6. where the kernel's time goes, at the main path's shape.
    serve_profile = profile_unroll(torch, unroll_forward, S=256, **SMALL)
    emit("profile", **serve_profile, **launched_plan(unroll_forward))

    # 7-9. the training kernels against their plain versions; gradients.
    from dladmm_tpu_torch.ops.cuda_traj import trajectory_forward, trajectory_forward_plain
    from dladmm_tpu_torch.train import qadam_cuda

    traj_err = 0.0
    with torch.no_grad():
        for label, shape, S in (("synthetic_small", SMALL, 64), ("synthetic_small", SMALL, 256),
                                ("synthetic_small", SMALL, 3000), ("synthetic_large", LARGE, 1024)):
            A, b, p = problem(torch, S=S, seed=S + 3, device=dev, **shape)
            for with_tax in (True, False):
                got = trajectory_forward(b, A, *p, with_tax=with_tax)
                want = trajectory_forward_plain(b, A, *p, with_tax=with_tax)
                torch.cuda.synchronize()
                names = ("tx", "tz", "tlam", "tax")[: len(want)]
                traj_err = max(traj_err, compare(torch, got, want, f"{label} S={S} with_tax={with_tax}",
                                                 names=names, phase="kernel_traj"))
                again = trajectory_forward(b, A, *p, with_tax=with_tax)
                if not all(torch.equal(g, w) for g, w in zip(got, again)):
                    raise AssertionError(f"trajectory {label} S={S} with_tax={with_tax}: a second call differs")
            emit("kernel_traj", case=f"{label} S={S}", repeats_bit_for_bit=True,
                 **launched_plan(trajectory_forward))
            del A, b, p, got, want, again
    int8_err = max(check_int8(torch, qadam_cuda, dev), check_step(torch, qadam_cuda, dev, ["int8"]))
    check_grads(torch, dev)

    # 10. the training slice, counted from 0; then its checkpoint served.
    train_launches, ckpt_serve_launches = train_slice(torch, dev, unroll_forward, str(ckpt10))

    # 11-12. training step time and kernel times; profile.
    _, train_timings, train_plans = time_train(torch, dev, card)
    barrier_cost(torch, card)
    profile_train(torch, dev)

    # 13-14. the final-layer slice's kernels against their plain versions.
    bwd_errs = check_bwd(torch, dev)
    dense_err = max(check_dense(torch, qadam_cuda, dev), check_step(torch, qadam_cuda, dev, list(qadam_cuda.DENSE_FMTS)))
    # 15. the final-layer training slice, counted from 0; its checkpoint
    # served; the batch-1024 run on the chunked route.
    final_launches, final_serve_launches, big_launches, chunk_launches = train_final_slice(torch, dev, unroll_forward)
    # 16-17. final-layer step time and kernel times; profile.
    _, final_timings, final_plans = time_train_final(torch, dev, card)
    profile_train_final(torch, dev)

    # 18. the int8 kernel against its plain version.
    int8_unroll_err = check_int8_unroll(torch, dev)
    # 19. int8 serving: the CLI on the phase-10 checkpoint and on the
    # LADMM-exact params, then the servers, each counted from 0.
    ladmm_pt = Path(work.name) / "ladmm_exact.pt"
    save_torch(params, ladmm_pt)
    int8_launches = serve_int8_slice(
        torch, dev, {"phase-10 checkpoint": ["--ckpt-dir", str(ckpt10)],
                     "LADMM-exact .pt": ["--import-torch", str(ladmm_pt)]}, params, A_cfg)
    # 20-21. the layer step against the plain loop; training through it,
    # counted from 0.
    layer_err = check_layer(torch, dev)
    layer_launches = train_layer(torch, dev)
    # 22. their times and device time.
    new_timings = time_int8_and_layer(torch, dev, card)
    # 23. the bf16-storage serving kernel and the layer step on bf16 state
    # against their plain versions; the bf16 fused-step loop, counted from 0.
    bf16_serve_err, bf16_layer_err, bf16_loop_launches = check_bf16_kernel(torch, dev)
    # 24. bf16 serving: the CLI on the LADMM-exact params and on the
    # phase-10 checkpoint, then the servers, each counted from 0.
    bf16_launches = serve_bf16_slice(
        torch, dev, {"LADMM-exact .pt": ["--import-torch", str(ladmm_pt)],
                     "phase-10 checkpoint": ["--ckpt-dir", str(ckpt10)]}, params, A_cfg)
    # 25. bf16 and fp32 in turns: times, device time, bounds.
    bf16_timings = time_bf16(torch, dev, card)
    # 26-28. bf16 training's kernels against their plain versions.
    traj16_err = check_traj_bf16(torch, dev)
    bwd16_errs = check_bwd_bf16(torch, dev)
    step16_errs = check_step_bf16(torch, qadam_cuda, dev)
    # 29. bf16 training through fit, recipes (a) and (b), each kernel counted
    # from 0; fp32 twins; the bf16 checkpoint served.
    ckpt29 = Path(work.name) / "train_bf16"
    ckpt29.mkdir()
    slice16 = train_bf16_slice(torch, dev, str(ckpt29))
    # 30. bf16 training beside fp32, in turns.
    train16 = time_train_bf16(torch, dev, card)
    work.cleanup()
    # 31-35. the image benchmark's shape, run_denoise, DLADMMSolver and the
    # XLA-side moment formats, each path counted from 0; their times.
    entries_patch = denoise_phases(torch, dev, card)
    # 36-40. fused_adam, greedy, data parallelism and sharded serving, each
    # path counted from 0.
    sharded_res, entries_sharded = sharded_phases(torch, dev, card)
    # 41-43. tensor parallelism: parity on 4 gloo ranks, run --config=tp_small
    # on 8, tp_large (and tp_large_bf16) at full width.
    tp_phases(torch, dev, card)
    # 44-49. the benchmarking tools, the examples and profiling, each bench
    # path's kernels counted from 0.
    launches_bench = bench_phases(torch, dev, card)

    ms, plain_ms, bms, by = timings[("synthetic_small", 256)]
    entries = [{
        "name": "unroll_forward",
        "route": "cuda",
        "source": "dladmm_tpu_torch/ops/csrc/unroll.cu",
        "replaces": "dladmm_tpu/ops/pallas_unroll.py:36",
        "launches": cli_launches,  # its main path: serve.main --demo 256
        "launches_by_path": {"serve_cli": cli_launches, "servers": server_launches,
                             "serve_ckpt_dir": ckpt_serve_launches},
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": None,
        "shape": "synthetic_small S=256",
        **serve_detail[("synthetic_small", 256)],
        "device_us_per_call": serve_profile["device_us_per_call"],  # phase 6
    }]
    ms, plain_ms, bms, by = train_timings["trajectory_forward"]
    entries.append({
        "name": "trajectory_forward", "route": "cuda", "source": "dladmm_tpu_torch/ops/csrc/unroll.cu",
        "replaces": "dladmm_tpu/ops/pallas_unroll.py:266",
        "launches": train_launches["trajectory_forward"],  # main path: run.main --steps=300
        "max_abs_err": traj_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
        "bound_by": by, "library_ms": None, "shape": "synthetic_small S=64 with_tax",
        **train_plans["trajectory_forward"],
    })

    def step_entry(name, source, replaces, err, launches, timing, shape):
        """Rows 3 and 6: the step's entry adam_step (prologue + sweep, both
        launches counted), timed on synthetic_small's five leaves."""
        t = dict(timing)
        return {"name": name, "entry": "adam_step", "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": t.pop("ms"), "plain_ms": t.pop("plain_ms"),
                "bound_ms": t.pop("bound_ms"), "bound_by": t.pop("bound_by"), "library_ms": t.pop("library_ms"),
                "shape": shape, **t}

    # main path: run.main --steps=300, two launches a step
    entries.append(step_entry("adam_int8_rows", "dladmm_tpu_torch/ops/csrc/qadam_int8.cu",
                              "dladmm_tpu/train/qadam_pallas.py:129", int8_err, train_launches["adam_step"],
                              train_timings["adam_step@int8"], "int8 synthetic_small five leaves, one step"))
    for name, source, replaces, err, timing, launches, shape in (
        ("unroll_bwd", "dladmm_tpu_torch/ops/csrc/unroll_bwd.cu", "dladmm_tpu/ops/pallas_bwd.py:56",
         bwd_errs["whole"], "unroll_bwd", final_launches["unroll_bwd"], "synthetic_small S=64"),
        ("unroll_bwd_chunked", "dladmm_tpu_torch/ops/csrc/unroll_bwd.cu", "dladmm_tpu/ops/pallas_bwd.py:356",
         bwd_errs["chunked"], "unroll_bwd@1024_chunked", chunk_launches["unroll_bwd_chunked"],
         "synthetic_small S=1024 bs=128"),
    ):
        ms, plain_ms, bms, by, library_ms = final_timings[timing]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            # main paths: run --layer-loss=none --moment-dtype=float32_pallas
            # --steps=1000; the chunked route's launches are those of the same
            # with --config=smoke --batch=1024 --steps=20 (synthetic_small does
            # not split), its times those at synthetic_small S=1024, bs=128
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms, "shape": shape,
            **final_plans.get(timing, {}),
        })
    # main path: run --layer-loss=none --moment-dtype=float32_pallas --steps=1000, two launches a step
    entries.append(step_entry("adam_dense_rows", "dladmm_tpu_torch/ops/csrc/qadam_dense.cu",
                              "dladmm_tpu/train/qadam_pallas.py:178", dense_err, final_launches["adam_step"],
                              final_timings["adam_step@float32"], "float32 synthetic_small five leaves, one step"))
    ms, plain_ms, bms, by = new_timings[("int8", 256)]
    entries.append({
        "name": "int8_unroll_forward", "route": "cuda", "source": "dladmm_tpu_torch/ops/csrc/int8_unroll.cu",
        "replaces": "dladmm_tpu/ops/quantized.py:197",
        # main path: serve --dtype=int8 --kernel=megakernel --demo 256 on the phase-10 checkpoint
        "launches": int8_launches["serve_cli phase-10 checkpoint megakernel"],
        "launches_by_path": int8_launches, "max_abs_err": int8_unroll_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": None, "shape": "synthetic_small S=256",
        **new_timings[("int8", 256, "detail")],
        "synthetic_large_S1024": dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"), new_timings[("int8_large", 1024)]),
                                      **new_timings[("int8_large", 1024, "detail")]),
    })
    ms, plain_ms, bms, by = new_timings[("layer", 256)]
    entries.append({
        "name": "layer_step", "route": "cuda", "source": "dladmm_tpu_torch/ops/csrc/unroll.cu",
        "replaces": "dladmm_tpu/ops/pallas_layer.py:61",
        # main path: 20 training steps through make_train_step(step_fn=fused_layer_step), K calls a forward
        "launches": layer_launches, "max_abs_err": layer_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": None, "shape": "synthetic_small S=256, one layer",
        **new_timings["layer_detail"],
    })
    # Rows 1 and 8 in bf16 (phases 23-25): main paths serve --dtype=bfloat16
    # --demo 256 on the LADMM-exact params, and the bf16 fused-step loop.
    rows16 = bf16_timings[("synthetic_small", 256)]
    entries[0]["bf16"] = {
        "launches": bf16_launches["serve_cli LADMM-exact .pt"], "launches_by_path": bf16_launches,
        "max_abs_err": bf16_serve_err, "library_ms": None, "shape": "synthetic_small S=256", **rows16["bf16"],
        "fp32_in_turns": rows16["fp32"],
        "other_shapes": {f"{label} S={S}": bf16_timings[(label, S)] for label, _, S in INT8_SHAPES if S != 256 or
                         label != "synthetic_small"},
    }
    entries[-1]["bf16"] = {"launches": bf16_loop_launches, "max_abs_err": bf16_layer_err, "library_ms": None,
                           "shape": "synthetic_small S=256, one layer, bf16 state", **bf16_timings["layer"]}

    def bf16_entry(name, source, replaces, launches, err, row, shape, **extra):
        """Rows 2-6 in bf16 (phases 26-30): main paths fit on
        synthetic_small with compute_dtype="bfloat16", recipe (a) (rows 2,
        4, 6) or (b) (row 3); the chunked backward's launches are those of
        recipe (a) at the smoke preset's batch 1024 (synthetic_small does
        not split), its times at the smoke preset's S = 1024."""
        keep = {k: v for k, v in row.items() if k not in ("device_kernels",)}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "storage": "bfloat16",
                "launches": launches, "max_abs_err": err, "ms": keep.pop("ms"), "plain_ms": keep.pop("plain_ms"),
                "bound_ms": keep.pop("bound_ms"), "bound_by": keep.pop("bound_by"), "library_ms": None,
                "shape": shape, "fp32_in_turns": keep.pop("fp32"), **keep, **extra}

    la, lb = slice16["a"]["launches"], slice16["b"]["launches"]
    entries += [
        bf16_entry("trajectory_forward_bf16", "dladmm_tpu_torch/ops/csrc/unroll.cu",
                   "dladmm_tpu/ops/pallas_unroll.py:266", la["trajectory_forward_bf16"], traj16_err,
                   train16[("trajectory_forward", "synthetic_small", 64)], "synthetic_small S=64 with_tax",
                   launches_by_path={"a": la["trajectory_forward_bf16"], "b": lb["trajectory_forward_bf16"]},
                   synthetic_large_S1024=train16[("trajectory_forward", "synthetic_large", 1024)]),
        bf16_entry("adam_int8_rows_bf16", "dladmm_tpu_torch/ops/csrc/qadam_int8.cu",
                   "dladmm_tpu/train/qadam_pallas.py:129", lb["adam_step_bf16"], step16_errs["int8"],
                   train16[("adam_step", "int8")], "int8 synthetic_small five leaves, bf16 gradients + copy",
                   entry="adam_step"),
        bf16_entry("unroll_bwd_bf16", "dladmm_tpu_torch/ops/csrc/unroll_bwd.cu", "dladmm_tpu/ops/pallas_bwd.py:56",
                   la["unroll_bwd_whole_bf16"], bwd16_errs["whole"], train16[("unroll_bwd", "synthetic_small", 64)],
                   "synthetic_small S=64", synthetic_large_S1024=train16[("unroll_bwd", "synthetic_large", 1024)]),
        bf16_entry("unroll_bwd_chunked_bf16", "dladmm_tpu_torch/ops/csrc/unroll_bwd.cu",
                   "dladmm_tpu/ops/pallas_bwd.py:356", slice16["chunked"]["launches"]["unroll_bwd_chunked_bf16"],
                   bwd16_errs["chunked"], train16[("unroll_bwd_chunked", "smoke", 1024)], "smoke S=1024 bs=128",
                   synthetic_small_S1024_bs128=train16[("unroll_bwd_chunked", "synthetic_small", 1024)]),
        bf16_entry("adam_dense_rows_bf16", "dladmm_tpu_torch/ops/csrc/qadam_dense.cu",
                   "dladmm_tpu/train/qadam_pallas.py:178", la["adam_step_bf16"], step16_errs["float32"],
                   train16[("adam_step", "float32")], "float32 synthetic_small five leaves, bf16 gradients + copy",
                   entry="adam_step",
                   max_abs_err_by_dense_format={f: e for f, e in step16_errs.items() if f != "int8"}),
    ]
    entries += entries_patch
    new_paths = new_path_launches(sharded_res)
    for e in entries:
        key = {"unroll_forward": "unroll_forward", "int8_unroll_forward": "int8_unroll_forward",
               "adam_int8_rows": "adam_step", "adam_dense_rows": "adam_step"}.get(e["name"])
        if key:
            e["launches_new_paths"] = new_paths[key]  # phases 36-40
    entries += entries_sharded
    for e in entries:  # phases 44-49, on the base entries: they ran no patch shape and no greedy depth
        e["launches_bench"] = launches_bench.get(e["name"], {})
    entries[0]["bf16"]["launches_bench"] = launches_bench["unroll_forward_bf16"]
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
