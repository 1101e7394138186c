"""NVLink and inter-host traffic, FLOPs and memory a card, per sharded
preset: the analytic model of a sharded training step.

``python -m dladmm_tpu_torch.bench.comm_model [--config NAME] [--hbm-gb G] [--out f.json]``

The port of ``dladmm_tpu/bench/comm_model.py``, at the published H100
rates. For every sharded preset (or one --config) and both TP layouts it
prints:
  * the bytes a card holds (parallel/memory.per_chip_bytes) and whether
    they fit 90% of the card's memory (80 GB, or --hbm-gb);
  * the matmul FLOPs a card does in a training step (forward ~1/3,
    backward ~2/3);
  * the bytes a step's tensor-parallel collectives move over NVLink and
    the data-parallel gradient all-reduce, flagged where it crosses hosts
    (parallel/memory.step_traffic_bytes);
  * the model's step-time components at those rates and the scaling
    efficiency they imply: compute / (compute + exposed communication)
    with no overlap (a lower bound) and with perfect overlap. The
    compute is priced at the peak of the step's compute dtype
    (bench/roofline): bf16 on the tensor cores, fp32 outside them, since
    the port's fp32 matmuls run with TF32 off.
"""

from __future__ import annotations

import argparse
import json
import sys

from dladmm_tpu_torch.bench.roofline import PEAK_BF16_FLOPS, PEAK_FP32_FLOPS

# Published H100 SXM figures (NVIDIA's data sheets): NVLink 4, 900 GB/s a
# GPU, both directions together; between hosts one NDR InfiniBand link of
# 400 Gb/s a GPU; 80 GB of HBM3. The compute peaks are bench/roofline's.
NVLINK_GBPS = 900.0
INTER_HOST_GBPS = 50.0
CARD_HBM_GB = 80.0
FIT_SHARE = 0.9  # the card's memory less 10% for temporaries (parallel/memory.DEFAULT_HEADROOM)


def flops_per_chip_per_step(m, n, K, S, T, layout):
    """Matmul FLOPs per card per TRAINING step (forward + ~2x backward).

    Per layer forward (B = I, cached-Ax recurrence, ops/reference.py):
      x-contraction u W1^T : 2 S m n / T   (W1 row-sharded, both layouts)
      A-matvec x1 A^T      : 2 S m n / T   (A column-sharded, both)
      z-update v W2^T      : 2 S m d / T   sharded_w2, else 2 S m d whole
    The backward about doubles each matmul (the gradients with respect to
    the input and to the weight)."""
    d = m
    x_side = 2 * S * m * n / T
    a_side = 2 * S * m * n / T
    z_side = 2 * S * m * d / (T if layout == "sharded_w2" else 1)
    return 3 * K * (x_side + a_side + z_side)


def analyze(name, m, n, K, S, data_axis, model_axis, layout, hosts=1, compute_dtype_bytes=None, hbm_gb=CARD_HBM_GB):
    """One row of the model. compute_dtype_bytes=2 models a bf16
    mixed-precision step: the activation collectives and the gradient
    all-reduce move bf16, and the bytes a card holds gain the persistent
    compute copy, while the fp32 masters and moments stay 4-byte (as
    fit_sharded's audit counts them)."""
    from dladmm_tpu_torch.parallel.memory import per_chip_bytes, step_traffic_bytes

    T, D = model_axis, data_axis
    cb = compute_dtype_bytes or 4
    bd = per_chip_bytes(m, n, K, S, D, T, layout, 4, compute_dtype_bytes)
    tr = step_traffic_bytes(m, n, K, S, D, T, layout, cb, hosts)
    fl = flops_per_chip_per_step(m, n, K, max(1, S // D), T, layout)
    t_compute = fl / (PEAK_BF16_FLOPS if cb == 2 else PEAK_FP32_FLOPS)
    t_nvlink = tr["tp_ici_bytes_per_step"] / (NVLINK_GBPS * 1e9)
    t_dp = tr["dp_grad_allreduce_bytes"] / ((INTER_HOST_GBPS if hosts > 1 else NVLINK_GBPS) * 1e9)
    t_total = t_compute + t_nvlink + t_dp  # no-overlap upper bound
    return {
        "config": name,
        "layout": layout,
        "mesh": f"{D}x{T}",
        "hosts": hosts,
        "per_chip_gb": round(bd.total / 1e9, 2),
        "fits_card": bd.total <= hbm_gb * 1e9 * FIT_SHARE,
        "per_chip_tflops_per_step": round(fl / 1e12, 3),
        "nvlink_mb_per_step": round(tr["tp_ici_bytes_per_step"] / 1e6, 1),
        "dp_allreduce_mb": round(tr["dp_grad_allreduce_bytes"] / 1e6, 1),
        "dp_crosses_hosts": tr["dp_crosses_dcn"],
        "model_step_ms": {
            "compute": round(t_compute * 1e3, 3),
            "tp_nvlink": round(t_nvlink * 1e3, 3),
            "dp_allreduce": round(t_dp * 1e3, 3),
        },
        # The bracket of the >= 80% linear-scaling target: no_overlap =
        # compute / (compute + all communication), every byte exposed;
        # perfect_overlap = compute / max(compute, communication). Real
        # runs land between; the claim holds where the upper end clears
        # 0.8 and the communication is shorter than the compute.
        "scaling_efficiency_no_overlap": round(t_compute / t_total, 3) if t_total else 1.0,
        "scaling_efficiency_perfect_overlap": round(t_compute / max(t_compute, t_nvlink + t_dp), 3)
        if t_total else 1.0,
    } | (_fused_dp_fields(K, t_compute, t_nvlink, t_dp) | _zero1_dp_fields(bd, D) if model_axis == 1 else {})


def _zero1_dp_fields(bd, D):
    """ZeRO-1 (sharding.zero1) on a DP mesh: the collective bytes stay
    (a ring all-reduce is a reduce-scatter and an all-gather, which is
    what the ZeRO-1 step issues), so t_dp stays; what shrinks by D is a
    card's optimizer work, Adam's ~7 params-sized streams (grads, params,
    mu, nu read; params, mu, nu written) and the moments it stores."""
    opt_stream = 7 * bd.params  # bytes a step, replicated optimizer
    return {
        "zero1_optimizer_hbm_mb_per_step": round(opt_stream / D / 1e6, 1),
        "zero1_optimizer_hbm_mb_replicated": round(opt_stream / 1e6, 1),
        "zero1_moments_gb_per_chip": round(bd.opt_moments / D / 1e9, 3),
        # int8 moments (int8_pallas) stack a further /4 on the moment
        # bytes; the ~2% of block scales is left out here.
        "zero1_int8_fused_moments_gb_per_chip": round(bd.opt_moments / D / 4 / 1e9, 4),
        "zero1_note": "collective bytes unchanged (ring allreduce = RS+AG); clip_norm becomes the exact "
                      "single-pass global clip",
    }


def _fused_dp_fields(K, t_compute, t_nvlink, t_dp):
    """optimizer='fused_adam' on a DP mesh: the port's DP fused step
    (parallel/collectives.make_dp_fused_adam_step) all-reduces each
    layer's five gradients inside the reverse sweep, K all-reduces of the
    same total bytes as the one bulk all-reduce. They are issued
    synchronously, in layer order, on the default stream: as written,
    each is exposed, so the step pays the bulk all-reduce's bytes plus
    K - 1 more collective setups (the no_overlap row). The sweep does
    not read layer k's reduced gradients again before layer k - 1's
    backward, so an asynchronous all-reduce of layer k could run under
    layer k - 1's backward; the "..._if_pipelined" fields model that best
    case (only the last layer's all-reduce exposed). The honest claim is
    the bracket [no_overlap, if_pipelined] until a multi-card
    measurement replaces it."""
    t_dp_layer = t_dp / K
    t_layer_bwd = (t_compute * 2 / 3) / K  # the backward is ~2/3 of a step's FLOPs
    exposed = t_dp_layer + (K - 1) * max(0.0, t_dp_layer - t_layer_bwd)
    denom = t_compute + t_nvlink + exposed
    return {
        "dp_fused_exposed_ms_if_pipelined": round(exposed * 1e3, 3),
        "scaling_efficiency_fused_if_pipelined": round(t_compute / denom, 3) if denom else 1.0,
        "fused_pipelining_note": "needs each layer's all-reduce issued asynchronously under the next "
                                 "layer's backward; as issued (synchronous, in layer order) = the no_overlap "
                                 "row + (K-1) collective latencies",
    }


def main(argv=None) -> int:
    from dladmm_tpu_torch.utils.config import PRESETS

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default=None)
    ap.add_argument("--hbm-gb", type=float, default=CARD_HBM_GB,
                    help="memory of one card in GB for fits_card (default: the H100's 80)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    rows = []
    for name, cfg in PRESETS.items():
        if args.config and name != args.config:
            continue
        s = cfg.sharding
        if s.data_axis * s.model_axis == 1 and not s.multihost:
            continue
        p, t = cfg.problem, cfg.train
        hosts = 2 if s.multihost else 1
        cb = 2 if t.compute_dtype == "bfloat16" else None
        for layout in ("sharded_w2", "replicated_w2"):
            rows.append(analyze(name, p.m, p.n, p.K, t.batch, s.data_axis, s.model_axis, layout, hosts,
                                compute_dtype_bytes=cb, hbm_gb=args.hbm_gb))
    out = json.dumps(rows, indent=2)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
