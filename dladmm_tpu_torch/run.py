"""Training CLI: ``python -m dladmm_tpu_torch.run --config=synthetic_small``.

The port of ``dladmm_tpu/run.py`` for single-device training: trains the
configured D-LADMM net and prints the NMSE-vs-layer table against the
classical LADMM baseline, then one summary JSON line. Runs on CUDA
unless ``DLADMM_PLATFORM=cpu``. The JAX CLI's flags are all accepted;
the ones whose path is not ported yet (greedy, sharded configs, ZeRO-1,
fused_adam, the HBM audit) end in an argparse error naming ROADMAP.md.
``--plot`` writes the NMSE-vs-layer figure (utils/plots.py; needs
matplotlib). A config with ``compute_dtype="bfloat16"`` trains in
bf16 (train/loop.fit); the two presets that ship it are sharded, which
the sharding check stops.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

_LATER = "is not ported yet (a later slice of the port, ROADMAP.md §1)"
_MOMENT_DTYPES = [
    "float32", "bfloat16", "bfloat16_sr", "int8", "float32_pallas",
    "bfloat16_pallas", "bfloat16_sr_pallas", "bfloat16_sr_mu_pallas", "int8_pallas",
]
_PROXES = ["l1", "nonneg_l1", "elastic_net", "box", "group_l2"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="synthetic_small")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--kernel", choices=["auto", "megakernel", "pallas", "reference"], default=None)
    ap.add_argument("--layer-loss", choices=["uniform", "linear", "none"], default=None,
                    help="deep supervision weights; none = final-layer loss only")
    ap.add_argument("--clip-mode", choices=["global", "delayed"], default=None)
    ap.add_argument("--vjp", choices=["auto", "manual", "xla"], default=None,
                    help="backward through the unroll: the manual reverse sweep "
                    "(ops/unroll_vjp.py) or, with xla, autograd through the plain loop")
    ap.add_argument("--optimizer", choices=["adam", "fused_adam"], default=None)
    ap.add_argument("--moment-dtype", choices=_MOMENT_DTYPES, default=None,
                    help="Adam moment storage: float32, the XLA-side int8 / bfloat16 / "
                    "bfloat16_sr (train/qmoments.py), or a *_pallas format (the fused "
                    "int8 and dense sweeps, train/qadam_cuda.py)")
    ap.add_argument("--prox-x", choices=_PROXES, default=None)
    ap.add_argument("--prox-z", choices=_PROXES, default=None)
    ap.add_argument("--prox-rho", type=float, default=None)
    ap.add_argument("--nonneg-x", action="store_true")
    ap.add_argument("--log-jsonl", default=None, help="append per-eval scalar records here")
    ap.add_argument("--plot", default=None, metavar="PNG",
                    help="write the NMSE-vs-layer figure of the last eval here")
    ap.add_argument("--ckpt-dir", default=None, help="checkpoint directory")
    ap.add_argument("--hbm-gb", type=float, default=None)
    ap.add_argument("--resume", action="store_true", help="resume from latest checkpoint")
    ap.add_argument("--accum-steps", type=int, default=None)
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--eval-only", action="store_true",
                    help="restore the latest --ckpt-dir checkpoint and report only")
    ap.add_argument("--import-torch", default=None, metavar="CKPT",
                    help="warm-start from a reference-style PyTorch checkpoint")
    ap.add_argument("--allow-pickle", action="store_true")
    ap.add_argument("--export-torch", default=None, metavar="CKPT",
                    help="after training, torch.save the net in the reference's layout")
    ap.add_argument("--greedy", action="store_true")
    return ap


def _reject_unported(ap, args, cfg) -> None:
    t, s = cfg.train, cfg.sharding
    if args.greedy:
        ap.error(f"--greedy (fit_greedy) {_LATER}")
    if args.zero1:
        ap.error(f"--zero1 {_LATER}")
    if args.hbm_gb is not None:
        ap.error(f"--hbm-gb (the sharded memory audit) {_LATER}")
    if s.data_axis * s.model_axis > 1:
        ap.error(f"config {cfg.name!r} is sharded; fit_sharded {_LATER}")
    if t.optimizer == "fused_adam":
        ap.error(f"--optimizer=fused_adam {_LATER}")


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.eval_only:
        if not args.ckpt_dir:
            ap.error("--eval-only needs --ckpt-dir (a trained checkpoint)")
        if args.steps:
            ap.error("--eval-only contradicts --steps (it trains nothing)")
        args.steps, args.resume = 0, True

    from dladmm_tpu_torch.utils.config import get_config

    cfg = get_config(args.config)
    overrides = {
        f: getattr(args, f)
        for f in ("steps", "batch", "lr", "seed", "kernel", "vjp", "clip_mode",
                  "optimizer", "moment_dtype", "accum_steps")
        if getattr(args, f) is not None
    }
    if args.layer_loss is not None:
        overrides["layer_loss"] = None if args.layer_loss == "none" else args.layer_loss
    if overrides:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **overrides))
    prob = {f: getattr(args, f) for f in ("prox_x", "prox_z", "prox_rho") if getattr(args, f) is not None}
    if args.nonneg_x:
        prob["nonneg_x"] = True
    if prob:
        cfg = dataclasses.replace(cfg, problem=dataclasses.replace(cfg.problem, **prob))
    if "elastic_net" in (cfg.problem.prox_x, cfg.problem.prox_z) and cfg.problem.prox_rho == 0.0:
        ap.error("prox=elastic_net needs --prox-rho > 0 (rho=0 reduces to l1; "
                 "pass --prox-x=l1 if that is what you want)")
    _reject_unported(ap, args, cfg)

    from dladmm_tpu_torch.models.api import select_forward
    from dladmm_tpu_torch.ops.prox import resolve_prox
    from dladmm_tpu_torch.train.loop import fit
    from dladmm_tpu_torch.utils.logging import JsonlLogger
    from dladmm_tpu_torch.utils.platform import resolve_device

    device = resolve_device()
    p, t = cfg.problem, cfg.train
    init_params = None
    if args.import_torch:
        from dladmm_tpu_torch.utils.torch_compat import from_torch

        init_params = from_torch(args.import_torch, allow_pickle=args.allow_pickle, device=device)
        print(f"imported torch checkpoint {args.import_torch} (K={init_params.K})", flush=True)

    if resolve_prox(p) is not None:
        # General proxes: fit() builds the prox layer step and trains
        # through autograd; the kernels and the manual backward are l1.
        if t.kernel not in ("auto", "reference"):
            ap.error(f"--kernel={t.kernel} covers the l1/l1 instantiation only; "
                     "general-prox configs run the plain loop")
        if t.vjp != "auto":
            ap.error("general-prox configs route through autograd automatically; drop --vjp")
        forward_fn = None
        desc = f"plain-loop + autograd (prox {p.prox_x}/{p.prox_z}" + (
            ", general B)" if not p.identity_B else ")")
    elif not p.identity_B:
        if t.kernel not in ("auto", "reference"):
            ap.error(f"--kernel={t.kernel} requires identity B; the general-B "
                     f"config {cfg.name!r} runs the plain loop + manual backward")
        forward_fn, desc = None, "plain-loop + manual general-B reverse sweep"
    elif t.vjp == "manual":
        forward_fn, desc = None, "manual-vjp-reverse-sweep"
    elif t.vjp == "xla":
        forward_fn, desc = None, "plain-loop-autograd"
    else:
        forward_fn, _, desc = select_forward(
            p.m, p.n, p.m, t.batch // t.accum_steps, kernel=t.kernel,
            need_trajectory=t.layer_loss is not None, device=device, dtype=t.compute_dtype,
        )
    print(f"kernel path: {desc}", flush=True)

    t0 = time.monotonic()
    params, history = fit(
        cfg, log_fn=JsonlLogger(args.log_jsonl), forward_fn=forward_fn,
        ckpt_dir=args.ckpt_dir, resume=args.resume, init_params=init_params, device=device,
    )
    wall = time.monotonic() - t0
    last = history[-1]
    curves = last["curves"]
    if args.plot:
        from dladmm_tpu_torch.utils.plots import save_nmse_curve_plot

        save_nmse_curve_plot(args.plot, [float(v) for v in curves["nmse_curve_db"]],
                             [float(v) for v in curves["ladmm_curve_db"]],
                             title=f"{cfg.name}: NMSE vs layer (K={p.K})")
        print(f"plot saved: {args.plot}")
    print(f"\nconfig={cfg.name}  steps={t.steps}")
    print(f"{'layer':>5} {'D-LADMM NMSE(dB)':>18} {'LADMM NMSE(dB)':>16}")
    for k, (a, b) in enumerate(zip(curves["nmse_curve_db"], curves["ladmm_curve_db"]), 1):
        print(f"{k:>5} {a:>18.2f} {b:>16.2f}")
    print(json.dumps({
        "final_nmse_db": last["nmse_db"],
        "final_residual": last["residual"],
        "ladmm_nmse_db_at_K": curves["ladmm_curve_db"][-1],
        "route": desc,
        "device": str(device),
        "fit_wall_s": wall,  # host clock around fit: training, evals, checkpoints
    }), flush=True)
    if args.export_torch:
        from dladmm_tpu_torch.utils.torch_compat import save_torch

        save_torch(params, args.export_torch)
        print(f"torch export saved: {args.export_torch}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
