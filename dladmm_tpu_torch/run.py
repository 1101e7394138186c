"""Training CLI: ``python -m dladmm_tpu_torch.run --config=synthetic_small``.

The port of ``dladmm_tpu/run.py`` for single-device training: trains the
configured D-LADMM net and prints the NMSE-vs-layer table against the
classical LADMM baseline, then one summary JSON line. Runs on CUDA
unless ``DLADMM_PLATFORM=cpu``. The JAX CLI's flags are all accepted
and routed as it routes them: ``--greedy`` (train/loop.fit_greedy),
``--optimizer=fused_adam`` (train/fused_adam.py), and the sharded
presets, data-parallel (general_b_dp, multihost; ``--zero1``,
``--hbm-gb``) and tensor-parallel (tp_small, tp_large, tp_large_bf16),
through train/loop.fit_sharded, one process a rank (D * T of them; a
sharded preset started in one process is refused with this line):

    python -m torch.distributed.run --standalone --nproc_per_node=8 \
        -m dladmm_tpu_torch.run --config=tp_small

Ranks that share one card talk over gloo (parallel/mesh.pick_backend).
``--plot`` writes the NMSE-vs-layer figure (utils/plots.py; needs
matplotlib).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

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

    from dladmm_tpu_torch.models.api import select_forward
    from dladmm_tpu_torch.ops.prox import resolve_prox
    from dladmm_tpu_torch.utils.logging import JsonlLogger

    p, s = cfg.problem, cfg.sharding
    sharded = s.data_axis * s.model_axis > 1
    if args.import_torch and (sharded or args.greedy):
        ap.error("--import-torch warm-starts the single-device fit only; use "
                 "utils.torch_compat.from_torch + fit_sharded's checkpoint path for sharded configs")
    if args.zero1:
        if s.data_axis <= 1 or s.model_axis > 1:
            ap.error("--zero1 applies to DP-only sharded configs (data_axis > 1, model_axis == 1); "
                     f"config {cfg.name!r} is {s.data_axis}x{s.model_axis}")
        cfg = dataclasses.replace(cfg, sharding=dataclasses.replace(s, zero1=True))
        s = cfg.sharding
    logger = JsonlLogger(args.log_jsonl)

    if sharded:
        if args.greedy:
            ap.error("--greedy is single-device only (layer-wise stages have no sharded "
                     f"implementation); unset it for config {cfg.name!r}")
        if args.export_torch:
            ap.error("--export-torch is single-device only; checkpoint the sharded run "
                     "(--ckpt-dir) and export from the restored params instead")
        from dladmm_tpu_torch.parallel.multihost import initialize_distributed, process_index, world_size
        from dladmm_tpu_torch.train.loop import LAUNCH, check_sharded, fit_sharded

        try:  # the config's refusals come before the launch line
            check_sharded(cfg)
        except ValueError as e:
            ap.error(str(e))
        ranks = s.data_axis * s.model_axis
        initialize_distributed()
        if world_size() != ranks:
            ap.error(f"config {cfg.name!r} is sharded over a {s.data_axis}x{s.model_axis} mesh, {ranks} "
                     f"ranks, and this run has {world_size()}; launch one process a rank: "
                     + LAUNCH.format(D=ranks, name=cfg.name))
        desc = ("data-parallel fit_sharded" if s.model_axis == 1
                else f"tensor-parallel fit_sharded ({s.layout})")
        t0 = time.monotonic()
        _, history = fit_sharded(cfg, log_fn=logger, ckpt_dir=args.ckpt_dir, resume=args.resume,
                                 hbm_bytes=args.hbm_gb and args.hbm_gb * 1e9)
        if process_index() == 0:
            _report(args, cfg, history[-1], desc, time.monotonic() - t0, history[-1]["mesh"])
        return 0

    from dladmm_tpu_torch.utils.platform import resolve_device

    device = resolve_device()
    t = cfg.train
    if args.greedy:
        if args.ckpt_dir or args.resume:
            ap.error("--greedy does not support --ckpt-dir/--resume")
        if not p.identity_B:
            ap.error(f"--greedy supports the identity-B benchmarks only; train config {cfg.name!r} without it")
        if t.optimizer == "fused_adam":
            ap.error("--greedy has no fused-optimizer implementation (stage losses run the "
                     "optimizer chain); drop --optimizer=fused_adam")
        from dladmm_tpu_torch.train.loop import fit_greedy

        desc = "greedy (per-stage auto-selection)"
        print(f"kernel path: {desc}", flush=True)
        t0 = time.monotonic()
        params, history = fit_greedy(cfg, log_fn=logger, device=device)
        _report(args, cfg, history[-1], desc, time.monotonic() - t0, device=device)
        _export(args, params)
        return 0

    init_params = None
    if args.import_torch:
        from dladmm_tpu_torch.utils.torch_compat import from_torch

        init_params = from_torch(args.import_torch, allow_pickle=args.allow_pickle, device=device)
        print(f"imported torch checkpoint {args.import_torch} (K={init_params.K})", flush=True)

    fused = t.optimizer == "fused_adam"
    if fused and resolve_prox(p) is None:
        from dladmm_tpu_torch.train.loop import check_fused_adam

        try:  # identity B: the plain forward loop owns the step, so --kernel must stay auto
            check_fused_adam(t, nonneg_x=p.nonneg_x, check_kernel=p.identity_B)
        except ValueError as e:
            ap.error(str(e))
    if resolve_prox(p) is not None:
        # General proxes: fit() builds the prox layer step and trains
        # through autograd; the kernels and the manual backward are l1.
        if t.kernel not in ("auto", "reference"):
            ap.error(f"--kernel={t.kernel} covers the l1/l1 instantiation only; "
                     "general-prox configs run the plain loop")
        if fused:
            ap.error("--optimizer=fused_adam hand-writes the l1 backward; "
                     "general-prox configs use the optimizer chain")
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
        if fused:
            desc += " + fused Adam-in-backward"
    elif fused:
        # The fused optimizer owns the whole step: the plain forward loop
        # and the reverse sweep with Adam in it.
        forward_fn, desc = None, "manual reverse sweep + fused Adam-in-backward"
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

    from dladmm_tpu_torch.train.loop import fit

    t0 = time.monotonic()
    params, history = fit(
        cfg, log_fn=logger, forward_fn=forward_fn,
        ckpt_dir=args.ckpt_dir, resume=args.resume, init_params=init_params, device=device,
    )
    _report(args, cfg, history[-1], desc, time.monotonic() - t0, device=device)
    _export(args, params)
    return 0


def _report(args, cfg, last, desc, wall, mesh=None, device=None) -> None:
    """The CLI's tail: the optional plot, the NMSE-vs-layer table against
    classical LADMM, and one summary JSON line."""
    curves = last["curves"]
    if args.plot:
        from dladmm_tpu_torch.utils.plots import save_nmse_curve_plot

        title = f"{cfg.name}: NMSE vs layer (K={cfg.problem.K}" + (f", mesh {mesh})" if mesh else ")")
        save_nmse_curve_plot(args.plot, [float(v) for v in curves["nmse_curve_db"]],
                             [float(v) for v in curves["ladmm_curve_db"]], title=title)
        print(f"plot saved: {args.plot}")
    print(f"\nconfig={cfg.name}  steps={cfg.train.steps}" + (f"  mesh={mesh}" if mesh else ""))
    print(f"{'layer':>5} {'D-LADMM NMSE(dB)':>18} {'LADMM NMSE(dB)':>16}")
    for k, (a, b) in enumerate(zip(curves["nmse_curve_db"], curves["ladmm_curve_db"]), 1):
        print(f"{k:>5} {a:>18.2f} {b:>16.2f}")
    payload = {
        "final_nmse_db": last["nmse_db"],
        "final_residual": last["residual"],
        "ladmm_nmse_db_at_K": curves["ladmm_curve_db"][-1],
        "route": desc,
        "device": str(device) if device is not None else None,
        "fit_wall_s": wall,  # host clock around the fit: training, evals, checkpoints
    }
    if mesh:
        payload["mesh"] = mesh
        payload.pop("device")
    print(json.dumps(payload), flush=True)


def _export(args, params) -> None:
    if args.export_torch:
        from dladmm_tpu_torch.utils.torch_compat import save_torch

        save_torch(params, args.export_torch)
        print(f"torch export saved: {args.export_torch}")


if __name__ == "__main__":
    sys.exit(main())
