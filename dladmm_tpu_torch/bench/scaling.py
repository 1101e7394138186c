"""Data-parallel scaling sweep of the training step.

``python -m dladmm_tpu_torch.bench.scaling [--virtual] [--out results.json]``

The port of ``dladmm_tpu/bench/scaling.py``: training layer-iterations
a second at growing data-parallel degree (weak scaling: the batch grows
with the ranks). Each mesh runs as one process a rank, started by
parallel/multihost.spawn_ranks (env://); each rank builds
parallel/mesh.make_mesh(data=dp, model=tp) and times the DP step
(parallel/collectives.make_dp_train_step, tp = 1) or the tensor-parallel
step (make_sharded_train_step) with bench/timing.time_chained; rank 0
writes the row. Ranks with a card each use NCCL; ranks that share a card
use gloo (parallel/mesh.pick_backend), and so do ``--virtual`` ranks,
gloo processes on the CPU. The measured fields of ranks that share a
card or run on the CPU are kept apart under ``harness_validation_only``:
they validate the harness and the collective structure, and are no
scaling result. The analytic bracket (bench/comm_model) stays top-level.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _rank_main(spec: dict) -> int:
    """One rank of a mesh: time the step, rank 0 writes the result."""
    import torch
    import torch.distributed as dist

    from dladmm_tpu_torch.bench.timing import time_chained
    from dladmm_tpu_torch.data.synthetic import SyntheticBatch, make_batch, make_dictionary
    from dladmm_tpu_torch.parallel.mesh import make_mesh, model_slice
    from dladmm_tpu_torch.parallel.multihost import initialize_distributed, rank_batch
    from dladmm_tpu_torch.train.loop import adam, make_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = initialize_distributed()
    dp, tp, m, n, K = spec["dp"], spec["tp"], spec["m"], spec["n"], spec["K"]
    mesh = make_mesh(data=dp, model=tp)
    S = spec["per_device_batch"] * dp
    gen = torch.Generator().manual_seed(0)
    A = make_dictionary(gen, m, n)
    data = make_batch(gen, A, S)
    rows = slice(mesh.data_index * (S // dp), (mesh.data_index + 1) * (S // dp))
    A = A.to(dev)
    opt = adam(1e-3)
    if tp == 1:
        from dladmm_tpu_torch.models.api import select_forward
        from dladmm_tpu_torch.models.unroll import init_dladmm_params
        from dladmm_tpu_torch.parallel.collectives import make_dp_train_step

        fwd = select_forward(m, n, m, S // dp, device=dev)[0]
        step = make_dp_train_step(opt, mesh, forward_fn=fwd)
        A_s = A
        batch = SyntheticBatch(*(v[rows].to(dev) for v in data))
        state = make_train_state(init_dladmm_params(A, K=K), opt)
    else:
        from dladmm_tpu_torch.parallel.collectives import init_params_tp, make_sharded_train_step

        step = make_sharded_train_step(opt, mesh)
        A_s = model_slice(A, mesh).contiguous()
        batch = rank_batch(mesh, data.x_star[rows], data.e_star[rows], A_s)
        state = make_train_state(init_params_tp(A, K, mesh), opt)
    cuda_nccl = dist.get_backend() == "nccl"

    def agree(secs: float) -> float:
        t = torch.tensor([secs], dtype=torch.float64, device=dev if cuda_nccl else "cpu")
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t)

    dt = time_chained(lambda s: step(s, A_s, batch)[0], state, iters=spec["iters"], agree=agree)
    if mesh.rank == 0:
        from dladmm_tpu_torch.bench.profile_step import wrapper_launches

        out = {"step_s": dt, "backend": dist.get_backend(), "device": str(dev), "launches": wrapper_launches(),
               "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
        Path(spec["out"]).write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def measure_dp_scaling(mesh_shapes, m=250, n=500, K=15, per_device_batch=64, iters=10, virtual=False,
                       timeout=600.0):
    """Weak-scaling sweep over ``mesh_shapes`` ((dp, tp) pairs): the batch
    grows with the DP degree. Returns a list of {devices, mesh,
    global_batch, model_efficiency_bracket, step_ms, layer_iter_per_s,
    efficiency_vs_linear, backend, device_kind, launches_rank0} (the
    kernel launches rank 0 made, by wrapper).

    Each mesh is dp * tp ranks spawned with a deadline of ``timeout``
    seconds; ``virtual`` runs them as gloo processes on the CPU. Measured
    fields of ranks on the CPU or sharing a card are kept under
    ``harness_validation_only`` with a note saying why."""
    from dladmm_tpu_torch.bench.comm_model import analyze
    from dladmm_tpu_torch.parallel.multihost import spawn_ranks

    env = {"PYTHONPATH": str(ROOT)} | ({"DLADMM_PLATFORM": "cpu"} if virtual else {})
    results = []
    base_rate = None
    with tempfile.TemporaryDirectory() as tmp:
        for dp, tp in mesh_shapes:
            out = Path(tmp) / f"mesh_{dp}x{tp}.json"
            spec = dict(dp=dp, tp=tp, m=m, n=n, K=K, per_device_batch=per_device_batch, iters=iters, out=str(out))
            spawn_ranks([sys.executable, "-m", "dladmm_tpu_torch.bench.scaling", "--worker", json.dumps(spec)],
                        dp * tp, timeout=timeout, env=env, cwd=str(ROOT))
            rank0 = json.loads(out.read_text())
            S = per_device_batch * dp
            dt = rank0["step_s"]
            rate = K * S / dt
            if base_rate is None:
                base_rate = rate / dp  # a device's rate at the first mesh
            model = analyze("sweep", m, n, K, S, dp, tp, "sharded_w2")
            measured = {
                "step_ms": dt * 1e3,
                "layer_iter_per_s": rate,
                "efficiency_vs_linear": rate / (base_rate * dp),
            }
            row = {
                "devices": dp * tp,
                "mesh": f"{dp}x{tp}",
                "global_batch": S,
                "backend": rank0["backend"],
                "device_kind": rank0["device_kind"],
                "launches_rank0": {k: v for k, v in rank0["launches"].items() if v},
                "model_efficiency_bracket": [
                    model["scaling_efficiency_no_overlap"],
                    model["scaling_efficiency_perfect_overlap"],
                ],
            }
            if virtual or rank0["device_kind"] == "cpu":
                row["harness_validation_only"] = {
                    **measured,
                    "note": "gloo ranks on the CPU: wall times reflect host core contention, not collectives "
                            "or NVLink; no scaling claim is made or implied by these numbers",
                }
            elif rank0["backend"] == "gloo":
                row["harness_validation_only"] = {
                    **measured,
                    "note": "the ranks share one card (their kernels run in turn) and gloo stages every "
                            "collective through the host: overhead, not scaling",
                }
            else:
                row.update(measured)
            results.append(row)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--virtual", action="store_true", help="8 gloo ranks on the CPU (harness validation)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--per-device-batch", type=int, default=64)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)  # one rank: its JSON spec
    args = ap.parse_args(argv)
    if args.worker is not None:
        return _rank_main(json.loads(args.worker))

    if args.virtual:
        ndev = 8
    else:
        import torch

        from dladmm_tpu_torch.utils.platform import resolve_device

        ndev = torch.cuda.device_count() if resolve_device().type == "cuda" else 1
    shapes = [(d, 1) for d in (1, 2, 4, 8) if d <= ndev]
    if ndev >= 8:
        shapes.append((4, 2))
    results = measure_dp_scaling(shapes, per_device_batch=args.per_device_batch, virtual=args.virtual)
    payload = {
        "device_kind": results[0]["device_kind"],
        "virtual": bool(args.virtual),
        "weak_scaling": results,
    }
    out = json.dumps(payload, indent=2)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
