"""Distributed tour: data-parallel and tensor-parallel training
(fit_sharded) on 8 ranks, then data-parallel sharded serving.

    python -m dladmm_tpu_torch.examples.distributed

The port of ``examples/distributed.py``. Started alone, it starts its
own 8 ranks (one process each, parallel/multihost.spawn_ranks: gloo
processes on the CPU with ``DLADMM_PLATFORM=cpu``, or ranks sharing the
card, which gloo also serves; with 8 cards each rank takes one, on
NCCL), prints rank 0's output, then serves from this process. Under
``python -m torch.distributed.run --nproc_per_node=8`` it runs as one
of the ranks (and serves nothing).
"""

import dataclasses
import os
import sys
import tempfile

import torch

from dladmm_tpu_torch.utils.config import Config, ProblemConfig, ShardingConfig, TrainConfig

RANKS = 8
DP_CFG = Config(
    name="dp_demo",
    problem=ProblemConfig(m=64, n=128, K=6),
    train=TrainConfig(batch=64, steps=120, lr=1e-3, eval_every=60),
    sharding=ShardingConfig(data_axis=8),
)


def rank_main(out_dir=None) -> None:
    """One rank: DP(8), then TP(4x2) on the same problem; rank 0 prints
    both and saves the DP params to ``out_dir``."""
    from dladmm_tpu_torch.parallel.multihost import initialize_distributed, process_index
    from dladmm_tpu_torch.train.loop import fit_sharded

    initialize_distributed()
    rank0 = process_index() == 0

    # 1) Data-parallel training: each rank runs the single-device stack
    #    (the trajectory kernel on the card) on its rows; the gradients
    #    and the loss are all-reduced over the data group.
    params, history = fit_sharded(DP_CFG)
    if rank0:
        print(f"DP(8): step {history[-1]['step']}, NMSE {history[-1]['nmse_db']:.2f} dB", flush=True)
        if out_dir:
            torch.save([p.cpu() for p in params], os.path.join(out_dir, "dp_params.pt"))

    # 2) Tensor-parallel training on a 4x2 (data x model) mesh: W1, W2,
    #    theta and their Adam moments are sharded over the model group
    #    (the sharded_w2 layout); a startup audit refuses layouts that
    #    exceed a rank's share of the card.
    tp_cfg = dataclasses.replace(DP_CFG, name="tp_demo", sharding=ShardingConfig(data_axis=4, model_axis=2))
    _, history_tp = fit_sharded(tp_cfg)
    if rank0:
        print(f"TP(4x2): step {history_tp[-1]['step']}, NMSE {history_tp[-1]['nmse_db']:.2f} dB "
              "(same problem instance as DP at the same seed)", flush=True)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def main(device=None) -> None:
    from dladmm_tpu_torch.data.synthetic import make_batch, problem_matrices
    from dladmm_tpu_torch.metrics.core import nmse_db
    from dladmm_tpu_torch.models.unroll import DLADMMParams
    from dladmm_tpu_torch.parallel.mesh import make_mesh
    from dladmm_tpu_torch.parallel.multihost import spawn_ranks
    from dladmm_tpu_torch.serve import ShardedInferenceServer
    from dladmm_tpu_torch.utils.platform import resolve_device

    device = resolve_device(device)
    with tempfile.TemporaryDirectory() as out_dir:
        logs = spawn_ranks([sys.executable, "-m", "dladmm_tpu_torch.examples.distributed", "--rank", out_dir],
                           RANKS, timeout=1200, env={"DLADMM_PLATFORM": device.type})
        print(logs[0], end="", flush=True)
        params = DLADMMParams(*torch.load(os.path.join(out_dir, "dp_params.pt")))

    # 3) Data-parallel sharded serving: rows split over 8 parts, no
    #    collective in the forward. On one card the 8 parts share it.
    A, _ = problem_matrices(DP_CFG, device=device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    devices = [torch.device("cuda", i % cards) for i in range(RANKS)] if cards else [device] * RANKS
    server = ShardedInferenceServer(params.to(device), A, make_mesh(data=RANKS, devices=devices), max_batch=256,
                                    dtype=torch.bfloat16)
    data = make_batch(torch.Generator().manual_seed(7), A, 200)
    x, _ = server.solve(data.b)
    print(f"sharded serving: 200 solves over {RANKS} shards (bf16), "
          f"NMSE {float(nmse_db(x.float(), data.x_star)):.2f} dB")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2])
    elif "WORLD_SIZE" in os.environ:  # a rank of python -m torch.distributed.run
        rank_main()
    else:
        main()
