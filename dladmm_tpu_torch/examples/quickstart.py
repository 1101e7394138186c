"""End-to-end tour of the port's user surface in one script: generate
data -> train -> evaluate against classical LADMM -> checkpoint ->
resume -> serve.

    python -m dladmm_tpu_torch.examples.quickstart

The port of ``examples/quickstart.py``. Runs on the card (the kernels of
the training and serving paths); ``DLADMM_PLATFORM=cpu`` runs it on the
CPU through their plain versions, in about a minute at these toy shapes.
"""

import tempfile

import torch

from dladmm_tpu_torch.data.synthetic import make_batch, make_dictionary
from dladmm_tpu_torch.metrics.core import nmse_db
from dladmm_tpu_torch.serve import InferenceServer
from dladmm_tpu_torch.train.loop import fit
from dladmm_tpu_torch.utils.config import Config, ProblemConfig, TrainConfig
from dladmm_tpu_torch.utils.platform import resolve_device


def main(device=None):
    device = resolve_device(device)
    cfg = Config(
        name="quickstart",
        problem=ProblemConfig(m=64, n=128, K=8),
        train=TrainConfig(
            batch=32,
            steps=300,
            lr=1e-3,
            lr_schedule="cosine",
            clip_norm=1.0,
            eval_every=100,
            eval_batch=128,
            layer_loss="uniform",  # deep supervision (measured best)
        ),
    )

    # 1) Train (checkpointing at every eval). The dictionary A is data,
    #    not a parameter: build it and pass it in (fit would otherwise
    #    draw one from the config's seed).
    A = make_dictionary(torch.Generator().manual_seed(42), 64, 128)
    ckpt = tempfile.mkdtemp(prefix="dladmm_quickstart_")
    params, history = fit(cfg, A=A, ckpt_dir=ckpt, device=device)
    last = history[-1]
    print(f"trained on {device}: NMSE {last['nmse_db']:.2f} dB, residual {last['residual']:.3f}")

    # 2) The paper's signature comparison: NMSE by layer against
    #    classical LADMM at the same iteration count (the untrained
    #    LADMM-init net is classical LADMM).
    curves = last["curves"]
    print(f"{'layer':>5} {'D-LADMM':>9} {'LADMM':>9}")
    for k, (a, b) in enumerate(zip(curves["nmse_curve_db"], curves["ladmm_curve_db"]), 1):
        print(f"{k:>5} {float(a):>9.2f} {float(b):>9.2f}")

    # 3) Resume is bit for bit (each step's batch comes from its own
    #    generator).
    params2, _ = fit(cfg, A=A, ckpt_dir=ckpt, resume=True, device=device)
    if not all(torch.equal(a, b) for a, b in zip(params, params2)):
        raise AssertionError("resume mismatch")
    print("checkpoint/resume: bit-exact")

    # 4) Serve: bucketed inference, every bucket warmed at construction;
    #    layers=k is the early-exit latency knob (the table above says
    #    what each layer buys).
    A = A.to(device)
    req = make_batch(torch.Generator().manual_seed(123), A, 10)
    server = InferenceServer(params, A, max_batch=64, device=device)
    x, _ = server.solve(req.b)
    fast = InferenceServer(params, A, max_batch=64, layers=4, device=device)
    x4, _ = fast.solve(req.b)
    print(
        f"served {x.shape[0]} solves: NMSE full-K {float(nmse_db(x, req.x_star)):.2f} dB, "
        f"early-exit k=4 {float(nmse_db(x4, req.x_star)):.2f} dB"
    )


if __name__ == "__main__":
    main()
