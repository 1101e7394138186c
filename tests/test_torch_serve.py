"""The serving slice as a whole: the port's InferenceServer,
BatchingServer and serve CLI (device="cpu" / DLADMM_PLATFORM=cpu, so the
kernel's plain version runs) against the JAX package's servers, whose
whole-unroll Pallas kernel runs in interpret mode.

The two CLIs are not compared directly: at one seed their dictionaries
differ (torch.Generator vs jax.random; ROADMAP.md §3). The CLI test
serves a JAX-written checkpoint with the port, then solves the same
requests with the JAX server on the dictionary the port derived.
Tolerances are rtol 1e-5 / atol 1e-6 unless a test states otherwise."""

import json
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dladmm_tpu.models.unroll import DLADMMParams as JParams
from dladmm_tpu.models.unroll import init_dladmm_params as j_init
from dladmm_tpu.serve import InferenceServer as JServer
from dladmm_tpu.utils.torch_compat import from_torch as j_from_torch
from dladmm_tpu.utils.torch_compat import save_torch as j_save_torch
from dladmm_tpu_torch import serve as tserve
from dladmm_tpu_torch.models.api import select_forward
from dladmm_tpu_torch.models.unroll import dladmm_forward
from dladmm_tpu_torch.ops import prox as tprox
from dladmm_tpu_torch.ops.reference import make_cached_step
from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL, **kw)


def _problem(m=16, n=32, K=4, seed=0, A=None):
    """A (numpy) and perturbed LADMM-exact params as numpy leaves."""
    rng = np.random.default_rng(seed)
    if A is None:
        A = rng.normal(size=(m, n)).astype(np.float32)
        A /= np.linalg.norm(A, axis=0, keepdims=True)
    p0 = j_init(jnp.asarray(A), K=K)
    leaves = [
        np.asarray(leaf) + 0.05 * rng.normal(size=leaf.shape).astype(np.float32)
        for leaf in p0
    ]
    return A, leaves


def _requests(rows, m, seed):
    return np.random.default_rng(seed).normal(size=(rows, m)).astype(np.float32)


@pytest.fixture(scope="module")
def served():
    A, leaves = _problem()
    buckets = (1, 4, 16)
    port = tserve.InferenceServer(
        params_from_numpy(*leaves), torch.as_tensor(A), buckets=buckets, device="cpu"
    )
    jax_server = JServer(JParams(*map(jnp.asarray, leaves)), jnp.asarray(A), buckets=buckets)
    return A, leaves, port, jax_server


@pytest.mark.parametrize("rows", [1, 5, 16])
def test_inference_server_matches_jax(served, rows):
    A, _, port, jax_server = served
    assert set(port.routes.values()) == {"whole-unroll-plain-cpu"}
    b = _requests(rows, A.shape[0], seed=rows)
    x, z = port.solve(torch.as_tensor(b))
    xj, zj = jax_server.solve(jnp.asarray(b))
    assert x.shape == (rows, A.shape[1]) and z.shape == (rows, A.shape[0])
    _close(x, xj)
    _close(z, zj)
    # numpy requests are served the same
    xn, _ = port.solve(b)
    torch.testing.assert_close(xn, x, rtol=0, atol=0)


def test_early_exit_layers_matches_jax(served):
    A, leaves, _, _ = served
    k = 2
    port = tserve.InferenceServer(
        params_from_numpy(*leaves), torch.as_tensor(A), buckets=(8,), layers=k, device="cpu"
    )
    jax_server = JServer(
        JParams(*map(jnp.asarray, leaves)), jnp.asarray(A), buckets=(8,), layers=k
    )
    b = _requests(6, A.shape[0], seed=7)
    for g, w in zip(port.solve(b), jax_server.solve(jnp.asarray(b))):
        _close(g, w)
    with pytest.raises(ValueError, match="layers must be"):
        tserve.InferenceServer(params_from_numpy(*leaves), torch.as_tensor(A),
                               buckets=(8,), layers=0, device="cpu")


def test_server_validation(served):
    A, _, port, _ = served
    with pytest.raises(ValueError, match="exceeds max bucket"):
        port.solve(_requests(17, A.shape[0], 0))
    with pytest.raises(ValueError, match="expected"):
        port.solve(np.zeros((3, A.shape[0] + 1), np.float32))
    assert tserve._buckets(256) == (1, 2, 4, 8, 16, 32, 64, 128, 256)
    assert tserve._buckets(10) == (1, 2, 4, 8, 10)


def test_batching_server_matches_per_request(served):
    """Concurrent submits from 8 client threads, batched by the worker,
    equal per-request solves."""
    A, _, port, _ = served
    reqs = [_requests(s, A.shape[0], seed=s) for s in (1, 2, 3, 1, 4, 2, 1, 2)]
    front = tserve.BatchingServer(port, max_delay_ms=20.0)
    try:
        with ThreadPoolExecutor(8) as clients:
            futs = list(clients.map(front.submit, reqs))
        results = [f.result(timeout=60) for f in futs]
    finally:
        front.close()
    for r, (xb, zb) in zip(reqs, results):
        xs, zs = port.solve(r)
        _close(xb, xs.numpy())
        _close(zb, zs.numpy())


def test_batching_server_validation_and_close(served):
    A, _, port, _ = served
    front = tserve.BatchingServer(port)
    with pytest.raises(ValueError, match="expected"):
        front.submit(np.zeros((2, A.shape[0] + 1)))
    with pytest.raises(ValueError, match="exceed the largest bucket"):
        front.submit(np.zeros((17, A.shape[0])))
    x, z = front.solve(np.zeros((2, A.shape[0])))
    assert x.shape == (2, A.shape[1])
    front.close()
    front.close()  # idempotent
    assert not front._worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        front.submit(np.zeros((1, A.shape[0])))


def test_general_routes_match_plain_loop():
    """General B and trained proxes: the routes and their results (the
    plain loop and the prox-templated kernel's plain version)."""
    A, leaves = _problem(seed=3)
    At, p = torch.as_tensor(A), params_from_numpy(*leaves)
    b = torch.as_tensor(_requests(5, A.shape[0], seed=3))
    rng = np.random.default_rng(4)
    B = torch.as_tensor(rng.normal(size=(A.shape[0], A.shape[0])).astype(np.float32))
    gen = tserve.InferenceServer(p, At, buckets=(8,), B=B, device="cpu")
    assert gen.routes == {8: "plain-loop-general-B"}
    for g, w in zip(gen.solve(b), dladmm_forward(p, At, b, B=B)[:2]):
        _close(g, w)
    for name, route in (("nonneg_l1", "whole-unroll-plain-cpu-prox"),
                        ("group_l2", "plain-loop-prox")):
        pair = (tprox.get_prox(name), tprox.prox_l1)
        srv = tserve.InferenceServer(p, At, buckets=(8,), prox_pair=pair, device="cpu")
        assert srv.routes == {8: route}
        want = dladmm_forward(p, At, b, step_fn=make_cached_step(*pair))[:2]
        for g, w in zip(srv.solve(b), want):
            _close(g, w)
    with pytest.raises(ValueError, match="prox kernel unavailable"):
        tserve.InferenceServer(p, At, buckets=(8,), kernel="megakernel",
                               prox_pair=(tprox.get_prox("group_l2"), tprox.prox_l1),
                               device="cpu")
    with pytest.raises(ValueError, match="requires identity B"):
        tserve.InferenceServer(p, At, buckets=(8,), B=B, kernel="megakernel", device="cpu")
    ref = tserve.InferenceServer(p, At, buckets=(8,), kernel="reference", device="cpu")
    assert ref.routes == {8: "plain-loop-reference"}


def test_unported_options_raise():
    A, leaves = _problem()
    p = params_from_numpy(*leaves)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tserve.InferenceServer(p, torch.as_tensor(A), buckets=(4,), dtype="bfloat16", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        select_forward(16, 32, 16, 8, need_trajectory=True)
    with pytest.raises(ValueError, match="kernel="):
        select_forward(16, 32, 16, 8, kernel="pallas")


def _cli(argv, capsys):
    assert tserve.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_serves_jax_checkpoint(tmp_path, capsys, monkeypatch):
    """End to end: the JAX package writes a checkpoint; the port's CLI
    serves it (--config=smoke --import-torch --input --out, CPU); JAX's
    server solves the same requests with from_torch(ckpt, A=A_port) on
    the port's own dictionary. Outputs agree."""
    from dladmm_tpu_torch.data.synthetic import problem_matrices
    from dladmm_tpu_torch.utils.config import get_config

    monkeypatch.setenv("DLADMM_PLATFORM", "cpu")
    A_port = problem_matrices(get_config("smoke"))[0].numpy()
    _, leaves = _problem(K=4, seed=5, A=A_port)
    ckpt = tmp_path / "net.pt"
    j_save_torch(JParams(*map(jnp.asarray, leaves)), ckpt)
    b = _requests(9, A_port.shape[0], seed=9)
    np.savez(tmp_path / "req.npz", b=b)
    out = tmp_path / "out.npz"
    summary = _cli(["--config=smoke", "--import-torch", str(ckpt),
                    "--input", str(tmp_path / "req.npz"), "--out", str(out)], capsys)
    assert summary["requests"] == 9 and summary["device"] == "cpu"
    assert summary["route"] == "whole-unroll-plain-cpu"
    got = np.load(out)
    jparams = j_from_torch(str(ckpt), A=A_port)
    xj, zj = JServer(jparams, jnp.asarray(A_port), buckets=(9,)).solve(jnp.asarray(b))
    _close(got["x"], xj)
    _close(got["z"], zj)


def test_cli_demo_nmse_equals_ladmm(tmp_path, capsys, monkeypatch):
    """--demo with LADMM-exact weights reports the NMSE of classical
    LADMM on the same batch (chip_smoke.py's check, on the CPU), and
    --layers serves the prefix."""
    from dladmm_tpu_torch.baselines.ladmm import ladmm_run
    from dladmm_tpu_torch.data.synthetic import make_batch, problem_matrices, seed_keys
    from dladmm_tpu_torch.metrics.core import nmse_db
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.utils.config import get_config
    from dladmm_tpu_torch.utils.torch_compat import save_torch

    monkeypatch.setenv("DLADMM_PLATFORM", "cpu")
    cfg = get_config("smoke")
    A, _ = problem_matrices(cfg)
    ckpt = tmp_path / "ladmm.pt"
    save_torch(init_dladmm_params(A, K=cfg.problem.K), ckpt)
    demo = make_batch(seed_keys(cfg)[1], A, 64)
    base = ["--config=smoke", "--import-torch", str(ckpt), "--demo", "64"]
    for layers in (None, 2):
        argv = base + ([] if layers is None else [f"--layers={layers}"])
        summary = _cli(argv, capsys)
        iters = cfg.problem.K if layers is None else layers
        want = float(nmse_db(ladmm_run(A, demo.b, iters=iters)[0], demo.x_star))
        assert summary["layers"] == layers
        assert summary["nmse_db"] == pytest.approx(want, abs=0.01)


@pytest.mark.parametrize(
    "extra", [["--dtype=bfloat16"], ["--dtype=int8"], ["--sharded"], ["--kernel=pallas"]]
)
def test_cli_rejects_unported_options(tmp_path, extra, monkeypatch):
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.utils.torch_compat import save_torch

    monkeypatch.setenv("DLADMM_PLATFORM", "cpu")
    ckpt = tmp_path / "net.pt"
    save_torch(init_dladmm_params(torch.eye(32, 64), K=2), ckpt)
    with pytest.raises(SystemExit):
        tserve.main(["--config=smoke", "--import-torch", str(ckpt), "--demo", "4", *extra])
    with pytest.raises(SystemExit):
        tserve.main(["--config=smoke", "--ckpt-dir", str(tmp_path), "--demo", "4"])
