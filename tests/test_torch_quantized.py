"""Port parity for int8 serving: the codec and the plain int8 forwards
(ops/quantized.py), the int8 kernel's plain version (ops/cuda_int8.py),
the int8 InferenceServer, BatchingServer and CLI, on the CPU.

The JAX package's ``qdot`` and codec run eagerly, op by op, and the
port's equal them bit for bit. Its scan and its Pallas kernel (interpret
mode) are compiled by XLA, which contracts multiply-adds into FMAs on the
CPU, so their last bits differ from the port's round-to-nearest chain
by a few ulps of the output's largest value: they are held at
tests/test_quantized.py's rtol 1e-6 with an atol of 1e-6 * max(1,
max|ref|) in place of its 1e-7 (measured: up to 7.7e-7 on outputs of
magnitude ~1-4). A flipped int8 code would move an element by ~1e-2. At
these sizes no code flips; at synthetic_small some do (ROADMAP.md §3),
which is why the kernel is held to its plain version bit for bit on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

import json
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dladmm_tpu.models.unroll import DLADMMParams as JParams
from dladmm_tpu.models.unroll import init_dladmm_params as j_init
from dladmm_tpu.ops import quantized as jq
from dladmm_tpu_torch import serve as tserve
from dladmm_tpu_torch.ops import cuda_int8
from dladmm_tpu_torch.ops import prox as tprox
from dladmm_tpu_torch.ops import quantized as tq
from dladmm_tpu_torch.utils.torch_compat import params_from_numpy, quantized_from_numpy

RTOL, ATOL = 1e-6, 1e-6  # rtol of tests/test_quantized.py:33-46; atol scaled (module docstring)


def _setup(m=32, n=64, K=5, S=16, seed=0):
    """Numpy A, b, x* and perturbed LADMM-exact params, drawn with numpy."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    x_star = ((rng.random((S, n)) < 0.1) * rng.normal(size=(S, n))).astype(np.float32)
    e_star = ((rng.random((S, m)) < 0.1) * rng.normal(size=(S, m))).astype(np.float32)
    b = (x_star @ A.T + e_star).astype(np.float32)
    p0 = j_init(jnp.asarray(A), K=K)
    leaves = [np.asarray(v) + 0.05 * rng.normal(size=v.shape).astype(np.float32) for v in p0]
    return A, b, x_star, leaves


def _both(A, leaves):
    """The JAX package's quantized operands and the port's, from the same
    numpy params."""
    jqp, jqd = jq.quantize_params(JParams(*map(jnp.asarray, leaves)), jnp.asarray(A))
    qp, qd = tq.quantize_params(params_from_numpy(*leaves), torch.as_tensor(A))
    return (jqp, jqd), (qp, qd)


def _close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=RTOL, atol=ATOL * max(1.0, np.abs(w).max()))


def test_quantize_rows_matches_jax_bit_for_bit():
    """Codes and scales equal the JAX package's, an all-zero row (scale
    0, codes 0) and a row with a half-way value included."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(6, 37)).astype(np.float32)
    w[2] = 0.0
    w[4, :3] = [127.0, 0.5, -1.5]
    w[4, 3:] = 0.0
    jqv, jsv = jq.quantize_rows(jnp.asarray(w))
    tqv, tsv = tq.quantize_rows(torch.as_tensor(w))
    assert tqv.dtype == torch.int8 and tsv.dtype == torch.float32
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tsv.numpy(), np.asarray(jsv))
    assert tsv[2] == 0 and (tqv[2] == 0).all()
    np.testing.assert_array_equal(tqv[4, :3].numpy(), [127, 0, -2])  # half to even


def test_quantize_params_and_bridge_match_jax():
    """quantize_params equals the JAX package's leaf for leaf, bit for
    bit; quantized_from_numpy carries the JAX operands across unchanged."""
    A, _, _, leaves = _setup()
    (jqp, jqd), (qp, qd) = _both(A, leaves)
    for got, want in zip((*qp, *qd), (*jqp, *jqd)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cqp, cqd = quantized_from_numpy(jqp, jqd)
    for got, want in zip((*cqp, *cqd), (*qp, *qd)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_qdot_matches_jax_bit_for_bit():
    A, b, _, leaves = _setup()
    (jqp, _), (qp, _) = _both(A, leaves)
    act = np.random.default_rng(2).normal(size=(9, A.shape[0])).astype(np.float32)
    act[3] = 0.0  # zero scale: codes 0, result 0
    want = jq.qdot(jnp.asarray(act), jqp.W1_q[1], jqp.W1_s[1])
    got = tq.qdot(torch.as_tensor(act), qp.W1_q[1], qp.W1_s[1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[3] == 0).all()


def test_int_dot_is_exact_where_int8_matmul_wraps():
    """The int32 dot: int8 @ int8 wraps on the CPU, the float64 product
    does not (127 * 127 * 500 > 2^24, < 2^53)."""
    a = torch.full((2, 500), 127, dtype=torch.int8)
    w = torch.full((3, 500), -127, dtype=torch.int8)
    assert torch.equal(tq._int_dot(a, w), torch.full((2, 3), -127 * 127 * 500, dtype=torch.int32))


def test_forward_int8_matches_jax_scan():
    A, b, _, leaves = _setup()
    (jqp, jqd), (qp, qd) = _both(A, leaves)
    want = jq.dladmm_forward_int8(jqp, jqd, jnp.asarray(b))
    got = tq.dladmm_forward_int8(qp, qd, torch.as_tensor(b))
    _close(got, want)


def test_kernel_plain_version_matches_jax_pallas_kernel():
    """int8_unroll_forward on the CPU (its plain version, the kernel's
    operation order) against dladmm_forward_int8_pallas in interpret
    mode, m=32, n=64, K=5, S=16; the alias with the JAX argument order
    gives the same."""
    A, b, _, leaves = _setup()
    (jqp, jqd), (qp, qd) = _both(A, leaves)
    want = jq.dladmm_forward_int8_pallas(jqp, jqd, jnp.asarray(b))
    got = cuda_int8.int8_unroll_forward(torch.as_tensor(b), qp, qd)
    _close(got, want)
    assert cuda_int8.int8_unroll_forward.launches == 0  # the CPU runs no kernel
    for g, w in zip(cuda_int8.dladmm_forward_int8_pallas(qp, qd, torch.as_tensor(b)), got):
        assert torch.equal(g, w)


def test_kernel_and_scan_orders_drift_apart_at_synthetic_small():
    """The property ROADMAP.md §3 records: at synthetic_small (m=250,
    n=500, K=15, LADMM-exact params, the --demo batch) the kernel's order
    and the scan's give different int8 codes somewhere, so their outputs
    differ by far more than rounding (> 1e-4 of the largest value), yet
    both serve at one quality (NMSE within 0.05 dB)."""
    from dladmm_tpu_torch.data.synthetic import make_batch, problem_matrices, seed_keys
    from dladmm_tpu_torch.metrics.core import nmse_db
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.utils.config import get_config

    cfg = get_config("synthetic_small")
    A, _ = problem_matrices(cfg)
    data = make_batch(seed_keys(cfg)[1], A, 64)
    qp, qd = tq.quantize_params(init_dladmm_params(A, K=cfg.problem.K), A)
    xs, _, _ = tq.dladmm_forward_int8(qp, qd, data.b)
    xk, _, _ = cuda_int8.int8_unroll_forward_plain(data.b, qp, qd)
    assert float((xs - xk).abs().max()) > 1e-4 * float(xs.abs().max())
    assert abs(float(nmse_db(xs, data.x_star)) - float(nmse_db(xk, data.x_star))) < 0.05


@pytest.fixture(scope="module")
def int8_servers():
    A, b, x_star, leaves = _setup(K=6, seed=3)
    p, At = params_from_numpy(*leaves), torch.as_tensor(A)
    kw = dict(max_batch=16, device="cpu")
    return A, b, x_star, leaves, {
        "fp32": tserve.InferenceServer(p, At, **kw),
        "reference": tserve.InferenceServer(p, At, dtype="int8", kernel="reference", **kw),
        "auto": tserve.InferenceServer(p, At, dtype="int8", **kw),
    }


def test_int8_server_routes_and_exactness(int8_servers):
    """On an off-bucket batch (11 rows in the 16 bucket): the reference
    route equals dladmm_forward_int8, and the kernel route equals the
    kernel's plain version, bit for bit; the reference route agrees with
    the JAX package's int8 server at the JAX tests' tolerance."""
    A, b, _, leaves, servers = int8_servers
    assert set(servers["reference"].routes.values()) == {"plain-loop-int8-reference"}
    assert set(servers["auto"].routes.values()) == {"int8-unroll-plain-cpu"}
    qp, qd = servers["auto"]._operands
    bt = torch.as_tensor(b[:11])
    for name, fn in (("reference", tq.dladmm_forward_int8), ("auto", cuda_int8.dladmm_forward_int8_pallas)):
        x, z = servers[name].solve(bt)
        xr, zr, _ = fn(qp, qd, bt)
        assert torch.equal(x, xr) and torch.equal(z, zr), name
    jserver = tserve_jax(A, leaves)
    _close(servers["reference"].solve(bt), jserver.solve(jnp.asarray(b[:11])))


def tserve_jax(A, leaves):
    from dladmm_tpu.serve import InferenceServer as JServer

    return JServer(JParams(*map(jnp.asarray, leaves)), jnp.asarray(A), max_batch=16, dtype="int8")


@pytest.mark.parametrize("route", ["reference", "auto"])
def test_int8_server_quality_within_contract(int8_servers, route):
    """NMSE against the ground truth within 0.3 dB of the fp32 server
    (tests/test_serve.py:283-285)."""
    from dladmm_tpu_torch.metrics.core import nmse_db

    _, b, x_star, _, servers = int8_servers
    x32, _ = servers["fp32"].solve(b)
    x8, _ = servers[route].solve(b)
    d32 = float(nmse_db(x32, torch.as_tensor(x_star)))
    d8 = float(nmse_db(x8, torch.as_tensor(x_star)))
    assert abs(d8 - d32) < 0.3, (d8, d32)


def test_batching_server_over_int8(int8_servers):
    """Concurrent submits batched over an int8 server equal per-request
    solves (rows are independent after quantization too: each row has
    its own activation scale)."""
    A, _, _, _, servers = int8_servers
    rng = np.random.default_rng(5)
    reqs = [rng.normal(size=(s, A.shape[0])).astype(np.float32) for s in (1, 2, 3, 1, 4, 2, 1, 2)]
    front = tserve.BatchingServer(servers["auto"], max_delay_ms=20.0)
    try:
        with ThreadPoolExecutor(8) as clients:
            futs = list(clients.map(front.submit, reqs))
        results = [f.result(timeout=60) for f in futs]
    finally:
        front.close()
    for r, (xb, zb) in zip(reqs, results):
        xs, zs = servers["auto"].solve(r)
        np.testing.assert_array_equal(xb, xs.numpy())
        np.testing.assert_array_equal(zb, zs.numpy())


def test_int8_server_rejections():
    A, _, _, leaves = _setup(K=2)
    p, At = params_from_numpy(*leaves), torch.as_tensor(A)
    kw = dict(buckets=(4,), device="cpu")
    with pytest.raises(ValueError, match="identity B"):
        tserve.InferenceServer(p, At, dtype="int8", B=torch.eye(A.shape[0]), **kw)
    pair = (tprox.get_prox("nonneg_l1"), tprox.prox_l1)
    with pytest.raises(ValueError, match="l1/l1"):
        tserve.InferenceServer(p, At, dtype="int8", prox_pair=pair, **kw)
    from dladmm_tpu_torch.ops.reference import make_cached_step

    with pytest.raises(ValueError, match="l1/l1"):
        tserve.InferenceServer(p, At, dtype="int8", step_fn=make_cached_step(*pair), **kw)
    with pytest.raises(ValueError, match="kernel="):
        tserve.InferenceServer(p, At, dtype="int8", kernel="pallas", **kw)
    # bf16 serves now (tests/test_torch_bf16_serve.py); a type the port
    # does not serve is refused.
    assert tserve.InferenceServer(p, At, dtype="bfloat16", **kw).routes == {4: "whole-unroll-bf16-plain-cpu"}
    with pytest.raises(ValueError, match="float32, bfloat16 and int8"):
        tserve.InferenceServer(p, At, dtype=torch.float16, **kw)


def _cli(argv, capsys):
    assert tserve.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("kernel", ["megakernel", "auto", "reference"])
def test_int8_cli_on_the_cpu(tmp_path, capsys, monkeypatch, kernel):
    """serve --dtype=int8 --demo 64 with DLADMM_PLATFORM=cpu runs the
    plain versions, within 0.3 dB of the fp32 serve of the same
    checkpoint and requests."""
    from dladmm_tpu_torch.data.synthetic import problem_matrices
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.utils.config import get_config
    from dladmm_tpu_torch.utils.torch_compat import save_torch

    monkeypatch.setenv("DLADMM_PLATFORM", "cpu")
    cfg = get_config("smoke")
    ckpt = tmp_path / "ladmm.pt"
    save_torch(init_dladmm_params(problem_matrices(cfg)[0], K=cfg.problem.K), ckpt)
    base = ["--config=smoke", "--import-torch", str(ckpt), "--demo", "64"]
    fp32 = _cli(base, capsys)
    int8 = _cli(base + ["--dtype=int8", f"--kernel={kernel}"], capsys)
    route = "plain-loop-int8-reference" if kernel == "reference" else "int8-unroll-plain-cpu"
    assert int8["route"] == route and int8["dtype"] == "int8" and int8["device"] == "cpu"
    assert abs(int8["nmse_db"] - fp32["nmse_db"]) < 0.3, (int8["nmse_db"], fp32["nmse_db"])
