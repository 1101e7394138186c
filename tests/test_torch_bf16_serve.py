"""bf16 serving and the per-layer step on bf16 state: the port against
the JAX package on the CPU, where the port's kernels run their plain
versions (device="cpu" / DLADMM_PLATFORM=cpu) and the JAX package's
Pallas kernels run in interpret mode.

Both packages get the same numpy inputs, cast to bf16 on each side
(round to nearest even in both; params through
utils/torch_compat.params_from_numpy). The kernel route's rule is bf16
storage with fp32 arithmetic: each layer runs in fp32 on the widened
inputs and rounds only the four values it stores (x, z, lam, Ax)
(ops/cuda_unroll.unroll_forward_plain_bf16). The plain loop (the scan)
rounds every operation, as the JAX package's scan does.

Tolerance: equality where the two packages' fp32 products agree
(m=16, n=32, K=4, S=8 l1/l1 is held bit for bit). Elsewhere a product's
last fp32 bit can differ between torch's and XLA's CPU dots (another
summation order), a bf16 store then rounds the other way, and the flip
travels on through the later layers: there each output is held within
one bf16 ulp of its largest magnitude, 2^(floor(log2 max|ref|) - 7)
(measured: at most 0.56 of it, in box and elastic_net prox_x at 33 x
77). Gradients through the fused step: within two bf16 ulps of each
leaf's largest gradient (measured: one; the JAX package rematerializes
its step partly in bf16, the port in fp32)."""

import json
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dladmm_tpu.models.unroll import DLADMMParams as JParams
from dladmm_tpu.models.unroll import dladmm_forward as j_forward
from dladmm_tpu.models.unroll import init_dladmm_params as j_init
from dladmm_tpu.ops import pallas_unroll as jpu
from dladmm_tpu.ops import prox as jprox
from dladmm_tpu.ops.pallas_layer import make_fused_step as j_make_fused_step
from dladmm_tpu.ops.reference import make_cached_step as j_make_cached_step
from dladmm_tpu.serve import InferenceServer as JServer
from dladmm_tpu_torch import serve as tserve
from dladmm_tpu_torch.models.unroll import DLADMMParams, dladmm_forward
from dladmm_tpu_torch.ops import cuda_layer, cuda_unroll
from dladmm_tpu_torch.ops import prox as tprox
from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

BF = jnp.bfloat16
SHAPES = [(16, 32, 4, 8), (33, 77, 5, 13)]  # tests/test_torch_unroll_kernel.py's; the second is ragged


def _setup(m, n, K, S, seed=0, scalar_theta=False):
    """Numpy A, b, x* and perturbed LADMM-exact params (the recipe of
    tests/test_torch_unroll_kernel.py)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    x_star = ((rng.random((S, n)) < 0.1) * rng.normal(size=(S, n))).astype(np.float32)
    e_star = ((rng.random((S, m)) < 0.1) * rng.normal(size=(S, m))).astype(np.float32)
    b = (x_star @ A.T + e_star).astype(np.float32)
    p0 = j_init(jnp.asarray(A), K=K, per_coordinate=not scalar_theta)
    leaves = [
        np.asarray(leaf) + 0.05 * rng.normal(size=leaf.shape).astype(np.float32)
        for leaf in p0
    ]
    return A, b, x_star, leaves


def _jax16(A, b, leaves):
    return JParams(*(jnp.asarray(v).astype(BF) for v in leaves)), jnp.asarray(A).astype(BF), jnp.asarray(b).astype(BF)


def _torch16(A, b, leaves):
    return (params_from_numpy(*leaves, dtype=torch.bfloat16), torch.as_tensor(A).bfloat16(),
            torch.as_tensor(b).bfloat16())


def _f32(a) -> torch.Tensor:
    """A bf16 result of either package as fp32 (exact)."""
    if isinstance(a, torch.Tensor):
        return a.float()
    return torch.as_tensor(np.array(jnp.asarray(a).astype(jnp.float32)))


def _ulp(ref: torch.Tensor) -> float:
    """One bf16 ulp at ref's largest magnitude."""
    top = float(ref.abs().max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


def _close(got, want, exact=False):
    for g, w in zip(got, want):
        g, w = _f32(g), _f32(w)
        assert g.shape == w.shape and torch.isfinite(g).all()
        if exact:
            assert torch.equal(g, w), int((g != w).sum())
        else:
            err = float((g - w).abs().max())
            assert err <= _ulp(w), (err, _ulp(w), int((g != w).sum()))


@pytest.mark.parametrize("scalar_theta", [False, True])
@pytest.mark.parametrize("m,n,K,S", SHAPES)
def test_rule_matches_jax_kernel(m, n, K, S, scalar_theta):
    """make_unrolled_forward() on bf16 (the bf16-storage kernel's plain
    version on the CPU) against JAX's interpret-mode _unroll_kernel on
    bf16 refs; (K, 1) thresholds are the form from_torch produces."""
    A, b, _, leaves = _setup(m, n, K, S, seed=S, scalar_theta=scalar_theta)
    want = jpu.make_unrolled_forward(interpret=True)(*_jax16(A, b, leaves))
    tp, tA, tb = _torch16(A, b, leaves)
    got = cuda_unroll.make_unrolled_forward()(tp, tA, tb)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _close(got, want, exact=(m, n, K, S) == (16, 32, 4, 8))


@pytest.mark.parametrize("side", ["x", "z"])
@pytest.mark.parametrize("prox_name", ["nonneg_l1", "box", "elastic_net"])
@pytest.mark.parametrize("m,n,K,S", SHAPES)
def test_rule_with_prox_matches_jax_kernel(m, n, K, S, prox_name, side):
    """The prox-templated forward on bf16 (the named op as prox_x, then as
    prox_z, l1 on the other side; elastic_net at rho 0.3) against JAX's
    interpret-mode kernel on bf16."""
    A, b, _, leaves = _setup(m, n, K, S, seed=11)
    jpair = (jprox.get_prox(prox_name, rho=0.3), jprox.prox_l1)
    tpair = (tprox.get_prox(prox_name, rho=0.3), tprox.prox_l1)
    if side == "z":
        jpair, tpair = jpair[::-1], tpair[::-1]
    want = jpu.make_unrolled_inference_prox(*jpair, interpret=True)(*_jax16(A, b, leaves))
    got = cuda_unroll.make_unrolled_inference_prox(*tpair)(*_torch16(A, b, leaves))
    _close(got, want)


def test_scan_on_bf16_is_not_the_kernel_rule():
    """unroll_forward_plain fed bf16 rounds every operation: it is the
    JAX package's bf16 scan, bit for bit, and not its bf16 kernel; so the
    kernel route has its own plain version (the rule above)."""
    A, b, _, leaves = _setup(16, 32, 4, 8, seed=8)
    jp, jA, jb = _jax16(A, b, leaves)
    tp, tA, tb = _torch16(A, b, leaves)
    scan = cuda_unroll.unroll_forward_plain(tb, tA, *tp)
    _close(scan, j_forward(jp, jA, jb), exact=True)
    kernel = jpu.make_unrolled_forward(interpret=True)(jp, jA, jb)
    rule = cuda_unroll.unroll_forward_plain_bf16(tb, tA, *tp)
    _close(rule, kernel, exact=True)
    differ = [int((_f32(s) != _f32(k)).sum()) for s, k in zip(scan, kernel)]
    assert all(d > 0 for d in differ), differ


@pytest.mark.parametrize("matmul_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("m,n,S", [(16, 32, 8), (33, 77, 13), (128, 256, 8)])
def test_layer_step_on_bf16_state_matches_jax(m, n, S, matmul_dtype):
    """dladmm_forward through the fused step on bf16 params, A and b (so
    bf16 state) against JAX's make_fused_step (``_layer_kernel`` in
    interpret mode, block_s = S), with and without bf16 operands."""
    A, b, _, leaves = _setup(m, n, 4, S)
    jp, jA, jb = _jax16(A, b, leaves)
    want = j_forward(jp, jA, jb, step_fn=j_make_fused_step(block_s=S, matmul_dtype=matmul_dtype and BF))
    tp, tA, tb = _torch16(A, b, leaves)
    step = cuda_layer.make_fused_step(matmul_dtype=matmul_dtype and torch.bfloat16)
    got = dladmm_forward(tp, tA, tb, step_fn=step)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _close(got, want, exact=(m, n, S, matmul_dtype) == (16, 32, 8, None))
    one = (tb, tA, torch.zeros((S, n), dtype=torch.bfloat16), *(torch.zeros_like(tb) for _ in range(3)),
           tp.W1[0], tp.W2[0], tp.theta1[0], tp.theta2[0], tp.beta[:1].float())
    for o in cuda_layer.layer_step(*one, matmul_dtype=matmul_dtype and torch.bfloat16):
        assert o.dtype == torch.bfloat16


def test_fused_step_bf16_grads():
    """The port's counterpart of tests/test_pallas.py's bf16 gradient
    test: gradients through the fused step on bf16 params come back in
    bf16 (W1 too), finite, and close to jax.grad's."""
    import jax

    A, b, _, leaves = _setup(16, 32, 3, 8)
    jp, jA, jb = _jax16(A, b, leaves)
    step = j_make_fused_step(block_s=8)

    def loss(p):
        x, z, _ = j_forward(p, jA, jb, step_fn=step)
        return jnp.mean(x.astype(jnp.float32) ** 2) + jnp.mean(z.astype(jnp.float32) ** 2)

    want = jax.grad(loss)(jp)
    tp, tA, tb = _torch16(A, b, leaves)
    leaves_t = [t.requires_grad_() for t in tp]
    x, z, _ = dladmm_forward(DLADMMParams(*leaves_t), tA, tb, step_fn=cuda_layer.fused_layer_step)
    got = torch.autograd.grad(x.float().pow(2).mean() + z.float().pow(2).mean(), leaves_t)
    assert got[0].dtype == torch.bfloat16
    for name, g, w in zip(DLADMMParams._fields, got, want):
        g, w = _f32(g), _f32(w)
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        assert float((g - w).abs().max()) <= 2 * _ulp(w), name


@pytest.fixture(scope="module")
def served16():
    A, _, _, leaves = _setup(16, 32, 4, 8, seed=21)
    buckets = (1, 4, 16)
    port = tserve.InferenceServer(params_from_numpy(*leaves), torch.as_tensor(A), buckets=buckets,
                                  dtype=torch.bfloat16, device="cpu")
    jserver = JServer(JParams(*map(jnp.asarray, leaves)), jnp.asarray(A), buckets=buckets, dtype=BF)
    return A, leaves, port, jserver


def _requests(rows, m, seed):
    return np.random.default_rng(seed).normal(size=(rows, m)).astype(np.float32)


@pytest.mark.parametrize("rows", [1, 5, 16])
def test_inference_server_matches_jax(served16, rows):
    """InferenceServer(dtype=torch.bfloat16) against the JAX package's
    InferenceServer(dtype=jnp.bfloat16): params cast once, fp32 requests
    cast per call, bf16 answers."""
    A, _, port, jserver = served16
    assert set(port.routes.values()) == {"whole-unroll-bf16-plain-cpu"}
    b = _requests(rows, A.shape[0], seed=rows)
    x, z = port.solve(torch.as_tensor(b))
    xj, zj = jserver.solve(jnp.asarray(b))
    assert x.dtype == z.dtype == torch.bfloat16 and xj.dtype == BF
    _close((x, z), (xj, zj), exact=True)
    for g, w in zip(port.solve(b), (x, z)):  # numpy requests are served the same
        assert torch.equal(g, w)


def test_batching_server_returns_float32_of_bf16(served16):
    """Concurrent submits to a BatchingServer over the bf16 server: the
    futures are float32 arrays holding exactly the per-request solves'
    bf16 values (numpy has no bf16)."""
    A, _, port, jserver = served16
    reqs = [_requests(s, A.shape[0], seed=30 + s) for s in (1, 2, 3, 1, 4, 2, 1, 2)]
    front = tserve.BatchingServer(port, max_delay_ms=20.0)
    try:
        with ThreadPoolExecutor(8) as clients:
            futs = list(clients.map(front.submit, reqs))
        results = [f.result(timeout=60) for f in futs]
    finally:
        front.close()
    for r, (xb, zb) in zip(reqs, results):
        assert xb.dtype == zb.dtype == np.float32
        xs, zs = port.solve(r)
        np.testing.assert_array_equal(xb, xs.float().numpy())
        np.testing.assert_array_equal(zb, zs.float().numpy())
        _close((torch.as_tensor(xb), torch.as_tensor(zb)), jserver.solve(jnp.asarray(r)), exact=True)


def test_plain_loop_routes_match_jax_scan():
    """General B, group_l2 (no kernel variant) and kernel="reference" in
    bf16 serve through the plain loop, which equals the JAX package's
    bf16 scan (its servers' route for these) bit for bit, but for
    group_l2: its row norm's sum of squares rounds at other places in
    XLA's bf16 reduction than in torch's, so it is held to one ulp
    (measured: 24 of 40 x elements differ, each by one ulp of x's
    largest magnitude)."""
    A, _, _, leaves = _setup(16, 32, 4, 8, seed=3)
    At, p = torch.as_tensor(A), params_from_numpy(*leaves)
    jA, jp = jnp.asarray(A), JParams(*map(jnp.asarray, leaves))
    b = _requests(5, A.shape[0], seed=3)
    B = np.random.default_rng(4).normal(size=(16, 16)).astype(np.float32)
    group = (tprox.get_prox("group_l2"), tprox.prox_l1)
    jgroup = (jprox.get_prox("group_l2"), jprox.prox_l1)
    cases = {
        "plain-loop-bf16-general-B": (dict(B=torch.as_tensor(B)), dict(B=jnp.asarray(B))),
        "plain-loop-bf16-prox": (dict(prox_pair=group), dict(prox_pair=jgroup, step_fn=j_make_cached_step(*jgroup))),
        "plain-loop-bf16-reference": (dict(kernel="reference"), dict(kernel="reference")),
    }
    for route, (kw, jkw) in cases.items():
        srv = tserve.InferenceServer(p, At, buckets=(8,), dtype="bfloat16", device="cpu", **kw)
        assert srv.routes == {8: route}
        got = srv.solve(b)
        assert got[0].dtype == torch.bfloat16
        _close(got, JServer(jp, jA, buckets=(8,), dtype=BF, **jkw).solve(jnp.asarray(b)),
               exact=route != "plain-loop-bf16-prox")


def test_prox_server_matches_jax():
    """A trained elementwise prox in bf16 serves through the prox-templated
    kernel's bf16 route, as the JAX package's bf16 server takes its
    prox-templated kernel."""
    A, _, _, leaves = _setup(16, 32, 4, 8, seed=5)
    pair = (tprox.get_prox("nonneg_l1"), tprox.prox_l1)
    srv = tserve.InferenceServer(params_from_numpy(*leaves), torch.as_tensor(A), buckets=(8,),
                                 dtype=torch.bfloat16, prox_pair=pair, device="cpu")
    assert srv.routes == {8: "whole-unroll-bf16-plain-cpu-prox"}
    jpair = (jprox.get_prox("nonneg_l1"), jprox.prox_l1)
    jsrv = JServer(JParams(*map(jnp.asarray, leaves)), jnp.asarray(A), buckets=(8,), dtype=BF, prox_pair=jpair)
    b = _requests(6, 16, seed=6)
    _close(srv.solve(b), jsrv.solve(jnp.asarray(b)), exact=True)


def test_bf16_server_close_to_fp32():
    """The port's counterpart of tests/test_serve.py's bf16 test: x within
    0.05 of fp32's largest |x|, NMSE within 0.25 dB of fp32 serving."""
    from dladmm_tpu_torch.data.synthetic import make_batch, make_dictionary
    from dladmm_tpu_torch.metrics.core import nmse_db
    from dladmm_tpu_torch.models.unroll import init_dladmm_params

    g = torch.Generator().manual_seed(0)
    A = make_dictionary(g, 32, 64)
    params = init_dladmm_params(A, K=6)
    data = make_batch(g, A, 16)
    x32, _ = tserve.InferenceServer(params, A, max_batch=16, device="cpu").solve(data.b)
    x16, _ = tserve.InferenceServer(params, A, max_batch=16, dtype=torch.bfloat16, device="cpu").solve(data.b)
    assert x16.dtype == torch.bfloat16
    assert float((x16.float() - x32).abs().max()) < 0.05 * (float(x32.abs().max()) + 1e-9)
    d32, d16 = float(nmse_db(x32, data.x_star)), float(nmse_db(x16.float(), data.x_star))
    assert abs(d16 - d32) < 0.25, (d16, d32)


def _cli(argv, capsys):
    assert tserve.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_bf16_import_layers_out(tmp_path, capsys, monkeypatch):
    """The CLI with --dtype=bfloat16 (the counterpart of
    tests/test_serve.py's option-surface test): a JAX-written .pt served
    with --layers=2 --input --out, whose float32 arrays hold the bf16
    answers of JAX's bf16 server on the port's dictionary; and --demo,
    whose NMSE is taken on x widened to fp32."""
    from dladmm_tpu_torch.data.synthetic import problem_matrices
    from dladmm_tpu_torch.utils.config import get_config

    from dladmm_tpu.utils.torch_compat import from_torch as j_from_torch
    from dladmm_tpu.utils.torch_compat import save_torch as j_save_torch

    monkeypatch.setenv("DLADMM_PLATFORM", "cpu")
    A_port = problem_matrices(get_config("smoke"))[0].numpy()
    rng = np.random.default_rng(5)
    p0 = j_init(jnp.asarray(A_port), K=4)
    leaves = [np.asarray(v) + 0.05 * rng.normal(size=v.shape).astype(np.float32) for v in p0]
    ckpt = tmp_path / "net.pt"
    j_save_torch(JParams(*map(jnp.asarray, leaves)), ckpt)
    b = _requests(9, A_port.shape[0], seed=9)
    np.savez(tmp_path / "req.npz", b=b)
    out = tmp_path / "out.npz"
    base = ["--config=smoke", "--import-torch", str(ckpt), "--dtype=bfloat16", "--layers=2"]
    summary = _cli(base + ["--input", str(tmp_path / "req.npz"), "--out", str(out)], capsys)
    assert summary["dtype"] == "bfloat16" and summary["layers"] == 2
    assert summary["route"] == "whole-unroll-bf16-plain-cpu"
    got = np.load(out)
    assert got["x"].dtype == np.float32
    jserver = JServer(j_from_torch(str(ckpt), A=A_port), jnp.asarray(A_port), buckets=(9,), dtype=BF, layers=2)
    _close((torch.as_tensor(got["x"]), torch.as_tensor(got["z"])), jserver.solve(jnp.asarray(b)), exact=True)
    demo = _cli(base + ["--demo", "32"], capsys)
    assert demo["dtype"] == "bfloat16" and demo["layers"] == 2 and np.isfinite(demo["nmse_db"])
