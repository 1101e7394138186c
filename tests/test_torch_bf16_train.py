"""bf16 training (``compute_dtype="bfloat16"``): the port against the JAX
package on the CPU, where the port's kernels run their plain versions and
the JAX package's Pallas kernels run in interpret mode.

Both packages get the same numpy inputs, cast to bf16 on each side
(round to nearest even in both; params through
utils/torch_compat.params_from_numpy). Three rules are held here:

  * the trajectory kernel on bf16 refs keeps its state in fp32 and rounds
    only the stack stores (``trajectory_forward_plain_bf16``): bit for bit
    at m=16, n=32, K=4, S=8; elsewhere within one bf16 ulp of each stack's
    largest magnitude (a last-bit difference of the two packages' fp32
    products may round one stored value the other way, measured 0.125);
  * the backward kernel on bf16 refs carries fp32 cotangent state and
    rounds an activation only where it meets a bf16 weight or A
    (``unroll_bwd_plain_bf16``): each gradient within one bf16 ulp of its
    leaf's largest magnitude, its mean |difference| within 0.025 of that
    ulp (measured: at most 0.5 and 0.016, the latter one of beta's four
    values; a few elements whose fp32 sums differ in the last bit round
    the other way). bwd_from_carries in bf16,
    which rounds every operation, fails that at every case and leaf (mean
    0.056 to 10^8 ulps), so the test tells the two rules apart;
  * the clip norm of bf16 gradients is the one the JAX package's jitted
    step computes (``optax.global_norm(grads).astype(f32)`` in _scalars):
    each leaf's fp32 sum of squares rounded to bf16, those added in bf16,
    the square root in fp32 (``qadam_cuda.global_norm``). Eager optax
    rounds each square first and the root too; jit of optax.global_norm
    alone (a bf16 result) rounds the root.

Training steps on the persistent bf16 copy are held against the JAX
package's make_train_step_from_batch(compute_dtype=bfloat16): one step
within rtol 1e-3 (params) and 1e-4 (loss) -- the bf16 roundings of the
two packages' forwards and backwards agree except where fp32 sums
flip one -- and five steps at the JAX package's own tolerance for bf16
training (tests/test_training.py: rtol 0.05, atol 2e-3; loss 1e-2)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dladmm_tpu.data.synthetic import SyntheticBatch as JBatch
from dladmm_tpu.models import api as japi
from dladmm_tpu.models.unroll import DLADMMParams as JParams
from dladmm_tpu.models.unroll import init_dladmm_params as j_init
from dladmm_tpu.ops import pallas_bwd as jbwd
from dladmm_tpu.ops import pallas_unroll as jpu
from dladmm_tpu.ops import unroll_vjp as jvjp
from dladmm_tpu.train import loop as jloop
from dladmm_tpu.utils.config import TrainConfig
from dladmm_tpu_torch.data.synthetic import SyntheticBatch
from dladmm_tpu_torch.models import api as tapi
from dladmm_tpu_torch.models.unroll import DLADMMParams
from dladmm_tpu_torch.ops import cuda_bwd, cuda_traj, cuda_unroll, unroll_vjp
from dladmm_tpu_torch.train import loop as tloop
from dladmm_tpu_torch.train import qadam_cuda as tqa
from dladmm_tpu_torch.utils.config import get_config
from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

BF = jnp.bfloat16


def _ulp(x: np.ndarray) -> float:
    """One bf16 ulp at x's largest magnitude."""
    top = float(np.abs(x).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 1.0


def _np(a) -> np.ndarray:
    """A result of either package (any float dtype) as an fp32 array."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t16(a) -> torch.Tensor:
    """A JAX bf16 array as the same bf16 tensor."""
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).bfloat16()


def _problem(m, n, K, S, seed=0, scalar_theta=False, ties=False):
    """Numpy A, b and perturbed LADMM-exact params; with ties theta1 of
    layer 1 and theta2 of layer 2 partly 0 and beta of layer 1 at 1e-6
    (exact in bf16 after the cast: set on the bf16 values)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    b = rng.normal(size=(S, m)).astype(np.float32)
    leaves = [
        np.asarray(v) + 0.05 * np.abs(np.asarray(v)).mean() * rng.normal(size=v.shape).astype(np.float32)
        for v in j_init(jnp.asarray(A), K=K, per_coordinate=not scalar_theta)
    ]
    if ties:
        leaves[2][1, ::2] = 0.0
        leaves[3][2, ::3] = 0.0
        leaves[4][1] = np.float32(1e-6)
    return A, b, leaves


def _serve_problem(m, n, K, S, seed=0):
    """Numpy A, b = x* A^T + e* and perturbed LADMM-exact params: the
    recipe of tests/test_torch_bf16_serve.py."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    x_star = ((rng.random((S, n)) < 0.1) * rng.normal(size=(S, n))).astype(np.float32)
    e_star = ((rng.random((S, m)) < 0.1) * rng.normal(size=(S, m))).astype(np.float32)
    b = (x_star @ A.T + e_star).astype(np.float32)
    leaves = [np.asarray(v) + 0.05 * rng.normal(size=v.shape).astype(np.float32)
              for v in j_init(jnp.asarray(A), K=K)]
    return A, b, leaves


def _both16(A, b, leaves):
    """The bf16 inputs of each package: (JAX params, A, b), (port ...)."""
    jax_in = (JParams(*(jnp.asarray(v).astype(BF) for v in leaves)), jnp.asarray(A).astype(BF),
              jnp.asarray(b).astype(BF))
    port = (params_from_numpy(*leaves, dtype=torch.bfloat16), torch.as_tensor(A).bfloat16(),
            torch.as_tensor(b).bfloat16())
    return jax_in, port


# -- the trajectory kernel (row 2) ---------------------------------------------


@pytest.mark.parametrize("m,n,K,S", [(16, 32, 4, 8), (32, 64, 4, 8), (33, 77, 5, 13)])
@pytest.mark.parametrize("with_tax", [True, False])
def test_trajectory_plain_bf16_matches_jax_kernel(m, n, K, S, with_tax):
    """trajectory_forward on bf16 CPU tensors (its plain version) against
    _traj_pallas on bf16 refs in interpret mode: bit for bit at the
    smallest shape, else each stack within one bf16 ulp of its largest
    magnitude; bf16 stacks; nothing launches."""
    A, b, leaves = _serve_problem(m, n, K, S)
    (jp, jA, jb), (tp, tA, tb) = _both16(A, b, leaves)
    want = jpu._traj_pallas(jp, jA, jb, matmul_dtype=None, interpret=True, with_tax=with_tax)
    launches = cuda_traj.trajectory_forward.launches_bf16
    got = cuda_traj.trajectory_forward(tb, tA, *tp, with_tax=with_tax)
    assert cuda_traj.trajectory_forward.launches_bf16 == launches
    assert len(got) == len(want) == (4 if with_tax else 3)
    for name, g, w in zip(("tx", "tz", "tlam", "tax"), got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == tuple(w.shape), name
        g, w = _np(g), _np(w)
        if (m, n) == (16, 32):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert np.abs(g - w).max() <= _ulp(w), name


def test_trajectory_bf16_rule_is_not_the_serving_rule():
    """The trajectory's state stays fp32 across layers; the serving
    kernel's bf16 rule rounds it between layers. Their last layers differ
    (fact 1 of the port's bf16 training): the trajectory's x_K is held to
    the JAX trajectory kernel above, not to unroll_forward_plain_bf16."""
    A, b, leaves = _serve_problem(16, 32, 4, 8)
    _, (tp, tA, tb) = _both16(A, b, leaves)
    tx, tz, tlam = cuda_traj.trajectory_forward_plain_bf16(tb, tA, *tp)
    x, z, lam = cuda_unroll.unroll_forward_plain_bf16(tb, tA, *tp)
    assert not (torch.equal(tx[-1], x) and torch.equal(tz[-1], z) and torch.equal(tlam[-1], lam))
    xs, _, _ = cuda_traj.trajectory_forward_plain(tb.float(), tA.float(), *(t.float() for t in tp))
    assert torch.equal(tx, xs.bfloat16())


# -- the backward kernel (rows 4 and 5) ------------------------------------------


def _bwd_inputs(bs, scalar_theta, ties, m=16, n=32, K=4, S=16):
    """Both packages' bf16 inputs of one backward: params, A, b, the JAX
    bf16 trajectory kernel's stacks and bf16 final-state cotangents."""
    A, b, leaves = _problem(m, n, K, S, seed=bs or 1, scalar_theta=scalar_theta, ties=ties)
    (jp, jA, jb), (tp, tA, tb) = _both16(A, b, leaves)
    traj = jpu._traj_pallas(jp, jA, jb, matmul_dtype=None, interpret=True, with_tax=True)
    rng = np.random.default_rng(3)
    cts = tuple(jnp.asarray(scale * rng.normal(size=(S, d)).astype(np.float32)).astype(BF)
                for scale, d in ((1.0, n), (1.0, m), (0.1, m)))
    return (jp, jA, jb, traj, cts), (tb, tA, *tp, *map(_t16, traj), *map(_t16, cts))


def _bwd_agree(got, want) -> bool:
    """Each gradient within one bf16 ulp of its leaf's largest magnitude,
    and its mean |difference| within 0.025 of that ulp."""
    ok = True
    for g, w in zip(got, want):
        g, w = _np(g), _np(w).reshape(np.shape(g))
        d = np.abs(g - w) / _ulp(w)
        ok = ok and d.max() <= 1.0 and d.mean() <= 0.025
    return ok


@pytest.mark.parametrize("bs", [None, 4, 8])
@pytest.mark.parametrize("scalar_theta,ties", [(False, False), (False, True), (True, True)])
def test_bwd_plain_bf16_matches_jax_kernels(bs, scalar_theta, ties):
    """unroll_bwd on bf16 CPU tensors (unroll_bwd_plain_bf16) against
    unroll_bwd_pallas (bs None) and unroll_bwd_pallas_chunked on bf16 refs
    in interpret mode: every parameter gradient (in the parameter's shape
    and dtype), gA and gb; (K, 1) thresholds; ties at theta = 0 and
    beta = 1e-6. bwd_from_carries on the same bf16 inputs fails the same
    tolerance."""
    jargs, targs = _bwd_inputs(bs, scalar_theta, ties)
    if bs is None:
        want = jbwd.unroll_bwd_pallas(*jargs, interpret=True)
    else:
        want = jbwd.unroll_bwd_pallas_chunked(*jargs, bs=bs, interpret=True)
    launches = dict(cuda_bwd.unroll_bwd.launches_bf16)
    got = cuda_bwd.unroll_bwd(*targs, bs=bs, data_grads=True)
    assert cuda_bwd.unroll_bwd.launches_bf16 == launches
    for name, g, w in zip(JParams._fields, got[0], want[0]):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.bfloat16, name
    assert got[1].dtype == got[2].dtype == torch.bfloat16
    want_all, got_all = [*want[0], want[1], want[2]], [*got[0], got[1], got[2]]
    assert _bwd_agree(got_all, want_all)
    scan = cuda_bwd.unroll_bwd_plain(*targs, data_grads=True)
    assert not _bwd_agree([*scan[0], scan[1], scan[2]], want_all)


def test_bwd_from_carries_bf16_matches_jax():
    """The port's bwd_from_carries on bf16 (the deep-supervision backward
    of bf16 training, every operation in bf16 as the JAX package's: its
    products return bf16) against the JAX one on the same bf16 stacks and
    per-layer cotangents: each gradient within two bf16 ulps of its leaf's
    largest magnitude (the two packages sum their products in other
    orders, and each rounding of a bf16 operation may then flip)."""
    (jp, jA, jb, traj, cts), (tb, tA, *rest) = _bwd_inputs(None, False, False)
    tp = DLADMMParams(*rest[:5])
    K = jp.W1.shape[0]
    rng = np.random.default_rng(5)
    tcts = [jnp.asarray(0.1 * rng.normal(size=t.shape).astype(np.float32)).astype(BF) for t in traj[:3]]
    zeros = tuple(jnp.zeros_like(t[-1]) for t in traj[:3])
    want = jvjp.bwd_from_carries(jp, jA, jb, jvjp.shifted_residuals(*traj), zeros, traj_cts=tuple(tcts))
    ttraj = [_t16(t) for t in traj]
    tzeros = tuple(torch.zeros_like(t[-1]) for t in ttraj[:3])
    got = unroll_vjp.bwd_from_carries(tp, tA, tb, unroll_vjp.shifted_residuals(*ttraj), tzeros,
                                      tuple(_t16(t) for t in tcts))
    assert K == 4
    for name, g, w in zip((*JParams._fields, "gA", "gb"), [*got[0], got[1], got[2]], [*want[0], want[1], want[2]]):
        assert g.dtype == torch.bfloat16, name
        g, w = _np(g).reshape(np.shape(w)), _np(w)
        assert np.abs(g - w).max() <= 2 * _ulp(w), name


# -- the optimizer step on bf16 gradients (rows 3 and 6) ----------------------

STEP_SHAPES = [(2, 256, 128), (2, 128, 128), (2, 256), (2, 128), (2,)]  # tests/test_torch_qadam_step.py's


def _step_cfg(fmt):
    return TrainConfig(lr=1e-2, steps=40, lr_schedule="cosine", clip_norm=1.0, moment_dtype=f"{fmt}_pallas")


def _grads16(seed, scale):
    rng = np.random.default_rng(seed)
    g = [(scale * rng.normal(size=s)).astype(np.float32) for s in STEP_SHAPES]
    return JParams(*(jnp.asarray(v).astype(BF) for v in g)), DLADMMParams(*(torch.as_tensor(v).bfloat16() for v in g))


@pytest.mark.parametrize("seed", range(6))
def test_bf16_global_norm_is_the_jax_steps(seed):
    """global_norm on bf16 gradients equals the norm inside the JAX
    package's jitted step, bit for bit: optax.global_norm(g).astype(f32)
    under jit (_scalars' expression). The fp32 rule is unchanged (its own
    sums, no rounding to bf16)."""
    import optax

    jg, tg = _grads16(seed, 10.0 ** (seed / 2 - 3))
    want = float(jax.jit(lambda g: optax.global_norm(g).astype(jnp.float32))(jg))
    got = tqa.global_norm(tg)
    assert got.dtype == torch.float32 and float(got) == want
    exact = float(np.sqrt(sum(np.sum(np.square(t.double().numpy())) for t in tg)))
    assert float(tqa.global_norm([t.float() for t in tg])) == pytest.approx(exact, rel=1e-6)


@pytest.mark.parametrize("seed", range(6))
def test_clip_scale_check_tells_the_bf16_norm_from_the_fp32_one(seed):
    """step_checks.clip_scale_diff (the card's check of the prologue's
    bf16 norm) passes the clip scale of the JAX package's jitted norm and
    refuses that of the fp32 path's norm, at a clip of half the norm."""
    from dladmm_tpu_torch.train import step_checks as sc

    _, tg = _grads16(seed, 10.0 ** (seed / 2 - 3))
    clip = 0.5 * float(tqa.global_norm([t.float() for t in tg]))
    count = torch.tensor(1, dtype=torch.int32)
    bf16_scale = float(tqa.step_scalars(tg, count, 1e-3, clip)[0][3])
    fp32_scale = float(tqa.step_scalars([t.float() for t in tg], count, 1e-3, clip)[0][3])
    diff = sc.clip_scale_diff(tg, clip, bf16_scale, f"seed {seed}")
    assert diff["clipped"] and diff["rel"] == 0.0 and diff["fp32_norm_rel"] > 0.0
    with pytest.raises(AssertionError, match="clip scale"):
        sc.clip_scale_diff(tg, clip, fp32_scale, f"seed {seed}")


@pytest.mark.parametrize("fmt", ["int8", "float32"])
def test_step_plain_with_copy_matches_jax(fmt):
    """adam_step_plain on bf16 gradients with the compute copy against
    QAdamFusedPallas.fused_apply(compute_dtype=bfloat16) under jit (the
    JAX training step's), Pallas in interpret mode, 3 chained steps from a
    non-zero state, the first clipped: masters at tests/test_torch_qadam_
    step.py's tolerance (rtol 1e-6, atol 1e-7), the copy equal bit for bit
    to the JAX copy, the clip scale equal to the JAX one (the bf16 norm;
    every step's norm is above the clip); QAdamFused.fused_apply returns
    the copy it wrote in place."""
    jopt = dataclasses.replace(jloop._build_optimizer(_step_cfg(fmt)), interpret=True)
    rng = np.random.default_rng(1)
    leaves = [rng.normal(size=s).astype(np.float32) for s in STEP_SHAPES]
    jp = JParams(*map(jnp.asarray, leaves))
    js = jopt.init(jp)
    jcp = None
    topt = tloop._build_optimizer(_step_cfg(fmt))
    tp = params_from_numpy(*leaves)
    ts = topt.init(tp)
    cp = DLADMMParams(*(torch.empty_like(p, dtype=torch.bfloat16) for p in tp))
    japply = jax.jit(lambda g, s, p: jopt.fused_apply(g, s, p, BF))
    for step in range(3):
        jg, tg = _grads16(10 + step, 3.0 if step == 0 else 0.5)
        want_scal, _ = jax.jit(jopt._scalars)(jg, js)
        jp, js, jcp = japply(jg, js, jp)
        tp, ts, got_cp = topt.fused_apply(tg, ts, tp, torch.bfloat16, cp)
        assert got_cp is cp
        scal, _ = tqa.step_scalars(tg, ts.count - 1, topt.learning_rate, topt.clip_norm)
        assert float(scal[3]) == float(np.asarray(want_scal)[0, 3]) < 1.0
    for name, got, want, c, wc in zip(JParams._fields, tp, jp, cp, jcp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7, err_msg=name)
        assert c.dtype == torch.bfloat16 and torch.equal(c, got.bfloat16()), name
        np.testing.assert_array_equal(_np(c), _np(wc), err_msg=name)


# -- training steps on the persistent bf16 copy ----------------------------------

M, N, K, S = 128, 256, 2, 8  # tests/test_torch_training.py's: W1 (2, 256, 128) is a per-row int8 leaf
LOSSES = {
    # (a) the final-layer loss: trajectory + backward kernels, fp32 dense sweep
    "final": dict(layer_loss=None, moment_dtype="float32_pallas"),
    # (b) the shipped recipe: deep supervision, int8 sweep, clip, cosine
    "deep": dict(layer_loss="uniform", moment_dtype="int8_pallas", clip_norm=1.0, lr_schedule="cosine"),
}


def _train_problem(seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(M, N)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    leaves = [np.asarray(v) + 0.02 * np.abs(np.asarray(v)).mean() * rng.normal(size=v.shape).astype(np.float32)
              for v in j_init(jnp.asarray(A), K=K)]
    batches = []
    for _ in range(5):
        x = ((rng.random((S, N)) < 0.1) * rng.normal(size=(S, N))).astype(np.float32)
        e = ((rng.random((S, M)) < 0.1) * rng.normal(size=(S, M))).astype(np.float32)
        batches.append((x @ A.T + e, x, e))
    return A, leaves, batches


def _steps(loss, nsteps, accum_steps=1):
    """Both packages' bf16 training steps from the same params over the
    same batches: (JAX state, port state, JAX losses, port losses)."""
    t = TrainConfig(lr=3e-3, steps=40, **LOSSES[loss])
    A, leaves, batches = _train_problem()
    need_traj = t.layer_loss is not None
    jopt = dataclasses.replace(jloop._build_optimizer(t), interpret=True)
    jfwd = japi.select_forward(M, N, M, S, need_trajectory=need_traj)[0]
    jstep = jloop.make_train_step_from_batch(jopt, jnp.asarray(A), layer_weights=jloop._layer_weights(t.layer_loss, K, jnp.float32),
                                             forward_fn=jfwd, donate=False, compute_dtype=BF,
                                             accum_steps=accum_steps)
    jstate = jloop.make_train_state(JParams(*map(jnp.asarray, leaves)), jopt, BF)
    topt = tloop._build_optimizer(t)
    tfwd, _, route = tapi.select_forward(M, N, M, S, need_trajectory=need_traj, device="cpu", dtype=torch.bfloat16)
    assert route == ("trajectory-bf16-plain-cpu" if need_traj else "whole-unroll-bf16-plain-cpu")
    tstep = tloop.make_train_step_from_batch(topt, torch.as_tensor(A), layer_weights=tloop._layer_weights(t.layer_loss, K),
                                             forward_fn=tfwd, compute_dtype=torch.bfloat16,
                                             accum_steps=accum_steps)
    tstate = tloop.make_train_state(params_from_numpy(*leaves), topt, torch.bfloat16)
    jl, tl = [], []
    for b, x, e in batches[:nsteps]:
        jstate, loss_j = jstep(jstate, JBatch(*map(jnp.asarray, (b, x, e))))
        tstate, loss_t = tstep(tstate, SyntheticBatch(*map(torch.as_tensor, (b, x, e))))
        jl.append(float(loss_j))
        tl.append(float(loss_t))
    return jstate, tstate, jl, tl


@pytest.mark.parametrize("loss,accum_steps", [("final", 1), ("deep", 1), ("final", 2)])
def test_one_bf16_step_matches_jax(loss, accum_steps):
    """One make_train_step_from_batch(compute_dtype=bf16) step of each
    loss against the JAX package's (also with two microbatches, whose
    bf16 gradients both packages sum in fp32): the loss within rtol 1e-4,
    the fp32 masters within rtol 1e-3 and atol 3e-6 (1e-3 of lr, as
    tests/test_torch_training.py allows an int8 code step; measured
    1.6e-5 on W1 of the final-layer loss, 0 in deep supervision), the
    persistent copy the new masters rounded to bf16 and equal to the JAX
    copy in all but 1% of the elements (a master a last bit apart may
    round the other way), the leaves' dtypes as the JAX package's."""
    jstate, tstate, jl, tl = _steps(loss, 1, accum_steps)
    assert tl[0] == pytest.approx(jl[0], rel=1e-4)
    assert tstate.step == 1 and tstate.compute_params is not None
    for name, g, w, c, wc in zip(JParams._fields, tstate.params, jstate.params, tstate.compute_params,
                                 jstate.compute_params):
        assert g.dtype == torch.float32 and c.dtype == torch.bfloat16, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=3e-6, err_msg=name)
        assert torch.equal(c, g.bfloat16()), name
        assert (_np(c) != _np(wc)).mean() <= 0.01, name


@pytest.mark.parametrize("loss", sorted(LOSSES))
def test_five_bf16_steps_match_jax(loss):
    """Five steps at the JAX package's own tolerance for bf16 training
    (tests/test_training.py: params rtol 0.05, atol 2e-3; loss rtol 1e-2)."""
    jstate, tstate, jl, tl = _steps(loss, 5)
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    for name, g, w in zip(JParams._fields, tstate.params, jstate.params):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0.05, atol=2e-3, err_msg=name)


def test_state_with_a_copy_needs_a_bf16_step():
    """A state that carries the compute copy and a step built without
    compute_dtype raise ValueError (the JAX package's error), for both
    step builders; a bf16 step on a state without the copy casts inside
    the loss (the JAX package's fallback) and keeps no copy."""
    t = TrainConfig(lr=3e-3, **LOSSES["final"])
    A, leaves, batches = _train_problem(seed=2)
    opt = tloop._build_optimizer(t)
    At = torch.as_tensor(A)
    state = tloop.make_train_state(params_from_numpy(*leaves), opt, torch.bfloat16)
    data = SyntheticBatch(*map(torch.as_tensor, batches[0]))
    with pytest.raises(ValueError, match="compute_params"):
        tloop.make_train_step_from_batch(opt, At)(state, data)
    with pytest.raises(ValueError, match="compute_params"):
        tloop.make_train_step(opt, At, batch=8)(state, 0)
    plain = tloop.make_train_state(params_from_numpy(*leaves), opt)
    new, loss = tloop.make_train_step_from_batch(opt, At, compute_dtype=torch.bfloat16)(plain, data)
    assert new.compute_params is None and np.isfinite(float(loss))


def test_fit_bf16_checkpoints_and_resumes(tmp_path):
    """fit with compute_dtype="bfloat16" on the CPU: finite losses and
    NMSE; its checkpoints hold the fp32 masters and no copy, restore into
    a state with compute_params None (an old 3-field checkpoint loads the
    same way), and a resume from the middle ends where the cold run ends,
    value for value (the copy is cast again from the restored masters)."""
    from dladmm_tpu_torch.utils.checkpoint import latest_step_dir, restore_checkpoint

    cfg = get_config("smoke")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype="bfloat16", steps=20,
                                                             eval_every=10, moment_dtype="int8_pallas",
                                                             clip_norm=1.0))
    fwd = tapi.select_forward(32, 64, 32, 16, need_trajectory=True, device="cpu", dtype="bfloat16")[0]
    cold, hist = tloop.fit(cfg, forward_fn=fwd, ckpt_dir=str(tmp_path / "cold"), device="cpu")
    assert [h["step"] for h in hist] == [10, 20]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["nmse_db"]) for h in hist)
    opt = tloop._build_optimizer(cfg.train)
    template = tloop.make_train_state(cold, opt, torch.bfloat16)
    state, A, B = restore_checkpoint(latest_step_dir(str(tmp_path / "cold")), template)
    assert state.compute_params is None and state.step == 20 and B is None
    assert all(torch.equal(a, b) for a, b in zip(state.params, cold))
    half = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, steps=10))
    tloop.fit(half, forward_fn=fwd, ckpt_dir=str(tmp_path / "warm"), device="cpu")
    warm, hist2 = tloop.fit(cfg, forward_fn=fwd, ckpt_dir=str(tmp_path / "warm"), resume=True, device="cpu")
    assert [h["step"] for h in hist2] == [20]
    for a, b in zip(warm, cold):
        assert torch.equal(a, b)


def test_run_cli_takes_bf16_configs_but_not_sharded_ones(capsys):
    """run.py no longer refuses compute_dtype="bfloat16"; the two shipped
    bf16 presets are sharded: tp_large_bf16 is tensor-parallel (not
    ported, ROADMAP.md §1), and multihost needs its 8 ranks (one process
    is refused with the launch line)."""
    from dladmm_tpu_torch import run as trun

    for name in ("tp_large_bf16", "multihost"):
        assert get_config(name).train.compute_dtype == "bfloat16"
        with pytest.raises(SystemExit):
            trun.main([f"--config={name}", "--steps=1"])
        err = capsys.readouterr().err
        assert "is sharded" in err and "compute_dtype" not in err
