"""Port parity for the per-layer fused step (ops/cuda_layer.py) on the
CPU, where its wrapper runs the plain version: the forward through
``dladmm_forward(step_fn=...)`` against the JAX package's
``make_fused_step`` (Pallas ``_layer_kernel`` in interpret mode) over
tests/test_pallas.py's fast shapes at its rtol 1e-5, with its atol 1e-6
scaled by max(1, max|ref|): that test holds two JAX computations with
the same dots, where here two libraries sum the 256-deep products in
different orders, and at (128, 256, 8) each package's fp32 forward is
2.5-6.9e-6 from the fp64 one on outputs of magnitude 4-6 (measured);
gradients against ``jax.grad`` at its rtol 1e-4 / atol 1e-6; the
bf16-operand mode; the general-B fallback; and a training step through
the step. The CUDA kernel itself is held against the plain version by
tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dladmm_tpu.models.unroll import DLADMMParams as JParams
from dladmm_tpu.models.unroll import dladmm_forward as j_forward
from dladmm_tpu.models.unroll import init_dladmm_params as j_init
from dladmm_tpu.ops.pallas_layer import make_fused_step as j_make_fused_step
from dladmm_tpu_torch.models.api import select_forward
from dladmm_tpu_torch.models.unroll import DLADMMParams, dladmm_forward
from dladmm_tpu_torch.ops import cuda_layer, cuda_unroll
from dladmm_tpu_torch.utils.torch_compat import params_from_numpy


def _setup(m, n, S, K=4, seed=0):
    """Numpy A, b, x*, e* and perturbed LADMM-exact params (the
    tests/test_pallas.py recipe, drawn with numpy)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    x_star = ((rng.random((S, n)) < 0.1) * rng.normal(size=(S, n))).astype(np.float32)
    e_star = ((rng.random((S, m)) < 0.1) * rng.normal(size=(S, m))).astype(np.float32)
    b = (x_star @ A.T + e_star).astype(np.float32)
    p0 = j_init(jnp.asarray(A), K=K)
    leaves = [np.asarray(v) + 0.05 * rng.normal(size=v.shape).astype(np.float32) for v in p0]
    return A, b, x_star, e_star, leaves


def _jax(A, b, leaves):
    return jnp.asarray(A), jnp.asarray(b), JParams(*map(jnp.asarray, leaves))


def _torch(A, b, leaves):
    return torch.as_tensor(A), torch.as_tensor(b), params_from_numpy(*leaves)


@pytest.mark.parametrize("m,n,S", [(16, 32, 8), (33, 77, 13), (128, 256, 8)])
def test_fused_forward_matches_jax(m, n, S):
    A, b, _, _, leaves = _setup(m, n, S)
    jA, jb, jp = _jax(A, b, leaves)
    want = j_forward(jp, jA, jb, step_fn=j_make_fused_step(block_s=16))
    tA, tb, tp = _torch(A, b, leaves)
    got = dladmm_forward(tp, tA, tb, step_fn=cuda_layer.fused_layer_step)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6 * max(1.0, np.abs(w).max()))
    assert cuda_layer.layer_step.launches == 0  # the CPU runs no kernel


def test_fused_grads_match_jax():
    """Autograd through the step's Function (its backward recomputes the
    plain step) against jax.grad through make_fused_step's custom VJP,
    every parameter leaf, at (24, 48, 16)."""
    A, b, x_star, e_star, leaves = _setup(24, 48, 16)
    jA, jb, jp = _jax(A, b, leaves)

    def jloss(p):
        x, z, _ = j_forward(p, jA, jb, step_fn=j_make_fused_step(block_s=8))
        return jnp.mean((x - x_star) ** 2) + jnp.mean((z - e_star) ** 2)

    want = jax.grad(jloss)(jp)
    tA, tb, tp = _torch(A, b, leaves)
    tp = DLADMMParams(*(t.requires_grad_() for t in tp))
    x, z, _ = dladmm_forward(tp, tA, tb, step_fn=cuda_layer.fused_layer_step)
    loss = torch.mean((x - torch.as_tensor(x_star)) ** 2) + torch.mean((z - torch.as_tensor(e_star)) ** 2)
    got = torch.autograd.grad(loss, list(tp))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)


def test_bf16_operand_mode():
    """matmul_dtype=torch.bfloat16 within 5% relative Frobenius error of
    the fp32 forward (tests/test_pallas.py:85), and close to the JAX
    package's bf16 mode (both round the same operands; sums in another
    order can round one operand to the neighbouring bf16 value)."""
    A, b, _, _, leaves = _setup(64, 128, 32)
    tA, tb, tp = _torch(A, b, leaves)
    got = dladmm_forward(tp, tA, tb, step_fn=cuda_layer.make_fused_step(matmul_dtype=torch.bfloat16))
    fp32 = dladmm_forward(tp, tA, tb)
    jA, jb, jp = _jax(A, b, leaves)
    jbf = j_forward(jp, jA, jb, step_fn=j_make_fused_step(block_s=16, matmul_dtype=jnp.bfloat16))
    for g, w, j in zip(got, fp32, jbf):
        assert float((g - w).norm() / (w.norm() + 1e-9)) < 0.05
        assert not torch.equal(g, w)  # the operands really were rounded
        j = torch.as_tensor(np.array(j))
        assert float((g - j).norm() / (j.norm() + 1e-9)) < 1e-2


def test_general_b_and_validation():
    """A general B goes to the plain step; bf16 state runs (K bf16 steps
    equal the bf16-storage whole unroll's plain version, bit for bit:
    both store the state rounded after each layer; its values are held
    against the JAX package in tests/test_torch_bf16_serve.py), while a
    state whose type differs from the weights' and other operand types
    raise; auto_fused_step is the fp32 step at every shape and block_s
    changes nothing."""
    A, b, _, _, leaves = _setup(16, 32, 8, K=3)
    tA, tb, _ = _torch(A, b, leaves)
    rng = np.random.default_rng(1)
    B = torch.as_tensor(rng.normal(size=(16, 24)).astype(np.float32))
    from dladmm_tpu_torch.models.unroll import init_dladmm_params

    p = init_dladmm_params(tA, B, K=3)
    for g, w in zip(dladmm_forward(p, tA, tb, B=B, step_fn=cuda_layer.fused_layer_step),
                    dladmm_forward(p, tA, tb, B=B)):
        assert torch.equal(g, w)
    tp = params_from_numpy(*leaves)
    p16 = DLADMMParams(*(t.to(torch.bfloat16) for t in tp))
    got = dladmm_forward(p16, tA.bfloat16(), tb.bfloat16(), step_fn=cuda_layer.fused_layer_step)
    want = cuda_unroll.unroll_forward_plain_bf16(tb.bfloat16(), tA.bfloat16(), *p16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)
    with pytest.raises(TypeError, match="the kernel takes"):
        dladmm_forward(tp, tA.bfloat16(), tb.bfloat16(), step_fn=cuda_layer.fused_layer_step)
    with pytest.raises(TypeError, match="the kernel takes"):
        dladmm_forward(tp, tA.double(), tb.double(), step_fn=cuda_layer.fused_layer_step)
    with pytest.raises(ValueError, match="matmul_dtype"):
        cuda_layer.make_fused_step(matmul_dtype=torch.float16)
    want = dladmm_forward(tp, tA, tb)
    for step in (cuda_layer.auto_fused_step(8192, 16384, 8192), cuda_layer.make_fused_step(block_s=3)):
        for g, w in zip(dladmm_forward(tp, tA, tb, step_fn=step), want):
            assert torch.equal(g, w)


def test_layer_step_writes_fresh_buffers_and_refuses_a_device_mix():
    """The step returns new tensors and leaves its inputs as they were
    (autograd keeps them for the backward); a CPU/CUDA mix is refused
    before either version runs."""
    A, b, _, _, leaves = _setup(16, 32, 8, K=1)
    tA, tb, tp = _torch(A, b, leaves)
    rng = np.random.default_rng(2)
    state = [torch.as_tensor(rng.normal(size=s).astype(np.float32)) for s in ((8, 32), (8, 16), (8, 16), (8, 16))]
    before = [t.clone() for t in state]
    args = (tb, tA, *state, tp.W1[0], tp.W2[0], tp.theta1[0], tp.theta2[0], tp.beta[:1])
    out = cuda_layer.layer_step(*args)
    for t, t0 in zip(state, before):
        assert torch.equal(t, t0)
    assert not any(o.data_ptr() == t.data_ptr() for o in out for t in (*state, tb))
    for o, w in zip(out, cuda_layer.layer_step_plain(*args)):
        assert torch.equal(o, w)
    with pytest.raises(ValueError, match="is on"):
        cuda_layer.layer_step(tb, tA.to("meta"), *args[2:])


def test_train_step_through_the_fused_step():
    """make_train_step(step_fn=fused_layer_step) (final-layer loss) takes
    the same two steps as autograd through the plain loop
    (vjp="xla"): losses and parameters within rtol 1e-6."""
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.train.loop import _build_optimizer, make_train_state, make_train_step
    from dladmm_tpu_torch.utils.config import TrainConfig

    A, _, _, _, _ = _setup(16, 32, 8)
    tA = torch.as_tensor(A)
    opt = _build_optimizer(TrainConfig(lr=1e-2, steps=2, layer_loss=None))
    runs = []
    for kw in (dict(step_fn=cuda_layer.fused_layer_step), dict(vjp="xla")):
        state = make_train_state(init_dladmm_params(tA, K=3), opt)
        step = make_train_step(opt, tA, batch=8, **kw)
        losses = []
        for i in range(2):
            state, loss = step(state, i)
            losses.append(float(loss))
        runs.append((losses, state.params))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-6)
    for g, w in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


def test_select_forward_never_takes_the_per_layer_rung():
    """synthetic_small at S = 3000 (no TPU tile divides it, so the JAX
    policy took the per-layer kernel there) stays on the whole-unroll
    kernel: it runs at every S."""
    assert select_forward(250, 500, 250, 3000, device="cuda")[2] == "cuda-whole-unroll-kernel"
    assert select_forward(250, 500, 250, 3000, device="cpu")[2] == "whole-unroll-plain-cpu"
