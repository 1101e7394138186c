"""Port parity for the optimizers: the int8 codecs (train/qmoments.py,
train/qadam_cuda.py), the fused int8 Adam sweep, the learning-rate
schedule and fp32 Adam with both clips (train/loop.py).

On the CPU the sweep's wrapper runs its plain version; it is held
against the JAX package's ``QAdamFusedPallas(moment_fmt="int8")
.fused_apply`` with its Pallas kernel in interpret mode, over 3 chained
steps from a non-zero state carried across by
``utils.torch_compat.opt_state_from_numpy``. Leaves: W1 (2, 256, 128),
the smallest the codec rule sends to the per-row kernel, and flat-codec
leaves for the rest. Masters within rtol 1e-6; codes within one step;
scales within rtol 1e-6. The CUDA kernel itself is held against the
plain version by tests/test_torch_cuda.py (``gpu``) and chip_smoke.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dladmm_tpu.models.unroll import DLADMMParams as JParams
from dladmm_tpu.train import loop as jloop
from dladmm_tpu.train import qadam_pallas as jqa
from dladmm_tpu.train import qmoments as jqm
from dladmm_tpu.utils.config import TrainConfig
from dladmm_tpu_torch.models.unroll import DLADMMParams
from dladmm_tpu_torch.train import loop as tloop
from dladmm_tpu_torch.train import qadam_cuda as tqa
from dladmm_tpu_torch.train import qmoments as tqm
from dladmm_tpu_torch.utils.torch_compat import opt_state_from_numpy, params_from_numpy

SHAPES = [(2, 256, 128), (2, 128, 128), (2, 256), (2, 128), (2,)]
CFG = TrainConfig(lr=1e-2, steps=40, lr_schedule="cosine", clip_norm=1.0, moment_dtype="int8_pallas")


def _leaves(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.normal(size=s)).astype(np.float32) for s in SHAPES]


def _t(state) -> DLADMMParams:
    return params_from_numpy(*state)


def test_q8_codecs_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 300)).astype(np.float32)
    x[1] = 0.0  # a zero block takes scale 1.0
    x[0, :5] = [1e-9, -1e-9, 0.5, -0.5, 0.0]
    jq, tq = jqm.quantize_q8(jnp.asarray(x)), tqm.quantize_q8(torch.as_tensor(x))
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_array_equal(
        tqm.dequantize_q8(tq, x.shape).numpy(), np.asarray(jqm.dequantize_q8(jq, x.shape))
    )
    rows = rng.normal(size=(200, 130)).astype(np.float32) * rng.uniform(0, 3, size=(200, 1)).astype(np.float32)
    rows[7] = 0.0
    jr, tr = jqa.quantize_rows(jnp.asarray(rows)), tqa.quantize_rows(torch.as_tensor(rows))
    np.testing.assert_array_equal(tr.codes.numpy(), np.asarray(jr.codes))
    np.testing.assert_array_equal(tr.scale.numpy(), np.asarray(jr.scale).reshape(-1)[:200])
    assert tr.scale[7].item() == 1.0
    np.testing.assert_array_equal(tqa.dequantize_rows(tr).numpy(), np.asarray(jqa.dequantize_rows(jr)))


def test_leaf_rule_matches_jax():
    for shape in [(2, 256, 128), (2, 128, 128), (15, 500, 250), (15, 250, 250), (20, 2000, 1000),
                  (2, 256), (15,), (200, 2000), (1024, 127)]:
        leaf = np.zeros(shape, np.float32)
        assert tqa.leaf_eligible(torch.as_tensor(leaf)) == jqa.leaf_eligible(jnp.asarray(leaf)), shape


def _carried_state(seed=1):
    """A JAX optimizer, params and a non-zero int8 state after one step,
    and the same carried into the port."""
    jopt = dataclasses.replace(jloop._build_optimizer(CFG), interpret=True)
    jp = JParams(*map(jnp.asarray, _leaves(seed)))
    js = jopt.init(jp)
    jp, js, _ = jopt.fused_apply(JParams(*map(jnp.asarray, _leaves(seed + 1, 0.3))), js, jp)
    tp = _t([np.asarray(v) for v in jp])
    ts = opt_state_from_numpy(js)
    return jopt, jp, js, tp, ts


def _assert_state_close(tp, ts, jp, js):
    for name, g, w in zip(JParams._fields, tp, jp):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7, err_msg=name)
    assert int(ts.count) == int(js.count)
    want = opt_state_from_numpy(js)
    for moment in ("mu", "nu"):
        for name, g, w in zip(JParams._fields, getattr(ts, moment), getattr(want, moment)):
            assert g.codes.shape == w.codes.shape and g.scale.shape == w.scale.shape, name
            diff = (g.codes.to(torch.int32) - w.codes.to(torch.int32)).abs().max().item()
            assert diff <= 1, (moment, name, diff)
            np.testing.assert_allclose(g.scale.numpy(), w.scale.numpy(), rtol=1e-6, err_msg=name)


def test_fused_sweep_matches_jax_over_three_steps():
    jopt, jp, js, tp, ts = _carried_state()
    topt = tloop._build_optimizer(CFG)
    assert isinstance(topt, tqa.QAdamFused) and topt.clip_norm == 1.0
    for step in range(3):
        g = _leaves(10 + step, scale=0.5 if step else 3.0)  # step 0 is clipped
        jp, js, _ = jopt.fused_apply(JParams(*map(jnp.asarray, g)), js, jp)
        tp, ts, cp = topt.fused_apply(_t(g), ts, tp)
        assert cp is None
    _assert_state_close(tp, ts, jp, js)


def test_rows_sweep_plain_is_in_place_and_matches_update():
    """adam_int8_rows (the CPU path: its plain version) writes master
    and moments in place; QAdamFused.update computes the same step
    functionally, as the JAX package's update."""
    jopt, jp, js, tp, ts = _carried_state(seed=3)
    topt = tloop._build_optimizer(CFG)
    g = _leaves(20, 0.2)
    jup, js2 = jopt.update(JParams(*map(jnp.asarray, g)), js, jp)
    tup, ts2 = topt.update(_t(g), ts, tp)
    for name, a, b in zip(JParams._fields, tup, jup):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9, err_msg=name)
    _assert_state_close(_t([np.asarray(v) for v in jp]), ts2, jp, js2)
    master, mu = tp.W1.view(-1, 128), ts.mu.W1
    before, codes_ptr = master.clone(), mu.codes.data_ptr()
    scal = torch.tensor([0.1, 0.01, 1e-3, 1.0])
    tqa.adam_int8_rows(torch.as_tensor(g[0]).reshape(-1, 128), master, mu, ts.nu.W1, scal)
    assert mu.codes.data_ptr() == codes_ptr and not torch.equal(master, before)
    assert tqa.adam_int8_rows.launches == 0


def test_lr_schedule_matches_optax():
    for steps in (40, 10000, 7):
        t = dataclasses.replace(CFG, steps=steps)
        jf, tf = jloop._lr_of(t), tloop._lr_of(t)
        ws = max(1, steps // 20)
        for c in sorted({0, 1, ws - 1, ws, ws + 1, steps // 2, steps - 1, steps, steps + 5}):
            want = float(jf(jnp.asarray(c, jnp.int32)))
            got = float(tf(torch.tensor(c, dtype=torch.int32)))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), (steps, c)
    assert tloop._lr_of(dataclasses.replace(CFG, lr_schedule=None)) == CFG.lr


@pytest.mark.parametrize("clip_mode", ["global", "delayed", None])
def test_fp32_adam_and_clips_match_optax(clip_mode):
    """moment_dtype float32: Adam + clip_by_global_norm / the delayed
    clip / no clip against the JAX package's optax chain, 3 steps."""
    t = dataclasses.replace(CFG, moment_dtype="float32", clip_mode=clip_mode or "global",
                            clip_norm=None if clip_mode is None else 1.0)
    jopt, topt = jloop._build_optimizer(t), tloop._build_optimizer(t)
    jp = JParams(*map(jnp.asarray, _leaves(5)))
    tp = _t(_leaves(5))
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = _leaves(30 + step, scale=2.0 if step == 1 else 0.1)
        jup, js = jopt.update(JParams(*map(jnp.asarray, g)), js, jp)
        jp = optax.apply_updates(jp, jup)
        tup, ts = topt.update(_t(g), ts, tp)
        tp = tloop.apply_updates(tp, tup)
    for name, a, b in zip(JParams._fields, tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7, err_msg=name)


def test_unported_formats_raise():
    """The dense fused formats build the fused optimizer; the XLA-side
    formats (no ``_pallas``) now build the clip chained before
    adam_qmoments (train/qmoments.py) and take a step, its moments in
    their storage format; bad settings still raise."""
    for md in ("bfloat16_pallas", "float32_pallas", "bfloat16_sr_pallas", "bfloat16_sr_mu_pallas"):
        opt = tloop._build_optimizer(dataclasses.replace(CFG, moment_dtype=md))
        assert isinstance(opt, tqa.QAdamFused) and opt.moment_fmt == md[: -len("_pallas")]
    p = _t(_leaves(5))
    for md in ("int8", "bfloat16", "bfloat16_sr"):
        opt = tloop._build_optimizer(dataclasses.replace(CFG, moment_dtype=md))
        assert not isinstance(opt, tqa.QAdamFused)
        updates, state = opt.update(_t(_leaves(6)), opt.init(p), p)
        qstate = state[1][0]
        assert isinstance(qstate, tqm.QMomentsState) and int(qstate.count) == 1
        assert isinstance(qstate.mu.W1, tqm.QTensor) if md == "int8" else qstate.mu.W1.dtype == torch.bfloat16
        assert all(bool(torch.isfinite(u).all()) for u in updates)  # step 0 of the warmup: lr 0
    with pytest.raises(ValueError, match="clip_mode"):
        tloop._build_optimizer(dataclasses.replace(CFG, clip_mode="delayed"))
    with pytest.raises(ValueError, match="moment_fmt"):
        tqa.QAdamFused(1e-3, moment_fmt="int4")
