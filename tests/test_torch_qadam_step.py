"""The optimizer step as one table of leaves (train/qadam_cuda.adam_step,
ops/csrc/adam_step.cuh, qadam_int8.cu, qadam_dense.cu) on the CPU.

The kernels run only on the card; here the table they read is checked
(every element and every flat-256 block covered once, by the mapping the
kernels use, and vector widths that follow the pointers' alignment), and
the step's plain version ``adam_step_plain`` is held against the JAX
package's ``QAdamFusedPallas.fused_apply`` (Pallas in interpret mode)
over 3 chained steps from a non-zero state, at the leaf shapes of
tests/test_torch_qadam.py: two per-row int8 leaves of L = 128 and three
flat-256 leaves. Tolerances are those of tests/test_torch_qadam.py (int8:
masters rtol 1e-6, codes within one step, scales rtol 1e-6) and
tests/test_torch_qadam_dense.py (masters rtol 1e-6 atol 1e-7; stored
moments equal where the JAX package uses jnp, within 1e-6 of the largest
on the leaf its interpret-mode kernel sweeps, whose XLA contracts an
FMA). The SR formats draw other bits than the JAX package: each stored
moment is a bf16 neighbour of the fp32 moment of the same step, and the
mean over 64 step counts (64 seeds) is unbiased. The prologue's scalars
(``step_scalars``) match ``QAdamFusedPallas._scalars`` within rtol 1e-6,
and the schedule's fp32 operation order written out as the prologue
evaluates it equals the schedule object bit for bit."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dladmm_tpu.models.unroll import DLADMMParams as JParams
from dladmm_tpu.train import loop as jloop
from dladmm_tpu.train import qadam_pallas as jqa
from dladmm_tpu.train.qmoments import QMomentsState as JState
from dladmm_tpu.utils.config import TrainConfig
from dladmm_tpu_torch.models.unroll import DLADMMParams
from dladmm_tpu_torch.train import loop as tloop
from dladmm_tpu_torch.train import qadam_cuda as tqa
from dladmm_tpu_torch.train import qmoments as tqm
from dladmm_tpu_torch.utils.torch_compat import opt_state_from_numpy, params_from_numpy

SHAPES = [(2, 256, 128), (2, 128, 128), (2, 256), (2, 128), (2,)]
FORMATS = ["int8", "float32", "bfloat16", "bfloat16_sr", "bfloat16_sr_mu"]


def _cfg(fmt, **kw):
    kw = {"lr_schedule": "cosine", "clip_norm": 1.0, **kw}
    return TrainConfig(lr=1e-2, steps=40, moment_dtype=f"{fmt}_pallas", **kw)


def _leaves(seed, scale=1.0, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return [(scale * rng.normal(size=s)).astype(np.float32) for s in shapes]


# -- the leaf table -----------------------------------------------------------


def _int8_specs(shapes, ptr_offset=0):
    """(codec, n, rows, L, vec) of each leaf as adam_step builds it, with
    data pointers at 256-byte boundaries plus ``ptr_offset`` bytes on the
    fp32 arrays."""
    specs = []
    for i, shape in enumerate(shapes):
        leaf = torch.zeros(shape)
        n = leaf.numel()
        if tqa.leaf_eligible(leaf):
            codec, L, rows = tqa.CODEC_ROWS, shape[-1], n // shape[-1]
        else:
            codec, L, rows = tqa.CODEC_FLAT, tqm.BLOCK, -(-n // tqm.BLOCK)
        base = 4096 * (i + 1)
        vec = tqa.int8_vec(L, base + ptr_offset, 2 * base + ptr_offset, 3 * base, 5 * base)
        specs.append((codec, n, rows, L, vec))
    return tuple(specs)


def _int8_cover(plan):
    """Run the int8 sweep's mapping (qadam_int8.cu qadam_int8_sweep and
    row_update) over the plan: how often each element of g / master and
    each code of each leaf is touched, and the vector accesses' offsets."""
    elems = [np.zeros(lp.n, np.int64) for lp in plan.leaves]
    codes = [np.zeros((lp.rows, lp.L), np.int64) for lp in plan.leaves]
    starts = [set() for _ in plan.leaves]
    block0 = [lp.block0 for lp in plan.leaves]
    for w in range(plan.blocks):
        i = max(k for k, b in enumerate(block0) if w >= b)
        lp = plan.leaves[i]
        W, V = lp.warps, lp.vec
        G = 32 * W
        for grp in range(8 // W):
            row = (w - lp.block0) * (8 // W) + grp
            if row >= lp.rows:
                continue
            base = row * lp.L
            valid = min(lp.L, lp.n - base)
            for t in range(G):
                for c in range(8 // V):
                    j0 = (c * G + t) * V
                    if j0 >= lp.L:
                        continue
                    starts[i].add(base + j0)
                    for v in range(V):
                        codes[i][row, j0 + v] += 1
                        if j0 + v < valid:
                            elems[i][base + j0 + v] += 1
    return elems, codes, starts


def _chunk_cover(plan):
    """The prologue's norm chunks (adam_step.cuh adam_prologue): how often
    each element of each leaf's g is read."""
    seen = [np.zeros(lp.n, np.int64) for lp in plan.leaves]
    chunk0 = [lp.chunk0 for lp in plan.leaves]
    for c in range(plan.chunks):
        i = max(k for k, b in enumerate(chunk0) if c >= b)
        lp = plan.leaves[i]
        for t in range(256):
            i0 = (c - lp.chunk0) * tqa.CHUNK + 8 * t
            for k in range(8):
                if i0 + k < lp.n:
                    seen[i][i0 + k] += 1
    return seen


@pytest.mark.parametrize("L,vec", [(250, 2), (251, 1), (256, 4)])
def test_table_covers_every_element_once(L, vec):
    """Two per-row leaves of L codes a row (R = 512 and 384) and the three
    flat-256 leaves: every element of g and master once, every code (the
    flat leaves' padding too) once, every flat-256 block a row of its own;
    the vector width follows L and the alignment, and every vector access
    starts on a multiple of it."""
    shapes = [(2, 256, L), (3, 128, L), *SHAPES[2:]]
    plan = tqa.step_plan(_int8_specs(shapes))
    codecs = [lp.codec for lp in plan.leaves]
    assert codecs == [tqa.CODEC_ROWS] * 2 + [tqa.CODEC_FLAT] * 3
    assert [lp.vec for lp in plan.leaves] == [vec, vec, 4, 4, 4]
    assert [lp.warps for lp in plan.leaves] == [1] * 5
    assert [lp.rows for lp in plan.leaves[2:]] == [2, 1, 1]
    elems, codes, starts = _int8_cover(plan)
    for i, (e, c, s) in enumerate(zip(elems, codes, starts)):
        assert (e == 1).all() and (c == 1).all(), (i, e.min(), e.max(), c.min(), c.max())
        assert all(j % plan.leaves[i].vec == 0 for j in s)
    assert all((s == 1).all() for s in _chunk_cover(plan))
    assert plan.norm_blocks == min(plan.chunks, tqa.NORM_BLOCKS)


def test_table_groups_and_alignment_rules():
    """L = 1000 takes 4 warps a row (2 rows a block), L = 2048 eight; a
    misaligned fp32 pointer or code pointer narrows the vector; dense
    leaves take 8 elements a thread only where every pointer is 16-byte
    aligned; more than 8 leaves raise."""
    assert [tqa.int8_warps(L) for L in (128, 250, 256, 257, 512, 1000, 1638, 2048)] == [1, 1, 1, 2, 2, 4, 8, 8]
    assert tqa.int8_vec(1000, 0, 0, 0, 0) == 4
    assert tqa.int8_vec(1000, 8, 0, 0, 0) == 2
    assert tqa.int8_vec(1000, 0, 4, 0, 0) == 1
    assert tqa.int8_vec(1000, 0, 0, 2, 0) == 2
    assert tqa.int8_vec(1000, 0, 0, 0, 1) == 1
    plan = tqa.step_plan(((tqa.CODEC_ROWS, 40 * 1000, 40, 1000, 4),))
    assert plan.leaves[0].warps == 4 and plan.blocks == 20
    elems, codes, _ = _int8_cover(plan)
    assert (elems[0] == 1).all() and (codes[0] == 1).all()
    assert tqa.dense_vec(0, 16, 32, 48) == 8 and tqa.dense_vec(0, 16, 8, 48) == 1
    dense = tqa.step_plan(tuple((tqa.CODEC_DENSE, int(np.prod(s)), 0, 0, 8) for s in SHAPES))
    assert [lp.block0 for lp in dense.leaves] == [0, 32, 48, 49, 50] and dense.blocks == 51
    with pytest.raises(ValueError, match="leaves"):
        tqa.step_plan(((tqa.CODEC_DENSE, 10, 0, 0, 8),) * 9)


def _header_ints(text):
    """The integer constants and enumerators of ops/csrc/adam_step.cuh
    (``kName = a [* or / b ...]``, integers or earlier constants),
    evaluated in order, left to right."""
    import re

    consts = {}
    for name, expr in re.findall(r"\b(k[A-Z]\w*|CODEC_[A-Z]+)\s*=\s*([\w\s*/]+?)\s*[,;}]", text):
        tokens = re.findall(r"\w+|[*/]", expr)
        value = lambda t: consts[t] if t in consts else int(t)  # noqa: E731
        v = value(tokens[0])
        for op, t in zip(tokens[1::2], tokens[2::2]):
            v = v * value(t) if op == "*" else v // value(t)
        consts[name] = v
    return consts


def test_plan_constants_are_the_headers():
    """step_plan and pack_step use the numbers the C side lays the table
    out with (adam_step.cuh: threads, warps and chunk of a work block,
    leaves, norm blocks, codecs and the host arrays' strides)."""
    from dladmm_tpu_torch.ops import cuda_build

    c = _header_ints((cuda_build.CSRC / "adam_step.cuh").read_text())
    assert c["kChunk"] == tqa.CHUNK and c["kMaxLeaves"] == tqa.MAX_LEAVES
    assert c["kMaxNormBlocks"] == tqa.NORM_BLOCKS and c["kBlockWarps"] == tqa.BLOCK_WARPS
    assert (c["CODEC_ROWS"], c["CODEC_FLAT"], c["CODEC_DENSE"]) == (tqa.CODEC_ROWS, tqa.CODEC_FLAT, tqa.CODEC_DENSE)
    plan = tqa.step_plan(_int8_specs(SHAPES))
    ptrs, ints, _ = tqa.pack_step(plan, [0] * c["kPtrHead"], [[0] * c["kPtrLeaf"]] * 5, 0, None, False, 0, [])
    assert len(ptrs) == c["kPtrHead"] + 5 * c["kPtrLeaf"] and len(ints) == c["kIntHead"] + 5 * c["kIntLeaf"]


def test_packed_arrays_follow_the_header_layout():
    """pack_step: 7 pointers a step and 8 a leaf (the last the bf16
    compute copy), 10 ints (the last whether the gradients are bf16) and
    8 a leaf, 13 floats (ops/csrc/adam_step.cuh)."""
    plan = tqa.step_plan(_int8_specs(SHAPES))
    sched = tqa.WarmupCosine(0.0, 1e-2, 2, 40)
    leaf_ptrs = [[100 * i + k for k in range(8)] for i in range(5)]
    for g16 in (False, True):
        ptrs, ints, flts = tqa.pack_step(plan, list(range(7)), leaf_ptrs, 1, sched, True, 0, list(range(13)), g16)
        assert len(ptrs) == 7 + 8 * 5 and ptrs[7:15] == leaf_ptrs[0]
        assert ints[:10] == [5, plan.blocks, plan.chunks, plan.norm_blocks, 1, 2, 38, 1, 0, int(g16)]
        lp = plan.leaves[3]
        assert ints[10 + 8 * 3:10 + 8 * 4] == [lp.codec, lp.n, lp.rows, lp.L, lp.warps, lp.vec, lp.block0, lp.chunk0]
        assert len(flts) == 13


# -- the prologue's scalars ---------------------------------------------------


@pytest.mark.parametrize("clip", [1.0, 0.3, None])
@pytest.mark.parametrize("schedule", [True, False])
def test_scalars_match_jax(clip, schedule):
    """[c1, c2, lr, clip_scale] and the new count against the JAX
    package's _scalars, at counts across the warmup and the decay."""
    cfg = _cfg("int8", lr_schedule="cosine" if schedule else None, clip_norm=clip)
    jopt, topt = jloop._build_optimizer(cfg), tloop._build_optimizer(cfg)
    assert isinstance(topt.learning_rate, tqa.WarmupCosine) == schedule
    for c, scale in ((0, 3.0), (1, 0.05), (2, 1.0), (3, 0.4), (20, 2.0), (39, 0.1), (45, 5.0)):
        g = _leaves(50 + c, scale)
        want, wcount = jopt._scalars(JParams(*map(jnp.asarray, g)), JState(jnp.int32(c), None, None, None))
        got, count = tqa.step_scalars(params_from_numpy(*g), torch.tensor(c, dtype=torch.int32),
                                      topt.learning_rate, topt.clip_norm, topt.b1, topt.b2)
        assert got.dtype == torch.float32 and count.dtype == torch.int32 and int(count) == int(wcount) == c + 1
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(-1), rtol=1e-6, atol=0, err_msg=str(c))


def _f32(x):
    return np.float32(x)


def _kernel_order_lr(s: tqa.WarmupCosine, c: int) -> np.float32:
    """adam_step.cuh cosine_lr written out in numpy float32: its fields
    rounded once to fp32, true divisions, the cosine from PyTorch's."""
    if c < s.warmup_steps:
        frac = _f32(1.0) - _f32(max(c, 0)) / _f32(s.warmup_steps)
        return _f32(s.init_value - s.peak_value) * frac + _f32(s.peak_value)
    t = min(_f32(c - s.warmup_steps), _f32(s.decay))
    arg = _f32(np.pi) * t / _f32(s.decay)
    cos = _f32(torch.cos(torch.tensor(arg, dtype=torch.float32)).item())
    cosine = _f32(0.5) * (_f32(1.0) + cos)
    return _f32(s.peak_value) * (_f32(1.0 - s.alpha) * cosine + _f32(s.alpha))


@pytest.mark.parametrize("steps,end", [(300, 0.0), (10000, 0.0), (40, 1e-3)])
def test_schedule_object_is_the_kernels_operation_order(steps, end):
    """The prologue's order of the warmup-cosine schedule (true divisions,
    fields rounded once to fp32) equals WarmupCosine.__call__ bit for bit
    at counts where the warmup cancels most (the first steps)."""
    s = tloop.warmup_cosine_decay_schedule(0.0, 1e-2, max(1, steps // 20), steps, end)
    assert isinstance(s, tqa.WarmupCosine)
    ws = s.warmup_steps
    for c in sorted({0, 1, 2, ws - 1, ws, ws + 1, steps // 2, steps - 1, steps, steps + 7}):
        got = float(s(torch.tensor(c, dtype=torch.int32)))
        assert np.float32(got) == _kernel_order_lr(s, c), (steps, c)


# -- adam_step_plain against the JAX package ---------------------------------


def _carried(fmt, seed=1):
    """The JAX optimizer, params and a non-zero state after one step, and
    the same carried into the port."""
    jopt = dataclasses.replace(jloop._build_optimizer(_cfg(fmt)), interpret=True)
    jp = JParams(*map(jnp.asarray, _leaves(seed)))
    js = jopt.init(jp)
    jp, js, _ = jopt.fused_apply(JParams(*map(jnp.asarray, _leaves(seed + 1, 0.3))), js, jp)
    return jopt, jp, js, params_from_numpy(*[np.asarray(v) for v in jp]), opt_state_from_numpy(js)


def _step(topt, fmt, grads, params, state):
    count, scal, seeds = tqa.adam_step_plain(grads, params, state.mu, state.nu, state.count, fmt,
                                             topt.learning_rate, topt.clip_norm, topt.b1, topt.b2, topt.eps)
    return tqa.QMomentsState(count, state.mu, state.nu), scal, seeds


@pytest.mark.parametrize("fmt", ["int8", "float32", "bfloat16"])
def test_step_plain_matches_jax_over_three_steps(fmt):
    jopt, jp, js, tp, ts = _carried(fmt)
    topt = tloop._build_optimizer(_cfg(fmt))
    for step in range(3):
        g = _leaves(10 + step, scale=0.5 if step else 3.0)  # step 0 is clipped
        jp, js, _ = jopt.fused_apply(JParams(*map(jnp.asarray, g)), js, jp)
        ts, scal, seeds = _step(topt, fmt, params_from_numpy(*g), tp, ts)
        assert seeds is None and float(scal[3]) < 1.0  # every step's norm is above the clip
    for name, got, want in zip(JParams._fields, tp, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7, err_msg=name)
    want = opt_state_from_numpy(js)
    assert int(ts.count) == int(want.count) == 4
    kernel_leaves = {n for n, v in zip(JParams._fields, jp) if jqa.leaf_eligible(v)}
    for moment in ("mu", "nu"):
        for name, got, w in zip(JParams._fields, getattr(ts, moment), getattr(want, moment)):
            if fmt == "int8":
                assert (got.codes.int() - w.codes.int()).abs().max() <= 1, (moment, name)
                np.testing.assert_allclose(got.scale.numpy(), w.scale.numpy(), rtol=1e-6, err_msg=name)
            elif name in kernel_leaves:
                torch.testing.assert_close(got.float(), w.float(), rtol=0, atol=1e-6 * float(w.float().abs().max()))
            else:
                assert torch.equal(got, w), (moment, name)


def _neighbours(x):
    bits = x.view(torch.int32)
    return (bits & ~0xFFFF).view(torch.float32), ((bits & ~0xFFFF) + 0x10000).view(torch.float32)


@pytest.mark.parametrize("fmt", ["bfloat16_sr", "bfloat16_sr_mu"])
def test_step_plain_sr_formats(fmt):
    """The first step's masters and fp32 nu against the JAX package; then
    3 chained steps, each held against the fp32 step from the same state
    (masters equal: this step's rounding does not reach them) with every
    SR moment a bf16 neighbour of the fp32 moment; the seeds are
    _mix_seed(count, leaf)."""
    jopt, jp, js, tp, ts = _carried(fmt, seed=4)
    topt = tloop._build_optimizer(_cfg(fmt))
    exact = tloop._build_optimizer(_cfg("float32"))
    _, _, sr_mu, sr_nu = tqa.DENSE_FMTS[fmt]
    for step in range(3):
        g = _leaves(30 + step, scale=0.5)
        f32 = tqa.QMomentsState(ts.count, DLADMMParams(*(m.to(torch.float32, copy=True) for m in ts.mu)),
                                DLADMMParams(*(v.to(torch.float32, copy=True) for v in ts.nu)))
        fp = DLADMMParams(*(p.clone() for p in tp))
        f32, _, _ = _step(exact, "float32", params_from_numpy(*g), fp, f32)
        ts, _, seeds = _step(topt, fmt, params_from_numpy(*g), tp, ts)
        assert torch.equal(seeds, tqa._mix_seed(ts.count, torch.arange(5)))
        for a, b in zip(tp, fp):
            assert torch.equal(a, b)
        for moment, sr in (("mu", sr_mu), ("nu", sr_nu)):
            for got, want in zip(getattr(ts, moment), getattr(f32, moment)):
                if sr:
                    lo, hi = _neighbours(want)
                    assert ((got.float() == lo) | (got.float() == hi)).all()
                else:
                    assert torch.equal(got, want)
        if step == 0:
            jp, js, _ = jopt.fused_apply(JParams(*map(jnp.asarray, g)), js, jp)
            for name, got, want in zip(JParams._fields, tp, jp):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7, err_msg=name)
            if fmt == "bfloat16_sr_mu":
                for got, want in zip(ts.nu, js.nu):
                    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_step_plain_sr_is_unbiased_over_step_counts():
    """One bfloat16_sr step from one state at 64 step counts (64 seeds):
    the mean stored moment is the fp32 moment within 5 standard errors
    per value and 4 for the sum (the moments do not depend on the count,
    only their bits' seed does)."""
    _, _, _, tp, ts = _carried("bfloat16_sr", seed=7)
    topt = tloop._build_optimizer(_cfg("bfloat16_sr"))
    g = params_from_numpy(*_leaves(40, scale=0.5))
    exact = tqa.QMomentsState(ts.count, DLADMMParams(*(m.to(torch.float32, copy=True) for m in ts.mu)),
                              DLADMMParams(*(v.to(torch.float32, copy=True) for v in ts.nu)))
    exact, _, _ = _step(tloop._build_optimizer(_cfg("float32")), "float32", g,
                        DLADMMParams(*(p.clone() for p in tp)), exact)
    totals = [torch.zeros(s, dtype=torch.float64) for s in SHAPES]
    for c in range(64):
        st = tqa.QMomentsState(torch.tensor(c, dtype=torch.int32), DLADMMParams(*(m.clone() for m in ts.mu)),
                               DLADMMParams(*(v.clone() for v in ts.nu)))
        st, _, _ = _step(topt, "bfloat16_sr", g, DLADMMParams(*(p.clone() for p in tp)), st)
        for k, m in enumerate(st.mu):
            totals[k] += m.double()
    for total, want in zip(totals, exact.mu):
        lo, hi = _neighbours(want)
        sigma = (hi - lo).double().abs() / 2 / 8
        err = total / 64 - want.double()
        assert (err.abs() <= 5 * sigma + 1e-30).all()
        assert abs(float(err.sum())) <= 4 * float(sigma.pow(2).sum().sqrt()) + 1e-30


# -- fused_apply on the CPU -------------------------------------------------------


def _fused_apply_before(opt, grads, state, params):
    """QAdamFused.fused_apply as it was before the step became one table:
    per-leaf plain sweeps, new flat-256 QTensors."""
    scal, count = tqa.step_scalars(grads, state.count, opt.learning_rate, opt.clip_norm, opt.b1, opt.b2)
    seeds = tqa.step_seeds(count, opt.moment_fmt, len(grads))
    mus, nus = [], []
    for idx, (g, master, mu, nu) in enumerate(zip(grads, params, state.mu, state.nu)):
        if opt.dense:
            tqa.adam_dense_rows_plain(g, master, mu, nu, scal, opt.moment_fmt,
                                      None if seeds is None else seeds[idx], opt.b1, opt.b2, opt.eps)
        elif tqa.leaf_eligible(master):
            L = master.shape[-1]
            tqa.adam_int8_rows_plain(g.reshape(-1, L), master.view(-1, L), mu, nu, scal, opt.b1, opt.b2, opt.eps)
        else:
            mu_f, nu_f, upd = tqa._adam_core(g, tqm.dequantize_q8(mu, master.shape), tqm.dequantize_q8(nu, master.shape),
                                             scal[0], scal[1], scal[3], opt.b1, opt.b2, opt.eps)
            master.copy_(master - scal[2] * upd)
            mu, nu = tqm.quantize_q8(mu_f), tqm.quantize_q8(nu_f)
        mus.append(mu)
        nus.append(nu)
    return params, tqa.QMomentsState(count, DLADMMParams(*mus), DLADMMParams(*nus))


@pytest.mark.parametrize("fmt", FORMATS)
def test_fused_apply_on_the_cpu_returns_what_it_returned(fmt):
    """Two steps of fused_apply equal the per-leaf path it replaced, value
    for value; the flat leaves are now updated in place (the same
    QTensors); the input count is left as it was; nothing launches."""
    _, _, _, tp, ts = _carried(fmt, seed=9)
    opt = tloop._build_optimizer(_cfg(fmt))
    ref_p = DLADMMParams(*(p.clone() for p in tp))
    clone = (lambda q: tqm.QTensor(q.codes.clone(), q.scale.clone())) if fmt == "int8" else (lambda q: q.clone())
    ref_s = tqa.QMomentsState(ts.count.clone(), DLADMMParams(*map(clone, ts.mu)), DLADMMParams(*map(clone, ts.nu)))
    launches = tqa.adam_step.launches
    for step in range(2):
        g = params_from_numpy(*_leaves(60 + step, scale=2.0 if step == 0 else 0.3))
        count0 = ts.count.clone()
        ids = [id(q) for q in ts.mu]
        tp, ts2, cp = opt.fused_apply(g, ts, tp)
        assert cp is None
        assert torch.equal(ts.count, count0) and int(ts2.count) == int(count0) + 1
        assert [id(q) for q in ts2.mu] == ids
        ts = ts2
        ref_p, ref_s = _fused_apply_before(opt, g, ref_s, ref_p)
    assert tqa.adam_step.launches == launches
    for a, b in zip(tp, ref_p):
        assert torch.equal(a, b)
    assert torch.equal(ts.count, ref_s.count)
    for moment in ("mu", "nu"):
        for a, b in zip(getattr(ts, moment), getattr(ref_s, moment)):
            if fmt == "int8":
                assert torch.equal(a.codes, b.codes) and torch.equal(a.scale, b.scale)
            else:
                assert torch.equal(a, b)


def test_adam_step_on_the_cpu_is_its_plain_version():
    """adam_step on CPU tensors runs adam_step_plain (no launch): the same
    writes and results, with a constant rate and a plain callable."""
    for lr in (1e-3, lambda c: 1e-3 * (c.to(torch.float32) + 1)):
        runs = []
        for fn in (tqa.adam_step, tqa.adam_step_plain):
            _, _, _, tp, ts = _carried("int8", seed=11)
            out = fn(params_from_numpy(*_leaves(70)), tp, ts.mu, ts.nu, ts.count, "int8", lr, 1.0)
            runs.append((tp, ts, out))
        (p1, s1, o1), (p2, s2, o2) = runs
        assert all(torch.equal(a, b) for a, b in zip(p1, p2))
        assert torch.equal(o1[0], o2[0]) and torch.equal(o1[1], o2[1])
        for a, b in zip(s1.mu, s2.mu):
            assert torch.equal(a.codes, b.codes) and torch.equal(a.scale, b.scale)
