"""Checks of the optimizer step (``qadam_cuda.adam_step``) against its
one-leaf sweeps and its plain version, shared by the card tests
(tests/test_torch_cuda.py) and ``chip_smoke.py``.

The step is checked from a state and three gradient sets made here
(``step_state``): the step's state after it must equal the one-leaf
sweeps' run with the step's own scalars and seeds (``one_leaf_step``,
bit for bit where both run a kernel), and the plain version's step from
the state before it (``plain_step_diff``): masters within rtol 1e-6, int8
codes within one step and scales within rtol 1e-6, round-to-nearest
moments equal, SR moments a bf16 neighbour of the plain fp32 moment.
"""

from __future__ import annotations

import torch
from torch import Tensor

from dladmm_tpu_torch.models.unroll import DLADMMParams
from dladmm_tpu_torch.train import qadam_cuda as tqa
from dladmm_tpu_torch.train.qmoments import QTensor, quantize_q8

LEAF_NAMES = DLADMMParams._fields  # W1, W2, theta1, theta2, beta


def preset_shapes(m: int, n: int, K: int):
    """The five leaves of a preset: W1 (K, n, m), W2 (K, m, m), theta1
    (K, n), theta2 (K, m), beta (K,)."""
    return [(K, n, m), (K, m, m), (K, n), (K, m), (K,)]


def step_state(shapes, fmt: str, seed: int, device):
    """Masters, non-zero moments in the format (int8 in each leaf's codec)
    and 3 gradient sets whose norms are 3.0, 0.3 and 2.0: the first and
    last above a clip of 1.0, the middle below it."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(shape, scale):
        return scale * torch.randn(shape, generator=g, device=device)

    def moment(x, which):
        if fmt != "int8":
            return x.to(tqa.DENSE_FMTS[fmt][which])
        return tqa.quantize_rows(x.reshape(-1, x.shape[-1])) if tqa.leaf_eligible(x) else quantize_q8(x)

    params = DLADMMParams(*(rand(s, 0.05) for s in shapes))
    mu = DLADMMParams(*(moment(rand(s, 1e-2), 0) for s in shapes))
    nu = DLADMMParams(*(moment(rand(s, 3e-2) ** 2, 1) for s in shapes))
    total = sum(torch.Size(s).numel() for s in shapes)
    grads = [DLADMMParams(*(rand(s, scale / total ** 0.5) for s in shapes)) for scale in (3.0, 0.3, 2.0)]
    return params, mu, nu, grads


def clone_tree(tree):
    return DLADMMParams(*(QTensor(q.codes.clone(), q.scale.clone()) if hasattr(q, "codes") else q.clone()
                          for q in tree))


def clone_state(params, mu, nu):
    """Copies of masters and moments (int8 codes and scales too)."""
    return clone_tree(params), clone_tree(mu), clone_tree(nu)


def one_leaf_step(fmt: str, grads, params, mu, nu, scal, seeds) -> None:
    """The step leaf by leaf with given scalars and seeds, in place: the
    one-leaf launches (adam_dense_rows; adam_int8_rows on the per-row
    leaves) and adam_flat_plain on the flat-256 leaves."""
    for idx, (g, p, m, v) in enumerate(zip(grads, params, mu, nu)):
        if fmt != "int8":
            tqa.adam_dense_rows(g, p, m, v, scal, fmt, None if seeds is None else seeds[idx:idx + 1])
        elif tqa.leaf_eligible(p):
            L = p.shape[-1]
            tqa.adam_int8_rows(g.reshape(-1, L), p.view(-1, L), m, v, scal)
        else:
            tqa.adam_flat_plain(g, p, m, v, scal)


def scal_ulps(a: Tensor, b: Tensor) -> int:
    """The largest distance in fp32 ulps between two fp32 tensors."""
    ai, bi = a.contiguous().view(torch.int32).long(), b.contiguous().view(torch.int32).long()
    return int((ai - bi).abs().max())


def bf16_neighbours(x: Tensor):
    """The two bf16 values around each fp32 value, as fp32: truncated
    toward zero, and one bf16 step away from zero."""
    bits = x.contiguous().view(torch.int32)
    lo = bits & ~0xFFFF
    return lo.view(torch.float32), (lo + 0x10000).view(torch.float32)


def moment_diff(fmt: str, got, want) -> dict:
    """int8: the largest code difference and relative scale difference;
    dense: the count of stored values that differ."""
    if fmt == "int8":
        return {"max_code_diff": max(int((a.codes.int() - b.codes.int()).abs().max()) for a, b in zip(got, want)),
                "max_scale_rel_diff": max(float(((a.scale - b.scale).abs() / b.scale.abs()).max())
                                          for a, b in zip(got, want))}
    return {"values_differing": sum(int((a != b).sum()) for a, b in zip(got, want))}


def moments_agree(fmt: str, diff: dict, exact: bool) -> bool:
    """Whether a moment_diff passes: dense moments equal; int8 codes and
    scales equal where ``exact``, else codes within one step and scales
    within rtol 1e-6."""
    if fmt != "int8":
        return diff["values_differing"] == 0
    return diff["max_code_diff"] <= (0 if exact else 1) and diff["max_scale_rel_diff"] <= (0 if exact else 1e-6)


def same_state(a, b) -> bool:
    """Masters and moments (int8 codes and scales) equal bit for bit."""
    pairs = [(x, y) for ta, tb in zip(a, b) for x, y in zip(ta, tb)]
    return all(torch.equal(x.codes, y.codes) and torch.equal(x.scale, y.scale) if hasattr(x, "codes")
               else torch.equal(x, y) for x, y in pairs)


def check_against_one_leaf(fmt: str, post, one, label: str) -> None:
    """The step's state ``post`` against the one-leaf sweeps' run ``one``
    from the same state with the step's scalars: masters and moments
    bit for bit, SR too; the flat int8 leaves, which the one-leaf path
    sweeps with the plain version, within one code step. Raises
    AssertionError on a miss."""
    if not all(torch.equal(a, b) for a, b in zip(post[0], one[0])):
        raise AssertionError(f"{label}: masters differ from the one-leaf sweeps")
    for mname, got, want in (("mu", post[1], one[1]), ("nu", post[2], one[2])):
        for name, master, a, b in zip(LEAF_NAMES, post[0], got, want):
            d = moment_diff(fmt, [a], [b])
            if not moments_agree(fmt, d, exact=fmt != "int8" or tqa.leaf_eligible(master)):
                raise AssertionError(f"{label} {mname} {name}: {d} from the one-leaf sweeps")


def _f32(x) -> Tensor:
    return torch.tensor(x, dtype=torch.float64).to(torch.float32)


def _prologue_scale(norm: Tensor, clip: float) -> float:
    """The prologue's clip scale of an fp32 norm (a CPU scalar): the
    fp32 reciprocal of max(norm, 1e-16) times the clip, at most 1."""
    q = torch.reciprocal(torch.clamp(norm, min=1e-16)) * _f32(clip)
    return min(float(q), 1.0)


def clip_scale_diff(grads, clip: float, got: float, label: str) -> dict:
    """The step's clip scale ``got`` on bf16 gradients against the
    prologue's own rule (adam_step.cuh ``bf16_norm``), computed apart:
    each leaf's sum of squares in fp64, rounded to fp32 and then to bf16,
    those added in bf16 in leaf order, the fp32 square root of that
    total. Equal; where a leaf's sum lies within 2^-30 of a rounding
    boundary (the kernel's fp64 order may round it the other way) within
    2^-7: that leaf one bf16 step off moves the total by at most one bf16
    step of it, its rounding by one more, the norm by half of both. The
    control: where the step clips, the scale of the fp32 path's norm (the
    exact fp64 sum's root) must differ from the rule's, so the check
    tells the two rules apart. Raises AssertionError on a miss; returns
    the relative differences."""
    exact, norm2, near = 0.0, None, False
    for t in grads:
        s = float(torch.sum(torch.square(t.double())))
        exact += s
        leaf, lo, hi = (_f32(v).to(torch.bfloat16).to(torch.float32)
                        for v in (s, s * (1 - 2.0 ** -30), s * (1 + 2.0 ** -30)))
        near = near or not (torch.equal(leaf, lo) and torch.equal(leaf, hi))
        norm2 = leaf if norm2 is None else (norm2 + leaf).to(torch.bfloat16).to(torch.float32)
    rule = _prologue_scale(torch.sqrt(norm2), clip)
    control = _prologue_scale(_f32(exact ** 0.5), clip)
    limit = 2.0 ** -7 if near else 0.0
    rel, ctrl = abs(got - rule) / rule, abs(control - rule) / rule
    if not rel <= limit:
        raise AssertionError(f"{label}: clip scale {got} vs the bf16 norm's {rule} ({rel} relative > {limit})")
    if rule < 1.0 and ctrl == 0.0:
        raise AssertionError(f"{label}: the fp32 norm's clip scale {control} equals the bf16 norm's; "
                             "the check cannot tell the two apart")
    return {"rel": rel, "fp32_norm_rel": ctrl, "near_boundary": near, "clipped": rule < 1.0}


def plain_step_diff(fmt: str, grads, pre, post, scal, seeds, label: str = "step") -> dict:
    """The plain version's step from the state before it (``pre``) with
    the step's scalars and seeds, held against the step's state after it
    (``post``): masters within rtol 1e-6 (atol 1e-9); int8 codes within
    one step and scales within rtol 1e-6; round-to-nearest moments equal;
    SR moments a bf16 neighbour of the plain fp32 moment (other bits than
    the kernel's, by design). Raises AssertionError on a miss; returns the
    differences."""
    params, mu, nu = clone_state(*pre)
    _, _, sr_mu, sr_nu = tqa.DENSE_FMTS.get(fmt, (None, None, False, False))
    if sr_mu or sr_nu:
        mu = [m.to(torch.float32, copy=True) for m in mu]
        nu = [v.to(torch.float32, copy=True) for v in nu]
    for idx, (g, p, m, v) in enumerate(zip(grads, params, mu, nu)):
        if fmt == "int8" and tqa.leaf_eligible(p):
            L = p.shape[-1]
            tqa.adam_int8_rows_plain(g.reshape(-1, L), p.view(-1, L), m, v, scal)
        elif fmt == "int8":
            tqa.adam_flat_plain(g, p, m, v, scal)
        else:
            tqa.adam_dense_rows_plain(g, p, m, v, scal, "float32" if sr_mu or sr_nu else fmt,
                                      None if seeds is None else seeds[idx])
    err = max(float((a - b).abs().max()) for a, b in zip(post[0], params))
    if not all(bool((a - b).abs().le(1e-6 * b.abs() + 1e-9).all()) for a, b in zip(post[0], params)):
        raise AssertionError(f"{label} {fmt}: masters max|diff| {err} from the plain version")
    out = {"master_max_abs_err": err}
    for mname, got, want, sr in (("mu", post[1], mu, sr_mu), ("nu", post[2], nu, sr_nu)):
        if sr:
            ok = True
            for a, b in zip(got, want):
                lo, hi = bf16_neighbours(b)
                ok = ok and bool(((a.float() == lo) | (a.float() == hi)).all())
            d = {"bf16_neighbours": ok}
        else:
            d = moment_diff(fmt, got, want)
            ok = moments_agree(fmt, d, exact=False)
        if not ok:
            raise AssertionError(f"{label} {fmt} {mname}: {d} from the plain version")
        out[mname] = d
    return out


__all__ = [
    "LEAF_NAMES",
    "bf16_neighbours",
    "check_against_one_leaf",
    "clone_state",
    "clip_scale_diff",
    "clone_tree",
    "moment_diff",
    "moments_agree",
    "one_leaf_step",
    "plain_step_diff",
    "preset_shapes",
    "same_state",
    "scal_ulps",
    "step_state",
]
