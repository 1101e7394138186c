"""The numbers that decide ``correct``: gaps between what the program's
timed path produced and what the reference works out.

Serving: ``x_gap`` and ``z_gap``, the largest element-wise difference of
the checked rows' x (z) from the reference's, over the largest magnitude
of the reference's x (z) over those rows.

Training, after the window, from the program's readings of set-up's
first steps: ``loss_gap``, the largest relative difference of the first
three steps' losses; ``grad_gap``, over the leaves, the difference of the
norms of the first gradient as the optimizer got it (mu after one step
over 1 - b1), over the larger of that leaf's reference norm and the
median leaf's, for the median leaf; ``change_gap``, the same for the norm
of each leaf's change over three steps, leaving out leaves whose
reference gradient norm is under a thousandth of the median leaf's
(Adam moves those by round-off alone). Both take the median over the
leaves, not the worst leaf: the smallest leaf (beta, K values in one
int8 block of 256) moves by int8 rounding flips alone, by up to 2% of
the median leaf's change on a sound run. ``change_diff``, the norm of
the difference of each leaf's change from the reference's, over the
same denominator, for the worst leaf of those kept: a change of the
right size in a wrong direction (a sign flipped) passes the norms and
fails this.
"""

from __future__ import annotations

import statistics

import torch


def max_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    scale = float(torch.max(torch.abs(ref)))
    return float(torch.max(torch.abs(prog.to(ref.dtype) - ref))) / max(scale, 1e-30)


def leaf_gaps(prog_norms, ref_norms, keep=None) -> list:
    """Each leaf's |prog - ref| over max(ref leaf, median ref leaf), the
    leaves ``keep`` leaves out skipped."""
    median = statistics.median(ref_norms)
    return [abs(p - r) / max(r, median, 1e-30)
            for i, (p, r) in enumerate(zip(prog_norms, ref_norms)) if keep is None or keep[i]]


def diff_gaps(prog, ref, keep=None) -> list:
    """Each leaf's |prog - ref| (tensors: the norm of the difference) over
    max(|ref leaf|, median |ref leaf|), the leaves ``keep`` leaves out
    skipped: a change of the right size in a wrong direction shows here."""
    ref_norms = [float(r.norm()) for r in ref]
    median = statistics.median(ref_norms)
    return [float((p - r).norm()) / max(n, median, 1e-30)
            for i, (p, r, n) in enumerate(zip(prog, ref, ref_norms)) if keep is None or keep[i]]


def rel_gap(prog: float, ref: float) -> float:
    return abs(prog - ref) / max(abs(ref), 1e-30)


def numbers(values: dict, limits: dict) -> list:
    """[{"name", "value", "limit"}] in ``limits``' order, each value a
    float; a value that is missing or not finite fails (inf)."""
    out = []
    for name, limit in limits.items():
        v = values.get(name)
        v = float("inf") if v is None or v != v else float(v)
        out.append({"name": name, "value": v, "limit": float(limit)})
    return out


def passed(nums: list) -> bool:
    return all(n["value"] <= n["limit"] for n in nums)
