"""Pieces the drivers share: the stratified draws that give every seed
the same sizes and gaps in another order, and percentiles."""

from __future__ import annotations

import math
import statistics

import numpy as np


def stratified_lognormal(count: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    """``count`` whole sizes at the quantiles (i + 1/2) / count of a
    lognormal of that median and sigma, clipped to [lo, hi]: the same
    multiset for every seed."""
    nd = statistics.NormalDist()
    q = [(i + 0.5) / count for i in range(count)]
    return np.clip(np.rint([median * math.exp(sigma * nd.inv_cdf(p)) for p in q]), lo, hi).astype(np.int64)


def stratified_exponential(count: int, mean: float) -> np.ndarray:
    """``count`` gaps at the quantiles (i + 1/2) / count of an exponential
    of that mean (Poisson arrivals)."""
    q = (np.arange(count) + 0.5) / count
    return -mean * np.log1p(-q)


def percentile(values, pct: float) -> float:
    """The nearest-rank percentile: the smallest value with at least pct%
    of the values at or below it (inf counts as a value)."""
    v = sorted(values)
    if not v:
        return float("nan")
    return float(v[max(0, math.ceil(pct / 100.0 * len(v)) - 1)])
