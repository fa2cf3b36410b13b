"""The metric arithmetic: rates over the window, a percentile over all
fits, spreads, and the device's busy time as the union of its activity."""
from __future__ import annotations

import statistics

import numpy as np


def rate(work: float, t_start: float, t_end: float) -> float:
    """``work`` over the seconds from ``t_start`` to ``t_end``."""
    return work / (t_end - t_start)


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all ``values``, linearly interpolated
    between order statistics (NumPy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles(n=4)``)."""
    q1, q2, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / q2


def union(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of ``intervals`` (start, end) clipped to [lo, hi], as
    sorted disjoint intervals."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` within [lo, hi]."""
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in union(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = e
    if hi > t:
        out.append((t, hi))
    return out
