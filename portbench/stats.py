"""The benchmark's arithmetic: percentiles and the union of intervals."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of all `values`, interpolated linearly
    between the two nearest ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def merge_intervals(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Disjoint, sorted intervals covering the same points as `intervals`
    (each `(start, end)`, end >= start); touching intervals are joined."""
    out: List[List[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def gaps(merged: Sequence[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The parts of `[lo, hi]` that no interval of `merged` (disjoint and
    sorted, as `merge_intervals` returns) covers."""
    out, cur = [], lo
    for a, b in merged:
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]
