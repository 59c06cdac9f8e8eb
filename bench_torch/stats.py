"""The benchmark's arithmetic on measured samples: percentiles, rates and
the union of device intervals.  Plain Python, no program code."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    sample with at least q % of the samples at or below it, so the 95th of
    200 requests is the 190th slowest and ten lie beyond it."""
    if not values:
        raise ValueError("percentile of no samples")
    if not 0 < q <= 100:
        raise ValueError(f"percentile {q} outside (0, 100]")
    ordered = sorted(values)
    return float(ordered[max(math.ceil(q / 100.0 * len(ordered)) - 1, 0)])


def rate(amount: float, seconds: float) -> float:
    """Work done over the wall seconds it took."""
    if seconds <= 0:
        raise ValueError(f"a rate over {seconds} s")
    return amount / seconds


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The disjoint, sorted union of closed intervals (start, end)."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if e < s:
            raise ValueError(f"interval ends before it starts: {(s, e)}")
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def clip(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """Each interval cut to [lo, hi]; those outside it dropped."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def covered(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of the intervals."""
    return sum(e - s for s, e in union(intervals))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, pos = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > pos:
            out.append((pos, s))
        pos = max(pos, e)
    if hi > pos:
        out.append((pos, hi))
    return out
