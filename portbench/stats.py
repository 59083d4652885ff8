"""The arithmetic of the end-to-end metrics: over all the work and all the
time of a window, and over every call in it."""

from __future__ import annotations

import math


def rate(units: float, t0: float, t1: float) -> float:
    """Units completed per second over the whole window [t0, t1]."""
    if t1 <= t0:
        raise ValueError("an empty window has no rate")
    return units / (t1 - t0)


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of every value: the smallest
    value that at least q % of them do not exceed."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals, start: float, stop: float):
    """The stretches of [start, stop] that no interval covers, as (start,
    end, index of the interval that ends the gap, or None at ``stop``),
    intervals taken in order of their start."""
    out, end = [], start
    order = sorted(range(len(intervals)), key=lambda i: intervals[i][0])
    for i in order:
        a, b = intervals[i]
        if a > end:
            out.append((end, a, i))
        end = max(end, b)
    if stop > end:
        out.append((end, stop, None))
    return out
