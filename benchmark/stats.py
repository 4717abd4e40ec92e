"""Arithmetic of the benchmark's numbers: percentiles, rates and the union
of device intervals."""

from __future__ import annotations

import math


def percentile(values, q):
    """The ``q``-th percentile (0-100) of ``values``, linearly interpolated
    between the two nearest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(units, seconds):
    """Units of work completed per second of the window."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return units / seconds


def union(intervals):
    """Merge (start, end) intervals; returns the disjoint sorted list."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals):
    """Length of the union of the intervals: time in which at least one ran
    (not the sum of their lengths)."""
    return sum(e - s for s, e in union(intervals))


def gaps(intervals, start, end):
    """The idle (start, end) gaps of [start, end] that no interval covers."""
    out, t = [], start
    for s, e in union(intervals):
        s, e = max(s, start), min(e, end)
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if end > t:
        out.append((t, end))
    return out
