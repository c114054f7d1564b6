"""The arithmetic of the end-to-end numbers and of the device's busy time."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of values; inf sorts last."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def request_latencies(due, done, closed_at: float) -> list[float]:
    """Seconds from when each request was due to its answer. A request with no
    answer (shed or failed: done None) counts as answered when the run stopped
    waiting, closed_at, and no earlier than the latest answer."""
    latest = max([d - u for u, d in zip(due, done) if d is not None], default=0.0)
    return [d - u if d is not None else max(closed_at - u, latest)
            for u, d in zip(due, done)]


def rate(count: float, seconds: float) -> float:
    """Work over the seconds it took; a window with no time has no rate."""
    if seconds <= 0:
        raise ValueError("a rate needs a window longer than 0 s")
    return count / seconds


def merge(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as sorted, disjoint intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy(intervals, lo: float, hi: float) -> float:
    """Length of the union of intervals clipped to [lo, hi]."""
    return sum(min(b, hi) - max(a, lo) for a, b in merge(intervals) if min(b, hi) > max(a, lo))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in merge(intervals):
        if b <= lo or a >= hi:
            continue
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if cur < hi:
        out.append((cur, hi))
    return out


def quartile_spread(values) -> float:
    """(Q3 - Q1) / median, the quartiles as statistics.quantiles(n=4) gives them."""
    import statistics

    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
