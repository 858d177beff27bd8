"""Rates and tails over every request of a window: never a median of chunks."""

from __future__ import annotations

import math


def quantile(values, q: float) -> float:
    """The q-quantile (0 <= q <= 1) of all values, interpolated linearly
    between order statistics (numpy's default); +inf counts as a value
    (a request that never completed lies past every limit)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("quantile of no values")
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """Work completed in a window over the window's length."""
    if seconds <= 0:
        raise ValueError("a window of no length")
    return count / seconds
