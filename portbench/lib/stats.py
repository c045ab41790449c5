"""The arithmetic of a window's numbers (frozen with the benchmark)."""
from __future__ import annotations

import math
import statistics


def percentile(values, p: float) -> float:
    """The nearest-rank ``p``-th percentile of all ``values``: the smallest
    value with at least p % of the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(p / 100.0 * len(v)) - 1)]


def rate(count: float, seconds: float) -> float:
    """Work per second over the whole window."""
    return count / seconds


def spread(values) -> float:
    """(third quartile - first quartile) / median, quartiles as
    ``statistics.quantiles(values, n=4)`` gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
