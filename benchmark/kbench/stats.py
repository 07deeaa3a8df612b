"""Order statistics of the metrics."""

from __future__ import annotations

import math


def percentile(values, q: float):
    """The nearest-rank q-th percentile of all the values: the smallest
    value with at least q% of them at or below it. None if empty."""
    v = sorted(values)
    if not v:
        return None
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]
