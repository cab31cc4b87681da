"""Frozen percentile arithmetic for the end-to-end metrics."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of ``values`` by linear interpolation
    between the two nearest ranks (numpy's default ``linear`` method):
    rank q / 100 (n - 1) of the sorted values."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    r = q / 100.0 * (len(xs) - 1)
    lo = math.floor(r)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (r - lo)
