"""Latency metrics the port needs (a copy of part of ``repro.core.metrics``)."""
from __future__ import annotations

import math


def percentile(xs: list[float], q: float) -> float:
    """Nearest-rank percentile (the EventLog.tail convention)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, int(math.ceil(q * len(s))) - 1))]
