"""What a traced window leaves for the per-layer readers: the trace, the
host spans the drivers recorded, and the work the traffic asked for."""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from benchkit.trace import Trace


@dataclass
class Ctx:
    config: dict
    traffic: dict
    window: tuple[float, float]       # the traced window, perf_counter s
    trace: Trace
    spans: list = field(default_factory=list)     # (label, start, end)
    prefills: list = field(default_factory=list)  # (tokens, start, end)
    ticks: list = field(default_factory=list)     # (start, end, entries)
    steps: list = field(default_factory=list)     # (start, end)
    update_ms: list = field(default_factory=list)
    host: dict = field(default_factory=dict)      # the whole window's tails

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def launched_in(self, spans: list[tuple[float, float]], match) -> list:
        """Kernels (not copies or sets) whose name satisfies ``match`` and
        whose host launch lies in one of ``spans`` (start, end) (the
        device start where the trace has no launch for it)."""
        spans = sorted(spans)
        starts = [s for s, _ in spans]
        out = []
        for a in self.trace.acts:
            if not a.kernel:
                continue
            if not match(a.name):
                continue
            t = a.launch if a.launch is not None else a.start
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                out.append(a)
        return out

    def device_s(self, spans, match) -> float:
        return sum(a.dur for a in self.launched_in(spans, match))

    def breakdown(self) -> dict:
        return {"device_ops": self.trace.device_ops(10),
                "idle_gaps": self.trace.idle_by_host(self.spans, 10)}


def roofline_pct(least_s: float, device_s: float):
    """A kernel's share of its roofline in %, or None where the trace
    holds none of its launches."""
    if device_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / device_s
