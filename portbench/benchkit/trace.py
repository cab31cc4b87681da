"""The profiler's trace of a window, read once into plain tuples.

The events are read from the profiler's raw records
(``prof.profiler.kineto_results.events()``), as ``chip_smoke.device_times``
reads them: ``key_averages()`` builds a Python object a record first,
which over a serving window's hundreds of thousands of launches takes
minutes. The profiler stamps events with the wall clock (ns since the
epoch); :class:`Trace` moves them onto ``time.perf_counter``'s clock, the
one the program's spans and the drivers use, by the offset between the
two clocks read when the trace starts. A device activity's host launch is
the runtime call (``cudaLaunchKernel`` and its kin) with the same
correlation id.
"""
from __future__ import annotations

import time
from dataclasses import dataclass


@dataclass
class Activity:
    name: str
    start: float          # device start, perf_counter seconds
    dur: float            # seconds
    launch: float | None  # host launch, perf_counter seconds
    kernel: bool          # a kernel, not a copy or a set

    @property
    def end(self) -> float:
        return self.start + self.dur


def clock_offset_ns() -> int:
    """Wall clock minus perf_counter, ns (the smaller of three reads)."""
    return min(time.time_ns() - time.perf_counter_ns() for _ in range(3))


class Trace:
    """Device activities of a traced window [t0, t1] (perf_counter s)."""

    def __init__(self, acts: list[Activity], t0: float, t1: float):
        self.acts = sorted(acts, key=lambda a: a.start)
        self.t0, self.t1 = t0, t1

    @classmethod
    def from_profiler(cls, prof, offset_ns: int, t0: float, t1: float):
        from torch.autograd import DeviceType
        launches: dict[int, int] = {}
        device = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                if not e.is_async():
                    device.append((e.name(), e.start_ns(), e.duration_ns(),
                                   e.correlation_id()))
            elif e.name().startswith(("cudaLaunch", "cuLaunch")):
                launches[e.correlation_id()] = e.start_ns()
        acts = []
        for name, s, d, corr in device:
            ln = launches.get(corr)
            acts.append(Activity(
                name, (s - offset_ns) / 1e9, d / 1e9,
                None if ln is None else (ln - offset_ns) / 1e9,
                not name.startswith(("Memcpy", "Memset"))))
        return cls(acts, t0, t1)

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of device activity, clipped to the traced window."""
        out: list[list[float]] = []
        for a in self.acts:
            s, e = max(a.start, self.t0), min(a.end, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def gaps(self) -> list[tuple[float, float]]:
        """Idle intervals of the device inside the traced window."""
        out, at = [], self.t0
        for s, e in self.busy_intervals():
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.t1 > at:
            out.append((at, self.t1))
        return out

    def device_ops(self, n: int = 10) -> list[list]:
        """The ``n`` device operations that took most time: [name, s]."""
        tot: dict[str, float] = {}
        for a in self.acts:
            if self.t0 <= a.start < self.t1:
                tot[a.name] = tot.get(a.name, 0.0) + a.dur
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:160], v] for k, v in top]

    def idle_by_host(self, spans: list[tuple[str, float, float]],
                     n: int = 10) -> list[list]:
        """Idle device seconds by what the host was doing: each gap's
        seconds booked to the host span (label, start, end) that holds its
        midpoint, else to ``"host outside spans"``; the ``n`` largest."""
        spans = sorted(spans, key=lambda s: s[1])
        starts = [s[1] for s in spans]
        import bisect
        tot: dict[str, float] = {}
        for s, e in self.gaps():
            mid = (s + e) / 2
            i = bisect.bisect_right(starts, mid) - 1
            label = ("host outside spans" if i < 0 or spans[i][2] < mid
                     else spans[i][0])
            tot[label] = tot.get(label, 0.0) + (e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v] for k, v in top]
