"""Latency metrics and SLOs the port needs (a copy of part of
``repro.core.metrics``): the nearest-rank percentile, per-request latency
stats and tail SLOs, shared by the pipeline and the serving engine."""
from __future__ import annotations

import math
from dataclasses import dataclass, field


def percentile(xs: list[float], q: float) -> float:
    """Nearest-rank percentile (the EventLog.tail convention)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, int(math.ceil(q * len(s))) - 1))]


@dataclass
class LatencyStats:
    """Per-request latency summary in seconds (model time)."""
    n: int = 0
    mean: float = 0.0
    p50: float = 0.0
    p95: float = 0.0
    p99: float = 0.0
    max: float = 0.0

    @classmethod
    def from_samples(cls, xs: list[float]) -> "LatencyStats":
        if not xs:
            return cls()
        return cls(n=len(xs), mean=sum(xs) / len(xs),
                   p50=percentile(xs, 0.50), p95=percentile(xs, 0.95),
                   p99=percentile(xs, 0.99), max=max(xs))

    def to_dict(self) -> dict:
        return dict(self.__dict__)


@dataclass(frozen=True)
class TailSLO:
    """Latency objectives; ``None`` means "not part of the contract"."""
    p50_s: float | None = None
    p95_s: float | None = None
    p99_s: float | None = None
    max_drop_fraction: float | None = None

    def check(self, stats: LatencyStats,
              drop_fraction: float = 0.0) -> "SLOReport":
        violations = []
        for name, bound, got in (("p50", self.p50_s, stats.p50),
                                 ("p95", self.p95_s, stats.p95),
                                 ("p99", self.p99_s, stats.p99)):
            if bound is not None and got > bound:
                violations.append(f"{name}={got:.4f}s > {bound:.4f}s")
        if (self.max_drop_fraction is not None
                and drop_fraction > self.max_drop_fraction):
            violations.append(
                f"drops={drop_fraction:.3f} > {self.max_drop_fraction:.3f}")
        return SLOReport(ok=not violations, violations=violations)


@dataclass
class SLOReport:
    ok: bool
    violations: list = field(default_factory=list)
