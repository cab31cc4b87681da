"""Latency metrics, SLOs and fault/reliability accounting (the port's
copy of ``repro.core.metrics``): the nearest-rank percentile, per-request
latency stats and tail SLOs, shared by the pipeline, the serving engine
and the cluster; windowed tails, recovery and reliability reports for
the cluster's live runs and its DES."""
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


# ---- fault-recovery accounting ---------------------------------------------
#
# Everything below windows a stream of (completion_time, latency)
# samples around a fault so both execution engines (DES simulated time,
# live compressed wall time) report recovery in the same vocabulary:
# how high the rebalance spike pushed the tail, and how long after the
# repair the tail took to return to its pre-fault level.


def windowed_percentile(samples, q: float,
                        window_s: float) -> list[tuple[float, float, int]]:
    """Tumbling-window tail over ``(t, latency)`` samples.

    Returns ``(window_end_t, percentile, n)`` per non-empty window,
    aligned to ``t=0`` so same-seed runs window identically. Windows
    with no completions are simply absent — during a full outage
    nothing completes, and an empty window must not read as "tail
    recovered to zero".
    """
    if window_s <= 0:
        raise ValueError("window_s must be positive")
    buckets: dict[int, list[float]] = {}
    for t, lat in samples:
        buckets.setdefault(int(t // window_s), []).append(lat)
    return [((i + 1) * window_s, percentile(xs, q), len(xs))
            for i, xs in sorted(buckets.items())]


@dataclass
class RecoveryReport:
    """How a fault window moved the tail, and how fast it came back.

    ``recovery_s`` is measured from the REPAIR (``t_restore``), not the
    fault: it answers "once capacity returned, how long until the tail
    forgot the outage" — the backlog-drain time the paper's queueing
    model prices. ``inf`` means the tail never re-entered
    ``factor * baseline_p99`` before the run ended.
    """
    baseline_p99: float           # pre-fault tail
    spike_p99: float              # worst window at/after the fault
    recovery_s: float             # repair -> tail back under factor*baseline
    drain_s: float                # repair -> backlog back under pre-fault mean
    windows: list = field(default_factory=list)

    def to_dict(self) -> dict:
        return {k: (v if k != "windows" else list(v))
                for k, v in self.__dict__.items()}


# ---- reliability accounting -------------------------------------------------
#
# The retry/hedge/deadline layer (``repro_torch.cluster.reliability``) changes
# what "throughput" means: a request that completes after its deadline,
# or completes twice because a hedge raced the primary, is load the
# cluster carried but value the client never saw. Both execution engines
# emit the raw counters; this report turns them into the paper-style
# quantities — goodput vs throughput, retry amplification, deadline-miss
# rate — so live and DES runs can be compared number-for-number.


@dataclass
class ReliabilityReport:
    """Client-visible value vs cluster-carried load for one run.

    ``goodput`` counts only unique completions inside their deadline;
    ``throughput`` counts every unique completion; ``amplification`` is
    published attempts per offered request (1.0 = no retries/hedges —
    the retry-storm metric). ``breaker_timeline`` /
    ``degrade_timeline`` are ``(t, state_or_depth, ...)`` transition
    lists, empty when the corresponding policy is off.
    """
    offered: int = 0              # unique requests submitted
    attempts: int = 0             # publishes incl. retries + hedges
    completed: int = 0            # unique completions (dedup by rid)
    in_deadline: int = 0          # completions within the deadline
    deadline_misses: int = 0      # deadline passed with no completion yet
    retries: int = 0
    hedges: int = 0
    hedge_cancels: int = 0        # duplicate killed at dequeue (cheap)
    hedge_wastes: int = 0         # duplicate fully served (wasted work)
    breaker_sheds: int = 0        # attempts refused: every circuit open
    throughput: float = 0.0       # unique completions / span
    goodput: float = 0.0          # in-deadline completions / span
    amplification: float = 1.0    # attempts / offered
    deadline_miss_rate: float = 0.0
    accuracy_proxy_mean: float = 1.0
    breaker_timeline: list = field(default_factory=list)
    degrade_timeline: list = field(default_factory=list)

    def to_dict(self) -> dict:
        out = dict(self.__dict__)
        out["breaker_timeline"] = [list(x) for x in self.breaker_timeline]
        out["degrade_timeline"] = [list(x) for x in self.degrade_timeline]
        return out


def reliability_report(completions, deadline_s: float, span_s: float, *,
                       offered: int, attempts: int, deadline_misses: int = 0,
                       retries: int = 0, hedges: int = 0,
                       hedge_cancels: int = 0, hedge_wastes: int = 0,
                       breaker_sheds: int = 0,
                       accuracy_proxy_mean: float = 1.0,
                       breaker_timeline=(), degrade_timeline=(),
                       ) -> ReliabilityReport:
    """Fold a unique-completion stream + lifecycle counters into a report.

    ``completions`` is the deduped ``(t_complete, latency)`` stream
    (one entry per request id, the winning attempt); ``deadline_s``
    classifies each into goodput or late; ``span_s`` converts counts to
    rates. Shared verbatim by the DES and the live cluster so
    ``crossval`` can gate their agreement.
    """
    if span_s <= 0:
        raise ValueError("span_s must be positive")
    completed = len(completions)
    in_deadline = sum(1 for _, lat in completions if lat <= deadline_s)
    offered = max(int(offered), 0)
    return ReliabilityReport(
        offered=offered, attempts=int(attempts), completed=completed,
        in_deadline=in_deadline, deadline_misses=int(deadline_misses),
        retries=int(retries), hedges=int(hedges),
        hedge_cancels=int(hedge_cancels), hedge_wastes=int(hedge_wastes),
        breaker_sheds=int(breaker_sheds),
        throughput=completed / span_s, goodput=in_deadline / span_s,
        amplification=(attempts / offered) if offered else 1.0,
        deadline_miss_rate=(1.0 - in_deadline / offered) if offered else 0.0,
        accuracy_proxy_mean=accuracy_proxy_mean,
        breaker_timeline=list(breaker_timeline),
        degrade_timeline=list(degrade_timeline))


def goodput_timeline(completions, deadline_s: float,
                     window_s: float) -> list[tuple[float, float]]:
    """Tumbling-window goodput over ``(t, latency)`` completions.

    Returns ``(window_end_t, in_deadline_per_second)`` for every window
    from the first to the last completion — unlike
    :func:`windowed_percentile`, empty windows ARE emitted (as 0.0):
    during an outage zero goodput is the finding, not missing data.
    """
    if window_s <= 0:
        raise ValueError("window_s must be positive")
    if not completions:
        return []
    buckets: dict[int, int] = {}
    for t, lat in completions:
        buckets[int(t // window_s)] = (buckets.get(int(t // window_s), 0)
                                       + (1 if lat <= deadline_s else 0))
    lo, hi = min(buckets), max(buckets)
    return [((i + 1) * window_s, buckets.get(i, 0) / window_s)
            for i in range(lo, hi + 1)]


def recovery_report(samples, t_fault: float, t_restore: float,
                    window_s: float = 0.5, q: float = 0.99,
                    factor: float = 1.5,
                    depth_samples=None) -> RecoveryReport:
    """Window ``(t, latency)`` completions around a fault.

    ``samples``: completion stream; ``t_fault``/``t_restore``: model
    times of the outage and the repair; ``factor``: recovered means the
    windowed tail is back within ``factor * baseline``. Optional
    ``depth_samples`` ``(t, depth)`` adds backlog drain time.
    """
    if t_restore < t_fault:
        raise ValueError("t_restore must not precede t_fault")
    windows = windowed_percentile(samples, q, window_s)
    pre = [p for t, p, _ in windows if t <= t_fault]
    baseline = percentile(pre, q) if pre else 0.0
    post = [(t, p) for t, p, _ in windows if t > t_fault]
    spike = max((p for _, p in post), default=baseline)
    recovery = float("inf")
    for t, p in post:
        if t >= t_restore and p <= factor * max(baseline, 1e-12):
            recovery = max(0.0, t - t_restore)
            break
    drain = 0.0
    if depth_samples:
        pre_d = [d for t, d in depth_samples if t <= t_fault]
        floor = (sum(pre_d) / len(pre_d)) if pre_d else 0.0
        drain = float("inf")
        for t, d in depth_samples:
            if t >= t_restore and d <= max(floor, 1.0):
                drain = max(0.0, t - t_restore)
                break
    return RecoveryReport(baseline_p99=baseline, spike_p99=spike,
                          recovery_s=recovery, drain_s=drain,
                          windows=windows)
