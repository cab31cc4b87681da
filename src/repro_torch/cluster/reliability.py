"""Request-lifecycle reliability: retries, hedging, breakers, degradation.

The paper measures the tail of a fire-and-forget cluster; no operator
runs one. Production stacks wrap every request in a deadline + retry
policy, hedge the stragglers, trip a circuit breaker around failing
replicas, and degrade quality before they shed load. Each of those
mechanisms costs something — duplicated work, retry-amplified load,
accuracy — and that cost is an AI tax the five-way accounting must see.

This module is the policy vocabulary, shared verbatim by the live
cluster (``repro_torch.cluster.cluster``) and the DES
(``repro_torch.core.simulator``): pure-stdlib dataclasses plus one small
state machine, so ``repro_torch.core`` can consume instances duck-typed
without importing this package (the same layering rule as ``FaultPlan``
and ``AutoscalerConfig``).

Determinism discipline: every random draw (backoff jitter, probe
admission) is seeded per (policy seed, request id, attempt) or per
(config seed, breaker key), never from global state — same seed, same
storm, in both execution engines.

The port's copy of ``repro.cluster.reliability``, the same in behaviour:
one seed gives the same numbers in both packages.
"""
from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field


# ---- retry / hedge policy ---------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Deadline-aware retry + optional tail-latency hedging.

    An attempt that hasn't completed ``attempt_timeout_s`` after publish
    is presumed lost: the client re-publishes after a backoff (this is
    the retry-storm mechanism — under a capacity dip every queued
    request times out and doubles the offered load). Backoff is
    exponential with seeded *full jitter*: the delay before attempt
    ``k+1`` is uniform in ``[base, min(cap, base * 2**(k-1))]`` —
    deterministic per ``(seed, request_id, attempt)``.

    ``hedge_delay_s`` (off by ``None``) duplicates a still-incomplete
    request once, ``hedge_delay_s`` after first publish; the first
    completion wins and the loser is cancelled by request-id dedupe at
    dequeue (or accounted as wasted work if a replica already picked it
    up). Retries are never issued past the point where they could not
    possibly complete before ``deadline_s``.
    """
    deadline_s: float = 1.0
    attempt_timeout_s: float = 0.3
    max_attempts: int = 3
    backoff_base_s: float = 0.02
    backoff_cap_s: float = 0.25
    hedge_delay_s: float | None = None
    seed: int = 0

    def __post_init__(self):
        if self.deadline_s <= 0 or self.attempt_timeout_s <= 0:
            raise ValueError("deadline_s and attempt_timeout_s must be > 0")
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not (0 < self.backoff_base_s <= self.backoff_cap_s):
            raise ValueError("need 0 < backoff_base_s <= backoff_cap_s")
        if self.hedge_delay_s is not None and self.hedge_delay_s <= 0:
            raise ValueError("hedge_delay_s must be > 0 when set")

    def backoff_s(self, request_id: int, attempt: int) -> float:
        """Jittered delay before attempt ``attempt + 1`` (attempt >= 1).

        Full jitter over ``[base, min(cap, base * 2**(attempt-1))]``;
        the low end is the base (never zero) so a storm can't
        resynchronize into lockstep, and the high end is capped so late
        attempts still fit under the deadline.
        """
        if attempt < 1:
            raise ValueError("attempt counts from 1")
        hi = min(self.backoff_cap_s,
                 self.backoff_base_s * (2.0 ** (attempt - 1)))
        rng = random.Random(
            (self.seed * 1_000_003 + request_id * 7_919 + attempt)
            & 0x7FFF_FFFF)
        return self.backoff_base_s + rng.random() * (hi - self.backoff_base_s)

    def retry_allowed(self, t_now: float, t_first: float,
                      attempts: int) -> bool:
        """May a fresh attempt be issued at ``t_now``?

        Attempts are capped and a retry must still stand a chance: its
        publish time (after the minimum backoff) has to precede the
        deadline.
        """
        if attempts >= self.max_attempts:
            return False
        return t_now + self.backoff_base_s < t_first + self.deadline_s


# ---- circuit breaker --------------------------------------------------------


CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


@dataclass(frozen=True)
class BreakerConfig:
    """Windowed error-rate circuit breaker configuration.

    One ``CircuitBreaker`` is instantiated per publish target (broker
    partition, which maps 1:1 onto a consumer at the default replica
    count) via :meth:`make`. The breaker trips OPEN when, over the last
    ``window_s`` of outcomes with at least ``min_volume`` of them, the
    failure (error + attempt-timeout) fraction reaches
    ``failure_threshold``. After ``open_s`` it goes HALF_OPEN and
    admits a seeded ``probe_rate`` fraction of attempts;
    ``close_after`` consecutive probe successes close it, any probe
    failure re-opens it.
    """
    window_s: float = 1.0
    failure_threshold: float = 0.5
    min_volume: int = 5
    open_s: float = 1.0
    probe_rate: float = 0.2
    close_after: int = 3
    seed: int = 0

    def __post_init__(self):
        if not (0 < self.failure_threshold <= 1):
            raise ValueError("failure_threshold must be in (0, 1]")
        if not (0 < self.probe_rate <= 1):
            raise ValueError("probe_rate must be in (0, 1]")
        if self.window_s <= 0 or self.open_s <= 0:
            raise ValueError("window_s and open_s must be > 0")
        if self.min_volume < 1 or self.close_after < 1:
            raise ValueError("min_volume and close_after must be >= 1")

    def make(self, key: int = 0) -> "CircuitBreaker":
        """A fresh breaker for one target; ``key`` diversifies probes."""
        return CircuitBreaker(self, key)


class CircuitBreaker:
    """closed -> open -> half-open state machine over windowed outcomes.

    Thread-safe (the live cluster calls ``allow`` from producer threads
    and ``record`` from replica threads); the DES drives it
    single-threaded, where the lock is uncontended. Never blocks or
    sleeps under its lock. ``timeline`` records every state transition
    as ``(t, state)`` for the reliability report.
    """

    def __init__(self, cfg: BreakerConfig, key: int = 0):
        self.cfg = cfg
        self.key = key
        self.state = CLOSED
        self.timeline: list[tuple[float, str]] = [(0.0, CLOSED)]
        self._outcomes: list[tuple[float, bool]] = []  # (t, ok) window
        self._t_opened = 0.0
        self._probe_streak = 0
        self._rng = random.Random((cfg.seed * 9_176_531 + key * 65_537)
                                  & 0x7FFF_FFFF)
        self._lock = threading.Lock()

    def _transition(self, t: float, state: str) -> None:
        self.state = state
        self.timeline.append((t, state))

    def _step(self, t: float) -> None:
        # time-driven OPEN -> HALF_OPEN; caller holds the lock
        if self.state == OPEN and t - self._t_opened >= self.cfg.open_s:
            self._probe_streak = 0
            self._transition(t, HALF_OPEN)

    def _prune(self, t: float) -> None:
        w = self.cfg.window_s
        self._outcomes = [(tt, ok) for tt, ok in self._outcomes
                          if t - tt <= w]

    def allow(self, t: float) -> bool:
        """Admission decision for an attempt at model time ``t``."""
        with self._lock:
            self._step(t)
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                return False
            return self._rng.random() < self.cfg.probe_rate

    def record(self, t: float, ok: bool) -> None:
        """Outcome of an attempt: completion (ok) or error/timeout."""
        with self._lock:
            self._step(t)
            self._prune(t)
            self._outcomes.append((t, ok))
            if self.state == HALF_OPEN:
                if ok:
                    self._probe_streak += 1
                    if self._probe_streak >= self.cfg.close_after:
                        self._outcomes.clear()
                        self._transition(t, CLOSED)
                else:
                    self._t_opened = t
                    self._transition(t, OPEN)
                return
            if self.state == CLOSED:
                n = len(self._outcomes)
                bad = sum(1 for _, okk in self._outcomes if not okk)
                if (n >= self.cfg.min_volume
                        and bad / n >= self.cfg.failure_threshold):
                    self._t_opened = t
                    self._transition(t, OPEN)

    def snapshot(self) -> tuple[str, int]:
        """(state, windowed outcome count) without mutating time state."""
        with self._lock:
            return self.state, len(self._outcomes)


def open_fraction(breakers) -> float:
    """Fraction of breakers currently not CLOSED (degradation input)."""
    bs = list(breakers)
    if not bs:
        return 0.0
    return sum(1 for b in bs if b.state != CLOSED) / len(bs)


# ---- graceful degradation ---------------------------------------------------


@dataclass(frozen=True)
class DegradeLevel:
    """One rung of the quality ladder.

    ``service_factor`` scales per-item service time (the work actually
    saved); ``accuracy_proxy`` is the fraction of full-fidelity quality
    retained, logged with every degraded completion so the accuracy
    cost is on the books; ``post_nms``/``letterbox_scale`` say *how*
    the work is saved, consumed by the preprocess stage (skip the NMS
    re-rank, decode at reduced resolution).
    """
    name: str = "full"
    service_factor: float = 1.0
    accuracy_proxy: float = 1.0
    post_nms: bool = True
    letterbox_scale: float = 1.0

    def __post_init__(self):
        if not (0 < self.service_factor <= 1):
            raise ValueError("service_factor must be in (0, 1]")
        if not (0 < self.accuracy_proxy <= 1):
            raise ValueError("accuracy_proxy must be in (0, 1]")
        if not (0 < self.letterbox_scale <= 1):
            raise ValueError("letterbox_scale must be in (0, 1]")


FULL_FIDELITY = DegradeLevel()

DEFAULT_LADDER = (
    # skip the post-NMS re-rank: modest service saving, small accuracy hit
    DegradeLevel("skip_rerank", service_factor=0.75, accuracy_proxy=0.96,
                 post_nms=False),
    # half-resolution letterbox + no re-rank: big saving, visible hit
    DegradeLevel("low_res", service_factor=0.5, accuracy_proxy=0.88,
                 post_nms=False, letterbox_scale=0.5),
)


@dataclass(frozen=True)
class DegradePolicy:
    """When to walk down (and back up) the quality ladder.

    Depth 0 is full fidelity; depth ``k`` is ``levels[k-1]``. The
    ladder engages one rung per ``enter_backlog`` of per-replica
    backlog, jumps straight to the deepest rung when at least
    ``open_fraction`` of circuit breakers are open (the cluster is
    actively failing), and — hysteresis — only climbs back one rung at
    a time, and only once backlog has fallen to ``exit_backlog``, so
    the quality level doesn't flap at the threshold.
    """
    levels: tuple[DegradeLevel, ...] = DEFAULT_LADDER
    enter_backlog: float = 16.0
    exit_backlog: float = 4.0
    open_fraction: float = 0.5

    def __post_init__(self):
        if not self.levels:
            raise ValueError("need at least one degrade level")
        if not (0 < self.exit_backlog < self.enter_backlog):
            raise ValueError("need 0 < exit_backlog < enter_backlog")
        if not (0 < self.open_fraction <= 1):
            raise ValueError("open_fraction must be in (0, 1]")

    def level(self, depth: int) -> DegradeLevel:
        if depth <= 0:
            return FULL_FIDELITY
        return self.levels[min(depth, len(self.levels)) - 1]

    def decide(self, backlog_per_replica: float, breaker_open_fraction: float,
               current_depth: int) -> int:
        """Next ladder depth given pressure and the current depth."""
        if breaker_open_fraction >= self.open_fraction:
            return len(self.levels)
        target = min(len(self.levels),
                     int(backlog_per_replica // self.enter_backlog))
        if target >= current_depth:
            return target
        if backlog_per_replica <= self.exit_backlog:
            return max(target, current_depth - 1)
        return current_depth
