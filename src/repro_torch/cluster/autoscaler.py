"""Queue-depth / SLO-driven elastic autoscaler for the serving cluster.

One small controller closes the loop the paper leaves open: AI
acceleration moves the stability knee, faults move it again mid-run —
so replica count can't be a constant. The ``Autoscaler`` watches two
signals already measured by both execution engines (per-replica
backlog and recent p99 latency) and emits a replica delta; the caller
applies it through the ordinary generation-stamped join/leave path, so
— exactly like the fault engine — the consumer-group code never learns
that elasticity exists.

Control law (classic hysteresis band + cooldown, the minimum that
cannot oscillate):

  * scale UP by ``step`` when backlog-per-replica exceeds
    ``up_backlog``, or when the recent p99 breaches the SLO;
  * scale DOWN by ``step`` only when backlog-per-replica is below
    ``down_backlog`` AND backlog did not grow since the previous
    observation (never shrink into rising pressure — a just-drained
    queue under a rate that has crossed capacity looks idle for one
    interval) AND the post-removal backlog would still sit under the
    scale-up threshold AND the recent p99 leaves ``slo_margin``
    headroom under the SLO — the guards the "scale-down never
    violates the SLO" test pins;
  * otherwise hold. Any action arms a ``cooldown_s`` timer during
    which the controller holds regardless of the signals, so a
    rebalance's transient spike can't trigger a second action before
    the first one's effect is visible.

The controller is pure state + arithmetic (no threads, no clocks): the
live cluster drives it from a sampling thread on compressed wall time,
the DES drives it from simulated time, and the unit tests drive it
from a fluid-queue model — one control law, three harnesses.

The port's copy of ``repro.cluster.autoscaler``, the same in behaviour:
one seed gives the same numbers in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class AutoscalerConfig:
    """Controller constants (frozen so a spec stays hashable/printable).

    ``up_backlog``/``down_backlog`` are per-replica queue depths in
    messages; the dead band between them is the hysteresis. ``slo_p99_s``
    is optional — without it the controller is purely backlog-driven.
    """
    min_replicas: int = 1
    max_replicas: int = 16
    interval_s: float = 0.25          # model-time between decisions
    cooldown_s: float = 1.0           # model-time lockout after an action
    up_backlog: float = 8.0           # per-replica depth that forces growth
    down_backlog: float = 2.0         # per-replica depth that allows shrink
    step: int = 1
    slo_p99_s: float | None = None    # p99 target (model seconds)
    slo_margin: float = 0.8           # shrink only if p99 <= margin * SLO

    def __post_init__(self):
        if self.min_replicas < 1 or self.max_replicas < self.min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        if self.down_backlog >= self.up_backlog:
            raise ValueError("hysteresis band requires down_backlog <"
                             " up_backlog")
        if self.step < 1:
            raise ValueError("step must be >= 1")

    def controller(self) -> "Autoscaler":
        """Factory the DES calls, so ``repro_torch.core`` never has to import
        this module's class by name (duck-typed wiring, layering kept)."""
        return Autoscaler(self)


@dataclass(frozen=True)
class ScaleAction:
    """One applied decision, stamped with the model time it fired."""
    t: float
    delta: int
    n_before: int
    backlog: float
    reason: str


@dataclass
class Autoscaler:
    """The control law. Call :meth:`decide` once per interval."""
    cfg: AutoscalerConfig
    actions: list = field(default_factory=list)
    _last_action_t: float = float("-inf")
    _prev_backlog: float | None = None

    def decide(self, t: float, backlog: float, n_replicas: int,
               p99: float | None = None) -> int:
        """Return the replica delta to apply at model time ``t``.

        ``backlog`` is the total undelivered-message count across the
        topic; ``p99`` the recent-window tail latency when the harness
        has one (``None`` disables the SLO terms for this decision).
        """
        cfg = self.cfg
        rising = (self._prev_backlog is not None
                  and backlog > self._prev_backlog + 1e-9)
        # one sampling thread (the cluster's autoscale loop) drives
        # decide()/ _record(); the controller is single-threaded state
        self._prev_backlog = backlog  # lint: waive race-check -- controller state owned by the single autoscale-loop thread
        if t - self._last_action_t < cfg.cooldown_s:
            return 0
        per = backlog / max(1, n_replicas)
        slo_breach = (cfg.slo_p99_s is not None and p99 is not None
                      and p99 > cfg.slo_p99_s)

        if (per > cfg.up_backlog or slo_breach) \
                and n_replicas < cfg.max_replicas:
            delta = min(cfg.step, cfg.max_replicas - n_replicas)
            self._record(t, delta, n_replicas, backlog,
                         "slo" if slo_breach else "backlog")
            return delta

        if (per < cfg.down_backlog and not rising
                and n_replicas > cfg.min_replicas):
            delta = min(cfg.step, n_replicas - cfg.min_replicas)
            # guards: removing `delta` replicas must not push the
            # per-replica depth over the growth threshold, and the tail
            # must have real SLO headroom — shrink can never be the
            # cause of the next breach.
            if backlog / max(1, n_replicas - delta) > cfg.up_backlog:
                return 0
            if cfg.slo_p99_s is not None:
                if p99 is None or p99 > cfg.slo_margin * cfg.slo_p99_s:
                    return 0
            self._record(t, -delta, n_replicas, backlog, "drain")
            return -delta

        return 0

    def _record(self, t: float, delta: int, n: int, backlog: float,
                reason: str) -> None:
        self.actions.append(ScaleAction(t, delta, n, backlog, reason))
        self._last_action_t = t  # lint: waive race-check -- controller state owned by the single autoscale-loop thread
