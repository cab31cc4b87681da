"""Central fault-injection engine for the serving cluster (live + DES).

AsyncFlow's server-event-injection design, transplanted: ONE
deterministic timeline of planned outages owned by a central engine,
each transition an O(1) mutation of the single shared membership /
capacity map — the ``ConsumerGroup`` table in the live cluster, the
partition→owner map in the DES. Consumer-group and load-balancing code
carries ZERO outage awareness: replicas only ever see the current
membership, broker writers only their current pacing config, and
nobody asks "am I down?".

Fault kinds (``FaultEvent.action``):
  * ``kill`` / ``revive``       — replica consumers. Kill is abrupt:
    the victim's partitions rebalance onto the survivors and every
    record it held in flight is re-enqueued for the new owner with a
    logged ``requeue`` event (never dropped — five-way tax attribution
    must keep summing to 1 through a fault). Revive joins a FRESH
    member through the normal generation-stamped join path.
  * ``stall`` / ``restore``     — broker write channels. A stalled
    channel stops draining its inbox; restore replays the deferred
    writes at the modeled pacing.
  * ``drive_drop`` / ``drive_restore`` — remove/return one drive from
    a broker's ``BrokerConfig``, shifting its storage write capacity
    (and therefore the stability knee) mid-run.

The same ``FaultPlan`` drives both execution engines from one
``ClusterSpec.fault_plan``: ``FaultEngine.run_live`` applies it to a
``ServingCluster`` on the wall clock (model-time event stamps divided
by ``time_compression``), while ``ClusterSim`` pushes the events into
its heap and applies them in simulated time. Timelines are plain data
(seeded when generated via :meth:`FaultPlan.random`), so same-seed
runs are bit-identical — the determinism the golden fixtures pin.

The port's copy of ``repro.cluster.faults``, the same in behaviour: one
seed gives the same numbers in both packages.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass

ACTIONS = ("kill", "revive", "stall", "restore",
           "drive_drop", "drive_restore")

# paired down/up actions (used by plan generation + validation)
_PAIRS = {"kill": "revive", "stall": "restore",
          "drive_drop": "drive_restore"}


@dataclass(frozen=True)
class FaultEvent:
    """One planned transition at model time ``t``.

    ``target`` selects the victim: for ``kill`` it is a RANK into the
    sorted list of currently-alive members (not a name — names differ
    between runtimes; rank is stable and deterministic in both), for
    broker actions it is a broker id (``None`` = every broker).
    """
    t: float
    action: str
    target: int | None = None

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action: {self.action!r}")
        if self.t < 0:
            raise ValueError("fault time must be >= 0")


@dataclass(frozen=True)
class FaultPlan:
    """An immutable, time-sorted fault timeline."""
    events: tuple = ()

    def __post_init__(self):
        evs = tuple(self.events)
        if any(not isinstance(e, FaultEvent) for e in evs):
            raise TypeError("FaultPlan takes FaultEvent entries")
        if any(b.t < a.t for a, b in zip(evs, evs[1:])):
            raise ValueError("fault events must be time-sorted")
        object.__setattr__(self, "events", evs)

    def __bool__(self) -> bool:
        return bool(self.events)

    @property
    def horizon(self) -> float:
        return self.events[-1].t if self.events else 0.0

    # ---- canned scenarios ---------------------------------------------------

    @classmethod
    def kill_revive(cls, t_kill: float, t_revive: float,
                    n: int = 1, rank: int = 0) -> "FaultPlan":
        """Kill ``n`` replicas at ``t_kill``, revive ``n`` at ``t_revive``.

        Kills apply sequentially, each picking the current rank-th
        alive member — killing rank 0 ``n`` times removes the n lowest
        members deterministically.
        """
        if t_revive <= t_kill:
            raise ValueError("revive must follow kill")
        return cls(tuple(FaultEvent(t_kill, "kill", rank)
                         for _ in range(n))
                   + tuple(FaultEvent(t_revive, "revive")
                           for _ in range(n)))

    @classmethod
    def drive_drop(cls, t_drop: float, t_restore: float | None = None,
                   broker: int | None = None) -> "FaultPlan":
        """Drop one drive (all brokers by default); optionally restore."""
        evs = [FaultEvent(t_drop, "drive_drop", broker)]
        if t_restore is not None:
            if t_restore <= t_drop:
                raise ValueError("restore must follow drop")
            evs.append(FaultEvent(t_restore, "drive_restore", broker))
        return cls(tuple(evs))

    @classmethod
    def stall(cls, t_stall: float, t_restore: float,
              broker: int | None = 0) -> "FaultPlan":
        """Stall a broker's write channel for a window."""
        if t_restore <= t_stall:
            raise ValueError("restore must follow stall")
        return cls((FaultEvent(t_stall, "stall", broker),
                    FaultEvent(t_restore, "restore", broker)))

    @classmethod
    def random(cls, seed: int, horizon: float, n_faults: int = 3,
               kinds: tuple = ("kill", "stall", "drive_drop"),
               n_brokers: int = 3) -> "FaultPlan":
        """A seeded random timeline of paired down/up windows.

        Deterministic in its arguments (one ``random.Random(seed)``,
        no module-level RNG): same seed → bit-identical timeline, the
        property the determinism tests pin. Outage windows start in
        the middle 60% of the horizon and last 5–20% of it, so every
        fault leaves room to recover inside the run.
        """
        rng = random.Random(seed)
        evs: list[FaultEvent] = []
        for _ in range(n_faults):
            kind = kinds[rng.randrange(len(kinds))]
            t0 = (0.2 + 0.6 * rng.random()) * horizon
            t1 = min(horizon, t0 + (0.05 + 0.15 * rng.random()) * horizon)
            target = (rng.randrange(4) if kind == "kill"
                      else rng.randrange(n_brokers))
            evs.append(FaultEvent(t0, kind, target))
            evs.append(FaultEvent(t1, _PAIRS[kind],
                                  None if kind == "kill" else target))
        evs.sort(key=lambda e: (e.t, ACTIONS.index(e.action),
                                -1 if e.target is None else e.target))
        return cls(tuple(evs))


# single victim-selection rule, shared with the DES (which lives in
# repro_torch.core and cannot import this package)
from repro_torch.core.broker import pick_victim  # noqa: E402  (re-export)


@dataclass
class AppliedFault:
    """One transition as it actually landed (model time + victim)."""
    t: float
    action: str
    target: object = None


class FaultEngine:
    """Owns one timeline and applies it to a live ``ServingCluster``.

    The engine is the ONLY code that knows outages exist: it mutates
    membership through the group's ordinary ``join``/``leave`` path and
    flips broker-writer state, then gets out of the way — replicas and
    producers keep reading the same shared maps they always read.
    ``applied`` records each transition at the model time it landed,
    which is what the recovery metrics window on.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.applied: list[AppliedFault] = []
        self._base_drives: dict[int, int] = {}

    # ---- live runtime -------------------------------------------------------

    def run_live(self, cluster) -> None:
        """Blocking runner (spawn in a thread): sleep to each event's
        wall time, apply, repeat. Exits at the cluster deadline."""
        sp = cluster.spec
        for ev in self.plan.events:
            wall = cluster.t0 + ev.t / sp.time_compression
            while True:
                now = time.perf_counter()
                if now >= cluster.wall_deadline:
                    return
                if now >= wall:
                    break
                time.sleep(min(0.005, wall - now))
            self.apply_live(cluster, ev)

    def apply_live(self, cluster, ev: FaultEvent) -> None:
        t = cluster._now_model()
        if ev.action == "kill":
            victim = pick_victim(cluster.group.members, ev.target)
            if victim is not None:
                cluster.kill_replica(victim)
            self.applied.append(AppliedFault(t, "kill", victim))
        elif ev.action == "revive":
            self.applied.append(
                AppliedFault(t, "revive", cluster.add_replica()))
        elif ev.action in ("stall", "restore"):
            for b, w in self._writers(cluster, ev.target):
                (w.stalled.set if ev.action == "stall"
                 else w.stalled.clear)()
            self.applied.append(AppliedFault(t, ev.action, ev.target))
        elif ev.action in ("drive_drop", "drive_restore"):
            delta = -1 if ev.action == "drive_drop" else 1
            for b, w in self._writers(cluster, ev.target):
                base = self._base_drives.setdefault(
                    b, w.cfg.drives_per_broker)
                w.set_drives(min(base, max(
                    1, w.cfg.drives_per_broker + delta)))
            self.applied.append(AppliedFault(t, ev.action, ev.target))

    @staticmethod
    def _writers(cluster, target: int | None):
        ws = cluster.topic.writers
        if target is None:
            return list(enumerate(ws))
        return [(target % len(ws), ws[target % len(ws)])]
