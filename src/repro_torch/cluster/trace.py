"""Workload traces: recorded request timelines both engines can replay.

A :class:`WorkloadTrace` is a versioned, validated sequence of
timestamped requests — each with a request id, an optional partition
key (keyed traffic pins a partition, like a camera id hashing to one
Kafka partition) and a payload size. One trace drives BOTH execution
engines: ``ClusterSpec.trace`` hands it to the DES as a mirrored event
path (``ClusterSim(trace=...)``) and to the live ``ServingCluster``
through :class:`TraceReplayProducer`, which paces real publishes with
the same chunked absolute-deadline discipline as ``BrokerWriter`` (one
sleep paces a chunk of due events; the absolute wall deadline
self-corrects sleep overshoot instead of letting it accumulate).

Heartbeat windows (the OpenDT dc-mock idiom) mark the trace's time axis
every ``heartbeat_s``: both engines log a zero-duration ``heartbeat``
marker per window, and the digital-twin loop (``crossval.twin_compare``)
compares windowed tail latency and five-way tax per heartbeat window.

On-disk format (JSONL, one object per line):

  header  ``{"format": "repro-trace", "version": 1, "name": ...,
             "horizon_s": ..., "heartbeat_s": ..., "n_events": N}``
  events  ``{"t": ..., "rid": ..., "key": ... | null, "bytes": ...}``
          in non-decreasing ``t`` order, exactly N of them.

Anything else — bad JSON, missing header, unsupported version,
out-of-order timestamps, truncation — raises :class:`TraceError` with
the offending line number, never a silent partial load.

Trace timestamps are post-client wire arrivals: replay publishes each
request straight into the broker at its timestamp (no client send cost,
no linger) in BOTH engines, so a recorded trace replays the arrival
process it observed rather than re-taxing it.

The port's copy of ``repro.cluster.trace``, the same in behaviour: one
seed gives the same numbers in both packages.
"""
from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass, field, replace

TRACE_FORMAT = "repro-trace"
TRACE_VERSION = 1

# default payload: the FaceRec wire crop (FaceRecWorkload.face_bytes)
DEFAULT_PAYLOAD_BYTES = 37_300.0


class TraceError(ValueError):
    """A trace file or trace construction violated the format contract."""


@dataclass(frozen=True)
class TraceEvent:
    """One request arrival: time, id, optional partition key, payload."""
    t: float
    rid: int
    partition_key: int | None = None
    payload_bytes: float = DEFAULT_PAYLOAD_BYTES

    def __post_init__(self):
        if self.t < 0:
            raise TraceError(f"event t must be >= 0, got {self.t}")
        if self.payload_bytes <= 0:
            raise TraceError(
                f"event payload_bytes must be > 0, got {self.payload_bytes}")


@dataclass(frozen=True)
class WorkloadTrace:
    """A validated, immutable request timeline (see module docstring)."""
    name: str
    horizon_s: float
    heartbeat_s: float
    events: tuple = ()
    version: int = TRACE_VERSION

    def __post_init__(self):
        if self.version != TRACE_VERSION:
            raise TraceError(
                f"unsupported trace version {self.version} "
                f"(supported: {TRACE_VERSION})")
        if self.horizon_s <= 0:
            raise TraceError(f"horizon_s must be > 0, got {self.horizon_s}")
        if self.heartbeat_s <= 0:
            raise TraceError(
                f"heartbeat_s must be > 0, got {self.heartbeat_s}")
        evs = tuple(self.events)
        object.__setattr__(self, "events", evs)
        last = 0.0
        rids = set()
        for i, ev in enumerate(evs):
            if not isinstance(ev, TraceEvent):
                raise TraceError(f"events[{i}] is not a TraceEvent")
            if ev.t < last:
                raise TraceError(
                    f"events[{i}] out of order: t={ev.t} after t={last}")
            if ev.t > self.horizon_s:
                raise TraceError(
                    f"events[{i}] t={ev.t} beyond horizon_s={self.horizon_s}")
            if ev.rid in rids:
                raise TraceError(f"events[{i}] duplicate rid {ev.rid}")
            rids.add(ev.rid)
            last = ev.t

    # ---- derived ----------------------------------------------------------

    @property
    def n_events(self) -> int:
        return len(self.events)

    @property
    def offered_rate(self) -> float:
        """Mean arrivals/s over the horizon."""
        return len(self.events) / self.horizon_s

    @property
    def n_windows(self) -> int:
        """Heartbeat windows covering the horizon (last may be partial)."""
        import math
        return max(1, math.ceil(self.horizon_s / self.heartbeat_s - 1e-9))

    def rescale(self, speed_factor: float) -> "WorkloadTrace":
        """The same trace compressed ``speed_factor``x in simulated time.

        Timestamps, the horizon AND the heartbeat window all divide by
        the factor, so windows keep covering the same slices of the
        workload — replaying at speed s is identical to replaying the
        rescaled trace at 1x (the invariant the trace tests pin).
        """
        if speed_factor <= 0:
            raise TraceError(
                f"speed_factor must be > 0, got {speed_factor}")
        if speed_factor == 1.0:
            return self
        s = speed_factor
        return replace(
            self, horizon_s=self.horizon_s / s,
            heartbeat_s=self.heartbeat_s / s,
            events=tuple(replace(ev, t=ev.t / s) for ev in self.events))

    def partition_counts(self, n_partitions: int) -> dict[int, int]:
        """Events per partition under the engines' shared routing rule.

        Keyed events pin ``key % n_partitions``; unkeyed events take a
        round-robin counter that starts at 0 and advances ONLY on
        unkeyed events — exactly what both engines do when replaying a
        trace single-threaded in event order, so a recorded trace's
        expected per-partition counts can be asserted without a run.
        """
        counts = dict.fromkeys(range(n_partitions), 0)
        rr = 0
        for ev in self.events:
            if ev.partition_key is not None:
                counts[ev.partition_key % n_partitions] += 1
            else:
                counts[rr % n_partitions] += 1
                rr += 1
        return counts

    # ---- serialization ----------------------------------------------------

    def _header(self) -> dict:
        return {"format": TRACE_FORMAT, "version": self.version,
                "name": self.name, "horizon_s": self.horizon_s,
                "heartbeat_s": self.heartbeat_s,
                "n_events": len(self.events)}

    def to_jsonl(self, path) -> None:
        with open(path, "w") as f:
            f.write(json.dumps(self._header(), sort_keys=True) + "\n")
            for ev in self.events:
                f.write(json.dumps(
                    {"t": ev.t, "rid": ev.rid, "key": ev.partition_key,
                     "bytes": ev.payload_bytes}, sort_keys=True) + "\n")

    @classmethod
    def from_jsonl(cls, path) -> "WorkloadTrace":
        def bad(lineno: int, why: str) -> TraceError:
            return TraceError(f"{path}:{lineno}: {why}")

        with open(path) as f:
            lines = [ln for ln in (raw.strip() for raw in f) if ln]
        if not lines:
            raise TraceError(f"{path}: empty trace file (no header line)")
        try:
            head = json.loads(lines[0])
        except json.JSONDecodeError as e:
            raise bad(1, f"header is not valid JSON: {e}") from e
        if not isinstance(head, dict) or head.get("format") != TRACE_FORMAT:
            raise bad(1, f"missing {TRACE_FORMAT!r} header "
                         f"(got {head!r:.80})")
        if head.get("version") != TRACE_VERSION:
            raise bad(1, f"unsupported trace version "
                         f"{head.get('version')!r} "
                         f"(supported: {TRACE_VERSION})")
        for key in ("name", "horizon_s", "heartbeat_s", "n_events"):
            if key not in head:
                raise bad(1, f"header missing required field {key!r}")
        events = []
        for lineno, ln in enumerate(lines[1:], start=2):
            try:
                obj = json.loads(ln)
            except json.JSONDecodeError as e:
                raise bad(lineno, f"event is not valid JSON: {e}") from e
            try:
                ev = TraceEvent(
                    t=float(obj["t"]), rid=int(obj["rid"]),
                    partition_key=(None if obj.get("key") is None
                                   else int(obj["key"])),
                    payload_bytes=float(obj.get(
                        "bytes", DEFAULT_PAYLOAD_BYTES)))
            except (KeyError, TypeError, ValueError, TraceError) as e:
                raise bad(lineno, f"bad event: {e}") from e
            if events and ev.t < events[-1].t:
                raise bad(lineno, f"out-of-order event: t={ev.t} after "
                                  f"t={events[-1].t}")
            events.append(ev)
        if len(events) != head["n_events"]:
            raise TraceError(
                f"{path}: truncated or padded trace: header promises "
                f"{head['n_events']} events, file has {len(events)}")
        try:
            return cls(name=str(head["name"]),
                       horizon_s=float(head["horizon_s"]),
                       heartbeat_s=float(head["heartbeat_s"]),
                       events=tuple(events))
        except TraceError as e:
            raise TraceError(f"{path}: {e}") from e

    def trace_hash(self) -> str:
        """Stable content hash (the DES-twin cache key component).

        Canonical-JSON sha256 over the header and every event, so the
        hash survives process restarts and file round-trips — two
        traces hash equal iff they replay identically.
        """
        h = hashlib.sha256()
        h.update(json.dumps(self._header(), sort_keys=True).encode())
        for ev in self.events:
            h.update(json.dumps(
                [ev.t, ev.rid, ev.partition_key, ev.payload_bytes]).encode())
        return h.hexdigest()[:16]


def record_loadgen(gen, horizon_s: float, *, name: str | None = None,
                   heartbeat_s: float | None = None,
                   payload_bytes: float = DEFAULT_PAYLOAD_BYTES,
                   ) -> WorkloadTrace:
    """Snapshot an ``OpenLoopLoadGen`` run into a replayable trace.

    Uses the generator's own per-producer seeded schedules and the live
    cluster's rid convention (``rid = producer + k * n_producers``), so
    the recorded trace carries exactly the arrivals a live run with
    this generator would have produced — the recorder round-trip test
    replays it and checks order, per-partition counts and the five-way
    sum.
    """
    arrivals: list[tuple[float, int]] = []
    for p in range(gen.n_producers):
        for k, t in enumerate(gen.schedule(p, horizon_s)):
            arrivals.append((t, p + k * gen.n_producers))
    arrivals.sort()
    events = tuple(TraceEvent(t=t, rid=rid, payload_bytes=payload_bytes)
                   for t, rid in arrivals)
    return WorkloadTrace(
        name=name or f"loadgen-{gen.process}-{gen.n_producers}x",
        horizon_s=horizon_s,
        heartbeat_s=heartbeat_s or horizon_s / 8,
        events=events)


class TraceReplayProducer:
    """Replays a trace into live broker topics under a speed factor.

    ``timeline()`` is the pure replay schedule — ``(t_replay, event)``
    with ``t_replay = event.t / speed_factor`` — shared by the pacing
    loop and the rescale-invariant property tests. ``run_live`` paces
    real publishes against the wall clock with the ``BrokerWriter``
    chunk discipline: sleep once to the next event's absolute wall
    deadline, then publish EVERY event already due, so ~1 ms sleep
    overshoot on a busy container is amortized across the chunk instead
    of taxing (and serially delaying) every record.
    """

    def __init__(self, trace: WorkloadTrace, speed_factor: float = 1.0):
        if speed_factor <= 0:
            raise TraceError(
                f"speed_factor must be > 0, got {speed_factor}")
        self.trace = trace
        self.speed_factor = speed_factor
        self.heartbeats: list[tuple[int, float]] = []   # (window, t_replay)

    @property
    def window_s(self) -> float:
        """Heartbeat window length in replay time."""
        return self.trace.heartbeat_s / self.speed_factor

    @property
    def horizon_replay_s(self) -> float:
        return self.trace.horizon_s / self.speed_factor

    def timeline(self) -> list[tuple[float, "TraceEvent"]]:
        return [(ev.t / self.speed_factor, ev) for ev in self.trace.events]

    def run_live(self, t0: float, wall_deadline: float,
                 time_compression: float, publish, heartbeat=None,
                 now=time.perf_counter, sleep=time.sleep) -> int:
        """Pace ``publish(event, t_replay)`` against the wall clock.

        ``t0`` anchors replay time 0 at a ``now()`` reading; replay
        seconds map to wall seconds through ``time_compression`` (the
        cluster's model-time contract). ``heartbeat(window, t_replay)``
        fires once per completed heartbeat window, in order, including
        trailing windows after the last event. ``now``/``sleep`` are
        injectable for the deterministic pacing tests. Returns the
        number of events published.
        """
        hb = self.window_s
        next_hb = 1

        def mark_to(t_replay: float) -> None:
            nonlocal next_hb
            while next_hb * hb <= t_replay + 1e-12:
                self.heartbeats.append((next_hb, next_hb * hb))
                if heartbeat is not None:
                    heartbeat(next_hb, next_hb * hb)
                next_hb += 1

        evs = self.timeline()
        published = 0
        i = 0
        while i < len(evs):
            t_rep = evs[i][0]
            wall = t0 + t_rep / time_compression
            while True:
                n = now()
                if n >= wall:
                    break
                if n >= wall_deadline:
                    return published
                sleep(min(0.01, wall - n))
            if now() >= wall_deadline:
                return published
            mark_to(t_rep)
            # chunk: everything already due goes out behind one sleep
            due = (now() - t0) * time_compression
            while i < len(evs) and evs[i][0] <= due:
                publish(evs[i][1], evs[i][0])
                published += 1
                i += 1
        mark_to(self.horizon_replay_s)
        return published
