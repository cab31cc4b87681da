"""Discrete-event simulation of the edge data center (paper §3-§6).

Entities: producer containers (ingest/detect) with a client send path,
Kafka-model brokers with storage write channels, a consumer pool
(identification) with fetch batching, and the event log. Compute times are
the paper's measured stage latencies divided by the AI-acceleration factor
S (the paper's emulation technique, §5.2) while payload sizes are
preserved — inverting their sleep-based emulation into a simulated clock.

The simulator exposes the quantities behind the paper's figures: stage
latency breakdown (Fig 6), latency/throughput vs S (Fig 10), broker
network/storage utilization (Fig 11), the producer-side "Delay" tax of
Object Detection (Fig 14), and the Fig 15 mitigations (drives, brokers,
thumbnail scaling).

The port's copy of ``repro.core.simulator``, the same in behaviour: one
seed gives the same numbers in both packages.
"""
from __future__ import annotations

import heapq
import random
from dataclasses import dataclass, field

from repro_torch.core.broker import (
    BrokerConfig, Message, Topic, pick_victim, range_assignment)
from repro_torch.core.events import EventLog


@dataclass
class FaceRecWorkload:
    """Calibrated from the paper's measurements (§4, Table 2)."""
    name: str = "face_recognition"
    t_ingest: float = 0.0188
    t_detect: float = 0.0748
    t_identify: float = 0.1315
    face_bytes: float = 37_300.0
    faces_per_frame: float = 1.0        # §5 emulation: exactly one
    face_dist: str = "fixed"            # fixed | empirical (0.64 avg, spiky)
    n_producers: int = 840
    n_consumers: int = 1680
    t_send: float = 0.0005              # producer client per-message cost
    accelerate_ingest: bool = True      # §5.2 emulates ingest/detect /S
    batch_per_tick: bool = False        # ObjectDet: S frames per fixed tick
    fps_cap: float | None = None
    ai_stages: tuple = ("detect", "identify")

    @property
    def frame_period(self) -> float:
        if self.fps_cap:
            return 1.0 / self.fps_cap
        return self.t_ingest + self.t_detect

    def sample_faces(self, rng: random.Random) -> int:
        if self.face_dist == "fixed":
            return max(1, round(self.faces_per_frame))
        # empirical-like: 0..5 faces/frame, mean ~0.64, occasional spikes
        r = rng.random()
        if r < 0.55:
            return 0
        if r < 0.80:
            return 1
        if r < 0.92:
            return 2
        return rng.choice([3, 4, 5])


def object_detection_workload() -> FaceRecWorkload:
    """Second application (paper §6): every frame is sent, 30 FPS cap,
    acceleration = more simultaneous streams per producer."""
    return FaceRecWorkload(
        name="object_detection",
        t_ingest=0.0045, t_detect=0.0, t_identify=0.687,
        face_bytes=120_000.0, faces_per_frame=1.0,
        n_producers=21, n_consumers=36 * 56,
        t_send=0.0023, accelerate_ingest=False, batch_per_tick=True,
        fps_cap=30.0, ai_stages=("identify",))


class _Channel:
    """FIFO bandwidth/latency server."""

    def __init__(self, rate: float | None = None):
        self.rate = rate
        self.free_at = 0.0
        self.busy = 0.0
        self.bytes = 0.0

    def submit_bytes(self, t: float, nbytes: float) -> float:
        start = max(t, self.free_at)
        dur = nbytes / self.rate
        self.free_at = start + dur
        self.busy += dur
        self.bytes += nbytes
        return self.free_at

    def submit_time(self, t: float, dur: float, nbytes: float = 0.0) -> float:
        start = max(t, self.free_at)
        self.free_at = start + dur
        self.busy += dur
        self.bytes += nbytes
        return self.free_at


@dataclass
class SimResult:
    workload: str
    speedup: float
    mean_latency: float
    p99_latency: float
    throughput: float
    waiting_mean: float
    waiting_share: float
    stage_means: dict
    unstable: bool
    broker_write_util: float
    broker_net_util: float
    producer_net_util: float
    consumer_net_util: float
    ingest_delay_mean: float = 0.0
    messages: int = 0
    p50_latency: float = 0.0
    p95_latency: float = 0.0
    backlog: int = 0
    unwritten: int = 0
    # measured-only instability: queue growth / producer lag observed in
    # THIS run, with no analytic-rho escape hatch. ``unstable`` keeps the
    # rho short-circuit (short sims near the knee may end before a
    # just-unstable queue visibly diverges); cross-validation against
    # the closed form must use ``diverged`` or the agreement would be
    # circular.
    diverged: bool = False
    # fault/elasticity accounting (dynamic-membership runs only)
    requeues: int = 0               # in-flight work re-enqueued by kills
    fault_events: int = 0           # fault-plan transitions applied
    scale_events: int = 0           # autoscaler actions applied
    final_consumers: int = 0        # alive consumers at sim end
    # reliability accounting (runs with retry/breaker/degrade policies):
    # the ReliabilityReport dict — goodput vs throughput, retry
    # amplification, deadline misses, breaker/degrade timelines
    reliability: dict | None = None

    def to_dict(self):
        return dict(self.__dict__)


class ClusterSim:
    """Event-driven simulation of the deployed application."""

    def __init__(self, wl: FaceRecWorkload, bk: BrokerConfig,
                 speedup: float = 1.0, scale: float = 0.05,
                 sim_time: float = 40.0, warmup: float = 8.0,
                 seed: int = 0, fault_plan=None, autoscale=None,
                 n_partitions: int | None = None, sample_dt: float = 0.25,
                 retry=None, breaker=None, degrade=None, trace=None):
        """``scale`` shrinks producer/consumer counts and broker bandwidth
        together, preserving utilizations and latencies while cutting the
        event count (840 producers -> 42 at scale=0.05).

        ``fault_plan`` (any object with ``.events`` of ``.t/.action/
        .target`` — duck-typed so core never imports the cluster
        package) and ``autoscale`` (an ``AutoscalerConfig``-shaped
        object with ``.interval_s`` and ``.controller()``) switch the
        run onto the dynamic-membership path: consumers become group
        members over ``n_partitions`` partitions (default: one per
        consumer) with range assignment, kills requeue in-flight work,
        and the controller adds/removes members live. Without either,
        the legacy static path runs byte-identically to before (the
        golden DES fixtures pin this).

        ``retry`` / ``breaker`` / ``degrade`` (RetryPolicy /
        BreakerConfig / DegradePolicy-shaped objects from
        ``repro_torch.cluster.reliability``, duck-typed under the same
        layering rule) put the client reliability lifecycle into the
        simulation: attempt timeouts re-publish with jittered backoff,
        hedges duplicate stragglers, per-partition breakers shed toward
        healthy partitions, and the degradation ladder trades accuracy
        for service time under pressure. They require unique message
        keys (the default one-face-per-frame emulation) because the
        lifecycle dedupes by request id, and they force the dynamic
        path.

        ``trace`` (a ``WorkloadTrace``-shaped object with ``.events``
        of ``.t/.rid/.partition_key/.payload_bytes`` and
        ``.heartbeat_s`` — duck-typed under the same layering rule)
        replaces the producer tick process entirely: each trace event
        publishes one message at its timestamp (post-client wire
        arrival — no send cost, no linger, mirroring the live
        ``TraceReplayProducer``), keyed events pin partition
        ``key % n_partitions``, and a zero-duration ``heartbeat``
        marker is logged per ``heartbeat_s`` window. Trace runs force
        the dynamic path; without a trace nothing here changes."""
        self.wl = wl
        self.bk = bk
        self.S = speedup
        self.sim_time = sim_time
        self.warmup = warmup
        self.rng = random.Random(seed)
        self.n_prod = max(1, round(wl.n_producers * scale))
        self.n_cons = max(1, round(wl.n_consumers * scale))
        self.eff_scale = self.n_prod / wl.n_producers
        self.write_ch = [_Channel(bk.storage_write_capacity * self.eff_scale)
                         for _ in range(bk.n_brokers)]
        self.prod_ch = [_Channel() for _ in range(self.n_prod)]
        self.fault_plan = fault_plan
        self.autoscale = autoscale
        self.retry = retry
        self.breaker = breaker
        self.degrade = degrade
        self.trace = trace
        self.heartbeats: list = []              # (window, t) trace markers
        self.dynamic = (fault_plan is not None or autoscale is not None
                        or n_partitions is not None or retry is not None
                        or breaker is not None or degrade is not None
                        or trace is not None)
        self.n_partitions = n_partitions or self.n_cons
        self.sample_dt = sample_dt
        self.topic = Topic("faces", self.n_partitions, bk)
        self.log = EventLog()
        self.msgs: list[Message] = []
        self.ingest_delays: list[float] = []
        self._id = 0
        self._published = 0     # messages handed to a write channel
        # dynamic-path state (inert on the legacy path)
        self._stalled: set[int] = set()              # broker ids
        self._stall_buf: dict[int, list] = {}        # broker -> [(part, msg)]
        self.completions: list = []                  # (t_done, latency)
        self.depth_samples: list = []                # (t, backlog)
        self.requeues = 0
        self.fault_applied: list = []                # (t, action, victim)
        self.scale_actions: list = []
        self.generation = 0
        self._final_alive = self.n_cons
        # reliability state (inert unless retry/breaker/degrade are set)
        self._send = None                       # publish hook for _do_tick
        self._breakers: dict[int, object] = {}  # partition -> CircuitBreaker
        self._completed_map: dict[int, float] = {}   # rid -> t of first win
        self._rel_state: dict[int, dict] = {}        # rid -> attempts/t0
        self.rel_offered = 0
        self.rel_attempts = 0
        self.rel_retries = 0
        self.rel_hedges = 0
        self.rel_hedge_cancels = 0
        self.rel_hedge_wastes = 0
        self.rel_deadline_misses = 0
        self.rel_sheds = 0
        self._deg_depth = 0
        self.degrade_timeline: list = []             # (t, depth, level name)
        self._acc_sum = 0.0
        self._acc_n = 0

    # ---- run ---------------------------------------------------------------

    def run(self) -> SimResult:
        if self.dynamic:
            return self._run_dynamic()
        wl, S = self.wl, self.S
        heap: list = []
        seq = 0

        def push(t, kind, payload):
            nonlocal seq
            heapq.heappush(heap, (t, seq, kind, payload))
            seq += 1

        period = (wl.frame_period if wl.batch_per_tick
                  else wl.frame_period / (S if wl.accelerate_ingest else 1))
        for p in range(self.n_prod):
            push(self.rng.random() * period, "tick",
                 {"producer": p, "scheduled": None})

        consumer_free = [0.0] * self.n_cons

        while heap:
            t, _, kind, pl = heapq.heappop(heap)
            if t > self.sim_time:
                break
            if kind == "tick":
                self._do_tick(t, pl, push, period)
            elif kind == "deliver":
                part, msg = pl["part"], pl["msg"]
                msg.t_written = t
                part.append(t, msg)
                push(t, "poll", {"ci": part.index})
            elif kind == "poll":
                ci = pl["ci"]
                part = self.topic.partitions[ci]
                if not part.backlog:
                    continue
                t_free = max(t, consumer_free[ci])
                ready = sum(m.size for _, m in part.backlog)
                oldest = part.backlog[0][0]
                if (ready < self.bk.fetch_min_bytes
                        and t_free - oldest < self.bk.fetch_max_wait_s - 1e-9):
                    # epsilon guards the float-ulp case where the deferred
                    # poll lands a hair before oldest+max_wait and would
                    # re-defer at the same timestamp forever
                    push(max(oldest + self.bk.fetch_max_wait_s, t_free) + 1e-9,
                         "poll", {"ci": ci})
                    continue
                batch, part.backlog = list(part.backlog), []
                t_busy = t_free
                for _, m in batch:
                    m.t_consumed = t_busy
                    dur = wl.t_identify / S
                    self.log.log(m.key, "wait", m.t_produced, m.t_consumed,
                                 int(m.size))
                    self.log.log(m.key, "identify", t_busy, t_busy + dur,
                                 int(m.size))
                    t_busy += dur
                    self.msgs.append(m)
                consumer_free[ci] = t_busy
        return self._result()

    # ---- dynamic membership (faults + elasticity) --------------------------

    def _run_dynamic(self) -> SimResult:
        """Event loop with live membership over the partition set.

        Consumers become group MEMBERS: ownership is the same
        ``range_assignment`` the live ``ConsumerGroup`` uses, recomputed
        whole on every membership change — the AsyncFlow O(1)-per-
        transition design, so the serve path below carries zero outage
        awareness (it just reads the current owner map). Service is
        event-driven (``done`` events carrying the member's epoch)
        instead of the legacy inline fast-forward, so a kill can fence
        not-yet-finished work with an epoch bump and requeue it for the
        new owner instead of dropping it.
        """
        from repro_torch.core.metrics import percentile
        wl, S = self.wl, self.S
        heap: list = []
        seq = 0

        def push(t, kind, payload):
            nonlocal seq
            heapq.heappush(heap, (t, seq, kind, payload))
            seq += 1

        period = (wl.frame_period if wl.batch_per_tick
                  else wl.frame_period / (S if wl.accelerate_ingest else 1))
        if self.trace is None:
            for p in range(self.n_prod):
                push(self.rng.random() * period, "tick",
                     {"producer": p, "scheduled": None})
        else:
            # trace replay owns the arrival process: events are pushed
            # lazily (each schedules its successor) so a long trace
            # never pre-loads the heap, and the heartbeat chain marks
            # the comparison grid in lock-step with the live replayer
            if self.trace.events:
                push(self.trace.events[0].t, "tev", {"i": 0})
            push(self.trace.heartbeat_s, "hb", {"k": 1})

        alive = set(range(self.n_cons))
        next_cid = self.n_cons
        consumer_free = {c: 0.0 for c in alive}
        epoch = {c: 0 for c in alive}
        # inflight entries are (pi, msg, accuracy_proxy) FIFO
        inflight: dict[int, list] = {c: [] for c in alive}
        owner: dict[int, int] = {}                          # partition -> member
        drives = {b: self.bk.drives_per_broker
                  for b in range(self.bk.n_brokers)}

        # ---- client reliability lifecycle (retry / hedge / breaker) ----
        retry, degrade = self.retry, self.degrade
        rel_on = retry is not None
        rel_active = (retry is not None or self.breaker is not None
                      or degrade is not None)
        # reliability runs poll bounded batches (the live replica's
        # fetch quantum) and re-poll: a member must not serialize an
        # outage-deep queue onto itself — after a revive the NEW owner
        # takes the remainder, exactly like the live sweep re-reading
        # ownership between batches. Plain dynamic runs keep the greedy
        # poll the golden fixtures pin.
        poll_cap = (max(1, int(self.bk.fetch_min_bytes
                               // max(wl.face_bytes, 1.0)))
                    if rel_active else None)
        if self.breaker is not None:
            self._breakers = {pi: self.breaker.make(pi)
                              for pi in range(self.n_partitions)}

        def pick_part_allowed(t):
            # one round-robin candidate per attempt: its breaker either
            # admits or the attempt is shed (and retried against the
            # NEXT partition after backoff). Scanning for any willing
            # partition instead would compound per-partition probe
            # rates into near-certain admission and defeat the breaker.
            part = self.topic.pick_partition()
            b = self._breakers.get(part.index)
            if b is None or b.allow(t):
                return part
            return None

        def rel_send(msg, push, origin="attempt", part=None):
            # publish one attempt (first / retry / hedge) through the
            # breaker-aware partition pick; schedules its own timeout
            # check, plus the request's deadline check and hedge on the
            # first attempt. A keyed trace arrival passes ``part``;
            # the pin sticks for the request's whole retry chain —
            # keyed traffic is partition-affine, so a retry must face
            # the SAME (possibly melted) partition's breaker rather
            # than rotate around the hot key.
            rid = msg.key
            st = self._rel_state.get(rid)
            if st is None:
                st = self._rel_state[rid] = {
                    "n": 0, "t0": msg.t_produced,
                    "pin": part.index if part is not None else None}
                self.rel_offered += 1
                if rel_on:
                    push(st["t0"] + retry.deadline_s, "dlcheck", {"rid": rid})
                    if retry.hedge_delay_s is not None:
                        push(msg.t_published + retry.hedge_delay_s, "hedge",
                             {"rid": rid, "size": msg.size})
            st["n"] += 1
            self.rel_attempts += 1
            retryable = rel_on and origin != "hedge"
            pin = st.get("pin")
            if pin is not None:
                cand = self.topic.partitions[pin]
                b = self._breakers.get(pin)
                part = cand if (b is None or b.allow(msg.t_published)) \
                    else None
            else:
                part = pick_part_allowed(msg.t_published)
            if part is None:
                self.rel_sheds += 1
                self.log.log(rid, "reject", msg.t_published, msg.t_published,
                             int(msg.size), reason="breaker_open")
                # a shed attempt fails instantly: back off and retry
                if retryable and retry.retry_allowed(
                        msg.t_published, st["t0"], st["n"]):
                    push(msg.t_published + retry.backoff_s(rid, st["n"]),
                         "republish", {"rid": rid, "size": msg.size})
                return
            self._route(msg, part, push)
            if rel_on:
                push(msg.t_published + retry.attempt_timeout_s, "rcheck",
                     {"rid": rid, "pi": part.index, "size": msg.size,
                      "retryable": retryable})

        if rel_on or self._breakers:
            self._send = rel_send

        def rebalance(t):
            self.generation += 1
            owner.clear()
            for m, parts in range_assignment(alive, self.n_partitions).items():
                for pi in parts:
                    owner[pi] = m
            for pi in range(self.n_partitions):
                push(t, "poll", {"pi": pi})

        def requeue_member(t, cid):
            # fence cid's scheduled completions, hand its in-flight work
            # back to the partitions — never dropped, so the five-way
            # attribution keeps summing to 1 through a fault
            epoch[cid] += 1
            for pi, m, _acc in reversed(inflight[cid]):
                self.topic.partitions[pi].backlog.insert(0, (t, m))
                self.log.log(m.key, "requeue", t, t, int(m.size))
                self.requeues += 1
            inflight[cid] = []

        def kill(t, rank):
            victim = pick_victim(alive, rank)
            if victim is not None:
                alive.discard(victim)
                requeue_member(t, victim)
                rebalance(t)
            return victim

        def revive(t):
            nonlocal next_cid
            cid = next_cid
            next_cid += 1
            alive.add(cid)
            consumer_free[cid] = t
            epoch[cid] = 0
            inflight[cid] = []
            rebalance(t)
            return cid

        def apply_fault(t, ev):
            act, tgt = ev.action, ev.target
            if act == "kill":
                self.fault_applied.append((t, act, kill(t, tgt)))
                return
            if act == "revive":
                self.fault_applied.append((t, act, revive(t)))
                return
            brokers = (range(self.bk.n_brokers) if tgt is None
                       else [tgt % self.bk.n_brokers])
            if act == "stall":
                self._stalled.update(brokers)
            elif act == "restore":
                for b in brokers:
                    self._stalled.discard(b)
                    # replay deferred writes at pacing from the repair
                    for part, msg in self._stall_buf.pop(b, []):
                        t_avail = self.write_ch[b].submit_bytes(
                            t, msg.size + self.bk.write_overhead_bytes)
                        push(t_avail, "deliver", {"part": part, "msg": msg})
            elif act in ("drive_drop", "drive_restore"):
                from dataclasses import replace
                delta = -1 if act == "drive_drop" else 1
                for b in brokers:
                    drives[b] = max(1, min(drives[b] + delta,
                                           self.bk.drives_per_broker))
                    cap = replace(self.bk, drives_per_broker=drives[b]
                                  ).storage_write_capacity
                    self.write_ch[b].rate = cap * self.eff_scale
            self.fault_applied.append((t, act, tgt))

        rebalance(0.0)
        for ev in (self.fault_plan.events if self.fault_plan else ()):
            push(ev.t, "fault", {"ev": ev})
        ctl = self.autoscale.controller() if self.autoscale else None
        if ctl is not None:
            push(self.autoscale.interval_s, "ctl", {})
        push(self.sample_dt, "sample", {})
        p99_idx = 0     # completions pointer for the recent-window tail

        def backlog_now():
            # undelivered + in-service + stall-deferred, matching the
            # live cluster's produced-minus-done signal the controller
            # is tuned on (LiveTopic.backlog counts writer inboxes too)
            return (sum(len(p.backlog) for p in self.topic.partitions)
                    + sum(len(q) for q in inflight.values())
                    + sum(len(b) for b in self._stall_buf.values()))

        while heap:
            t, _, kind, pl = heapq.heappop(heap)
            if t > self.sim_time:
                break
            if kind == "tick":
                self._do_tick(t, pl, push, period)
            elif kind == "tev":
                # one trace arrival: publish at its timestamp (wire
                # arrival — no send cost / linger, like the live
                # replayer), then schedule the next event lazily
                ev = self.trace.events[pl["i"]]
                msg = Message(key=ev.rid, size=float(ev.payload_bytes),
                              t_produced=t)
                msg.t_published = t
                self._published += 1
                part = (self.topic.partitions[
                    ev.partition_key % self.n_partitions]
                    if ev.partition_key is not None else None)
                if self._send is not None:
                    self._send(msg, push, part=part)
                else:
                    self._route(msg, part if part is not None
                                else self.topic.pick_partition(), push)
                if pl["i"] + 1 < len(self.trace.events):
                    push(self.trace.events[pl["i"] + 1].t, "tev",
                         {"i": pl["i"] + 1})
            elif kind == "hb":
                # heartbeat-window marker: the twin comparison grid
                self.heartbeats.append((pl["k"], t))
                self.log.log(-1, "heartbeat", t, t, window=pl["k"])
                t_next = (pl["k"] + 1) * self.trace.heartbeat_s
                if t_next <= self.sim_time + 1e-9:
                    push(t_next, "hb", {"k": pl["k"] + 1})
            elif kind == "deliver":
                part, msg = pl["part"], pl["msg"]
                msg.t_written = t
                part.append(t, msg)
                push(t, "poll", {"pi": part.index})
            elif kind == "poll":
                pi = pl["pi"]
                part = self.topic.partitions[pi]
                if not part.backlog:
                    continue
                ci = owner.get(pi)
                if ci is None:          # group empty; retry until revive
                    push(t + 10 * period, "poll", {"pi": pi})
                    continue
                t_free = max(t, consumer_free[ci])
                ready = sum(m.size for _, m in part.backlog)
                oldest = part.backlog[0][0]
                if (ready < self.bk.fetch_min_bytes
                        and t_free - oldest
                        < self.bk.fetch_max_wait_s - 1e-9):
                    push(max(oldest + self.bk.fetch_max_wait_s, t_free)
                         + 1e-9, "poll", {"pi": pi})
                    continue
                if poll_cap is None or len(part.backlog) <= poll_cap:
                    batch, part.backlog = list(part.backlog), []
                else:
                    batch = part.backlog[:poll_cap]
                    part.backlog = part.backlog[poll_cap:]
                if rel_on:
                    # request-id dedupe at dequeue: a duplicate whose
                    # twin already won is cancelled before costing any
                    # service time (the cheap hedge outcome)
                    fresh = []
                    for tt, m in batch:
                        if m.key in self._completed_map:
                            self.rel_hedge_cancels += 1
                            self.log.log(m.key, "hedge_cancel", t_free,
                                         t_free, int(m.size))
                        else:
                            fresh.append((tt, m))
                    batch = fresh
                    if not batch:
                        continue
                lvl = degrade.level(self._deg_depth) if degrade else None
                dur = wl.t_identify / S * (lvl.service_factor if lvl else 1.0)
                acc = lvl.accuracy_proxy if lvl else 1.0
                t_busy = t_free
                for _, m in batch:
                    m.t_consumed = t_busy
                    inflight[ci].append((pi, m, acc))
                    push(t_busy + dur, "done",
                         {"ci": ci, "epoch": epoch[ci], "t_start": t_busy})
                    t_busy += dur
                consumer_free[ci] = t_busy
                if part.backlog:
                    # bounded fetch left a remainder: re-poll when this
                    # member frees up (whoever owns the partition THEN
                    # takes it — the rebalance window)
                    push(t_busy, "poll", {"pi": pi})
            elif kind == "done":
                ci = pl["ci"]
                if pl["epoch"] != epoch.get(ci, -1) or not inflight[ci]:
                    continue            # fenced: member killed/shrunk away
                pi, m, acc = inflight[ci].pop(0)
                b = self._breakers.get(pi)
                if b is not None and not (
                        rel_on and t - m.t_published
                        > retry.attempt_timeout_s + 1e-12):
                    # a late completion is not a success signal: its
                    # rcheck already recorded the timeout as the outcome
                    b.record(t, True)
                if rel_on:
                    if m.key in self._completed_map:
                        # both attempts were in service at once: the
                        # loser's span is wasted work, not a completion
                        self.rel_hedge_wastes += 1
                        self.log.log(m.key, "hedge_waste", pl["t_start"], t,
                                     int(m.size))
                        continue
                    self._completed_map[m.key] = t
                self.log.log(m.key, "wait", m.t_produced, m.t_consumed,
                             int(m.size))
                self.log.log(m.key, "identify", pl["t_start"], t,
                             int(m.size))
                if acc < 1.0:
                    name = next((l.name for l in degrade.levels
                                 if l.accuracy_proxy == acc), "degraded")
                    self.log.log(m.key, "degrade", t, t, int(m.size),
                                 accuracy_proxy=acc, level=name)
                self._acc_sum += acc
                self._acc_n += 1
                self.msgs.append(m)
                self.completions.append((t, t - m.t_produced))
            elif kind == "fault":
                apply_fault(t, pl["ev"])
            elif kind == "rcheck":
                # attempt timeout: presumed lost -> breaker failure, and
                # (for the primary chain) a backed-off re-publish
                rid = pl["rid"]
                if rid in self._completed_map:
                    continue
                b = self._breakers.get(pl["pi"])
                if b is not None:
                    b.record(t, False)
                st = self._rel_state[rid]
                if (pl["retryable"]
                        and retry.retry_allowed(t, st["t0"], st["n"])):
                    push(t + retry.backoff_s(rid, st["n"]), "republish",
                         {"rid": rid, "size": pl["size"]})
            elif kind == "republish":
                rid = pl["rid"]
                if rid in self._completed_map:
                    continue
                self.rel_retries += 1
                self.log.log(rid, "retry", t, t, int(pl["size"]))
                m2 = Message(key=rid, size=pl["size"],
                             t_produced=self._rel_state[rid]["t0"])
                m2.t_published = t + self.bk.linger_s
                self._published += 1
                rel_send(m2, push, "retry")
            elif kind == "hedge":
                rid = pl["rid"]
                if rid in self._completed_map:
                    continue
                self.rel_hedges += 1
                self.log.log(rid, "hedge", t, t, int(pl["size"]))
                m2 = Message(key=rid, size=pl["size"],
                             t_produced=self._rel_state[rid]["t0"])
                m2.t_published = t + self.bk.linger_s
                self._published += 1
                rel_send(m2, push, "hedge")
            elif kind == "dlcheck":
                rid = pl["rid"]
                if rid not in self._completed_map:
                    self.rel_deadline_misses += 1
                    self.log.log(rid, "deadline_miss", t, t)
            elif kind == "sample":
                self.depth_samples.append((t, backlog_now()))
                if degrade is not None:
                    per = backlog_now() / max(len(alive), 1)
                    bs = list(self._breakers.values())
                    of = (sum(1 for b in bs if b.state != "closed")
                          / len(bs)) if bs else 0.0
                    nd = degrade.decide(per, of, self._deg_depth)
                    if nd != self._deg_depth:
                        self._deg_depth = nd
                        self.degrade_timeline.append(
                            (t, nd, degrade.level(nd).name))
                push(t + self.sample_dt, "sample", {})
            elif kind == "ctl":
                horizon = 4 * self.autoscale.interval_s
                while (p99_idx < len(self.completions)
                       and self.completions[p99_idx][0] < t - horizon):
                    p99_idx += 1
                recent = [lat for _, lat in self.completions[p99_idx:]]
                p99 = percentile(recent, 0.99) if recent else None
                delta = ctl.decide(t, backlog_now(), len(alive), p99)
                for _ in range(delta):
                    revive(t)
                for _ in range(-delta):
                    if len(alive) > 1:
                        # shrink the newest member, kill-style: fence +
                        # requeue so scale-down loses no in-flight work
                        kill(t, len(alive) - 1)
                push(t + self.autoscale.interval_s, "ctl", {})

        if ctl is not None:
            self.scale_actions = list(ctl.actions)
        self._final_alive = len(alive)
        return self._result()

    def _do_tick(self, t, pl, push, period):
        wl, S = self.wl, self.S
        p = pl["producer"]
        ch = self.prod_ch[p]
        sched = pl.get("scheduled")
        n_frames = max(1, round(S)) if wl.batch_per_tick else 1
        div = S if wl.accelerate_ingest else 1.0
        t_ing = wl.t_ingest / div
        t_det = wl.t_detect / div
        if wl.batch_per_tick:
            # ObjectDet: a frame SET must finish its sends before the next
            # set starts — the client send path is the §6.3 "Delay" tax.
            start = max(t, ch.free_at)
            t_busy = ch.submit_time(start, t_ing)
        else:
            # FaceRec: stages are pipelined — the tick rate carries the
            # throughput; only the client send cost rides the channel.
            start = t
            t_busy = start + t_ing + t_det
        if sched is not None:
            self.ingest_delays.append(max(0.0, start - sched))
        for _ in range(n_frames):
            rid = self._id
            self._id += 1
            self.log.log(rid, "ingest", start, start + t_ing)
            if wl.t_detect:
                self.log.log(rid, "detect", start + t_ing, start + t_ing + t_det)
            for _ in range(wl.sample_faces(self.rng)):
                # client send path (per-message cost), then linger, then
                # the leader broker's storage write channel
                t_sent = ch.submit_time(t_busy, wl.t_send, wl.face_bytes)
                self._published += 1
                msg = Message(key=rid, size=wl.face_bytes, t_produced=t_busy)
                msg.t_published = t_sent + self.bk.linger_s
                if self._send is not None:
                    # reliability lifecycle owns partition choice and
                    # timeout/hedge scheduling for this attempt
                    self._send(msg, push)
                    continue
                self._route(msg, self.topic.pick_partition(), push)
        push(t + period, "tick", {"producer": p, "scheduled": t + period})

    def _route(self, msg, part, push):
        """Hand one message to its leader's write channel (or the stall
        buffer while the fault engine has that broker down — the legacy
        path never populates ``_stalled``, so never defers)."""
        if part.leader in self._stalled:
            self._stall_buf.setdefault(part.leader, []).append((part, msg))
            return
        wch = self.write_ch[part.leader]
        t_avail = wch.submit_bytes(
            msg.t_published, msg.size + self.bk.write_overhead_bytes)
        push(t_avail, "deliver", {"part": part, "msg": msg})

    # ---- results -----------------------------------------------------------

    def _result(self) -> SimResult:
        wl, S = self.wl, self.S
        div = S if wl.accelerate_ingest else 1.0
        msgs = [m for m in self.msgs if m.t_produced >= self.warmup]
        span = max(self.sim_time - self.warmup, 1e-9)
        delays = self.ingest_delays or [0.0]
        d_mean = sum(delays) / len(delays)
        if self.trace is not None:
            # trace replay measures latency per completion (arrival ->
            # done); the frame-period reconstruction below assumes the
            # tick process and would misprice a recorded arrival shape
            lat = sorted(l for tt, l in self.completions
                         if tt - l >= self.warmup)
        else:
            lat = sorted((wl.frame_period / div) + m.broker_wait
                         + wl.t_identify / S + d_mean for m in msgs)
        mean_lat = sum(lat) / len(lat) if lat else float("inf")

        # shared nearest-rank convention (repro_torch.core.metrics), so the
        # DES and live-cluster tails overlay under one definition
        from repro_torch.core.metrics import percentile

        def pct(q: float) -> float:
            return percentile(lat, q) if lat else float("inf")

        p50, p95, p99 = pct(0.50), pct(0.95), pct(0.99)
        backlog = sum(len(p.backlog) for p in self.topic.partitions)
        # a saturated write channel accumulates its queue as deliveries
        # scheduled past sim_time: published-but-never-written messages
        # are backlog too, or storage saturation would be invisible to
        # the measured signal (consumed + partition backlog both stall).
        # Deduped duplicates and shed attempts were published but can
        # never complete — they are amplification, not backlog.
        dups = (self.rel_hedge_cancels + self.rel_hedge_wastes
                + self.rel_sheds)
        unwritten = self._published - len(self.msgs) - backlog - dups
        diverged = ((backlog + unwritten) > 0.08 * max(self._published, 1)
                    or d_mean > 5 * wl.frame_period)
        # instability = measured divergence OR analytic rho >= 1 (a short
        # sim can end before a just-unstable queue visibly diverges)
        if self.trace is None:
            from repro_torch.core.queueing import utilizations
            rho_max = max(u.rho
                          for u in utilizations(wl, self.bk, S).values())
        else:
            # the analytic rho prices the tick process; a trace's
            # offered load is whatever it recorded, so only measured
            # divergence can call a trace run unstable
            rho_max = 0.0
        unstable = (backlog > 0.15 * max(len(self.msgs), 1)
                    or d_mean > 5 * wl.frame_period
                    or rho_max >= 0.995)
        waits = [m.broker_wait for m in msgs]
        waits_m = sum(waits) / len(waits) if waits else float("inf")
        share = (waits_m / mean_lat) if lat and mean_lat > 0 else 1.0
        # utilization vs NOMINAL drive bandwidth (how the paper reports it)
        nominal = (self.bk.drives_per_broker * self.bk.drive_write_bw
                   * self.eff_scale)
        util = (sum(c.bytes for c in self.write_ch)
                / (len(self.write_ch) * nominal * self.sim_time))
        raw = sum(c.bytes for c in self.write_ch) / self.sim_time
        nic = self.bk.net_bw * self.eff_scale
        return SimResult(
            workload=wl.name, speedup=S,
            mean_latency=(float("inf") if unstable else mean_lat),
            p99_latency=(float("inf") if unstable else p99),
            throughput=len(msgs) / span,
            waiting_mean=waits_m, waiting_share=share,
            stage_means=self.log.breakdown(), unstable=unstable,
            broker_write_util=min(util, 1.0 / self._drive_eff()),
            broker_net_util=raw / (len(self.write_ch) * nic),
            producer_net_util=raw / (self.n_prod * nic),
            consumer_net_util=raw / (self.n_cons * nic),
            ingest_delay_mean=d_mean, messages=len(msgs),
            p50_latency=(float("inf") if unstable else p50),
            p95_latency=(float("inf") if unstable else p95),
            backlog=backlog, unwritten=unwritten, diverged=diverged,
            requeues=self.requeues, fault_events=len(self.fault_applied),
            scale_events=len(self.scale_actions),
            final_consumers=self._final_alive,
            reliability=self._reliability_dict())

    def _reliability_dict(self) -> dict | None:
        if (self.retry is None and self.breaker is None
                and self.degrade is None):
            return None
        from repro_torch.core.metrics import reliability_report
        timeline = sorted((tt, pi, s)
                          for pi, b in sorted(self._breakers.items())
                          for tt, s in b.timeline)
        # without a retry policy every publish is its own sole attempt
        offered = (self.rel_offered if self.retry is not None
                   else self._published)
        attempts = (self.rel_attempts if self.retry is not None
                    else self._published)
        deadline = (self.retry.deadline_s if self.retry is not None
                    else float("inf"))
        return reliability_report(
            self.completions, deadline, max(self.sim_time, 1e-9),
            offered=offered, attempts=attempts,
            deadline_misses=self.rel_deadline_misses,
            retries=self.rel_retries, hedges=self.rel_hedges,
            hedge_cancels=self.rel_hedge_cancels,
            hedge_wastes=self.rel_hedge_wastes,
            breaker_sheds=self.rel_sheds,
            accuracy_proxy_mean=(self._acc_sum / self._acc_n
                                 if self._acc_n else 1.0),
            breaker_timeline=timeline,
            degrade_timeline=self.degrade_timeline).to_dict()

    def _drive_eff(self) -> float:
        d = self.bk.drives_per_broker
        return self.bk.drive_efficiency[min(d, len(self.bk.drive_efficiency)) - 1]


def sweep_acceleration(wl: FaceRecWorkload, bk: BrokerConfig,
                       speedups=(1, 2, 4, 6, 8), **kw) -> list[SimResult]:
    return [ClusterSim(wl, bk, speedup=s, **kw).run() for s in speedups]
