"""Multi-replica serving cluster runtime (the live measured system): the
port's copy of ``repro.cluster.cluster``, whose real-service replicas run
the port's identify stack on the card.

``ServingCluster`` runs the paper's deployment shape as real threads on
a real clock: open- or closed-loop producers publish face messages into
a ``LiveTopic`` whose broker write channels are paced at the modeled
storage capacity, and N replica consumers — partition-aware members of
a ``ConsumerGroup`` — drain their assigned partitions through the same
``Batcher`` the streaming pipeline uses, then serve each message with
the identification stage.

Two service modes:
  * ``service="paced"`` — the identify span is the workload's measured
    constant divided by the AI-acceleration factor S (the paper's
    sleep-based emulation, §5.2). Every demand/capacity ratio matches
    the DES and the closed-form queueing model, so the S at which the
    live cluster destabilizes is directly cross-validatable
    (``repro_torch.cluster.crossval``).
  * ``service="real"`` — messages carry codec-encoded crops (planar
    YUV, the wire format) and the replica runs the SAME stack as
    ``StreamingPipeline`` (``facerec.build_identify_stack``) on
    ``ClusterSpec.device`` (the card unless the caller asks for
    ``"cpu"``): decode through the stack's preprocess stage —
    ``ClusterSpec.placement`` moves that decode between the host (the
    plain version on CPU tensors) and the YUV kernel — then the fused
    identify, whose two products are matmul kernel launches. Real
    compute, real host<->device boundary, hardware-dependent latency.
    The replica threads share one stack and launch on PyTorch's current
    stream, as the reference's replicas share one jitted program.

Time compression: all modeled durations are divided by
``time_compression`` so a 6-model-second experiment takes ~1.5 wall
seconds; results are reported back in model seconds. Demand/capacity
ratios — and therefore the knee — are invariant under this scaling.

Everything is logged through one ``EventLog`` (model-time stamps):
``wait`` (partition queue time), ``identify`` (service), ``reject``
(admission drops), so ``ClusterResult.ai_tax()`` splits AI vs
tax exactly like the single-replica pipeline.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field, replace

from repro_torch.core.batching import Batcher, BatchStats
from repro_torch.core.broker import BrokerConfig, Message
from repro_torch.core.events import EventLog
from repro_torch.core.queueing import stability_knee, utilizations
from repro_torch.core.simulator import ClusterSim, FaceRecWorkload
from repro_torch.cluster.loadgen import ClosedLoopLoadGen, OpenLoopLoadGen
from repro_torch.cluster.metrics import LatencyStats, SLOReport, TailSLO
from repro_torch.cluster.scheduler import ConsumerGroup
from repro_torch.cluster.topic import LiveTopic


@dataclass
class ClusterSpec:
    """One deployment configuration, shared by all three models.

    The spec is the single source of truth for the cross-validation:
    ``closed_form_knee`` prices it analytically, ``des_sim`` builds the
    equivalent discrete-event simulation, and ``ServingCluster`` runs
    it live. ``n_producers`` scales the full workload down
    (``eff = n_producers / wl.n_producers``) and the broker bandwidth
    with it, preserving utilizations — the same trick as
    ``ClusterSim(scale=...)``.
    """
    wl: FaceRecWorkload = field(default_factory=FaceRecWorkload)
    bk: BrokerConfig = field(default_factory=BrokerConfig)
    n_replicas: int = 8
    n_producers: int = 4
    n_partitions: int | None = None      # default: one per replica
    speedup: float = 1.0
    time_compression: float = 4.0
    sim_time: float = 6.0                # model seconds
    warmup: float = 1.5
    seed: int = 0
    service: str = "paced"               # paced | real
    arrival: str = "periodic"            # periodic | poisson
    loop: str = "open"                   # open | closed
    n_clients: int = 8                   # closed loop population
    think_s: float = 0.0                 # closed loop think time (model s)
    admission: str = "none"              # none | drop | block
    partition_capacity: int = 64         # in-flight bound for drop/block
    fetch_max_wait_s: float | None = None   # default: bk.fetch_max_wait_s
    placement: str = "host"              # real mode: where the replica's
    #                                      crop decode runs (host|device)
    device: str = "cuda"                 # real mode: where the identify
    #                                      stack runs (raises with no card)
    fault_plan: object = None            # FaultPlan; one timeline drives
    #                                      BOTH engines (live + DES)
    autoscale: object = None             # AutoscalerConfig; elastic
    #                                      replica count in both engines
    retry: object = None                 # RetryPolicy; deadline + retry +
    #                                      hedge lifecycle in both engines
    breaker: object = None               # BreakerConfig; per-partition
    #                                      circuit breakers in both engines
    degrade: object = None               # DegradePolicy; graceful quality
    #                                      ladder in both engines
    trace: object = None                 # WorkloadTrace; ONE recorded
    #                                      arrival timeline replayed by
    #                                      BOTH engines (replaces loadgen)
    scenario: str | None = None          # library scenario name; resolved
    #                                      to a trace at sim_time horizon
    trace_speed: float = 1.0             # replay speed factor (the trace
    #                                      is rescaled for both engines)

    @property
    def eff(self) -> float:
        return self.n_producers / self.wl.n_producers

    @property
    def partitions(self) -> int:
        return self.n_partitions or self.n_replicas

    @property
    def period_s(self) -> float:
        """Per-producer inter-arrival time at this S (model seconds)."""
        div = self.speedup if self.wl.accelerate_ingest else 1.0
        return self.wl.frame_period / div

    def scaled_broker(self) -> BrokerConfig:
        return self.bk.scaled(self.eff)

    def scaled_workload(self) -> FaceRecWorkload:
        return replace(self.wl, n_producers=self.n_producers,
                       n_consumers=self.n_replicas)

    def closed_form_knee(self) -> float:
        return stability_knee(self.scaled_workload(), self.scaled_broker())

    def predicted_rho(self) -> dict[str, float]:
        us = utilizations(self.scaled_workload(), self.scaled_broker(),
                          self.speedup)
        return {name: u.rho for name, u in us.items()}

    def resolve_trace(self):
        """The replay-ready trace both engines consume, or ``None``.

        An explicit ``trace`` wins; otherwise a ``scenario`` name is
        built at the spec's own horizon and seed (deterministic, so
        repeated resolution yields hash-identical traces). The
        ``trace_speed`` rescale is applied HERE, once, so the live
        replayer and the DES see the identical compressed timeline.
        """
        tr = self.trace
        if tr is None and self.scenario is not None:
            from repro_torch.cluster.scenarios import build_trace
            tr = build_trace(self.scenario, horizon_s=self.sim_time,
                             seed=self.seed)
        if tr is None or self.trace_speed == 1.0:
            return tr
        return tr.rescale(self.trace_speed)

    def des_sim(self, speedup: float | None = None, *, sim_time: float = 20.0,
                warmup: float = 4.0, seed: int | None = None) -> ClusterSim:
        """The equivalent DES run (scale pre-applied, so scale=1).

        A spec with a ``fault_plan``, ``autoscale``, explicit
        ``n_partitions``, or a ``trace``/``scenario`` hands them to the
        DES (duck-typed — ``repro_torch.core`` never imports the cluster
        package), switching it onto the dynamic-membership path so both
        engines replay one timeline over one topology. Default specs
        keep the legacy static path (pinned by the golden fixtures)
        byte-identical."""
        resolved = self.resolve_trace()
        kw: dict = {}
        if (self.fault_plan is not None or self.autoscale is not None
                or self.n_partitions is not None or self.retry is not None
                or self.breaker is not None or self.degrade is not None
                or resolved is not None):
            kw = dict(fault_plan=self.fault_plan, autoscale=self.autoscale,
                      n_partitions=self.partitions, retry=self.retry,
                      breaker=self.breaker, degrade=self.degrade,
                      trace=resolved)
        return ClusterSim(self.scaled_workload(), self.scaled_broker(),
                          speedup=self.speedup if speedup is None else speedup,
                          scale=1.0, sim_time=sim_time, warmup=warmup,
                          seed=self.seed if seed is None else seed, **kw)


@dataclass
class ClusterResult:
    spec_speedup: float
    n_replicas: int
    produced: int
    completed: int
    dropped: int
    backlog: int
    diverged: bool
    latency: LatencyStats
    throughput: float                  # completions/s, model time
    utilization: dict                  # measured busy fractions
    predicted_rho: dict                # closed-form rho at this S
    producer_lag_mean: float           # model seconds behind schedule
    rebalances: int
    fetch_stats: BatchStats
    log: EventLog
    slo: SLOReport | None = None
    inflight_growth: float = 0.0       # second-half minus first-half mean
    requeues: int = 0                  # in-flight work re-enqueued on kills
    faults: list = field(default_factory=list)        # AppliedFault records
    scale_actions: list = field(default_factory=list)  # ScaleAction records
    samples: list = field(default_factory=list)       # (t_complete, latency)
    inflight_samples: list = field(default_factory=list)  # (t, in-flight)
    reliability: dict | None = None    # ReliabilityReport.to_dict(), when
    #                                    a retry/breaker/degrade policy ran
    heartbeats: list = field(default_factory=list)  # (window, t) trace
    #                                    replay markers (trace runs only)
    batch_spans: list = field(default_factory=list)  # real mode: (batch
    #                                    size, wall seconds) of every decode
    #                                    + identify call, in no set order

    @property
    def drop_fraction(self) -> float:
        offered = self.produced + self.dropped
        return self.dropped / offered if offered else 0.0

    def ai_tax(self) -> dict:
        from repro_torch.core import facerec
        return self.log.ai_tax(ai_stages={"identify"},
                               category_of=facerec.stage_category)

    def to_dict(self) -> dict:
        d = dict(self.__dict__)
        d["latency"] = self.latency.to_dict()
        d["faults"] = [(f.t, f.action, f.target) for f in self.faults]
        d["scale_actions"] = [(a.t, a.delta, a.n_before, a.reason)
                              for a in self.scale_actions]
        d.pop("log")
        d.pop("samples")
        d.pop("inflight_samples")
        d.pop("batch_spans")
        return d


class _ReplicaState:
    """Per-replica accumulators; merged single-threaded at result time."""

    def __init__(self, name: str):
        self.name = name
        self.latencies: list[tuple[float, float]] = []  # (t_submit, latency)
        self.busy_model = 0.0
        self.served = 0       # unique wins (client-visible completions)
        self.consumed = 0     # everything drained, incl. cancelled/wasted
        #                       duplicates — the backlog-accounting count
        self.acc_sum = 0.0    # accuracy proxy over wins (degradation cost)
        self.acc_n = 0
        self.stats = BatchStats()
        self.batch_spans: list[tuple[int, float]] = []  # real mode


class WireCrops:
    """One feeder thread's messages' crops in the wire format: its
    generator's (48, 48, 3) uint8 draws through the camera's encoder
    (``preprocess.host.rgb_to_yuv``, planar YUV), one a message.

    The first ``ahead`` are drawn and encoded in bulk when this is made,
    which an open-loop producer does before the run's clock starts: in
    the deployment the cameras are other hosts, and encoding on the
    clock put their codec's work on the cluster's own host, where it
    delayed the producers' schedule and the replicas. The crops are the
    same, byte for byte, as drawing and encoding one a call.
    """

    CHUNK = 256                      # crops a bulk encode (bounds its temp)

    def __init__(self, rng, ahead: int = 0):
        import numpy as np
        self._rng = rng
        self._ahead = np.empty((ahead, 3, 48, 48), np.uint8)
        for j in range(0, ahead, self.CHUNK):
            n = min(self.CHUNK, ahead - j)
            self._ahead[j:j + n] = self._encode((n, 48, 48, 3))
        self._i = 0

    def _encode(self, shape):
        import numpy as np
        from repro_torch.preprocess import host as pre_host
        return pre_host.rgb_to_yuv(
            self._rng.integers(0, 256, shape, dtype=np.uint8))

    def next(self):
        """The next message's (3, 48, 48) uint8 wire crop."""
        if self._i < len(self._ahead):
            self._i += 1
            return self._ahead[self._i - 1]
        return self._encode((48, 48, 3))


class ServingCluster:
    def __init__(self, spec: ClusterSpec, slo: TailSLO | None = None):
        self.spec = spec
        self.slo = slo
        self.log = EventLog()
        self.group = ConsumerGroup(spec.partitions)
        self._lock = threading.Lock()          # producer-side counters
        self.produced = 0
        self.dropped = 0
        self._lag_sum = 0.0
        self._replica_states: dict[str, _ReplicaState] = {}
        self._replica_threads: list[threading.Thread] = []
        self._removed: set[str] = set()
        self._killed: set[str] = set()
        self._feeder_threads: list[threading.Thread] = []
        self._done_events: dict[int, threading.Event] = {}
        self._identify = None                  # lazy, real mode only
        self._n_spawned = 0
        self._inflight_samples: list[tuple[float, int]] = []
        self.heartbeats: list[tuple[float, float]] = []  # trace replay
        self.fault_engine = None
        self.autoscaler = None
        # ---- reliability lifecycle (retry / hedge / breaker / degrade) ----
        # the retry+breaker path reroutes _produce_one through
        # _produce_rel; degrade alone only scales service in _serve
        self._rel_routed = (spec.retry is not None
                            or spec.breaker is not None)
        self._breakers: dict[int, object] = {}   # pi -> CircuitBreaker
        self._rel_state: dict[int, dict] = {}    # rid -> attempt ledger
        self._rel_completed: dict[int, float] = {}  # rid -> t_win (dedupe)
        self._rel_inservice: dict[int, float | None] = {}  # rid -> planned
        #                                      t_fin (None until known)
        self._rel_offered = 0
        self._rel_attempts = 0
        self._rel_retries = 0
        self._rel_hedges = 0
        self._rel_hedge_cancels = 0
        self._rel_hedge_wastes = 0
        self._rel_deadline_misses = 0
        self._rel_sheds = 0
        # model-time timer wheel for rcheck/republish/hedge/dlcheck —
        # one daemon thread sleeps on this condition (its OWN lock, the
        # sanctioned wait-under-lock pattern) until the next due event
        self._rel_cv = threading.Condition()
        self._rel_heap: list = []                # (t_model, seq, kind, pl)
        self._rel_seq = itertools.count()
        self._deg_depth = 0
        self.degrade_timeline: list[tuple[float, int, str]] = []

    # ---- time -------------------------------------------------------------

    def _now_model(self) -> float:
        return (time.perf_counter() - self.t0) * self.spec.time_compression

    # ---- lifecycle --------------------------------------------------------

    def warm(self) -> None:
        """Real mode: build the identify stack on ``spec.device`` and warm
        it, once (``start`` calls it; a caller may call it first, to count
        the timed run's kernel launches apart from the warm-up's)."""
        sp = self.spec
        if sp.service != "real" or self._identify is not None:
            return
        import numpy as np
        from repro_torch.core import facerec
        # same shared factory as StreamingPipeline (the replica IS
        # the pipeline's identify stage): the replica decodes the
        # wire-format YUV crops through the stack's preprocess
        # stage (sp.placement moves that work host<->device) and
        # identifies with the fused matmul kernels. The stage logs
        # nowhere here — its clock is wall time, this log is model
        # time; the decode cost lands inside the measured service
        # span instead.
        stack = facerec.build_identify_stack(
            seed=sp.seed, fast_path=True, placement=sp.placement,
            device=sp.device)
        # warm every power-of-two batch bucket the drain-all fetch
        # can produce BEFORE the clock starts: the first-use nvcc
        # build and load of the kernel libraries, the first cuBLAS
        # handle (the gallery product) and the allocator's blocks for
        # the tile route's split-K workspace would otherwise land in
        # the timed window and masquerade as queueing collapse
        for b in (1, 2, 4, 8, 16, 32, 64):
            stack.fused.identify_crops(stack.preprocess.decode(
                np.zeros((b, 3, 48, 48), np.uint8)))
        self._stack = stack
        self._identify = stack.fused
        self._preprocess = stack.preprocess

    def start(self) -> None:
        sp = self.spec
        self.warm()
        trace = sp.resolve_trace()
        feeds = []
        if trace is None and sp.loop != "closed":
            # open-loop producers: each one's schedule, and in real mode
            # its crops encoded ahead, before the clock starts
            gen = OpenLoopLoadGen(sp.n_producers, sp.period_s,
                                  process=sp.arrival, seed=sp.seed)
            for i in range(gen.n_producers):
                schedule = gen.schedule(i, sp.sim_time)
                feeds.append((schedule, self._wire_crops(i, len(schedule))))
        self.t0 = time.perf_counter()
        self.wall_deadline = self.t0 + sp.sim_time / sp.time_compression
        self.topic = LiveTopic("faces", sp.partitions, sp.scaled_broker(),
                               sp.time_compression, self.wall_deadline)
        self.topic.start()
        if sp.breaker is not None:
            self._breakers = {pi: sp.breaker.make(pi)
                              for pi in range(sp.partitions)}
        if sp.retry is not None:
            # timeout/backoff/hedge/deadline events fire in model time;
            # without a retry policy nothing schedules, so no thread
            rt = threading.Thread(target=self._reliability_loop,
                                  daemon=True)
            self._feeder_threads.append(rt)
            rt.start()
        for _ in range(sp.n_replicas):
            self.add_replica()
        if trace is not None:
            # trace replay owns the arrival process (loadgen idle): one
            # producer thread paces the recorded timeline with the
            # BrokerWriter chunk discipline
            tt = threading.Thread(target=self._trace_producer,
                                  daemon=True, args=(trace,))
            self._feeder_threads.append(tt)
            tt.start()
        elif sp.loop == "closed":
            gen = ClosedLoopLoadGen(sp.n_clients, sp.think_s,
                                    process=sp.arrival, seed=sp.seed)
            for i in range(gen.n_clients):
                t = threading.Thread(target=self._client, daemon=True,
                                     args=(i, gen.think_sampler(i)))
                self._feeder_threads.append(t)
                t.start()
        else:
            for i, (schedule, crops) in enumerate(feeds):
                t = threading.Thread(target=self._producer, daemon=True,
                                     args=(i, schedule, crops))
                self._feeder_threads.append(t)
                t.start()
        mon = threading.Thread(target=self._monitor, daemon=True)
        self._feeder_threads.append(mon)
        mon.start()
        if sp.fault_plan is not None:
            from repro_torch.cluster.faults import FaultEngine
            self.fault_engine = FaultEngine(sp.fault_plan)
            ft = threading.Thread(target=self.fault_engine.run_live,
                                  args=(self,), daemon=True)
            self._feeder_threads.append(ft)
            ft.start()
        if sp.autoscale is not None:
            # build the controller BEFORE the thread exists: attaching
            # it from inside the loop published self.autoscaler across
            # threads unlocked (_result() reads it at shutdown)
            self.autoscaler = sp.autoscale.controller()
            at = threading.Thread(target=self._autoscale_loop, daemon=True)
            self._feeder_threads.append(at)
            at.start()

    def _monitor(self) -> None:
        """Samples the in-flight population for the divergence signal.

        A stable system near the knee legitimately carries a large
        steady-state in-flight population (Little's law: rate x
        latency), so an absolute end-of-run backlog can't separate
        "high but flat" from "growing". The monitor records
        (t_model, produced - completed) every ~50 ms wall; divergence
        compares the two post-warmup half-window means.
        """
        sp = self.spec
        while time.perf_counter() < self.wall_deadline:
            # snapshot: add_replica() may insert mid-iteration; consumed
            # (not served) so a drained hedge duplicate leaves the
            # in-flight population like any other record
            states = list(self._replica_states.values())
            done = sum(st.consumed for st in states)
            t = self._now_model()
            backlog = self.produced - done
            self._inflight_samples.append((t, backlog))
            if sp.degrade is not None:
                # degradation controller rides the monitor cadence:
                # per-replica backlog + breaker-open fraction in, ladder
                # depth out — same decide() as the DES sample event
                per = backlog / max(len(states), 1)
                bs = list(self._breakers.values())
                of = (sum(1 for b in bs if b.state != "closed")
                      / len(bs)) if bs else 0.0
                nd = sp.degrade.decide(per, of, self._deg_depth)
                if nd != self._deg_depth:
                    with self._lock:
                        self._deg_depth = nd
                    self.degrade_timeline.append(
                        (t, nd, sp.degrade.level(nd).name))
            time.sleep(0.05)

    def add_replica(self) -> str:
        # under _lock: the autoscaler thread and the fault engine can
        # both add replicas while the monitor iterates the states
        with self._lock:
            name = f"replica-{self._n_spawned}"
            self._n_spawned += 1
            st = _ReplicaState(name)
            self._replica_states[name] = st
        # join the group HERE, not in the replica thread: membership is
        # then synchronous with add/remove calls, so remove_replica()
        # can never race an in-flight join and leave a ghost member
        # owning partitions no thread serves
        self.group.join(name)
        t = threading.Thread(target=self._replica, daemon=True,
                             args=(name, st))
        self._replica_threads.append(t)
        t.start()
        return name

    def remove_replica(self, name: str) -> None:
        """Revoke the replica's partitions; the group rebalances onto
        the survivors and the thread exits at its next ownership check."""
        self._removed.add(name)
        self.group.leave(name)

    def kill_replica(self, name: str) -> None:
        """Abrupt failure (fault engine): same membership transition as
        a graceful leave — the group just sees a member vanish — but
        tracked separately so results can attribute the rebalance to a
        fault. The victim's held-back records are requeued (with a
        logged ``requeue`` event) on its way out, never dropped."""
        self._killed.add(name)
        self.group.leave(name)

    def _autoscale_loop(self) -> None:
        """Samples backlog + recent tail every interval and applies the
        controller's delta through the ordinary join/leave path — the
        group code never learns that elasticity exists (same zero-
        awareness contract as the fault engine)."""
        sp = self.spec
        ctl = self.autoscaler
        from repro_torch.cluster.metrics import percentile
        interval_wall = sp.autoscale.interval_s / sp.time_compression
        horizon = 4 * sp.autoscale.interval_s
        while True:
            time.sleep(min(interval_wall, max(
                0.0, self.wall_deadline - time.perf_counter())) or 0.001)
            if time.perf_counter() >= self.wall_deadline:
                return
            t = self._now_model()
            states = list(self._replica_states.values())
            backlog = self.produced - sum(st.consumed for st in states)
            recent = [lat for st in states
                      for t_sub, lat in st.latencies[-256:]
                      if t_sub + lat > t - horizon]
            p99 = percentile(recent, 0.99) if recent else None
            members = self.group.members
            delta = ctl.decide(t, backlog, len(members), p99)
            for _ in range(delta):
                self.add_replica()
            if delta < 0:
                # shrink newest-first: replica names carry their spawn
                # index, so "newest" is well-defined and deterministic
                for name in sorted(
                        members,
                        key=lambda n: -int(n.rsplit("-", 1)[1]))[:-delta]:
                    if len(self.group.members) > 1:
                        self.remove_replica(name)

    def run(self) -> ClusterResult:
        self.start()
        for t in self._feeder_threads:
            t.join()
        for t in self._replica_threads:
            t.join()
        self.topic.join()
        return self._result()

    # ---- producers (open loop) --------------------------------------------

    def _crop_rng(self, stream: int):
        """Per-feeder-thread crop generator (real mode): seeding a fresh
        Generator per message would tax the very path being timed."""
        import numpy as np
        return np.random.default_rng(self.spec.seed * 7919 + stream)

    def _wire_crops(self, stream: int, ahead: int = 0):
        """Feeder ``stream``'s wire-format crops (real mode; None in
        paced mode), the next ``ahead`` of them encoded now."""
        if self.spec.service != "real":
            return None
        return WireCrops(self._crop_rng(stream), ahead)

    def _produce_one(self, rid: int, scheduled_model: float,
                     crops=None, part=None, size=None) -> bool:
        """Admit + publish one message; False if dropped/rejected.

        ``part``/``size`` carry a trace event's pinned partition (keyed
        traffic) and recorded payload; loadgen callers leave both None
        (round-robin pick, workload payload) — unchanged behavior.
        """
        sp = self.spec
        if self._rel_routed:
            return self._produce_rel(rid, scheduled_model, crops,
                                     part=part, size=size)
        if part is None:
            part = self.topic.pick_partition()
        bounded = sp.admission in ("drop", "block")
        while True:            # check-and-admit atomically across producers
            with self._lock:
                if not bounded or part.in_flight < sp.partition_capacity:
                    part.accepted += 1
                    self.produced += 1
                    admitted = True
                    break
                if sp.admission == "drop":
                    self.dropped += 1
                    admitted = False
                    break
            # block: wait for capacity, then RE-check under the lock
            if time.perf_counter() >= self.wall_deadline:
                return False
            time.sleep(0.002)
        now = self._now_model()
        if not admitted:
            self.log.log(rid, "reject", now, now,
                         payload_bytes=int(sp.wl.face_bytes))
            return False
        msg = Message(key=rid,
                      size=sp.wl.face_bytes if size is None else size,
                      t_produced=now)
        msg.meta["scheduled"] = scheduled_model
        if sp.service == "real":
            msg.meta["crop_yuv"] = crops.next()
            msg.size = float(msg.meta["crop_yuv"].nbytes)
        with self._lock:
            self._lag_sum += max(0.0, now - scheduled_model)
        self.topic.publish(msg, part)
        return True

    # ---- reliability lifecycle (mirrors the DES rel_send/rcheck path) -----

    def _produce_rel(self, rid: int, scheduled_model: float,
                     crops=None, part=None, size=None) -> bool:
        """Register one request and issue its first attempt.

        The reliability path replaces bounded admission with breaker
        shedding: an attempt whose round-robin partition refuses it is
        rejected instantly (and retried after backoff, if the policy
        allows), never blocked — a client with a deadline cannot wait on
        the producer side. A trace event's pinned ``part`` sticks for
        the request's whole retry chain (keyed traffic is
        partition-affine — same rule as the DES ``rel_send``).
        """
        sp = self.spec
        now = self._now_model()
        size = sp.wl.face_bytes if size is None else size
        crop_yuv = None
        if sp.service == "real":
            crop_yuv = crops.next()
            size = float(crop_yuv.nbytes)
        with self._lock:
            # attempt ledger: retries re-publish from this template so a
            # re-sent message carries the ORIGINAL payload + t_produced
            # (client-perceived latency spans all attempts)
            self._rel_state[rid] = {"n": 0, "t0": now, "size": size,
                                    "crop": crop_yuv,
                                    "pin": part.index if part is not None
                                    else None}
            self._rel_offered += 1
            self._lag_sum += max(0.0, now - scheduled_model)
        if sp.retry is not None:
            t_dl = now + sp.retry.deadline_s
            self._rel_schedule(t_dl, "dlcheck", (rid, t_dl))
            if sp.retry.hedge_delay_s is not None:
                t_h = now + sp.retry.hedge_delay_s
                self._rel_schedule(t_h, "hedge", (rid, t_h))
        return self._rel_attempt(rid, "attempt")

    def _rel_attempt(self, rid: int, origin: str) -> bool:
        """One publish attempt (first / retry / hedge) for a known rid."""
        sp, retry = self.spec, self.spec.retry
        now = self._now_model()
        with self._lock:
            st = self._rel_state.get(rid)
            if st is None:
                return False
            st["n"] += 1
            n = st["n"]
            self._rel_attempts += 1
        retryable = retry is not None and origin != "hedge"
        # one round-robin candidate per attempt: its breaker admits or
        # the attempt is shed and retried against the NEXT partition
        # after backoff (scanning for any willing partition would
        # compound per-partition probe rates into near-certain
        # admission — same rule as the DES pick_part_allowed). A
        # pinned (keyed-trace) request always faces its own partition.
        pin = st.get("pin")
        part = (self.topic.partitions[pin] if pin is not None
                else self.topic.pick_partition())
        b = self._breakers.get(part.index)
        if b is not None and not b.allow(now):
            with self._lock:
                self._rel_sheds += 1
            self.log.log(rid, "reject", now, now, int(st["size"]),
                         reason="breaker_open")
            if retryable and retry.retry_allowed(now, st["t0"], n):
                t_r = now + retry.backoff_s(rid, n)
                self._rel_schedule(t_r, "republish", (rid, t_r))
            return False
        msg = Message(key=rid, size=st["size"], t_produced=st["t0"])
        msg.meta["rel_pub"] = now       # late-completion gate in _serve
        if st["crop"] is not None:
            msg.meta["crop_yuv"] = st["crop"]
        with self._lock:
            part.accepted += 1
            self.produced += 1
        self.topic.publish(msg, part)
        if retry is not None:
            t_due = now + retry.attempt_timeout_s
            self._rel_schedule(t_due, "rcheck",
                               (rid, part.index, retryable, t_due))
        return True

    def _rel_schedule(self, t_model: float, kind: str, payload) -> None:
        with self._rel_cv:
            heapq.heappush(self._rel_heap,
                           (t_model, next(self._rel_seq), kind, payload))
            self._rel_cv.notify()

    def _reliability_loop(self) -> None:
        """Model-time timer wheel for the request lifecycle.

        Pops rcheck/republish/hedge/dlcheck events as they come due,
        firing each OUTSIDE the condition (handlers publish and take
        other locks). Waiting happens on the condition's own lock —
        the wheel never sleeps holding anyone else's.
        """
        sp = self.spec
        while True:
            with self._rel_cv:
                now = self._now_model()
                while not self._rel_heap or self._rel_heap[0][0] > now:
                    if time.perf_counter() >= self.wall_deadline:
                        return
                    gap_wall = ((self._rel_heap[0][0] - now)
                                / sp.time_compression
                                if self._rel_heap else 0.05)
                    self._rel_cv.wait(timeout=min(max(gap_wall, 0.0005),
                                                  0.05))
                    now = self._now_model()
                t, _, kind, pl = heapq.heappop(self._rel_heap)
            self._rel_fire(kind, pl)

    def _rel_verdict(self, rid: int, t_due: float):
        """Model-time completion verdict for a timer due at ``t_due``.

        The DES processes completions and timers in strict model-time
        order, so an rcheck/dlcheck "sees" a completion iff its model
        finish time precedes the timer. The live replica backdates each
        item's ``t_fin`` inside the batch span but records it only when
        the batch's service SLEEP ends — wall time runs ahead of the
        books, and a membership test here would book false failures for
        items that completed (in model time) mid-batch. So: defer the
        verdict while the rid is mid-service, then compare recorded
        ``t_fin`` against ``t_due`` — the same ordering the DES gets
        for free. Returns ``("done"|"pending"|"defer", st)``.
        """
        with self._lock:
            st = self._rel_state.get(rid)
            t_fin = self._rel_completed.get(rid)
            inserv = rid in self._rel_inservice
            eta = self._rel_inservice.get(rid)
        if st is None:
            return "done", None
        if t_fin is not None and t_fin <= t_due + 1e-12:
            return "done", st
        if t_fin is None and inserv:
            if eta is None:
                # real-service batch: no pacing plan, wait for the books
                return "defer", st
            # paced batch: rule punctually on the planned finish time
            return ("done" if eta <= t_due + 1e-12 else "pending"), st
        return "pending", st

    def _rel_fire(self, kind: str, pl) -> None:
        retry = self.spec.retry
        now = self._now_model()
        if kind == "rcheck":
            # attempt timeout: presumed lost -> breaker failure, and
            # (for the primary chain) a backed-off re-publish
            rid, pi, retryable, t_due = pl
            verdict, st = self._rel_verdict(rid, t_due)
            if verdict == "done":
                return
            if verdict == "defer":
                self._rel_schedule(now + 0.02, kind, pl)
                return
            b = self._breakers.get(pi)
            if b is not None:
                b.record(t_due, False)
            if retryable and retry.retry_allowed(t_due, st["t0"], st["n"]):
                t_r = t_due + retry.backoff_s(rid, st["n"])
                self._rel_schedule(t_r, "republish", (rid, t_r))
        elif kind in ("republish", "hedge"):
            rid, t_due = pl
            verdict, st = self._rel_verdict(rid, t_due)
            if verdict == "done":
                return
            if verdict == "defer":
                self._rel_schedule(now + 0.02, kind, pl)
                return
            with self._lock:
                if kind == "republish":
                    self._rel_retries += 1
                else:
                    self._rel_hedges += 1
            self.log.log(rid, "retry" if kind == "republish" else "hedge",
                         now, now, int(st["size"]))
            self._rel_attempt(rid, "retry" if kind == "republish"
                              else "hedge")
        elif kind == "dlcheck":
            rid, t_due = pl
            verdict, _ = self._rel_verdict(rid, t_due)
            if verdict == "defer":
                self._rel_schedule(now + 0.02, kind, pl)
                return
            if verdict == "pending":
                with self._lock:
                    self._rel_deadline_misses += 1
                self.log.log(rid, "deadline_miss", t_due, t_due)

    def _trace_producer(self, trace) -> None:
        """Replay the resolved trace into the live topic.

        One thread paces every recorded arrival (the trace is already
        rescaled, so the replayer runs at 1x): publishes go through the
        ordinary ``_produce_one`` path with the event's pinned
        partition and payload, and each completed heartbeat window is
        recorded + logged as a zero-duration marker at its grid time —
        the same (window, t) pairs the DES emits, so the twin loop
        compares like against like.
        """
        from repro_torch.cluster.trace import TraceReplayProducer
        sp = self.spec
        crops = self._wire_crops(0)
        rp = TraceReplayProducer(trace)

        def publish(ev, t_rep):
            part = (self.topic.partitions[ev.partition_key % sp.partitions]
                    if ev.partition_key is not None else None)
            self._produce_one(ev.rid, t_rep, crops, part=part,
                              size=float(ev.payload_bytes))

        def heartbeat(k, t_mark):
            self.heartbeats.append((k, t_mark))
            self.log.log(-1, "heartbeat", t_mark, t_mark, window=k)

        rp.run_live(self.t0, self.wall_deadline, sp.time_compression,
                    publish, heartbeat)

    def _producer(self, i: int, schedule: list[float], crops) -> None:
        sp = self.spec
        for k, arrival in enumerate(schedule):
            wall = self.t0 + arrival / sp.time_compression
            delay = wall - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            if time.perf_counter() >= self.wall_deadline:
                return
            self._produce_one(i + k * sp.n_producers, arrival, crops)

    # ---- clients (closed loop) --------------------------------------------

    def _client(self, i: int, think) -> None:
        sp = self.spec
        crops = self._wire_crops(i)
        k = 0
        while time.perf_counter() < self.wall_deadline:
            rid = i + k * sp.n_clients
            k += 1
            evt = threading.Event()
            # each client thread touches only its own rid keys; the
            # replica side reads through dict.get on a different key
            # space per client, and CPython dict setitem is atomic
            self._done_events[rid] = evt  # lint: waive race-check -- per-client key space, atomic dict setitem, reader uses .get
            if self._produce_one(rid, self._now_model(), crops):
                evt.wait(timeout=max(
                    0.0, self.wall_deadline - time.perf_counter()))
            self._done_events.pop(rid, None)
            pause = think() / sp.time_compression
            if pause > 0:
                time.sleep(min(
                    pause,
                    max(0.0, self.wall_deadline - time.perf_counter())))

    # ---- replicas ---------------------------------------------------------

    def _replica(self, name: str, st: _ReplicaState) -> None:
        """Partition-aware consumer loop, one thread per replica.

        Fetch semantics mirror the DES (and Kafka): drain everything a
        partition has, serve it if it clears ``fetch_min_bytes`` or the
        oldest record has aged past ``fetch_max_wait_s``, otherwise
        hold it pending and sweep on — messages keep accumulating WHILE
        the replica serves other partitions, so fetch batching never
        eats service capacity. Ownership is re-read every sweep; on
        revocation, pending records are requeued for the new owner.
        """
        sp = self.spec
        fetch_wait_wall = (sp.bk.fetch_max_wait_s
                           if sp.fetch_max_wait_s is None
                           else sp.fetch_max_wait_s) / sp.time_compression
        batch_cap = max(1, int(sp.bk.fetch_min_bytes // max(
            sp.wl.face_bytes, 1.0)))
        batchers: dict[int, Batcher] = {}
        pending: dict[int, list] = {}
        while time.perf_counter() < self.wall_deadline:
            if name in self._removed or name in self._killed:
                break
            asg = self.group.assignment(name)
            # revoked partitions: hand any held-back records straight
            # back to the partition queue so the NEW owner serves them
            # (not at thread exit — a rebalance survivor keeps running)
            for pi in list(pending):
                if pi not in asg.partitions and pending[pi]:
                    self._requeue(pi, pending.pop(pi))
            if not asg.partitions:
                time.sleep(0.004)
                continue
            served_any = False
            for pi in asg.partitions:
                if time.perf_counter() >= self.wall_deadline:
                    break
                # generation fence: if membership changed since this
                # sweep's assignment was read, restart with a fresh
                # view instead of fetching from a possibly-revoked
                # partition (shrinks the rebalance overlap to a serve
                # already in flight — Kafka's cooperative window)
                if self.group.assignment(name).generation != asg.generation:
                    break
                part = self.topic.partitions[pi]
                b = batchers.get(pi)
                if b is None:
                    b = batchers[pi] = Batcher(
                        part.queue, batch_size=batch_cap, timeout_s=0.0)
                buf = pending.setdefault(pi, [])
                buf.extend(b.poll(1 << 30))
                if not buf:
                    continue
                ready = sum(m.size for m in buf)
                age = time.perf_counter() - buf[0].t_written
                if (ready < sp.bk.fetch_min_bytes
                        and age < fetch_wait_wall):
                    continue
                pending[pi] = []
                self._serve(st, part, buf)
                served_any = True
            if not served_any:
                time.sleep(0.002)
        # fold per-partition fetch stats once, on the way out (results
        # are read only after the thread joins)
        st.stats = BatchStats()
        for b in batchers.values():
            st.stats = st.stats.merge(b.stats)
        # hand anything still pending back to the partition queue: the
        # rebalanced owner (or final backlog accounting) picks it up
        for pi, buf in pending.items():
            self._requeue(pi, buf)

    def _requeue(self, pi: int, msgs: list) -> None:
        """Give held-back records back to their partition for the new
        owner, each with a logged ``requeue`` event — a fault or
        rebalance relocates work, it never drops it, and the event
        keeps the five-way tax attribution summing to 1 (the relocated
        wait lands in the queue bucket)."""
        now = self._now_model()
        for m in msgs:
            self.log.log(m.key, "requeue", now, now,
                         payload_bytes=int(m.size))
            self.topic.partitions[pi].queue.put(m)

    def _serve(self, st: _ReplicaState, part, batch: list[Message]) -> None:
        sp = self.spec
        rel_on = sp.retry is not None
        t_deq = self._now_model()
        if rel_on:
            # request-id dedupe at dequeue: a duplicate whose twin
            # already won is cancelled before costing any service time
            # (the cheap hedge outcome)
            fresh = []
            for msg in batch:
                with self._lock:
                    dup = msg.key in self._rel_completed
                    if dup:
                        self._rel_hedge_cancels += 1
                        part.consumed += 1
                    else:
                        # mid-service marker: timer verdicts defer until
                        # this item's planned t_fin is known (set once
                        # the batch's pacing plan is computed below)
                        self._rel_inservice[msg.key] = None
                if dup:
                    self.log.log(msg.key, "hedge_cancel", t_deq, t_deq,
                                 int(msg.size))
                    st.consumed += 1  # lint: waive race-check -- per-replica state; only this replica thread writes it, merged after join
                else:
                    fresh.append(msg)
            batch = fresh
            if not batch:
                return
        lvl = (sp.degrade.level(self._deg_depth)
               if sp.degrade is not None else None)
        low_res = False
        if sp.service == "real":
            import numpy as np
            yuv = np.stack([m.meta["crop_yuv"] for m in batch])
            w0 = time.perf_counter()
            low_res = self._identify_real(yuv, lvl)[1]
            span = time.perf_counter() - w0
            st.batch_spans.append((len(batch), span))
            dur_model = span * sp.time_compression
        else:
            # paced mode prices the whole ladder: the degrade level's
            # service_factor scales the emulated identify span
            dur_model = (sp.wl.t_identify / sp.speedup * len(batch)
                         * (lvl.service_factor if lvl is not None else 1.0))
            if not self._rel_routed:
                time.sleep(dur_model / sp.time_compression)
        st.busy_model += dur_model  # lint: waive race-check -- per-replica state; only this replica thread writes it, merged after join
        # real mode books accuracy cost only for the rung it actually
        # implements (the letterbox decode); paced mode emulates every
        # rung, so the ladder's proxy always applies
        applied = sp.service != "real" or low_res
        acc = (lvl.accuracy_proxy
               if (lvl is not None and applied) else 1.0)
        if sp.service != "real" and self._rel_routed:
            # item-by-item pacing at absolute wall deadlines: each
            # completion goes on the books AT its model finish time, so
            # breaker outcomes and timer-wheel verdicts observe
            # completions in the model-time order the DES processes
            # them in. Recording at batch end would let punctual
            # timeout failures overtake backdated successes and
            # scramble the breaker's windowed error fraction.
            dt = dur_model / len(batch)
            with self._lock:
                # publish the pacing plan: timer verdicts can now rule
                # punctually on mid-service items by planned t_fin
                for j, m in enumerate(batch):
                    if m.key in self._rel_inservice:
                        self._rel_inservice[m.key] = t_deq + (j + 1) * dt
            w0 = time.perf_counter()
            for j, msg in enumerate(batch):
                delay = (w0 + (j + 1) * dt / sp.time_compression
                         - time.perf_counter())
                if delay > 0:
                    time.sleep(delay)
                self._finish_item(st, part, msg, t_deq + j * dt,
                                  t_deq + (j + 1) * dt, len(batch), acc)
            return
        t_end = self._now_model()
        dt = (t_end - t_deq) / len(batch)
        for j, msg in enumerate(batch):
            self._finish_item(st, part, msg, t_deq + j * dt,
                              t_deq + (j + 1) * dt, len(batch), acc)

    def _identify_real(self, yuv, lvl) -> tuple[list, bool]:
        """One real-mode batch: (B, 3, 48, 48) wire-format YUV crops through
        the stack's decode and the fused identify; returns the (name,
        score) list and whether the degraded (low-resolution) decode ran."""
        from repro_torch.core import facerec
        low_res = (lvl is not None and lvl.letterbox_scale < 1.0
                   and self._preprocess.placement == "host")
        # decode (host or device per spec.placement), then the
        # fused identify; only the device decode pads to pow2
        # (aligning with the pre-warmed buckets, as the reference's
        # jitted path does) — the host decode has no buckets, so
        # padding would just be wasted work inside the measured
        # service span
        if low_res:
            # degraded decode: subsample the wire YUV down to the
            # letterboxed resolution (a fraction of the codec
            # work), then nearest-neighbour upsample the decoded
            # RGB back to the stack's native crop size. Host
            # placement only, as in the reference (whose jitted
            # device decode is shape-specialized to the pre-warmed
            # buckets).
            step = max(1, round(1.0 / lvl.letterbox_scale))
            rgb = self._preprocess.decode(yuv[:, :, ::step, ::step])
            rgb = rgb.repeat(step, axis=1).repeat(step, axis=2)
        elif self._preprocess.placement == "device":
            rgb = self._preprocess.decode(
                facerec._pad_rows_pow2(yuv))[:len(yuv)]
        else:
            rgb = self._preprocess.decode(yuv)
        return self._identify.identify_crops(rgb), low_res

    def _finish_item(self, st: _ReplicaState, part, msg: Message,
                     t_start: float, t_fin: float, n_batch: int,
                     acc: float) -> None:
        """Book one served item's completion at model time ``t_fin``."""
        sp = self.spec
        rel_on = sp.retry is not None
        # consumed feeds part.in_flight, which _produce_one's
        # admission check reads under _lock — keep the pair of
        # counters consistent for bounded admission
        if rel_on:
            with self._lock:
                win = msg.key not in self._rel_completed
                if win:
                    self._rel_completed[msg.key] = t_fin
                else:
                    self._rel_hedge_wastes += 1
                part.consumed += 1
                self._rel_inservice.pop(msg.key, None)
            if not win:
                # both attempts were in service at once: the
                # loser's span is wasted work, not a completion
                self.log.log(msg.key, "hedge_waste", t_start,
                             t_fin, int(msg.size))
                st.consumed += 1  # lint: waive race-check -- per-replica state; only this replica thread writes it, merged after join
                return
        else:
            with self._lock:
                part.consumed += 1
        b = self._breakers.get(part.index)
        if b is not None and not (
                rel_on and t_fin - msg.meta.get("rel_pub", t_fin)
                > sp.retry.attempt_timeout_s + 1e-12):
            # a late completion is not a success signal: its rcheck
            # already recorded the timeout as the outcome
            b.record(t_fin, True)
        # the wait runs to THIS item's service start (like the DES's
        # per-item t_consumed), not the batch dequeue — the hold inside
        # a fetched batch is queue tax and must be on the books
        self.log.log(msg.key, "wait", msg.t_produced, t_start,
                     payload_bytes=int(msg.size))
        self.log.log(msg.key, "identify", t_start, t_fin,
                     payload_bytes=int(msg.size), batch_size=n_batch)
        if acc < 1.0:
            name = next((l.name for l in sp.degrade.levels
                         if l.accuracy_proxy == acc), "degraded")
            self.log.log(msg.key, "degrade", t_fin, t_fin,
                         int(msg.size), accuracy_proxy=acc, level=name)
        st.served += 1  # lint: waive race-check -- per-replica state; only this replica thread writes it, merged after join
        st.consumed += 1  # lint: waive race-check -- per-replica state; only this replica thread writes it, merged after join
        st.acc_sum += acc  # lint: waive race-check -- per-replica state; only this replica thread writes it, merged after join
        st.acc_n += 1  # lint: waive race-check -- per-replica state; only this replica thread writes it, merged after join
        st.latencies.append(
            (msg.t_produced, t_fin - msg.t_produced))
        evt = self._done_events.get(msg.key)
        if evt is not None:
            evt.set()

    # ---- results ----------------------------------------------------------

    def _result(self) -> ClusterResult:
        sp = self.spec
        span_wall = time.perf_counter() - self.t0
        span_model = span_wall * sp.time_compression
        states = list(self._replica_states.values())
        completed = sum(st.served for st in states)
        # backlog counts what was published and never drained; a hedge
        # duplicate that WAS drained (cancelled or wasted) is not backlog
        backlog = self.produced - sum(st.consumed for st in states)
        samples = [lat for st in states for t_sub, lat in st.latencies
                   if t_sub >= sp.warmup]
        steady_span = max(span_model - sp.warmup, 1e-9)
        lag_mean = self._lag_sum / max(self.produced, 1)
        mid = sp.warmup + 0.5 * (sp.sim_time - sp.warmup)
        first = [n for t, n in self._inflight_samples
                 if sp.warmup <= t < mid]
        second = [n for t, n in self._inflight_samples if t >= mid]
        growth = ((sum(second) / len(second)) - (sum(first) / len(first))
                  if first and second else 0.0)
        diverged = (growth > max(0.04 * max(self.produced, 1), 25)
                    or lag_mean > 5 * sp.period_s)
        stats = LatencyStats.from_samples(samples)
        fetch = BatchStats()
        for st in states:
            fetch = fetch.merge(st.stats)
        util = {
            "broker_storage_write": self.topic.write_utilization(span_wall),
            "consumers": sum(st.busy_model for st in states)
            / (span_model * max(len(states), 1)),
        }
        completions = sorted((t_sub + lat, lat)
                             for st in states
                             for t_sub, lat in st.latencies)
        result = ClusterResult(
            spec_speedup=sp.speedup, n_replicas=len(states),
            produced=self.produced, completed=completed,
            dropped=self.dropped, backlog=backlog, diverged=diverged,
            latency=stats, throughput=len(samples) / steady_span,
            utilization=util, predicted_rho=sp.predicted_rho(),
            producer_lag_mean=lag_mean, rebalances=self.group.rebalances,
            fetch_stats=fetch, log=self.log, inflight_growth=growth,
            requeues=sum(1 for e in self.log.events
                         if e.stage == "requeue"),
            faults=(list(self.fault_engine.applied)
                    if self.fault_engine else []),
            scale_actions=(list(self.autoscaler.actions)
                           if self.autoscaler else []),
            samples=completions,
            inflight_samples=list(self._inflight_samples),
            reliability=self._reliability_dict(span_model, completions,
                                               states),
            heartbeats=list(self.heartbeats),
            batch_spans=[b for st in states for b in st.batch_spans])
        if self.slo is not None:
            result.slo = self.slo.check(stats, result.drop_fraction)
        return result

    def _reliability_dict(self, span_model: float, completions: list,
                          states: list) -> dict | None:
        sp = self.spec
        if (sp.retry is None and sp.breaker is None
                and sp.degrade is None):
            return None
        from repro_torch.cluster.metrics import reliability_report
        timeline = sorted((t, pi, s)
                          for pi, b in sorted(self._breakers.items())
                          for t, s in b.timeline)
        # without the rerouted producer path every publish is its own
        # sole attempt (degrade-only runs)
        offered = self._rel_offered if self._rel_routed else self.produced
        attempts = self._rel_attempts if self._rel_routed else self.produced
        deadline = (sp.retry.deadline_s if sp.retry is not None
                    else float("inf"))
        acc_n = sum(st.acc_n for st in states)
        acc_sum = sum(st.acc_sum for st in states)
        return reliability_report(
            completions, deadline, max(span_model, 1e-9),
            offered=offered, attempts=attempts,
            deadline_misses=self._rel_deadline_misses,
            retries=self._rel_retries, hedges=self._rel_hedges,
            hedge_cancels=self._rel_hedge_cancels,
            hedge_wastes=self._rel_hedge_wastes,
            breaker_sheds=self._rel_sheds,
            accuracy_proxy_mean=(acc_sum / acc_n if acc_n else 1.0),
            breaker_timeline=timeline,
            degrade_timeline=self.degrade_timeline).to_dict()
