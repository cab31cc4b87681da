"""Measured-vs-modeled stability knee (the §5.3-5.4 closed loop).

Three independent estimates of the acceleration factor S at which one
deployment configuration destabilizes:

  * closed form — smallest S with any resource rho >= 1
    (``queueing.stability_knee``; exact, instantaneous);
  * DES — bisection on ``SimResult.diverged``, the *measured-only*
    queue-growth signal (no analytic escape hatch, or the agreement
    with the closed form would be circular);
  * live — bisection on ``ClusterResult.diverged`` from real
    ``ServingCluster`` runs (real threads, real clock).

Tolerances (documented here; the reference's tests assert them, and
``chip_smoke.py`` prints the port's live knee against them): divergence detectors
need a finite observation window, so a run at rho barely above 1 can
look stable — both measured knees land ON OR ABOVE the closed form's
and within ``DES_TOL`` / ``LIVE_TOL`` relative error of it. The live
bound is looser because sleep-granularity jitter adds real noise on a
busy container.

The port's copy of ``repro.cluster.crossval``, the same in behaviour:
one seed gives the same numbers in both packages.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field, fields, is_dataclass, replace

DES_TOL = 0.25
LIVE_TOL = 0.35


def find_knee(diverged, lo: float, hi: float, iters: int = 6) -> float:
    """Bisection for the smallest diverging S; assumes monotonicity.

    ``diverged(s) -> bool`` runs one experiment. Returns the bracket
    midpoint after ``iters`` refinements (resolution (hi-lo)/2^iters).
    Endpoint returns are BOUNDS, not located knees: ``lo`` back means
    the knee is at or below the bracket (already diverging at lo),
    ``hi`` back means divergence was never observed (knee >= hi).
    Consumers comparing a knee against a model must sanity-check it
    against that model (the benchmark and tests gate on
    DES_TOL/LIVE_TOL) rather than trust an endpoint as a measurement.
    """
    if diverged(lo):
        return lo
    if not diverged(hi):
        return hi
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if diverged(mid):
            hi = mid
        else:
            lo = mid
    return 0.5 * (lo + hi)


def des_knee(spec, lo: float | None = None, hi: float | None = None,
             iters: int = 6, sim_time: float = 20.0,
             warmup: float = 4.0) -> float:
    """DES-measured knee for a ClusterSpec (divergence = queue growth)."""
    closed = spec.closed_form_knee()
    lo = 0.4 * closed if lo is None else lo
    hi = 2.0 * closed if hi is None else hi

    def diverged(s: float) -> bool:
        return spec.des_sim(speedup=s, sim_time=sim_time,
                            warmup=warmup).run().diverged

    return find_knee(diverged, lo, hi, iters)


def live_knee(spec, lo: float | None = None, hi: float | None = None,
              iters: int = 4) -> float:
    """Live-cluster-measured knee (each probe is a real timed run).

    A "diverged" verdict is confirmed by a second run before the
    bisection trusts it: transient CPU contention on a shared box can
    make one stable run look saturated, and a single false positive
    would drag the whole bracket down. (False "stable" needs no
    confirmation — contention only ever pushes toward divergence.)
    """
    from repro_torch.cluster.cluster import ServingCluster
    closed = spec.closed_form_knee()
    lo = 0.4 * closed if lo is None else lo
    hi = 2.0 * closed if hi is None else hi

    def diverged(s: float) -> bool:
        first = ServingCluster(replace(spec, speedup=s)).run().diverged
        if not first:
            return False
        return ServingCluster(replace(spec, speedup=s)).run().diverged

    return find_knee(diverged, lo, hi, iters)


@dataclass
class KneeComparison:
    n_replicas: int
    drives_per_broker: int
    closed_form: float
    des: float
    live: float | None = None

    def rel_err(self, measured: float) -> float:
        return abs(measured - self.closed_form) / self.closed_form

    @property
    def agree(self) -> bool:
        ok = self.rel_err(self.des) <= DES_TOL
        if self.live is not None:
            ok = ok and self.rel_err(self.live) <= LIVE_TOL
        return ok

    def row(self) -> str:
        live = "-" if self.live is None else f"{self.live:.1f}"
        return (f"R{self.n_replicas}_d{self.drives_per_broker}:"
                f"closed={self.closed_form:.1f};des={self.des:.1f};"
                f"live={live};agree={self.agree}")


def knee_comparison(spec, include_live: bool = True,
                    des_iters: int = 6, live_iters: int = 4,
                    ) -> KneeComparison:
    """All three knees for one deployment configuration."""
    return KneeComparison(
        n_replicas=spec.n_replicas,
        drives_per_broker=spec.bk.drives_per_broker,
        closed_form=spec.closed_form_knee(),
        des=des_knee(spec, iters=des_iters),
        live=live_knee(spec, iters=live_iters) if include_live else None)


@dataclass
class FaultKnees:
    """Knee movement under a persistent degradation.

    ``closed_healthy``/``closed_degraded`` price the spec analytically
    before and after the fault (e.g. one fewer drive per broker);
    ``des_degraded`` measures the degraded knee by bisection on DES
    runs that carry the fault plan for their WHOLE horizon — the
    cross-validation the fig_fault_recovery benchmark gates on.
    """
    closed_healthy: float
    closed_degraded: float
    des_degraded: float

    @property
    def agree(self) -> bool:
        return (abs(self.des_degraded - self.closed_degraded)
                / self.closed_degraded) <= DES_TOL

    def row(self) -> str:
        return (f"closed={self.closed_healthy:.1f}"
                f"->degraded={self.closed_degraded:.1f};"
                f"des={self.des_degraded:.1f};agree={self.agree}")


@dataclass
class ReliabilityAgreement:
    """Live-vs-DES agreement on the reliability-tax quantities.

    One spec — same fault plan, same retry/breaker/degrade policies —
    runs through both execution engines; agreement is gated on the two
    quantities the reliability layer exists to control: goodput
    (client-visible value rate) and retry amplification (cluster-
    carried load per offered request). Both are gated at ``DES_TOL``
    relative error — unlike the knee comparison there is no analytic
    third referee here, so the DES tolerance IS the contract between
    the engines.
    """
    des_goodput: float
    live_goodput: float
    des_amplification: float
    live_amplification: float

    @staticmethod
    def _err(live: float, des: float) -> float:
        return abs(live - des) / max(abs(des), 1e-9)

    @property
    def goodput_err(self) -> float:
        return self._err(self.live_goodput, self.des_goodput)

    @property
    def amplification_err(self) -> float:
        return self._err(self.live_amplification, self.des_amplification)

    @property
    def agree(self) -> bool:
        return (self.goodput_err <= DES_TOL
                and self.amplification_err <= DES_TOL)

    def row(self) -> str:
        return (f"goodput:des={self.des_goodput:.1f};"
                f"live={self.live_goodput:.1f};"
                f"err={self.goodput_err:.2f}|"
                f"amp:des={self.des_amplification:.2f};"
                f"live={self.live_amplification:.2f};"
                f"err={self.amplification_err:.2f}|agree={self.agree}")


def reliability_agreement(spec) -> ReliabilityAgreement:
    """Run one reliability spec through both engines and compare.

    ``spec`` must carry a retry policy (else neither engine produces a
    reliability report); the fault plan and breaker/degrade policies
    ride along identically. The DES run uses the spec's own
    sim_time/warmup so both engines observe the same horizon.
    """
    from repro_torch.cluster.cluster import ServingCluster
    if spec.retry is None:
        raise ValueError("reliability_agreement needs spec.retry set")
    live = ServingCluster(spec).run().reliability
    des = spec.des_sim(sim_time=spec.sim_time,
                       warmup=spec.warmup).run().reliability
    return ReliabilityAgreement(
        des_goodput=des["goodput"], live_goodput=live["goodput"],
        des_amplification=des["amplification"],
        live_amplification=live["amplification"])


def fault_knees(spec, fault_plan, degraded_spec,
                iters: int = 5, sim_time: float = 20.0,
                warmup: float = 4.0) -> FaultKnees:
    """Where the stability knee sits while a fault persists.

    ``degraded_spec`` is the healthy spec with the fault's effect
    applied statically (drives removed, replicas reduced) — its closed
    form is the analytic target. The DES probe runs the healthy spec
    WITH ``fault_plan`` (fault applied early, never repaired), so the
    measured knee comes from the dynamic fault machinery, not from a
    statically reconfigured sim — that non-circularity is the point.
    """
    closed_h = spec.closed_form_knee()
    closed_d = degraded_spec.closed_form_knee()
    probe = replace(spec, fault_plan=fault_plan)

    def diverged(s: float) -> bool:
        return probe.des_sim(speedup=s, sim_time=sim_time,
                             warmup=warmup).run().diverged

    des_d = find_knee(diverged, 0.4 * closed_d, 2.0 * closed_d, iters)
    return FaultKnees(closed_healthy=closed_h, closed_degraded=closed_d,
                      des_degraded=des_d)


# ---- digital-twin loop over a workload trace -------------------------------
#
# One ClusterSpec, ONE resolved trace, BOTH execution engines: the DES
# replays the trace event-by-event, the live cluster replays it through
# real threads on a compressed wall clock. The twin gate compares the
# two runs per heartbeat window — windowed tail latency AND five-way
# tax fractions — at DES_TOL. DES summaries are cached keyed on
# (spec hash, trace hash): a scenario's modeled half runs once per
# spec revision, so the recurring cost of the gate is one live run.


def _canon(obj):
    """Canonical JSON-able form of a spec tree for hashing.

    Dataclasses become sorted field dicts, tuples become lists; any
    leftover object falls back to its repr — stable for the frozen
    policy/config vocabulary the specs are built from.
    """
    if is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _canon(getattr(obj, f.name)) for f in fields(obj)}
    if isinstance(obj, dict):
        return {str(k): _canon(v) for k, v in sorted(obj.items())}
    if isinstance(obj, (list, tuple)):
        return [_canon(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def spec_key(spec) -> str:
    """Stable 16-hex digest of a ClusterSpec, EXCLUDING its trace.

    The trace is priced separately (``WorkloadTrace.trace_hash``) so a
    cache entry key is ``spec_key(spec) + ':' + trace_hash`` — editing
    either the deployment or the workload invalidates the entry, and
    nothing else does.
    """
    d = _canon(spec)
    if isinstance(d, dict):
        d.pop("trace", None)
    blob = json.dumps(d, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class TwinCache:
    """DES-summary cache for the twin loop, keyed (spec hash, trace hash).

    In-memory dict with optional JSON write-through (``path``), so a
    benchmark re-run — same spec, same trace — skips the modeled half
    entirely. ``hits``/``misses`` are exposed so the scenario gate can
    assert the cache actually engaged on the second pass.
    """

    def __init__(self, path=None):
        self.path = path
        self.hits = 0
        self.misses = 0
        self._mem: dict[str, dict] = {}
        if path is not None:
            try:
                with open(path, encoding="utf-8") as fh:
                    self._mem.update(json.load(fh))
            except (OSError, ValueError):
                pass

    def get(self, key: str):
        hit = self._mem.get(key)
        if hit is None:
            self.misses += 1
            return None
        self.hits += 1
        return hit

    def put(self, key: str, value: dict) -> None:
        self._mem[key] = value
        if self.path is not None:
            with open(self.path, "w", encoding="utf-8") as fh:
                json.dump(self._mem, fh, sort_keys=True)


def des_twin_summary(spec, q: float = 0.99) -> dict:
    """Run the modeled half of the twin and reduce it to a JSON dict.

    The DES runs at the spec's OWN horizon (``sim_time = horizon``,
    warmup 0) so neither engine gets drain time the other lacks. The
    summary carries exactly what the gate compares: per-window tail
    latency, per-window five-way tax fractions, heartbeat markers, and
    the divergence flag.
    """
    from repro_torch.core import facerec
    from repro_torch.core.metrics import windowed_percentile
    trace = spec.resolve_trace()
    if trace is None:
        raise ValueError("des_twin_summary needs a spec with a trace "
                         "or scenario")
    sim = spec.des_sim(speedup=1.0, sim_time=spec.sim_time, warmup=0.0)
    res = sim.run()
    hb = trace.heartbeat_s
    five = sim.log.windowed_five_way(facerec.stage_category, hb)
    rel = res.reliability or {}
    return {
        "q": q,
        "heartbeat_s": hb,
        "horizon_s": trace.horizon_s,
        "diverged": bool(res.diverged),
        "heartbeats": [[int(k), float(t)] for k, t in sim.heartbeats],
        "windows": [[float(t), float(p), int(n)] for t, p, n in
                    windowed_percentile(sim.completions, q, hb)],
        "five_way": {str(k): {c: float(v) for c, v in row.items()}
                     for k, row in five.items()},
        "reliability": {k: rel[k] for k in
                        ("attempts", "retries", "breaker_sheds",
                         "deadline_misses") if k in rel},
    }


def live_twin_summary(spec, q: float = 0.99) -> dict:
    """Run the physical half of the twin and reduce it the same way."""
    from repro_torch.core import facerec
    from repro_torch.core.metrics import windowed_percentile
    from repro_torch.cluster.cluster import ServingCluster
    trace = spec.resolve_trace()
    if trace is None:
        raise ValueError("live_twin_summary needs a spec with a trace "
                         "or scenario")
    cl = ServingCluster(spec)
    res = cl.run()
    hb = trace.heartbeat_s
    # completion-keyed samples, like the DES's completions list
    comp = []
    for st in cl._replica_states.values():
        comp.extend((tp + lat, lat) for tp, lat in st.latencies)
    comp.sort()
    five = cl.log.windowed_five_way(facerec.stage_category, hb)
    rel = res.reliability or {}
    return {
        "q": q,
        "heartbeat_s": hb,
        "horizon_s": trace.horizon_s,
        "diverged": bool(res.diverged),
        "heartbeats": [[int(k), float(t)] for k, t in cl.heartbeats],
        "windows": [[float(t), float(p), int(n)] for t, p, n in
                    windowed_percentile(comp, q, hb)],
        "five_way": {str(k): {c: float(v) for c, v in row.items()}
                     for k, row in five.items()},
        "reliability": {k: rel[k] for k in
                        ("attempts", "retries", "breaker_sheds",
                         "deadline_misses") if k in rel},
    }


@dataclass
class WindowComparison:
    """Live vs DES over one heartbeat window."""
    t_end: float
    des_p: float
    live_p: float
    des_n: int
    live_n: int
    tax_diff: float          # max abs five-way fraction difference

    @property
    def p_err(self) -> float:
        return abs(self.live_p - self.des_p) / max(abs(self.des_p), 1e-9)

    @property
    def agree(self) -> bool:
        return self.p_err <= DES_TOL and self.tax_diff <= DES_TOL

    def row(self) -> str:
        return (f"t={self.t_end:.2f}:des={self.des_p:.3f};"
                f"live={self.live_p:.3f};err={self.p_err:.2f};"
                f"tax_diff={self.tax_diff:.2f};agree={self.agree}")


@dataclass
class TwinReport:
    """The twin gate's verdict for one (spec, trace) pair.

    ``windows`` covers the heartbeat windows BOTH engines populated
    (>= ``min_window_n`` completions each, inside the trace horizon);
    the gate needs at least two such windows — a comparison with fewer
    says nothing about the shape — and every one of them must agree on
    windowed tail latency AND five-way tax at DES_TOL.
    """
    scenario: str | None
    trace_hash: str
    cached: bool             # DES half came from the TwinCache
    des_diverged: bool
    live_diverged: bool
    windows: list = field(default_factory=list)

    @property
    def agree(self) -> bool:
        return len(self.windows) >= 2 and all(w.agree for w in self.windows)

    @property
    def worst_p_err(self) -> float:
        return max((w.p_err for w in self.windows), default=float("inf"))

    @property
    def worst_tax_diff(self) -> float:
        return max((w.tax_diff for w in self.windows),
                   default=float("inf"))

    def row(self) -> str:
        name = self.scenario or self.trace_hash
        return (f"{name}:windows={len(self.windows)};"
                f"p_err={self.worst_p_err:.2f};"
                f"tax_diff={self.worst_tax_diff:.2f};"
                f"cached={self.cached};agree={self.agree}")


_FIVE_WAY = ("pre", "ai", "post", "transfer", "queue")


def twin_compare(spec, cache: TwinCache | None = None, q: float = 0.99,
                 min_window_n: int = 4) -> TwinReport:
    """One full turn of the digital-twin loop.

    The DES half is served from ``cache`` when the (spec, trace) pair
    was seen before; the live half ALWAYS re-runs — it is the physical
    system under test, the cached model is the twin. Windows past the
    trace horizon (the live cluster books its final in-service batch a
    beat after the deadline) and windows either engine left sparse are
    excluded; divergence flags are reported, not gated — the live
    inflight-growth detector trips on transient spikes (a flash crowd's
    second half) that the DES's longer-lens detector rides out, and the
    per-window latency gate already catches any REAL disagreement.
    """
    trace = spec.resolve_trace()
    if trace is None:
        raise ValueError("twin_compare needs a spec with a trace or "
                         "scenario")
    key = f"{spec_key(spec)}:{trace.trace_hash()}"
    des = cache.get(key) if cache is not None else None
    cached = des is not None
    if des is None:
        des = des_twin_summary(spec, q)
        if cache is not None:
            cache.put(key, des)
    live = live_twin_summary(spec, q)
    hb = trace.heartbeat_s
    dw = {round(t / hb): (p, n) for t, p, n in des["windows"]}
    lw = {round(t / hb): (p, n) for t, p, n in live["windows"]}
    horizon_k = round(trace.horizon_s / hb)
    out = []
    for k in sorted(set(dw) & set(lw)):
        if k > horizon_k:
            continue
        (dp, dn), (lp, ln) = dw[k], lw[k]
        if dn < min_window_n or ln < min_window_n:
            continue
        dfw = des["five_way"].get(str(k - 1), {})
        lfw = live["five_way"].get(str(k - 1), {})
        tax = max(abs(dfw.get(c, 0.0) - lfw.get(c, 0.0))
                  for c in _FIVE_WAY)
        out.append(WindowComparison(t_end=k * hb, des_p=dp, live_p=lp,
                                    des_n=dn, live_n=ln, tax_diff=tax))
    return TwinReport(scenario=getattr(spec, "scenario", None),
                      trace_hash=trace.trace_hash(), cached=cached,
                      des_diverged=des["diverged"],
                      live_diverged=live["diverged"], windows=out)


def scenario_knee(spec, lo: float = 0.25, hi: float = 8.0,
                  iters: int = 5) -> float:
    """Smallest speedup S at which the trace replays stably (DES).

    A trace fixes the offered load, so S only scales service capacity:
    divergence is monotone DECREASING in S and the interesting knee is
    the smallest S that keeps the replay stable — found by bisecting
    ``stable(s)`` with :func:`find_knee` (whose convention is
    False-at-lo / True-at-hi). Endpoint returns are bounds, as ever:
    ``lo`` back means even lo is stable, ``hi`` means nothing was.
    """
    def stable(s: float) -> bool:
        return not spec.des_sim(speedup=s, sim_time=spec.sim_time,
                                warmup=0.0).run().diverged

    return find_knee(stable, lo, hi, iters)
