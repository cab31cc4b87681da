"""Scenario library: named workload shapes as replayable traces.

Each scenario is a seeded function producing a :class:`WorkloadTrace`
for a given horizon — the shapes "AI on the Edge" reports for video
fleets (diurnal day/night swings, flash crowds, skewed per-camera heat,
bursty on/off duty cycles) — plus the stress signature the shape is
EXPECTED to produce, encoded as a check function over a DES run. The
benchmark (``fig_scenarios``) and the golden tests both call the same
checks, so a scenario that stops stressing what it claims to stress
fails loudly in both places.

Rates are tuned against the default ``ClusterSpec`` at S=1: aggregate
consumer capacity ~61 req/s (8 replicas / 131.5 ms identify), single
partition ~7.6 req/s. Shapes that exceed capacity do so transiently
and drain before the horizon, so no scenario trips the divergence
detector on the default spec.

All randomness flows through ``loadgen._rng`` with a per-scenario salt
(``scenario:<name>``): every scenario draws from its own stream space,
independent of the open/closed-loop producers and of every other
scenario — the property the seeding-audit test asserts pairwise.

The port's copy of ``repro.cluster.scenarios``, the same in behaviour:
one seed gives the same numbers in both packages.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.cluster.loadgen import _rng
from repro_torch.cluster.trace import (
    DEFAULT_PAYLOAD_BYTES, TraceEvent, WorkloadTrace)


def _poisson_thinned(rng, horizon_s: float, rate_fn, rate_max: float,
                     ) -> list[float]:
    """Inhomogeneous-Poisson arrivals by thinning a rate_max process."""
    out: list[float] = []
    t = 0.0
    while True:
        t += rng.expovariate(rate_max)
        if t >= horizon_s:
            return out
        if rng.random() * rate_max <= rate_fn(t):
            out.append(t)


def _trace(name: str, horizon_s: float, arrivals, keys=None,
           payload_bytes: float = DEFAULT_PAYLOAD_BYTES) -> WorkloadTrace:
    """Assemble sorted arrivals (+ optional per-arrival keys) into a
    trace; rids are assigned in arrival order so they are unique and
    stable under the engines' event-order replay."""
    if keys is None:
        pairs = sorted((t, None) for t in arrivals)
    else:
        pairs = sorted(zip(arrivals, keys))
    events = tuple(
        TraceEvent(t=t, rid=i, partition_key=k, payload_bytes=payload_bytes)
        for i, (t, k) in enumerate(pairs))
    return WorkloadTrace(name=name, horizon_s=horizon_s,
                         heartbeat_s=horizon_s / 8, events=events)


# ---- trace functions -----------------------------------------------------

def diurnal(horizon_s: float = 6.0, seed: int = 0, *,
            base_rate: float = 16.0, peak_rate: float = 76.0,
            ) -> WorkloadTrace:
    """One day/night cycle: trough at the edges, peak mid-horizon.

    The peak deliberately exceeds aggregate capacity (~61/s at S=1), so
    queues build through the peak and drain on the falling edge — the
    windowed p99 must swing with the rate profile.
    """
    rng = _rng(seed, 0, "scenario:diurnal")
    mid = 0.5 * (base_rate + peak_rate)
    amp = 0.5 * (peak_rate - base_rate)

    def rate(t: float) -> float:
        return mid - amp * math.cos(2 * math.pi * t / horizon_s)

    arrivals = _poisson_thinned(rng, horizon_s, rate, peak_rate)
    return _trace("diurnal", horizon_s, arrivals)


def flash_crowd(horizon_s: float = 6.0, seed: int = 0, *,
                base_rate: float = 22.0, spike_rate: float = 170.0,
                spike_at: float = 0.45, spike_frac: float = 0.12,
                ) -> WorkloadTrace:
    """Steady base load with one short super-capacity spike.

    ``spike_at``/``spike_frac`` are fractions of the horizon. The spike
    (~2.8x capacity) builds a queue that takes several windows to
    drain: queue tax must jump in the spike window and decay after.
    """
    rng = _rng(seed, 0, "scenario:flash_crowd")
    t_spike = spike_at * horizon_s
    t_end = t_spike + spike_frac * horizon_s

    def rate(t: float) -> float:
        return spike_rate if t_spike <= t < t_end else base_rate

    arrivals = _poisson_thinned(rng, horizon_s, rate, spike_rate)
    return _trace("flash_crowd", horizon_s, arrivals)


def camera_fleet(horizon_s: float = 6.0, seed: int = 0, *,
                 n_cameras: int = 12, hot_rate: float = 16.0,
                 cold_rate: float = 1.8, n_keys: int = 8) -> WorkloadTrace:
    """Multi-camera fleet with skewed partition heat.

    Camera 0 is hot (~2x a single partition's capacity) and keys every
    frame to partition key 0; the cool cameras spread over keys
    1..n_keys-1, each far below capacity. Under a retry+breaker spec
    only key 0's partition can melt, so only ITS breaker may open — the
    skewed-heat signature.
    """
    arrivals: list[float] = []
    keys: list[int] = []
    for cam in range(n_cameras):
        rng = _rng(seed, cam, "scenario:camera_fleet")
        rate = hot_rate if cam == 0 else cold_rate
        key = 0 if cam == 0 else 1 + (cam - 1) % (n_keys - 1)
        t = 0.0
        while True:
            t += rng.expovariate(rate)
            if t >= horizon_s:
                break
            arrivals.append(t)
            keys.append(key)
    return _trace("camera_fleet", horizon_s, arrivals, keys)


def burst_drain(horizon_s: float = 6.0, seed: int = 0, *,
                burst_rate: float = 120.0, burst_s: float = 0.8,
                drain_s: float = 1.2, base_rate: float = 4.0,
                ) -> WorkloadTrace:
    """Square-wave duty cycle: super-capacity bursts, near-idle drains.

    Each burst banks ~(burst_rate - capacity) * burst_s of backlog; the
    drain phase has enough headroom to clear it before the next burst,
    so the in-flight depth must oscillate — build, drain to near-empty,
    repeat — rather than ratchet upward.
    """
    rng = _rng(seed, 0, "scenario:burst_drain")
    cycle = burst_s + drain_s

    def rate(t: float) -> float:
        return burst_rate if (t % cycle) < burst_s else base_rate

    arrivals = _poisson_thinned(rng, horizon_s, rate, burst_rate)
    return _trace("burst_drain", horizon_s, arrivals)


# ---- stress-signature checks ----------------------------------------------
# Each check takes (sim, result, trace) from a DES run of the
# scenario's spec and returns a list of violations (empty = signature
# holds). Thresholds carry ~2x margin under the measured values so
# seed-to-seed wiggle cannot flip them, while a scenario that lost its
# stress entirely still fails.

def _windows(sim, trace, min_n: int = 3):
    from repro_torch.core.metrics import windowed_percentile
    win = windowed_percentile(sim.completions, 0.99, trace.heartbeat_s)
    return [(t, p, n) for t, p, n in win if n >= min_n]


def _check_diurnal(sim, res, trace) -> list[str]:
    problems = []
    if res.diverged:
        problems.append("diurnal run diverged: the falling edge must "
                        "drain the peak's backlog")
    win = _windows(sim, trace)
    if len(win) < 4:
        return problems + [f"only {len(win)} populated windows"]
    ps = [p for _, p, _ in win]
    if max(ps) < 1.3 * min(ps):
        problems.append(f"windowed p99 never swung with the cycle: "
                        f"max {max(ps):.3f} < 1.3x min {min(ps):.3f}")
    peak_t = max(win, key=lambda w: w[1])[0]
    if peak_t <= 0.3 * trace.horizon_s:
        problems.append(f"worst window ends at t={peak_t:.2f}: the tail "
                        f"must build toward the mid-horizon peak, not "
                        f"peak at the trough")
    return problems


def _check_flash_crowd(sim, res, trace) -> list[str]:
    from repro_torch.core import facerec
    problems = []
    if res.diverged:
        problems.append("flash crowd diverged: base load must leave "
                        "headroom to drain the spike")
    # locate the spike window from the trace itself
    per_win: dict[int, int] = {}
    for ev in trace.events:
        w = int(ev.t // trace.heartbeat_s)
        per_win[w] = per_win.get(w, 0) + 1
    spike_w = max(per_win, key=per_win.get)
    qsec = sim.log.windowed_five_way(facerec.stage_category,
                                     trace.heartbeat_s, fractions=False)
    pre = [qsec[w]["queue"] for w in qsec if w < spike_w and w in per_win]
    if not pre:
        return problems + ["no pre-spike windows to baseline against"]
    base = sorted(pre)[len(pre) // 2]
    spike_q = max(qsec.get(w, {}).get("queue", 0.0)
                  for w in (spike_w, spike_w + 1))
    if spike_q < 3.0 * max(base, 1e-9):
        problems.append(f"queue tax did not spike: {spike_q:.2f} "
                        f"queue-seconds in the crowd window vs "
                        f"pre-spike median {base:.2f}")
    return problems


def _check_camera_fleet(sim, res, trace) -> list[str]:
    problems = []
    opened = {pi for pi, b in sim._breakers.items()
              if any(s != "closed" for _, s in b.timeline)}
    if opened != {0}:
        problems.append(f"breakers opened on partitions {sorted(opened)}; "
                        f"skewed heat must open exactly the hot "
                        f"partition's (0)")
    rel = res.reliability or {}
    if not rel.get("breaker_sheds", 0):
        problems.append("hot partition melted but its breaker never "
                        "shed an attempt")
    return problems


def _check_burst_drain(sim, res, trace) -> list[str]:
    problems = []
    if res.diverged:
        problems.append("burst_drain diverged: drains must clear each "
                        "burst's backlog")
    depths = [d for _, d in sim.depth_samples]
    if not depths:
        return problems + ["no depth samples recorded"]
    # depth counts in-service work and fetch-held records too, so a
    # "drained" valley still carries ~2 msgs/partition of floor
    hi, lo = 40, 16
    if max(depths) < hi:
        problems.append(f"bursts never banked a backlog: max depth "
                        f"{max(depths)} < {hi}")
    # count build->drain oscillations: above hi, later back below lo
    cycles, armed = 0, False
    for d in depths:
        if d >= hi:
            armed = True
        elif armed and d <= lo:
            cycles += 1
            armed = False
    if cycles < 2:
        problems.append(f"in-flight depth oscillated {cycles}x "
                        f"(need >= 2 build->drain cycles)")
    if depths[-1] > lo:
        problems.append(f"final depth {depths[-1]} > {lo}: the last "
                        f"drain window did not clear the backlog")
    return problems


# ---- registry --------------------------------------------------------------

@dataclass(frozen=True)
class Scenario:
    """A named workload shape plus its expected stress signature."""
    name: str
    build: object                  # (horizon_s, seed) -> WorkloadTrace
    check: object                  # (sim, result, trace) -> [violations]
    signature: str                 # one-line expected stress signature
    spec_kw: dict = field(default_factory=dict)   # extra ClusterSpec fields


def _fleet_policies() -> dict:
    """Retry + breaker for the skewed-heat scenario.

    Breaker failures are only recorded through the retry lifecycle's
    attempt timeouts, so the breaker needs a retry policy to see the
    hot partition melt. ``attempt_timeout_s`` sits well above the
    fetch-batching floor (fetch_max_wait 0.5 s + service) so healthy
    partitions never time out; ``open_s`` outlasts the horizon so an
    opened breaker stays open into the result.
    """
    from repro_torch.cluster.reliability import BreakerConfig, RetryPolicy
    return dict(
        retry=RetryPolicy(deadline_s=3.0, attempt_timeout_s=1.0,
                          max_attempts=2, backoff_base_s=0.05,
                          backoff_cap_s=0.2, seed=0),
        breaker=BreakerConfig(window_s=1.0, failure_threshold=0.5,
                              min_volume=4, open_s=30.0, probe_rate=0.05,
                              close_after=3, seed=0))


SCENARIOS: dict[str, Scenario] = {
    "diurnal": Scenario(
        "diurnal", diurnal, _check_diurnal,
        "windowed p99 swings >=1.4x between trough and the mid-horizon "
        "peak, and the falling edge drains the backlog"),
    "flash_crowd": Scenario(
        "flash_crowd", flash_crowd, _check_flash_crowd,
        "queue tax spikes >=3x the pre-spike median in the crowd "
        "window, then the base load drains it"),
    "camera_fleet": Scenario(
        "camera_fleet", camera_fleet, _check_camera_fleet,
        "only the hot camera's partition breaker opens; cool "
        "partitions stay closed", _fleet_policies()),
    "burst_drain": Scenario(
        "burst_drain", burst_drain, _check_burst_drain,
        "in-flight depth oscillates: each burst banks >=20 and each "
        "drain clears it"),
}


def build_trace(name: str, horizon_s: float = 6.0,
                seed: int = 0) -> WorkloadTrace:
    """Build one library scenario's trace (deterministic in args)."""
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; library: "
                       f"{sorted(SCENARIOS)}")
    return SCENARIOS[name].build(horizon_s, seed)


def scenario_spec(name: str, sim_time: float = 6.0, seed: int = 0, **over):
    """The ClusterSpec that drives BOTH engines for one scenario.

    ``spec.scenario`` carries the name; both engines resolve it to the
    same trace (``ClusterSpec.resolve_trace``) at ``sim_time`` horizon,
    and the scenario's policies (retry/breaker for the skewed-heat
    fleet) ride along.
    """
    from repro_torch.cluster.cluster import ClusterSpec
    kw = dict(SCENARIOS[name].spec_kw)
    kw.update(over)
    return ClusterSpec(scenario=name, sim_time=sim_time, seed=seed, **kw)
