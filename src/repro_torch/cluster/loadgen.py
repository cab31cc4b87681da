"""Open- and closed-loop load generators for the serving cluster.

Open loop models the paper's deployment: cameras tick at a fixed frame
period regardless of downstream health, so offered load is insensitive
to latency and an under-provisioned cluster diverges — this is the mode
the stability knee is measured in. Arrivals are periodic (the paper's
emulation) or Poisson (rate-matched, for tail studies).

Closed loop models K clients that wait for each response before
submitting again (plus think time): offered load self-throttles, the
system cannot diverge, and throughput saturates at capacity instead —
the contrast the tail-latency docs discuss.

Every random choice flows from one seeded ``random.Random`` per
producer/client (seed derived deterministically from the generator
seed and the index) — no module-level RNG anywhere, so schedules are
reproducible run to run.

The port's copy of ``repro.cluster.loadgen``, the same in behaviour: one
seed gives the same numbers in both packages.
"""
from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass


def _rng(seed: int, stream: int, salt: str = "") -> random.Random:
    """Distinct, deterministic stream per (salt, seed, stream).

    ``salt`` partitions the stream space per generator kind (open-loop
    producers, closed-loop clients, the diurnal profile, each scenario
    trace function). Without it any two generators handed the same
    ``(seed, stream)`` pair share one underlying sequence — exactly the
    coupling the seeding-audit test pins down: ``diurnal_profile``'s
    jitter used to ride producer 0's stream, so a diurnal experiment
    silently correlated its rate noise with one producer's phase.
    The unsalted legacy formula remains for callers that pass no salt.
    """
    if salt:
        digest = hashlib.sha256(f"{salt}:{seed}:{stream}".encode()).digest()
        return random.Random(int.from_bytes(digest[:8], "big"))
    return random.Random((seed * 1_000_003 + stream) & 0x7FFFFFFF)


def rng_fingerprint(seed: int, stream: int, salt: str = "",
                    k: int = 8) -> tuple:
    """First ``k`` draws of a stream — the audit's identity check.

    Two streams are treated as the SAME underlying sequence iff their
    fingerprints collide; the seeding-audit test asserts pairwise
    distinctness across every (generator kind x producer index x
    scenario) combination the library can instantiate.
    """
    rng = _rng(seed, stream, salt)
    return tuple(rng.random() for _ in range(k))


@dataclass
class OpenLoopLoadGen:
    """Per-producer arrival schedules at a fixed mean period.

    ``period_s`` is the mean inter-arrival time in MODEL seconds
    (``frame_period / S`` for the accelerated FaceRec producer).
    """
    n_producers: int
    period_s: float
    process: str = "periodic"          # periodic | poisson
    seed: int = 0

    def __post_init__(self):
        if self.process not in ("periodic", "poisson"):
            raise ValueError(f"unknown arrival process: {self.process}")

    def schedule(self, producer: int, horizon_s: float) -> list[float]:
        """Absolute arrival times in [0, horizon_s) for one producer.

        Deterministic in (seed, producer): periodic producers get a
        seeded phase offset (like the DES's randomized first tick),
        Poisson producers exponential gaps.
        """
        rng = _rng(self.seed, producer, "open-loop")
        out: list[float] = []
        t = rng.random() * self.period_s
        while t < horizon_s:
            out.append(t)
            if self.process == "periodic":
                t += self.period_s
            else:
                t += rng.expovariate(1.0 / self.period_s)
        return out

    @property
    def offered_rate(self) -> float:
        """Aggregate arrivals/s (model time)."""
        return self.n_producers / self.period_s


def diurnal_profile(horizon_s: float, base_rate: float, peak_rate: float,
                    period_s: float, seed: int = 0,
                    dt: float | None = None) -> list[tuple[float, float]]:
    """Seeded diurnal offered-load trace: ``(t, rate)`` samples.

    One sinusoidal day–night cycle per ``period_s`` between
    ``base_rate`` (trough) and ``peak_rate`` (peak), plus ±5% seeded
    jitter per sample — the golden trace the autoscaler's
    scale-down-never-violates-SLO test replays through the fluid-queue
    harness. Deterministic in its arguments (one ``random.Random``,
    no module RNG), like every generator in this module.
    """
    import math
    if peak_rate < base_rate:
        raise ValueError("peak_rate must be >= base_rate")
    rng = _rng(seed, 0, "diurnal-profile")
    dt = period_s / 48 if dt is None else dt
    mid = 0.5 * (base_rate + peak_rate)
    amp = 0.5 * (peak_rate - base_rate)
    out: list[tuple[float, float]] = []
    t = 0.0
    while t < horizon_s:
        rate = mid - amp * math.cos(2 * math.pi * t / period_s)
        rate *= 1.0 + 0.05 * (2 * rng.random() - 1)
        out.append((t, max(0.0, rate)))
        t += dt
    return out


@dataclass
class ClosedLoopLoadGen:
    """K clients, each: submit -> await completion -> think -> repeat.

    ``think_s`` is the mean think time in model seconds (exponential
    when ``process="poisson"``, fixed otherwise). Offered load adapts
    to latency, so the cluster saturates instead of diverging.
    """
    n_clients: int
    think_s: float = 0.0
    process: str = "periodic"
    seed: int = 0

    def think_sampler(self, client: int):
        """Seeded think-time sampler for one client."""
        rng = _rng(self.seed, client, "closed-loop")

        def sample() -> float:
            if self.think_s <= 0:
                return 0.0
            if self.process == "poisson":
                return rng.expovariate(1.0 / self.think_s)
            return self.think_s
        return sample
