"""Analytic stability / utilization model (paper §5.3-5.4).

The DES shows *that* the system destabilizes; this module shows *why*,
with closed-form resource utilizations: the system is stable iff every
resource's utilization rho = demand/capacity < 1. Under AI acceleration S
the face arrival rate scales with S while storage capacity is fixed —
broker storage write bandwidth is the first rho to cross 1.

The port's copy of ``repro.core.queueing``, the same in behaviour: one
seed gives the same numbers in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.broker import BrokerConfig
from repro_torch.core.simulator import FaceRecWorkload


@dataclass
class ResourceUtilization:
    name: str
    demand: float          # bytes/s or busy-seconds/s
    capacity: float

    @property
    def rho(self) -> float:
        return self.demand / self.capacity if self.capacity else float("inf")

    @property
    def stable(self) -> bool:
        return self.rho < 1.0


def utilizations(wl: FaceRecWorkload, bk: BrokerConfig,
                 speedup: float = 1.0,
                 n_consumers: int | None = None) -> dict[str, ResourceUtilization]:
    """Per-resource rho at acceleration ``speedup``.

    ``n_consumers`` overrides the workload's consumer pool size — the
    cluster uses it to price a deployment of N replica consumers
    without forging a new workload object.
    """
    consumers = wl.n_consumers if n_consumers is None else n_consumers
    div = speedup if wl.accelerate_ingest else 1.0
    frame_rate = wl.n_producers / (wl.frame_period / div)
    if wl.batch_per_tick:
        frame_rate = wl.n_producers * speedup / wl.frame_period
    face_rate = frame_rate * wl.faces_per_frame
    byte_rate = face_rate * (wl.face_bytes + bk.write_overhead_bytes)

    # producer send-path busy fraction. Pipelined (FaceRec): only the
    # client send cost serializes; batch-per-tick (ObjectDet): ingest + the
    # whole set's sends must fit in the tick.
    if wl.batch_per_tick:
        per_tick = wl.t_ingest + speedup * wl.faces_per_frame * wl.t_send
        period = wl.frame_period
    else:
        per_tick = wl.faces_per_frame * wl.t_send
        period = wl.frame_period / div
    return {
        "broker_storage_write": ResourceUtilization(
            "broker_storage_write", byte_rate / bk.n_brokers,
            bk.storage_write_capacity),
        "broker_network": ResourceUtilization(
            "broker_network", 2 * byte_rate / bk.n_brokers, bk.net_bw),
        "producer_send": ResourceUtilization(
            "producer_send", per_tick / period, 1.0),
        "consumers": ResourceUtilization(
            "consumers", face_rate * wl.t_identify / speedup,
            float(consumers)),
    }


def max_stable_speedup(wl: FaceRecWorkload, bk: BrokerConfig,
                       resource: str = "broker_storage_write",
                       hi: float = 64.0) -> float:
    """Largest S with rho < 1 for the given resource (bisection)."""
    lo, hi_ = 0.5, hi
    for _ in range(40):
        mid = 0.5 * (lo + hi_)
        if utilizations(wl, bk, mid)[resource].stable:
            lo = mid
        else:
            hi_ = mid
    return lo


def stability_knee(wl: FaceRecWorkload, bk: BrokerConfig,
                   n_consumers: int | None = None,
                   hi: float = 64.0) -> float:
    """Largest S with EVERY resource's rho < 1 (bisection).

    Unlike :func:`max_stable_speedup` (one named resource), this is the
    whole-system destabilization point the DES and the live cluster
    measure — the quantity the three models are cross-validated on.
    """
    def stable(s: float) -> bool:
        return all(u.stable
                   for u in utilizations(wl, bk, s, n_consumers).values())

    lo, hi_ = 0.5, hi
    if not stable(lo):
        return lo
    for _ in range(40):
        mid = 0.5 * (lo + hi_)
        if stable(mid):
            lo = mid
        else:
            hi_ = mid
    return lo


def bottleneck(wl: FaceRecWorkload, bk: BrokerConfig,
               speedup: float) -> ResourceUtilization:
    us = utilizations(wl, bk, speedup)
    return max(us.values(), key=lambda u: u.rho)
