"""Apache-Kafka-model broker substrate (paper §3.4).

Models the mechanisms the paper measures:
  * topics split into partitions (max one consumer per partition);
  * leader + follower replication (``replication`` copies, acks=1:
    a message is consumable after the leader write; follower traffic is
    asynchronous background load);
  * producer-side batching (``linger_s``, ``batch_bytes``);
  * broker-side consumer fetch batching (``fetch_min_bytes``,
    ``fetch_max_wait_s``) — the mechanism behind §5.5's waiting-time floor;
  * storage write channel per broker with configurable drive count —
    the resource §5.4 shows saturating under AI acceleration.

Calibration note (documented in EXPERIMENTS.md §Paper-validation): the
paper reports broker storage write utilization of ~10% at 1x with the
Fig-10 setup, which matches leader-write accounting; async follower
replication in their deployment evidently consolidated into large
sequential writes whose marginal cost is folded into the drive-efficiency
constant rather than tripling byte volume.

The port's copy of ``repro.core.broker``, the same in behaviour: one
seed gives the same numbers in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class BrokerConfig:
    n_brokers: int = 3
    replication: int = 3
    drives_per_broker: int = 1
    drive_write_bw: float = 1.1e9        # bytes/s (Intel P4510, Table 2)
    drive_read_bw: float = 2.85e9
    # multi-drive striping efficiency (queue-depth effects; calibrated to
    # the paper's Fig 15a unlock points)
    drive_efficiency: tuple = (0.75, 0.65, 0.83, 0.83)
    write_overhead_bytes: int = 800      # per-record log overhead (fs+index)
    linger_s: float = 0.005              # producer batching window
    batch_bytes: int = 16384
    fetch_min_bytes: int = 150 * 1024    # broker withholds until this...
    fetch_max_wait_s: float = 0.5        # ...or this timeout (Kafka defaults)
    net_bw: float = 100e9 / 8            # 100 Gbps NIC, bytes/s
    page_cache_reads: bool = True        # consumer reads served from memory

    @property
    def storage_write_capacity(self) -> float:
        """Effective bytes/s per broker across its drives."""
        d = self.drives_per_broker
        eff = self.drive_efficiency[min(d, len(self.drive_efficiency)) - 1]
        return d * self.drive_write_bw * eff

    def write_time(self, nbytes: float) -> float:
        """Seconds the leader's storage channel is busy for one record
        (log payload + per-record overhead). Both the DES and the live
        cluster pace writes with this, so their knees are comparable."""
        return (nbytes + self.write_overhead_bytes) / self.storage_write_capacity

    def leader_for(self, partition_index: int) -> int:
        """Static round-robin partition->leader placement (how Topic
        assigns leaders; exposed so live partitions match the model)."""
        return partition_index % self.n_brokers

    def scaled(self, eff: float) -> "BrokerConfig":
        """A copy with per-broker bandwidths scaled by ``eff``.

        Scale-model runs shrink producer counts by ``eff`` and broker
        capacity together, preserving every utilization ratio (and thus
        the stability knee) while cutting the event/thread count —
        the same trick as ``ClusterSim``'s ``scale`` knob, lifted here
        so the live cluster and the closed form share it.
        """
        from dataclasses import replace
        return replace(self, drive_write_bw=self.drive_write_bw * eff,
                       net_bw=self.net_bw * eff)


def range_assignment(members, n_partitions: int) -> dict:
    """Kafka's range assignment: partitions split contiguously over the
    sorted member list (first ``extra`` members get one more).

    Pure and deterministic in (members, n_partitions) — no RNG — so the
    live ``ConsumerGroup`` and the DES's fault-mode membership map share
    one implementation and can never disagree about who owns what.
    Members beyond ``n_partitions`` own nothing (idle standbys).
    """
    table: dict = {}
    ms = sorted(members)
    if not ms:
        return table
    base, extra = divmod(n_partitions, len(ms))
    start = 0
    for i, m in enumerate(ms):
        width = base + (1 if i < extra else 0)
        table[m] = tuple(range(start, start + width))
        start += width
    return table


def pick_victim(members, rank):
    """Rank-th member of the sorted alive list (None when empty).

    The ONE victim-selection rule for fault injection, shared by the
    live ``FaultEngine`` and the DES so a fault plan names the same
    casualty in both runtimes.
    """
    ms = sorted(members)
    if not ms:
        return None
    return ms[(rank or 0) % len(ms)]


@dataclass
class Partition:
    topic: str
    index: int
    leader: int                        # broker id
    backlog: list = field(default_factory=list)   # (ready_time, msg)
    bytes_in: float = 0.0

    def append(self, ready_time: float, msg) -> None:
        self.backlog.append((ready_time, msg))
        self.bytes_in += msg.size


@dataclass
class Message:
    key: int
    size: float
    t_produced: float                  # end of producing stage
    t_published: float = 0.0           # after producer batching
    t_written: float = 0.0             # leader write done (consumable)
    t_consumed: float = 0.0            # consumer picks it up
    meta: dict = field(default_factory=dict)

    @property
    def broker_wait(self) -> float:
        return self.t_consumed - self.t_produced


class Topic:
    """Partitioned topic with round-robin producer assignment."""

    def __init__(self, name: str, n_partitions: int, cfg: BrokerConfig):
        self.name = name
        self.cfg = cfg
        self.partitions = [
            Partition(name, i, leader=i % cfg.n_brokers)
            for i in range(n_partitions)]
        self._rr = 0

    def pick_partition(self) -> Partition:
        p = self.partitions[self._rr % len(self.partitions)]
        self._rr += 1
        return p

    def bytes_per_broker(self) -> dict[int, float]:
        out: dict[int, float] = {}
        for p in self.partitions:
            out[p.leader] = out.get(p.leader, 0.0) + p.bytes_in
        return out
