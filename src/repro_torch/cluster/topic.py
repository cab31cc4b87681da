"""Live partitions + paced broker write channels.

The in-process realization of ``repro_torch.core.broker``'s Kafka model: a
``LiveTopic`` holds one thread-safe queue per partition, and one writer
thread per broker that paces leader writes at the configured storage
capacity (``BrokerConfig.write_time``). Pacing uses absolute deadlines
(``free_at``), so sleep overshoot does not accumulate — a saturated
channel delivers at exactly the modeled bandwidth, which is what lets
the live knee line up with the DES and the closed form.

All modeled durations are divided by the cluster's ``time_compression``
factor: one model second takes ``1/c`` wall seconds, shrinking a 10 s
experiment to a test-sized run while preserving every demand/capacity
ratio (and therefore the stability knee).

The port's copy of ``repro.cluster.topic``, the same in behaviour: one
seed gives the same numbers in both packages.
"""
from __future__ import annotations

import queue
import threading
import time

from repro_torch.core.broker import BrokerConfig, Message


class LivePartition:
    """One partition: FIFO queue + counters.

    ``produced``/``bytes_in`` are written only by the leader broker's
    writer thread, ``consumed`` only by the partition's (single, per
    the group invariant) consumer — so the counters need no locks.
    """

    def __init__(self, topic: str, index: int, leader: int):
        self.topic = topic
        self.index = index
        self.leader = leader
        self.queue: queue.Queue = queue.Queue()
        self.accepted = 0       # admitted at publish (incl. unwritten)
        self.produced = 0       # leader write finished
        self.consumed = 0
        self.bytes_in = 0.0

    def deliver(self, msg: Message) -> None:
        # single-writer invariant: only the partition's leader
        # BrokerWriter thread calls deliver
        self.produced += 1   # lint: waive race-check -- leader BrokerWriter is the only writer; readers tolerate staleness
        self.bytes_in += msg.size  # lint: waive race-check -- same single-leader-writer invariant as produced
        self.queue.put(msg)

    @property
    def in_flight(self) -> int:
        """Admitted but unconsumed — the quantity admission bounds.
        Counts messages still sitting in the broker write channel, so
        backpressure engages when STORAGE (not just the consumer) is
        the backlog point."""
        return self.accepted - self.consumed


class BrokerWriter(threading.Thread):
    """Leader write channel for one broker, paced at storage capacity."""

    def __init__(self, broker_id: int, cfg: BrokerConfig, compress: float,
                 deadline: float):
        super().__init__(daemon=True, name=f"broker-{broker_id}")
        self.broker_id = broker_id
        self.cfg = cfg
        self.compress = compress
        self.deadline = deadline          # wall perf_counter time
        self.inbox: queue.Queue = queue.Queue()
        self.free_at = 0.0
        self.busy = 0.0                   # wall seconds the channel served
        self.bytes = 0.0
        # fault-engine hooks: a stalled channel stops draining its inbox
        # (records pile up and replay at pacing once cleared); set_drives
        # swaps the pacing config mid-run. The serve loop below reads
        # self.cfg fresh per chunk, so neither needs its cooperation.
        self.stalled = threading.Event()
        self._base_drives = cfg.drives_per_broker

    CHUNK = 128

    def set_drives(self, n: int) -> None:
        """Repace the channel at ``n`` drives (fault engine only)."""
        from dataclasses import replace
        n = max(1, min(n, self._base_drives))
        # atomic reference swap by design: run() re-reads self.cfg per
        # chunk, so a degraded channel takes effect at the next write
        self.cfg = replace(self.cfg, drives_per_broker=n)  # lint: waive race-check -- immutable-config swap; run() reads cfg fresh each chunk

    def drop_drive(self) -> None:
        self.set_drives(self.cfg.drives_per_broker - 1)

    def restore_drive(self) -> None:
        self.set_drives(self.cfg.drives_per_broker + 1)

    def run(self) -> None:
        while True:
            now = time.perf_counter()
            if now >= self.deadline:
                return
            if self.stalled.is_set():
                time.sleep(0.002)
                continue
            try:
                chunk = [self.inbox.get(
                    timeout=min(0.02, self.deadline - now))]
            except queue.Empty:
                continue
            # drain whatever else is queued: one sleep paces the whole
            # chunk, so the ~1 ms sleep-overshoot on this container is
            # amortized instead of taxing every record (a per-record
            # sleep silently halves effective write bandwidth). The
            # absolute free_at deadline self-corrects residual drift.
            while len(chunk) < self.CHUNK:
                try:
                    chunk.append(self.inbox.get_nowait())
                except queue.Empty:
                    break
            dur = sum(self.cfg.write_time(m.size)
                      for _, m in chunk) / self.compress
            start = max(time.perf_counter(), self.free_at)
            # run() is the writer thread itself; these are its private
            # pacing/throughput counters, read only after join()
            self.free_at = start + dur  # lint: waive race-check -- owned by this writer thread; read after join
            self.busy += dur  # lint: waive race-check -- owned by this writer thread; read after join
            self.bytes += sum(  # lint: waive race-check -- owned by this writer thread; read after join
                m.size + self.cfg.write_overhead_bytes for _, m in chunk)
            delay = self.free_at - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            tw = time.perf_counter()
            for part, msg in chunk:
                msg.t_written = tw
                part.deliver(msg)


class LiveTopic:
    """Partitioned topic over per-broker paced write channels."""

    def __init__(self, name: str, n_partitions: int, cfg: BrokerConfig,
                 compress: float, deadline: float):
        self.name = name
        self.cfg = cfg
        self.partitions = [
            LivePartition(name, i, cfg.leader_for(i))
            for i in range(n_partitions)]
        self.writers = [BrokerWriter(b, cfg, compress, deadline)
                        for b in range(cfg.n_brokers)]
        self._rr = 0
        self._rr_lock = threading.Lock()

    def start(self) -> None:
        for w in self.writers:
            w.start()

    def join(self) -> None:
        for w in self.writers:
            w.join()

    def pick_partition(self) -> LivePartition:
        with self._rr_lock:
            p = self.partitions[self._rr % len(self.partitions)]
            self._rr += 1
            return p

    def publish(self, msg: Message, part: LivePartition | None = None) -> None:
        """Hand the message to its leader's write channel (async write)."""
        if part is None:
            part = self.pick_partition()
        self.writers[part.leader].inbox.put((part, msg))

    def backlog(self) -> int:
        """Messages accepted but not yet consumed (incl. unwritten)."""
        unwritten = sum(w.inbox.qsize() for w in self.writers)
        return unwritten + sum(p.queue.qsize() for p in self.partitions)

    def write_utilization(self, span_wall: float) -> float:
        """Mean busy fraction of the broker write channels."""
        if span_wall <= 0 or not self.writers:
            return 0.0
        return sum(w.busy for w in self.writers) / (
            len(self.writers) * span_wall)
