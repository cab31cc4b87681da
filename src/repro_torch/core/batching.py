"""Micro-batching over broker topics (the paper's batching lever, §5.5).

The port's own copy of ``repro.core.batching``, unchanged in behaviour.

The paper shows that once the AI stages are accelerated, the win comes
from amortizing per-item overheads — but batching also *creates* tax:
items wait in the topic for the batch to fill, and that wait is exactly
the broker/queueing time Fig 6 shows dominating. ``Batcher`` makes the
trade explicit and measurable: it drains a ``queue.Queue`` (the
in-process stand-in for a Kafka partition) into batches bounded by a
max size AND a max linger — the same (batch.size, linger.ms) pair a
Kafka consumer/producer exposes.

Consumers log each item's queue wait individually (the Batcher never
touches the EventLog), so per-request AI-tax accounting survives
batching; see docs/ai_tax_accounting.md.

One Batcher per consumer thread: stop-sentinel handling is stateful
(a partial batch is flushed before the iterator ends), so sharing one
across threads would swallow peers' sentinels.
"""
from __future__ import annotations

import queue
import time
from dataclasses import dataclass, fields


@dataclass
class BatchStats:
    """Why batches flushed — the observable knob/latency trade."""
    n_batches: int = 0
    n_items: int = 0
    flush_size: int = 0      # batch filled to batch_size
    flush_timeout: int = 0   # linger expired with a partial batch
    flush_stop: int = 0      # stop sentinel ended a partial batch
    flush_drain: int = 0     # non-blocking poll emptied the queue

    @property
    def mean_batch_size(self) -> float:
        return self.n_items / self.n_batches if self.n_batches else 0.0

    def merge(self, other: "BatchStats") -> "BatchStats":
        return BatchStats(*(getattr(self, f.name) + getattr(other, f.name)
                            for f in fields(self)))

    def _count(self, batch_len: int, reason: str) -> None:
        # one Batcher (and its stats) per consumer thread by contract;
        # cross-thread totals go through the associative merge() only
        self.n_batches += 1  # lint: waive race-check -- per-consumer-thread stats object; aggregation uses merge()
        self.n_items += batch_len  # lint: waive race-check -- per-consumer-thread stats object; aggregation uses merge()
        setattr(self, f"flush_{reason}", getattr(self, f"flush_{reason}") + 1)


class Batcher:
    """Size/timeout-bounded batches, pull- or push-fed.

    Pull (consumer threads): iterate, or call ``next_batch``. Blocks
    for the first item of each batch (idle consumers cost nothing),
    then lingers at most ``timeout_s`` past that first item while
    filling up to ``batch_size``. A ``stop`` sentinel ends iteration
    (required for it); a partial batch in flight is flushed first.

    ``poll`` is the non-blocking pull variant for callers with their
    own scheduling loop (e.g. serving-engine admission).

    Push (in-process producers with no consumer thread, e.g. the fused
    ingest->detect stage): ``push`` each item — it returns a batch
    when the size or linger bound trips — and ``flush`` at end of
    stream. One flush policy, either way.
    """

    def __init__(self, source: queue.Queue | None = None, *,
                 batch_size: int = 8, timeout_s: float = 0.005,
                 stop: object = None):
        self.source = source
        self.batch_size = max(1, batch_size)
        self.timeout_s = timeout_s
        self.stop = stop
        self.stats = BatchStats()
        self._stopped = False
        self._pending: list = []      # push-side partial batch
        self._deadline = 0.0

    # ---- push interface ---------------------------------------------------

    def push(self, item) -> list | None:
        """Add one item; returns a batch to process when a bound trips.

        The linger is checked at push time (there is no thread to wake
        on a timer), so the effective bound is timeout_s plus one
        inter-push gap.
        """
        if not self._pending:
            self._deadline = time.perf_counter() + self.timeout_s
        self._pending.append(item)
        full = len(self._pending) == self.batch_size
        if full or time.perf_counter() >= self._deadline:
            batch, self._pending = self._pending, []
            self.stats._count(len(batch), "size" if full else "timeout")
            return batch
        return None

    def flush(self) -> list | None:
        """End of stream: hand back any partial push()ed batch."""
        if not self._pending:
            return None
        batch, self._pending = self._pending, []
        self.stats._count(len(batch), "stop")
        return batch

    # ---- pull interface ---------------------------------------------------

    def next_batch(self, max_wait: float | None = None) -> list | None:
        """One batch, or None once the stop sentinel has been consumed.

        ``max_wait`` bounds the blocking wait for the batch's FIRST
        item; when it expires with nothing queued the call returns an
        empty list (distinct from the ``None`` end-of-stream signal).
        Cluster replicas poll several partition queues from one thread,
        so an idle partition must hand control back instead of parking
        the consumer forever.
        """
        if self.source is None:
            raise ValueError("pull interface needs a source queue; "
                             "this Batcher is push-fed")
        if self._stopped:
            return None
        try:
            first = self.source.get(timeout=max_wait)
        except queue.Empty:
            return []
        if self.stop is not None and first is self.stop:
            self._stopped = True  # lint: waive race-check -- monotonic stop latch; flips one way, any observer order is safe
            return None
        batch = [first]
        deadline = time.perf_counter() + self.timeout_s
        reason = "size"
        while len(batch) < self.batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                reason = "timeout"
                break
            try:
                item = self.source.get(timeout=remaining)
            except queue.Empty:
                reason = "timeout"
                break
            if self.stop is not None and item is self.stop:
                self._stopped = True  # lint: waive race-check -- monotonic stop latch; flips one way, any observer order is safe
                reason = "stop"
                break
            batch.append(item)
        self.stats._count(len(batch), reason)
        return batch

    def poll(self, max_items: int | None = None) -> list:
        """Non-blocking drain of up to max_items (default batch_size)."""
        if self.source is None:
            raise ValueError("pull interface needs a source queue; "
                             "this Batcher is push-fed")
        limit = self.batch_size if max_items is None else max_items
        batch: list = []
        while len(batch) < limit and not self._stopped:
            try:
                item = self.source.get_nowait()
            except queue.Empty:
                break
            if self.stop is not None and item is self.stop:
                self._stopped = True  # lint: waive race-check -- monotonic stop latch; flips one way, any observer order is safe
                break
            batch.append(item)
        if batch:
            # "size" only when the batch genuinely filled; a drain cut
            # short by the caller's limit or an empty queue is "drain"
            self.stats._count(len(batch), "size" if len(batch) ==
                              self.batch_size else "drain")
        return batch

    def __iter__(self):
        if self.stop is None:
            raise ValueError("iterating a Batcher needs a stop sentinel "
                             "(nothing could ever end the loop); use "
                             "poll() or push() for sentinel-free feeds")
        return iter(self.next_batch, None)
