"""Consumer-group partition scheduler (Kafka's group protocol, in-process).

Invariants (the ones the broker model in ``repro_torch.core.broker`` states
and the DES assumes):
  * at most ONE consumer owns a partition at any generation;
  * every partition is owned whenever the group is non-empty;
  * ownership is range-assigned over the sorted member list, so
    assignment is deterministic in (members, n_partitions) — no RNG.

A rebalance bumps the ``generation``; replicas read their assignment
at the top of each sweep and re-check the generation before every
partition fetch, restarting the sweep when it moved — so the overlap
window during a rebalance shrinks to a serve already in flight (the
same cooperative-rebalance window a Kafka consumer group has), and
held-back records for revoked partitions are requeued for the new
owner.

The port's copy of ``repro.cluster.scheduler``, the same in behaviour:
one seed gives the same numbers in both packages.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

from repro_torch.core.broker import range_assignment


@dataclass
class Assignment:
    generation: int
    partitions: tuple


class ConsumerGroup:
    """Thread-safe membership + range partition assignment."""

    def __init__(self, n_partitions: int):
        if n_partitions < 1:
            raise ValueError("need at least one partition")
        self.n_partitions = n_partitions
        self._members: list[str] = []
        self._lock = threading.Lock()
        self.generation = 0
        self.rebalances = 0
        self._table: dict[str, tuple] = {}

    # ---- membership --------------------------------------------------------

    def join(self, member: str) -> Assignment:
        with self._lock:
            if member not in self._members:
                self._members.append(member)
                self._rebalance()
            return self._assignment(member)

    def leave(self, member: str) -> None:
        with self._lock:
            if member in self._members:
                self._members.remove(member)
                self._rebalance()

    @property
    def members(self) -> list[str]:
        with self._lock:
            return list(self._members)

    # ---- assignment --------------------------------------------------------

    def _rebalance(self) -> None:
        """Range assignment over the sorted member list (lock held)."""
        self.generation += 1
        self.rebalances += 1
        self._table = range_assignment(self._members, self.n_partitions)

    def _assignment(self, member: str) -> Assignment:
        return Assignment(self.generation, self._table.get(member, ()))

    def assignment(self, member: str) -> Assignment:
        """The member's current partitions, stamped with the generation."""
        with self._lock:
            return self._assignment(member)

    def check_fence(self, member: str, partition: int,
                    generation: int) -> bool:
        """Generation fence for a write/commit attempt.

        True only when ``generation`` is the CURRENT generation and
        ``member`` owns ``partition`` in it — a write stamped with any
        older generation is rejected, so a zombie consumer that was
        rebalanced away (or killed by the fault engine) can never
        commit against a partition it no longer owns.
        """
        with self._lock:
            return (generation == self.generation
                    and partition in self._table.get(member, ()))

    def owner_of(self, partition: int) -> str | None:
        with self._lock:
            for member, parts in self._table.items():
                if partition in parts:
                    return member
        return None

    def table(self) -> dict[str, tuple]:
        with self._lock:
            return dict(self._table)
