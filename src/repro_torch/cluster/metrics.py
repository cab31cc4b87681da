"""Cluster-namespace re-export of the shared tail-latency metrics.

The implementations live in :mod:`repro_torch.core.metrics` (pure stdlib) so
the serving engine can share the LatencyStats/TailSLO vocabulary
without importing the cluster runtime; cluster code and tests address
them here. The fault-recovery accounting (windowed tails, recovery /
drain times) rides the same re-export, as does the reliability
accounting (goodput vs throughput, retry amplification, deadline-miss
rate): both execution engines hand it their completion streams and
report recovery in one vocabulary.

The port's copy of ``repro.cluster.metrics``, the same in behaviour: one
seed gives the same numbers in both packages.
"""
from repro_torch.core.metrics import (
    LatencyStats, RecoveryReport, ReliabilityReport, SLOReport, TailSLO,
    goodput_timeline, percentile, recovery_report, reliability_report,
    windowed_percentile)

__all__ = ["LatencyStats", "RecoveryReport", "ReliabilityReport",
           "SLOReport", "TailSLO", "goodput_timeline", "percentile",
           "recovery_report", "reliability_report", "windowed_percentile"]
