"""Multi-replica serving cluster (paper §5 at deployment scale).

The live analogue of the DES: N replica consumers behind the
Kafka-model ``Topic``/``BrokerConfig`` substrate, partition-aware (max
one consumer per partition, rebalance on replica add/remove), fed by
open- or closed-loop load generators, with per-request tail-latency
percentiles, per-resource utilization, and admission/backpressure — all
instrumented through the same ``EventLog``/``ai_tax`` machinery as the
single-replica pipeline.

Modules:
  * ``scheduler`` — consumer-group partition assignment + rebalance;
  * ``topic``     — live partitions + paced broker write channels;
  * ``loadgen``   — open-loop (periodic/Poisson) and closed-loop load;
  * ``metrics``   — percentiles, tail-latency SLOs, recovery windows;
  * ``cluster``   — the ServingCluster runtime tying them together;
  * ``faults``    — central fault-injection engine: one deterministic
    timeline (kill/revive, stall/restore, drive drop) driving both the
    live cluster and the DES;
  * ``autoscaler`` — queue-depth/SLO-driven elastic replica count
    (hysteresis + cooldown) through the same join/leave path;
  * ``reliability`` — deadline-aware request lifecycle: retry/hedge
    policies, per-target circuit breakers, graceful-degradation ladder
    (shared with the DES, duck-typed through the spec);
  * ``trace``     — versioned JSONL workload traces + the replay
    producer that paces them into live broker topics;
  * ``scenarios`` — the trace library (diurnal, flash crowd, skewed
    camera fleet, burst/drain) with per-shape stress-signature checks;
  * ``crossval``  — measured-vs-modeled knee comparison (live / DES /
    closed-form) and the digital-twin loop: windowed live-vs-DES
    tail/tax agreement per scenario, DES results cached per
    (spec, trace) — ``benchmarks/fig_scenarios.py`` gates it.

The port's copy of ``repro.cluster``, the same in behaviour: one seed
gives the same numbers in both packages.
"""
from repro_torch.cluster.autoscaler import (
    Autoscaler, AutoscalerConfig, ScaleAction)
from repro_torch.cluster.cluster import (
    ClusterResult, ClusterSpec, ServingCluster)
from repro_torch.cluster.crossval import (
    KneeComparison, ReliabilityAgreement, TwinCache, TwinReport,
    WindowComparison, des_twin_summary, knee_comparison, live_twin_summary,
    reliability_agreement, scenario_knee, spec_key, twin_compare)
from repro_torch.cluster.faults import FaultEngine, FaultEvent, FaultPlan
from repro_torch.cluster.loadgen import (
    ClosedLoopLoadGen, OpenLoopLoadGen, rng_fingerprint)
from repro_torch.cluster.metrics import (
    LatencyStats, RecoveryReport, ReliabilityReport, SLOReport, TailSLO,
    recovery_report, reliability_report)
from repro_torch.cluster.reliability import (
    BreakerConfig, CircuitBreaker, DegradeLevel, DegradePolicy, RetryPolicy)
from repro_torch.cluster.scenarios import (
    SCENARIOS, Scenario, build_trace, scenario_spec)
from repro_torch.cluster.scheduler import ConsumerGroup
from repro_torch.cluster.trace import (
    DEFAULT_PAYLOAD_BYTES, TraceError, TraceEvent, TraceReplayProducer,
    WorkloadTrace, record_loadgen)

__all__ = [
    "ClusterResult", "ClusterSpec", "ServingCluster",
    "KneeComparison", "knee_comparison",
    "ReliabilityAgreement", "reliability_agreement",
    "TwinCache", "TwinReport", "WindowComparison", "twin_compare",
    "des_twin_summary", "live_twin_summary", "scenario_knee", "spec_key",
    "SCENARIOS", "Scenario", "build_trace", "scenario_spec",
    "DEFAULT_PAYLOAD_BYTES", "TraceError", "TraceEvent",
    "TraceReplayProducer", "WorkloadTrace", "record_loadgen",
    "rng_fingerprint",
    "FaultEngine", "FaultEvent", "FaultPlan",
    "Autoscaler", "AutoscalerConfig", "ScaleAction",
    "BreakerConfig", "CircuitBreaker", "DegradeLevel", "DegradePolicy",
    "RetryPolicy",
    "ClosedLoopLoadGen", "OpenLoopLoadGen",
    "LatencyStats", "RecoveryReport", "ReliabilityReport", "SLOReport",
    "TailSLO", "recovery_report", "reliability_report",
    "ConsumerGroup",
]
