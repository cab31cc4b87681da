"""The port's live serving cluster on a wall clock, on the CPU: a paced
stable run, a rebalance on replica add/remove, and a real-service run
whose replicas decode and identify wire-format crops through the port's
identify stack (``device="cpu"``: the kernels' plain versions), each held
to the reference's own thresholds (``tests/test_cluster.py``).

The knee bisection, the bracket around the closed-form knee and the
card's real-service runs are ``chip_smoke.py``'s cluster phase.
"""
import collections
from dataclasses import replace

from repro_torch.cluster import ClusterSpec, ServingCluster, TailSLO
from repro_torch.core.facerec import CROP_SIZE


def _small_spec(**kw):
    kw.setdefault("sim_time", 3.0)
    kw.setdefault("warmup", 1.0)
    kw.setdefault("speedup", 4.0)
    return ClusterSpec(**kw)


def test_cluster_stable_run_completes_and_reports():
    slo = TailSLO(p99_s=3.0, max_drop_fraction=0.0)
    res = ServingCluster(_small_spec(), slo=slo).run()
    assert res.produced > 100
    assert res.completed > 0.8 * res.produced
    assert not res.diverged
    assert res.latency.p50 <= res.latency.p95 <= res.latency.p99
    assert res.slo.ok, res.slo.violations
    tax = res.ai_tax()
    assert 0.0 < tax["ai_fraction"] < 1.0
    assert "wait" in tax["per_stage"]
    rho = res.predicted_rho["broker_storage_write"]
    assert abs(res.utilization["broker_storage_write"] - rho) < 0.25 * rho + 0.05
    assert res.batch_spans == []            # paced service times nothing


def test_cluster_rebalances_on_replica_add_remove():
    spec = _small_spec(n_replicas=2, n_partitions=4, n_producers=1,
                       fetch_max_wait_s=0.05)
    cl = ServingCluster(spec)
    cl.start()
    base = cl.group.rebalances
    name = cl.add_replica()
    assert cl.group.rebalances > base
    assert len(cl.group.assignment(name).partitions) >= 1
    cl.remove_replica(name)
    assert cl.group.assignment(name).partitions == ()
    owned = sorted(p for parts in cl.group.table().values() for p in parts)
    assert owned == list(range(4))
    for t in cl._feeder_threads:
        t.join(timeout=30)
        assert not t.is_alive()
    for t in cl._replica_threads:
        t.join(timeout=30)
        assert not t.is_alive()
    cl.topic.join()
    res = cl._result()
    assert res.completed > 0.8 * res.produced
    assert not res.diverged


def test_real_service_mode_runs_the_ports_identify_stage():
    """service="real" on the CPU: the replicas serve actual crops through
    the port's ``facerec.build_identify_stack``, warmed before the clock.
    Every identify batch is one recorded span, and the broker is loaded
    by the crops' own bytes: its measured utilization tracks the closed
    form priced at the wire payload, not at the workload's face bytes."""
    spec = _small_spec(service="real", n_replicas=2, n_producers=1,
                       fetch_max_wait_s=0.05, placement="device",
                       device="cpu")
    res = ServingCluster(spec).run()
    assert res.completed > 0.8 * res.produced
    assert not res.diverged
    tax = res.ai_tax()
    assert 0.0 < tax["ai_fraction"] < 1.0
    sizes = collections.Counter(
        e.meta["batch_size"] for e in res.log.events
        if e.stage == "identify")
    assert sum(sizes.values()) == res.completed
    spans = collections.Counter(n for n, _ in res.batch_spans)
    assert {n: c * n for n, c in spans.items()} == dict(sizes)
    assert all(s > 0 for _, s in res.batch_spans)
    wire = replace(spec, wl=replace(spec.wl,
                                    face_bytes=float(CROP_SIZE**2 * 3)))
    rho = wire.predicted_rho()["broker_storage_write"]
    assert rho < 0.5 * res.predicted_rho["broker_storage_write"]
    assert abs(res.utilization["broker_storage_write"] - rho) < 0.25 * rho + 0.05
