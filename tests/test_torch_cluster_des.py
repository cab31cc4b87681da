"""The port's DES, queueing model and TCO against the JAX package's.

Both packages' discrete-event simulators are fed the same seeded
configurations (fixed and empirical face counts, fault plans, an
autoscaler, retry + breaker + degrade, a trace replay) and must return
equal ``SimResult.to_dict()``s; the closed form, the DES knee and the
provisioning choice must be equal too. The port also reproduces the
committed DES goldens (``tests/fixtures/des_golden.json``) with a copy of
``golden_des.compute_goldens``'s recipe on its own modules.
"""
import json
import math
import pathlib
from types import SimpleNamespace

import pytest

import repro.cluster.autoscaler as ref_autoscaler
import repro.cluster.cluster as ref_cluster
import repro.cluster.crossval as ref_crossval
import repro.cluster.faults as ref_faults
import repro.cluster.reliability as ref_reliability
import repro.cluster.trace as ref_trace
import repro.core.broker as ref_broker
import repro.core.queueing as ref_queueing
import repro.core.simulator as ref_simulator
import repro.core.tco as ref_tco
import repro_torch.cluster.autoscaler as port_autoscaler
import repro_torch.cluster.cluster as port_cluster
import repro_torch.cluster.crossval as port_crossval
import repro_torch.cluster.faults as port_faults
import repro_torch.cluster.reliability as port_reliability
import repro_torch.cluster.trace as port_trace
import repro_torch.core.broker as port_broker
import repro_torch.core.queueing as port_queueing
import repro_torch.core.simulator as port_simulator
import repro_torch.core.tco as port_tco
from golden_des import ABS_TOL, REL_TOL

FIXTURES = pathlib.Path(__file__).parent / "fixtures"

REF = SimpleNamespace(sim=ref_simulator, broker=ref_broker,
                      queueing=ref_queueing, tco=ref_tco, faults=ref_faults,
                      autoscaler=ref_autoscaler, rel=ref_reliability,
                      trace=ref_trace, cluster=ref_cluster,
                      crossval=ref_crossval)
PORT = SimpleNamespace(sim=port_simulator, broker=port_broker,
                       queueing=port_queueing, tco=port_tco,
                       faults=port_faults, autoscaler=port_autoscaler,
                       rel=port_reliability, trace=port_trace,
                       cluster=port_cluster, crossval=port_crossval)


# ---- the DES battery: one seeded configuration, both packages ---------------

def _sim(p, wl=None, **kw):
    kw.setdefault("speedup", 4.0)
    kw.setdefault("scale", 0.02)
    kw.setdefault("sim_time", 10.0)
    kw.setdefault("warmup", 2.0)
    kw.setdefault("seed", 7)
    return p.sim.ClusterSim(wl or p.sim.FaceRecWorkload(),
                            p.broker.BrokerConfig(), **kw)


DES_CASES = {
    "fixed": lambda p: _sim(p),
    "empirical": lambda p: _sim(p, p.sim.FaceRecWorkload(
        face_dist="empirical", faces_per_frame=0.64)),
    "fault_random": lambda p: _sim(
        p, fault_plan=p.faults.FaultPlan.random(seed=3, horizon=10.0),
        speedup=6.0),
    "fault_kill_revive": lambda p: _sim(
        p, fault_plan=p.faults.FaultPlan.kill_revive(3.0, 6.0, n=4),
        speedup=6.0, scale=0.04),
    "autoscaler": lambda p: _sim(
        p, autoscale=p.autoscaler.AutoscalerConfig(
            min_replicas=2, max_replicas=12, cooldown_s=0.5,
            interval_s=0.25), n_partitions=12, speedup=6.0),
    "retry_breaker_degrade": lambda p: _sim(
        p, retry=p.rel.RetryPolicy(deadline_s=2.0, attempt_timeout_s=0.6,
                                   max_attempts=3, hedge_delay_s=0.4,
                                   seed=1),
        breaker=p.rel.BreakerConfig(window_s=1.0, min_volume=5, open_s=1.0,
                                    probe_rate=0.2, seed=2),
        degrade=p.rel.DegradePolicy(),
        fault_plan=p.faults.FaultPlan.kill_revive(2.0, 4.0, n=6)),
    "trace_replay": lambda p: _sim(
        p, trace=p.trace.WorkloadTrace.from_jsonl(
            FIXTURES / "trace_smoke.jsonl"), n_partitions=4, scale=1.0,
        sim_time=6.0, warmup=1.0),
}


@pytest.mark.parametrize("case", sorted(DES_CASES))
def test_des_results_equal_the_reference(case):
    ref = DES_CASES[case](REF).run().to_dict()
    port = DES_CASES[case](PORT).run().to_dict()
    assert port == ref
    assert ref["messages"] > 0


def test_des_run_leaves_equal_completions_and_depth_samples():
    sims = [DES_CASES["fault_kill_revive"](p) for p in (REF, PORT)]
    for s in sims:
        s.run()
    assert sims[1].completions == sims[0].completions
    assert sims[1].depth_samples == sims[0].depth_samples


# ---- the closed form and the knees ------------------------------------------

@pytest.mark.parametrize("speedup", [1.0, 4.0, 7.0, 16.0])
def test_utilizations_equal_the_reference(speedup):
    def rhos(p, bk_kw):
        us = p.queueing.utilizations(p.sim.FaceRecWorkload(),
                                     p.broker.BrokerConfig(**bk_kw), speedup)
        return {k: (u.demand, u.capacity, u.rho) for k, u in us.items()}
    for bk_kw in ({}, {"drives_per_broker": 3}, {"n_brokers": 6}):
        assert rhos(PORT, bk_kw) == rhos(REF, bk_kw)


def test_max_stable_speedup_and_stability_knee_equal_the_reference():
    for d in (1, 2, 3, 4):
        got = [p.queueing.max_stable_speedup(
            p.sim.FaceRecWorkload(), p.broker.BrokerConfig(
                drives_per_broker=d)) for p in (REF, PORT)]
        assert got[0] == got[1]
    specs = [p.cluster.ClusterSpec(n_replicas=10, bk=p.broker.BrokerConfig(
        drives_per_broker=2)) for p in (REF, PORT)]
    assert specs[1].closed_form_knee() == specs[0].closed_form_knee()
    assert specs[1].predicted_rho() == specs[0].predicted_rho()


def test_des_knee_equals_the_reference():
    knees = [p.crossval.des_knee(p.cluster.ClusterSpec(), iters=4)
             for p in (REF, PORT)]
    assert knees[1] == knees[0]
    closed = PORT.cluster.ClusterSpec().closed_form_knee()
    assert abs(knees[1] - closed) / closed <= port_crossval.DES_TOL


# ---- TCO from port-measured knees -------------------------------------------

def test_provisioning_from_port_knees_picks_the_papers_design():
    """The port's DES knees at 3 and 4 drives a broker drive the Tables
    3/4 provisioning to 4 drives for 32x, at >= 15% lower TCO, and the
    reference's TCO model gives the same comparison from those knees."""
    knees = {d: port_crossval.des_knee(port_cluster.ClusterSpec(
        bk=port_broker.BrokerConfig(drives_per_broker=d)), iters=5)
        for d in (3, 4)}
    assert port_tco.provision_drives(32.0, knees, tolerance=0.05) == 4
    comp = port_tco.measured_comparison(32.0, knees, tolerance=0.05)
    assert comp.saving_fraction >= 0.15
    assert comp.summary() == ref_tco.measured_comparison(
        32.0, knees, tolerance=0.05).summary()
    assert (comp.homogeneous.equipment_cost
            == port_tco.paper_comparison(True).homogeneous.equipment_cost)


def test_paper_tables_equal_the_reference():
    for support in (False, True):
        assert (port_tco.paper_comparison(support_32x=support).summary()
                == ref_tco.paper_comparison(support_32x=support).summary())


# ---- the DES goldens, reproduced by the port --------------------------------

_SIM_KW = dict(scale=0.04, sim_time=20, warmup=5, seed=0)


def port_goldens() -> dict:
    """``golden_des.compute_goldens``'s recipe on the port's modules."""
    from repro_torch.core.broker import BrokerConfig
    from repro_torch.core.queueing import max_stable_speedup
    from repro_torch.core.simulator import ClusterSim, FaceRecWorkload
    out: dict = {"sim_kw": dict(_SIM_KW), "fig10_11": {}, "fig15": {}}
    wl, bk = FaceRecWorkload(), BrokerConfig()
    out["fault_kill_revive"] = _port_fault_golden(wl, bk)
    out["scenarios"] = _port_scenario_goldens()
    for s in (1, 2, 4, 6, 8):
        r = ClusterSim(wl, bk, speedup=s, **_SIM_KW).run()
        entry = {
            "unstable": r.unstable, "diverged": r.diverged,
            "throughput": r.throughput, "waiting_mean": r.waiting_mean,
            "broker_write_util": r.broker_write_util,
            "broker_net_util": r.broker_net_util, "messages": r.messages,
            "backlog": r.backlog, "unwritten": r.unwritten,
        }
        if not r.unstable:
            entry.update(mean_latency=r.mean_latency,
                         p50_latency=r.p50_latency,
                         p95_latency=r.p95_latency,
                         p99_latency=r.p99_latency,
                         waiting_share=r.waiting_share)
        out["fig10_11"][f"S{s}"] = entry
    for d in (1, 2, 3, 4):
        out["fig15"][f"drives{d}"] = max_stable_speedup(
            wl, BrokerConfig(drives_per_broker=d))
    for n in (3, 4, 6, 8):
        out["fig15"][f"brokers{n}"] = max_stable_speedup(
            wl, BrokerConfig(n_brokers=n))
    for frac in (1.0, 0.5, 0.25):
        out["fig15"][f"face_x{frac}"] = max_stable_speedup(
            FaceRecWorkload(face_bytes=37_300 * frac), bk)
    return out


def _port_scenario_goldens() -> dict:
    from repro_torch.cluster.crossval import des_twin_summary, scenario_knee
    from repro_torch.cluster.scenarios import SCENARIOS, scenario_spec
    out: dict = {}
    for name in SCENARIOS:
        spec = scenario_spec(name)
        trace = spec.resolve_trace()
        s = des_twin_summary(spec)
        out[name] = {
            "trace_hash": trace.trace_hash(), "n_events": trace.n_events,
            "horizon_s": s["horizon_s"], "heartbeat_s": s["heartbeat_s"],
            "diverged": s["diverged"],
            "n_heartbeats": len(s["heartbeats"]), "windows": s["windows"],
            "five_way": s["five_way"], "reliability": s["reliability"],
            "replay_knee": scenario_knee(spec, iters=4),
        }
    return out


def _port_fault_golden(wl, bk) -> dict:
    from repro_torch.cluster.faults import FaultPlan
    from repro_torch.core.metrics import recovery_report
    from repro_torch.core.simulator import ClusterSim
    plan = FaultPlan.kill_revive(6.0, 10.0, n=30)
    sim = ClusterSim(wl, bk, speedup=6, fault_plan=plan, **_SIM_KW)
    r = sim.run()
    rep = recovery_report(sim.completions, 6.0, 10.0, window_s=1.0,
                          depth_samples=sim.depth_samples)
    return {
        "t_kill": 6.0, "t_revive": 10.0, "n_killed": 30, "speedup": 6,
        "requeues": r.requeues, "fault_events": r.fault_events,
        "final_consumers": r.final_consumers, "messages": r.messages,
        "throughput": r.throughput, "backlog": r.backlog,
        "unwritten": r.unwritten, "diverged": r.diverged,
        "baseline_p99": rep.baseline_p99, "spike_p99": rep.spike_p99,
        "recovery_s": rep.recovery_s, "drain_s": rep.drain_s,
    }


@pytest.fixture(scope="module")
def goldens():
    return (json.loads((FIXTURES / "des_golden.json").read_text()),
            port_goldens())


def _assert_close(path: str, want, got):
    if isinstance(want, float):
        assert math.isclose(got, want, rel_tol=REL_TOL, abs_tol=ABS_TOL), \
            f"{path}: fixture={want!r} port={got!r}"
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (w, g) in enumerate(zip(want, got)):
            _assert_close(f"{path}[{i}]", w, g)
    elif isinstance(want, dict):
        assert set(got) == set(want), f"{path}: keys differ"
        for k, w in want.items():
            _assert_close(f"{path}.{k}", w, got[k])
    else:
        assert got == want, f"{path}: fixture={want!r} port={got!r}"


@pytest.mark.parametrize("section", ["sim_kw", "fig10_11", "fig15",
                                     "fault_kill_revive", "scenarios"])
def test_port_reproduces_the_des_goldens(goldens, section):
    fixture, port = goldens
    assert set(port) == set(fixture)
    _assert_close(section, fixture[section], port[section])
