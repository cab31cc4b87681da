"""The port's cluster control plane, its degrade rung of post-processing and
its real-service replica path against the JAX package's.

Every test feeds the same seeded inputs to both packages: range
assignment over join/leave sequences, load-generator schedules and think
samplers, trace hashes and rescales, the scenario library, retry backoff,
breaker transitions, autoscaler and degrade decisions, the wire-format
crops and what the replica's decode + identify makes of them (the
reference embedder's weights carried across as numpy).
"""
import numpy as np
import pytest
import torch

import repro.cluster as ref
import repro.core.broker as ref_broker
from repro.cluster import loadgen as ref_loadgen
from repro.core import facerec as jf
from repro.core.events import EventLog as JaxLog
from repro.preprocess import PreprocessStage as JaxStage
from repro.preprocess import host as jax_host

import repro_torch.cluster as port
import repro_torch.core.broker as port_broker
from repro_torch.cluster import cluster as port_cluster
from repro_torch.cluster import loadgen as port_loadgen
from repro_torch.core import facerec as tf
from repro_torch.core.events import EventLog
from repro_torch.preprocess import PreprocessStage
from repro_torch.preprocess import host as port_host

CPU = "cpu"
PKGS = (ref, port)


# ---- consumer groups ---------------------------------------------------------

def _churn(pkg, n_partitions: int, seed: int):
    """A seeded join/leave sequence; the table after every step."""
    rng = np.random.default_rng(seed)
    g = pkg.ConsumerGroup(n_partitions)
    live: list[str] = []
    tables = []
    for step in range(24):
        if live and rng.random() < 0.4:
            g.leave(live.pop(int(rng.integers(len(live)))))
        else:
            live.append(f"m{step}")
            g.join(live[-1])
        tables.append((g.generation, g.rebalances, g.table(),
                       [g.owner_of(p) for p in range(n_partitions)]))
    return tables


@pytest.mark.parametrize("n_partitions,seed", [(1, 0), (4, 1), (13, 2),
                                               (32, 3)])
def test_consumer_group_churn_equals_the_reference(n_partitions, seed):
    assert _churn(port, n_partitions, seed) == _churn(ref, n_partitions, seed)


@pytest.mark.parametrize("n_members", [0, 1, 3, 8, 20])
def test_range_assignment_equals_the_reference(n_members):
    members = [f"c{i:02d}" for i in range(n_members)][::-1]
    for n in (1, 5, 8, 13):
        assert (port_broker.range_assignment(members, n)
                == ref_broker.range_assignment(members, n))
        if members:
            for rank in range(3 * n_members):
                assert (port_broker.pick_victim(members, rank)
                        == ref_broker.pick_victim(members, rank))


# ---- load generators ---------------------------------------------------------

@pytest.mark.parametrize("process", ["periodic", "poisson"])
def test_open_loop_schedules_equal_the_reference(process):
    for seed in (0, 3):
        gens = [pkg.OpenLoopLoadGen(4, period_s=0.05, process=process,
                                    seed=seed) for pkg in PKGS]
        for producer in range(4):
            assert (gens[1].schedule(producer, 6.0)
                    == gens[0].schedule(producer, 6.0))
        assert gens[1].offered_rate == gens[0].offered_rate


@pytest.mark.parametrize("process,think_s", [("periodic", 0.0),
                                             ("periodic", 0.2),
                                             ("poisson", 0.3)])
def test_closed_loop_think_samplers_equal_the_reference(process, think_s):
    gens = [pkg.ClosedLoopLoadGen(6, think_s=think_s, process=process,
                                  seed=5) for pkg in PKGS]
    for client in range(6):
        samplers = [g.think_sampler(client) for g in gens]
        assert ([samplers[1]() for _ in range(50)]
                == [samplers[0]() for _ in range(50)])


def test_rng_streams_and_diurnal_profile_equal_the_reference():
    for salt in ("", "open-loop", "closed-loop", "diurnal"):
        for stream in range(5):
            assert (port.rng_fingerprint(11, stream, salt)
                    == ref.rng_fingerprint(11, stream, salt))
    assert (port_loadgen.diurnal_profile(60.0, 2.0, 9.0, 30.0, seed=4)
            == ref_loadgen.diurnal_profile(60.0, 2.0, 9.0, 30.0, seed=4))


# ---- traces and the scenario library ----------------------------------------

def test_trace_hash_rescale_and_partition_counts_equal_the_reference():
    from pathlib import Path
    path = Path(__file__).parent / "fixtures" / "trace_smoke.jsonl"
    traces = [pkg.WorkloadTrace.from_jsonl(path) for pkg in PKGS]
    assert traces[1].trace_hash() == traces[0].trace_hash() \
        == "e9642dcdab94e2ad"
    for s in (0.5, 2.0, 3.7):
        a, b = traces[0].rescale(s), traces[1].rescale(s)
        assert b.trace_hash() == a.trace_hash()
        assert [e.t for e in b.events] == [e.t for e in a.events]
    for n in (1, 3, 8):
        assert traces[1].partition_counts(n) == traces[0].partition_counts(n)
    recorded = [pkg.record_loadgen(pkg.OpenLoopLoadGen(3, period_s=0.1,
                                                       process="poisson",
                                                       seed=2), 4.0,
                                   name="rt") for pkg in PKGS]
    assert recorded[1].trace_hash() == recorded[0].trace_hash()


@pytest.mark.parametrize("name", sorted(ref.SCENARIOS))
def test_scenario_traces_hash_equal_the_reference(name):
    assert sorted(port.SCENARIOS) == sorted(ref.SCENARIOS)
    for seed in (0, 1):
        a = ref.build_trace(name, horizon_s=6.0, seed=seed)
        b = port.build_trace(name, horizon_s=6.0, seed=seed)
        assert b.trace_hash() == a.trace_hash()
        assert b.n_events == a.n_events > 0
    assert (port.SCENARIOS[name].signature
            == ref.SCENARIOS[name].signature)


# ---- reliability policies and the autoscaler ---------------------------------

def test_backoff_sequences_equal_the_reference():
    for seed in (0, 1, 9):
        pols = [pkg.RetryPolicy(backoff_base_s=0.02, backoff_cap_s=0.25,
                                seed=seed) for pkg in PKGS]
        for rid in range(20):
            assert ([pols[1].backoff_s(rid, a) for a in range(1, 6)]
                    == [pols[0].backoff_s(rid, a) for a in range(1, 6)])
        for t in (0.0, 0.7, 0.95, 1.2):
            for attempts in range(4):
                assert (pols[1].retry_allowed(t, 0.0, attempts)
                        == pols[0].retry_allowed(t, 0.0, attempts))


def test_breaker_transitions_equal_the_reference_on_one_outcome_stream():
    rng = np.random.default_rng(4)
    stream = [(0.05 * i, bool(rng.random() < (0.2 if i < 60 else 0.8)))
              for i in range(200)]
    walks = []
    for pkg in PKGS:
        b = pkg.BreakerConfig(window_s=1.0, failure_threshold=0.5,
                              min_volume=4, open_s=0.5, probe_rate=0.3,
                              close_after=3, seed=7).make(2)
        walk = []
        for t, ok in stream:
            admitted = b.allow(t)
            if admitted:
                b.record(t, ok)
            walk.append((admitted, b.snapshot()))
        walks.append((walk, list(b.timeline)))
    assert walks[1] == walks[0]
    assert {s for _, s in walks[0][1]} >= {"open", "half_open", "closed"}


def test_degrade_decisions_equal_the_reference():
    pols = [pkg.DegradePolicy() for pkg in PKGS]
    rng = np.random.default_rng(6)
    depth = [0, 0]
    for _ in range(300):
        backlog = float(rng.uniform(0, 60))
        open_frac = float(rng.choice([0.0, 0.1, 0.6]))
        for i, p in enumerate(pols):
            depth[i] = p.decide(backlog, open_frac, depth[i])
        assert depth[1] == depth[0]
        a, b = pols[0].level(depth[0]), pols[1].level(depth[1])
        assert (b.name, b.service_factor, b.accuracy_proxy, b.post_nms,
                b.letterbox_scale) == (a.name, a.service_factor,
                                       a.accuracy_proxy, a.post_nms,
                                       a.letterbox_scale)


def test_autoscaler_actions_equal_the_reference_on_one_observation_stream():
    rng = np.random.default_rng(8)
    obs = [(0.25 * i, float(rng.uniform(0, 80)),
            None if i % 3 else float(rng.uniform(0.1, 3.0)))
           for i in range(200)]
    runs = []
    for pkg in PKGS:
        ctl = pkg.AutoscalerConfig(min_replicas=2, max_replicas=16,
                                   up_backlog=8, down_backlog=2,
                                   cooldown_s=1.0, slo_p99_s=1.5,
                                   interval_s=0.25).controller()
        n, deltas = 4, []
        for t, backlog, p99 in obs:
            d = ctl.decide(t, backlog, n, p99)
            n += d
            deltas.append(d)
        runs.append((deltas, [(a.t, a.delta, a.n_before, a.backlog, a.reason)
                              for a in ctl.actions]))
    assert runs[1] == runs[0]
    assert any(d > 0 for d in runs[0][0]) and any(d < 0 for d in runs[0][0])


def test_fault_plans_equal_the_reference():
    for seed in range(5):
        a = ref.FaultPlan.random(seed=seed, horizon=20.0)
        b = port.FaultPlan.random(seed=seed, horizon=20.0)
        assert ([(e.t, e.action, e.target) for e in b.events]
                == [(e.t, e.action, e.target) for e in a.events])
    a, b = (pkg.FaultPlan.kill_revive(1.0, 2.0, n=3) for pkg in PKGS)
    assert ([(e.t, e.action, e.target) for e in b.events]
            == [(e.t, e.action, e.target) for e in a.events])


# ---- the degrade rung of post-processing: skip_nms ---------------------------

@pytest.mark.parametrize("placement", ["host", "device"])
def test_postprocess_skip_nms_equals_the_reference(placement):
    """Threshold + plain top-k on the host whatever the placement: the
    same centers as the reference's and one ``post_nms`` span over the
    batch, with no transfer booked."""
    rng = np.random.default_rng(11)
    hms = rng.uniform(0, 70, (5, 27, 48)).astype(np.float32)
    hms[1] = 0.0
    hms[2, 3:6, 3:6] = 80.0                 # a plateau of equal scores
    hms[3] = 0.0                            # one blob over adjacent cells
    hms[3, 10:13, 20:23] = 90.0 + np.arange(9, dtype=np.float32).reshape(3, 3)
    jlog, tlog = JaxLog(), EventLog()
    want = JaxStage(placement, log=jlog).postprocess(
        hms, tf.DETECT_POOL, rids=range(5), skip_nms=True)
    got = PreprocessStage(placement, log=tlog, device=CPU).postprocess(
        hms, tf.DETECT_POOL, rids=range(5), skip_nms=True)
    assert got == want
    assert got[1] == [] and len(got[2]) == 5
    assert [(e.request_id, e.stage, e.payload_bytes, e.meta) for e in
            tlog.events] == [(e.request_id, e.stage, e.payload_bytes, e.meta)
                             for e in jlog.events]
    assert {e.stage for e in tlog.events} == {"post_nms"}
    assert len(tlog.events) == 5
    assert sum(e.payload_bytes for e in tlog.events) == hms.nbytes
    # the cheap rung keeps near-duplicates NMS would suppress
    full = PreprocessStage(placement, device=CPU).postprocess(
        hms, tf.DETECT_POOL)
    assert len(full[3]) == 1 and len(got[3]) == 5


# ---- the real-service replica's path -----------------------------------------

def _wire_crops(pkg_cluster, host, spec, n: int, stream: int = 0):
    """``n`` wire-format crops as the produce path makes them: the crop
    generator of one feeder thread, then the camera's encoder."""
    rng = pkg_cluster.ServingCluster(spec)._crop_rng(stream)
    crops = [rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)
             for _ in range(n)]
    return np.stack([host.rgb_to_yuv(c) for c in crops])


def test_wire_crops_are_byte_equal_to_the_reference():
    for seed, stream in ((0, 0), (3, 2)):
        a = _wire_crops(ref, jax_host, ref.ClusterSpec(seed=seed), 9, stream)
        b = _wire_crops(port_cluster, port_host,
                        port.ClusterSpec(seed=seed), 9, stream)
        assert a.dtype == b.dtype == np.uint8 and a.shape == (9, 3, 48, 48)
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("ahead", [0, 3, 300])
def test_wire_crops_encoded_ahead_equal_one_a_call(ahead):
    """An open-loop producer's crops, encoded in bulk before the clock
    starts, are the reference's one-a-call crops byte for byte, also
    past the bulk."""
    spec = port.ClusterSpec(seed=5, service="real", device="cpu")
    crops = port.ServingCluster(spec)._wire_crops(2, ahead)
    got = np.stack([crops.next() for _ in range(ahead + 7)])
    want = _wire_crops(ref, jax_host, ref.ClusterSpec(seed=5), ahead + 7, 2)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert port.ServingCluster(port.ClusterSpec())._wire_crops(0, 9) is None


@pytest.mark.parametrize("placement", ["host", "device"])
def test_replica_decode_identify_equals_the_reference(placement,
                                                      monkeypatch):
    """The port's replica (its warm-up and its decode + identify of one
    batch) with the reference embedder's weights, against the JAX stack
    on the same wire-format crops: names equal, scores within 1e-5."""
    jstack = jf.build_identify_stack(seed=0, fast_path=True,
                                     placement=placement)
    params = tf.embedder_params_from_numpy(
        {"w1": np.asarray(jstack.embedder.w1),
         "w2": np.asarray(jstack.embedder.w2)})
    build = tf.build_identify_stack

    def carried(**kw):
        assert kw["device"] == CPU and kw["placement"] == placement
        return build(**kw, params=params)
    monkeypatch.setattr(tf, "build_identify_stack", carried)
    spec = port.ClusterSpec(service="real", placement=placement, device=CPU)
    cl = port.ServingCluster(spec)
    cl.warm()
    for n in (1, 5, 13, 64):
        yuv = _wire_crops(port_cluster, port_host, spec, n, stream=n)
        got, low_res = cl._identify_real(yuv, None)
        # the reference replica's path, cluster.py's real-mode branch
        if placement == "device":
            rgb = jstack.preprocess.decode(jf._pad_rows_pow2(yuv))[:n]
        else:
            rgb = jstack.preprocess.decode(yuv)
        want = jstack.fused.identify_crops(rgb)
        assert not low_res and len(got) == n
        assert [name for name, _ in got] == [name for name, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                                   atol=1e-5, rtol=0)


def test_real_service_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = port.ClusterSpec(service="real")
    assert spec.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.ServingCluster(spec).warm()
    # paced service builds no stack and needs no card
    port.ServingCluster(port.ClusterSpec()).warm()


def test_result_dict_keys_equal_the_reference():
    """``ClusterResult.to_dict()`` keeps the reference's keys: the
    real-mode batch spans ride beside it, not in it."""
    import dataclasses
    names = {f.name for f in dataclasses.fields(port.ClusterResult)}
    ref_names = {f.name for f in dataclasses.fields(ref.ClusterResult)}
    assert names - ref_names == {"batch_spans"}
    spec_names = {f.name for f in dataclasses.fields(port.ClusterSpec)}
    ref_spec = {f.name for f in dataclasses.fields(ref.ClusterSpec)}
    assert spec_names - ref_spec == {"device"}
