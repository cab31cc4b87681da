"""The port's ServingEngine (repro_torch.serve.engine) against the JAX
engine, mirroring tests/test_serve.py.

Both engines serve the smoke config of ``arch`` (llama3-8b here;
``test_torch_serve_rwkv.py`` collects the same cases for rwkv6-3b) in
float32 on the CPU with the same weights: the reference's ``Model.init``
tree with numpy noise from a seed on every leaf (so that zeros/ones-
initialised leaves are exercised too), carried across with
``params_from_jax``. Greedy token streams must be identical, request by
request, for both schedulers and both ``fast_path`` settings, and the
port's transfer ledger must equal its own counters and the reference's
device->host bytes.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro.serve import engine as jax_engine

from repro_torch import configs
from repro_torch.core.metrics import TailSLO
from repro_torch.models.model import Model, params_from_jax
from repro_torch.serve.engine import Request, ServingEngine


@pytest.fixture(scope="module")
def arch():
    return "llama3-8b"


@pytest.fixture(scope="module")
def models(arch):
    return build_models(arch)


def build_models(arch):
    """(jax model, jax params, port model, port params, port cfg) of
    ``arch``'s float32 smoke config, every leaf moved by numpy noise."""
    cfg = jax_get_config(arch, smoke=True).replace(dtype="float32")
    jm = jax_build_model(cfg)
    rng = np.random.default_rng(0)
    jp = jax.tree.map(
        lambda a: (np.asarray(a) + 0.2 * rng.standard_normal(a.shape))
        .astype(np.float32), jm.init(jax.random.PRNGKey(0)))
    pcfg = configs.get_config(arch, smoke=True).replace(dtype="float32")
    pm = Model(pcfg, device="cpu")
    pp = params_from_jax(pcfg, jp, device="cpu")
    return jm, jp, pm, pp, pcfg


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n) for n in lens]


def _run(models, prompts, max_tokens, *, port=True, slots=2, cache_len=48,
         **kw):
    jm, jp, pm, pp, _ = models
    if port:
        eng = ServingEngine(pm, pp, batch_slots=slots, cache_len=cache_len,
                            **kw)
        make = Request
    else:
        eng = jax_engine.ServingEngine(jm, jp, batch_slots=slots,
                                       cache_len=cache_len, **kw)
        make = jax_engine.Request
    for i, p in enumerate(prompts):
        eng.submit(make(i, p, max_tokens=max_tokens))
    done = eng.run()
    return eng, done


def _streams(done):
    return {r.rid: r.tokens for r in done}


@pytest.mark.parametrize("fast_path", [True, False])
@pytest.mark.parametrize("scheduler", ["continuous", "slot"])
def test_greedy_streams_equal_the_jax_engine(models, scheduler, fast_path):
    cfg = models[4]
    prompts = _prompts(cfg, [9, 5, 14, 7, 3], seed=7)
    kw = dict(scheduler=scheduler, fast_path=fast_path)
    jeng, jdone = _run(models, prompts, 6, port=False, **kw)
    peng, pdone = _run(models, prompts, 6, **kw)
    assert _streams(pdone) == _streams(jdone)
    assert len(pdone) == 5 and all(len(r.tokens) == 6 for r in pdone)
    # the same device->host fetches; admissions upload no slot index here
    assert (peng.d2h_syncs, peng.d2h_bytes) == (jeng.d2h_syncs, jeng.d2h_bytes)
    admits = len(prompts) if scheduler == "continuous" else 0
    assert peng.log.transfer_bytes()["h2d"] == \
        jeng.log.transfer_bytes()["h2d"] - 4 * admits


@pytest.mark.parametrize("fast_path", [True, False])
@pytest.mark.parametrize("scheduler", ["continuous", "slot"])
def test_transfer_ledger_accounts_every_d2h_byte(models, scheduler,
                                                 fast_path):
    eng, done = _run(models, _prompts(models[4], [8] * 4, seed=19), 4,
                     scheduler=scheduler, fast_path=fast_path)
    assert len(done) == 4 and eng.d2h_syncs > 0
    assert eng.log.transfer_bytes()["d2h"] == eng.d2h_bytes
    if scheduler == "slot":                 # one record per fetch
        assert sum(e.meta.get("direction") == "d2h"
                   for e in eng.log.events) == eng.d2h_syncs


def test_decode_d2h_roundtrips_collapse_with_batching(models):
    prompts = _prompts(models[4], [8] * 4, seed=23)
    slot_eng, _ = _run(models, prompts, 5, scheduler="slot")
    cont_eng, _ = _run(models, prompts, 5, scheduler="continuous")
    # 4 prefill fetches either way; decode fetches: 16 vs 8 ticks
    assert slot_eng.d2h_syncs - 4 == 2 * (cont_eng.d2h_syncs - 4)


@pytest.mark.parametrize("scheduler", ["continuous", "slot"])
def test_max_tokens_one_emits_exactly_one_token(models, scheduler):
    eng, done = _run(models, _prompts(models[4], [8] * 3, seed=17), 1,
                     scheduler=scheduler)
    assert len(done) == 3 and all(len(r.tokens) == 1 for r in done)
    assert not [e for e in eng.log.events if e.stage == "decode"]


def test_respects_cache_capacity(models):
    (prompt,) = _prompts(models[4], [10], seed=4)
    eng, done = _run(models, [prompt], 100, slots=1, cache_len=16)
    jeng, jdone = _run(models, [prompt], 100, port=False, slots=1,
                       cache_len=16)
    assert done[0].done and len(done[0].tokens) <= 16
    assert _streams(done) == _streams(jdone)


def test_cache_len_768_matches_the_jax_engine(models):
    """cache_len 768 is no multiple of the Pallas kernel's default tile;
    the port's decode takes any cache length."""
    prompts = _prompts(models[4], [8, 30], seed=29)
    _, done = _run(models, prompts, 4, cache_len=768)
    _, jdone = _run(models, prompts, 4, port=False, cache_len=768)
    assert _streams(done) == _streams(jdone)


def test_mid_flight_admit_joins_without_perturbing_residents(models):
    pa, pb, pc = _prompts(models[4], [8, 8, 8], seed=11)

    def make():
        return [Request(0, pa, max_tokens=10), Request(1, pb, max_tokens=3),
                Request(2, pc, max_tokens=4)]

    jm, jp, pm, pp, _ = models
    runs = []
    for reqs in (make()[:2], make()):
        eng = ServingEngine(pm, pp, batch_slots=2, cache_len=48)
        for r in reqs:
            eng.submit(r)
        runs.append((eng, _streams(eng.run())))
    (_, ab), (eng3, abc) = runs
    assert abc[0] == ab[0] and abc[1] == ab[1]
    c_prefill_end = max(e.t_end for e in eng3.log.events
                        if e.request_id == 2 and e.stage == "prefill")
    assert [e for e in eng3.log.events if e.request_id == 0
            and e.stage == "decode" and e.t_start >= c_prefill_end]


def test_ttft_samples_cover_all_requests_and_latency_report(models):
    eng, done = _run(models, _prompts(models[4], [8] * 4, seed=31), 3)
    ttfts = eng.ttft_samples()
    assert len(ttfts) == 4 and all(t > 0 for t in ttfts)
    stats, slo = eng.latency_report(TailSLO(p99_s=1e9,
                                            max_drop_fraction=0.0))
    assert stats.n == 4 and slo.ok
    rep = eng.tax_report()
    assert set(rep) >= {"ai_fraction", "tax_fraction", "per_stage"}
    assert {"prefill", "decode"} <= set(rep["per_stage"])


class _Level:
    def __init__(self, name, factor):
        self.name, self.service_factor, self.accuracy_proxy = name, factor, 0.9


class _Ladder:
    """A duck-typed degrade policy: level 1 as soon as anything queues."""
    levels = (_Level("full", 1.0), _Level("short", 0.5))

    def decide(self, backlog, open_frac, depth):
        return 1 if backlog > 0 else 0

    def level(self, depth):
        return self.levels[depth]


def test_degrade_ladder_and_max_queue_match_the_jax_engine(models):
    prompts = _prompts(models[4], [6] * 6, seed=37)
    kw = dict(slots=2, degrade=_Ladder(), max_queue=4)
    eng, done = _run(models, prompts, 6, **kw)
    jeng, jdone = _run(models, prompts, 6, port=False, **kw)
    assert eng.rejected == jeng.rejected == 2
    assert _streams(done) == _streams(jdone)
    assert [len(r.tokens) for r in done] == [len(r.tokens) for r in jdone]
    assert sum(e.stage == "degrade" for e in eng.log.events) == \
        sum(e.stage == "degrade" for e in jeng.log.events) > 0
    assert [d for _, d, _ in eng.degrade_timeline] == \
        [d for _, d, _ in jeng.degrade_timeline]
