"""The port's launch-plan autotuner (``repro_torch.kernels.autotune``),
case for case as ``tests/test_autotune.py`` holds the reference's: the
candidates are plans the kernels take, the formula's plan among them; a
miss tunes, a hit does not; the cache persists, is deterministic, buckets
M, survives corruption, overlays a seed and drops stale entries; decode's
plans; the committed seed equals the battery. In place of the reference's
tuned-kernel case (which fails with the reference's Pallas matmul), the
plain path on the CPU ignores the cache. Every case runs on a cache of its
own (never the user's)."""
import json

import pytest
import torch

from repro_torch.kernels import autotune
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import matmul as mm

N_SM = 132
MM_SHAPES = [(1, 6912, 256), (8, 256, 128), (5, 3072, 256), (3, 100, 37),
             (1, 7, 16), (16, 6912, 256), (64, 256, 128), (512, 3072, 256),
             (13, 200, 37), (9, 1, 5)]


@pytest.fixture
def cache(tmp_path):
    return autotune.AutotuneCache(path=tmp_path / "cache.json",
                                  seed_path=None)


@pytest.fixture(autouse=True)
def hermetic_cache(tmp_path, monkeypatch):
    """The process-wide cache on this test's own files."""
    monkeypatch.setattr(autotune, "_CACHE", autotune.AutotuneCache(
        path=tmp_path / "process.json", seed_path=None))


@pytest.mark.parametrize("M,K,N", MM_SHAPES)
def test_matmul_candidates_are_plans_the_kernel_takes(M, K, N):
    cands = autotune.matmul_candidates(M, K, N, N_SM)
    assert cands and len({json.dumps(c, sort_keys=True)
                          for c in cands}) == len(cands)
    for c in cands:
        mm.check_plan(M, K, c)                   # raises on a bad plan
    if M <= mm.SKINNY_M:
        formula = dict(zip(("cluster", "k_chunk"), mm.skinny_plan(N, K, N_SM)))
    else:
        formula = dict(zip(("splits", "k_chunk"), mm.split_k(M, N, K, N_SM)))
    assert formula in cands
    assert autotune.matmul_formula(M, K, N, N_SM) == formula


@pytest.mark.parametrize("plan,M,K", [
    ({"cluster": 9, "k_chunk": 768}, 1, 6912),     # past MAX_CLUSTER
    ({"cluster": 8, "k_chunk": 1000}, 1, 6912),    # an empty rank
    ({"cluster": 5, "k_chunk": 20}, 1, 100),       # over ceil(K / 32) ranks
    ({"splits": 2, "k_chunk": 100}, 16, 200),      # not a multiple of 32
    ({"splits": 8, "k_chunk": 32}, 16, 200),       # an empty split
    ({"splits": 2, "k_chunk": 64}, 4, 128),        # the other route's keys
])
def test_a_plan_the_kernel_rejects_raises(plan, M, K):
    a, b = torch.zeros(M, K), torch.zeros(K, 8)
    with pytest.raises(ValueError):
        mm.matmul(a, b, plan=plan)
    q, k = torch.zeros(2, 1, 4, 16), torch.zeros(2, 300, 2, 16)
    lens = torch.full((2,), 300)
    for n in (0, 4):                             # ceil(300 / 128) = 3
        with pytest.raises(ValueError):
            da.decode_attention(q, k, k, kv_len=lens, plan={"n_split": n})


def test_matmul_plan_miss_then_hit(cache, monkeypatch):
    p1 = autotune.matmul_plan(64, 6912, 256, N_SM, cache=cache)
    assert set(p1) == {"splits", "k_chunk"}
    assert cache.path.is_file()
    # a hit must not re-run the sweep: poison the scorer
    monkeypatch.setattr(autotune, "matmul_cost_us", lambda *a, **k: 1 / 0)
    assert autotune.matmul_plan(64, 6912, 256, N_SM, cache=cache) == p1


def test_matmul_plan_persists_across_cache_objects(cache):
    p1 = autotune.matmul_plan(4, 3072, 256, N_SM, cache=cache)
    fresh = autotune.AutotuneCache(path=cache.path, seed_path=None)
    entry = fresh.lookup(autotune.matmul_key(4, 3072, 256, N_SM))
    assert entry is not None and entry["plan"] == p1
    assert entry["mode"] == "analytic" and entry["v"] == \
        autotune.SCHEMA_VERSION


def test_matmul_plan_deterministic(tmp_path):
    a = autotune.AutotuneCache(path=tmp_path / "a.json", seed_path=None)
    b = autotune.AutotuneCache(path=tmp_path / "b.json", seed_path=None)
    for M, K, N in MM_SHAPES:
        assert autotune.matmul_plan(M, K, N, N_SM, cache=a) == \
            autotune.matmul_plan(M, K, N, N_SM, cache=b)


def test_m_bucketing_shares_keys():
    """Ragged batch rows land in the pow2 bucket of the padded call the
    face path makes, so one tuning serves the whole bucket; the skinny and
    tile routes never share one (SKINNY_M is a power of two)."""
    assert autotune.matmul_key(5, 3072, 256, N_SM) == \
        autotune.matmul_key(8, 3072, 256, N_SM)
    assert autotune.matmul_key(8, 3072, 256, N_SM) != \
        autotune.matmul_key(9, 3072, 256, N_SM)
    assert autotune.matmul_key(8, 3072, 256, N_SM) != \
        autotune.matmul_key(8, 3072, 256, 114)          # another card


def test_corrupt_cache_is_empty_cache(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text("{not json")
    c = autotune.AutotuneCache(path=p, seed_path=None)
    assert c.lookup("anything") is None
    plan = autotune.matmul_plan(64, 256, 128, N_SM, cache=c)
    assert set(plan) == {"splits", "k_chunk"}
    assert json.loads(p.read_text())   # rewritten valid


def test_seed_cache_overlay(tmp_path):
    seed = tmp_path / "seed.json"
    key = autotune.matmul_key(1, 6912, 256, N_SM)
    seed.write_text(json.dumps(
        {key: {"plan": {"cluster": 4, "k_chunk": 1728},
               "v": autotune.SCHEMA_VERSION}}))
    c = autotune.AutotuneCache(path=tmp_path / "user.json", seed_path=seed)
    assert autotune.matmul_plan(1, 6912, 256, N_SM, cache=c) == \
        {"cluster": 4, "k_chunk": 1728}
    assert not (tmp_path / "user.json").is_file()   # hit: nothing written


def test_stale_schema_entries_ignored(tmp_path):
    """An overlay written under an older schema can't shadow a refresh:
    its entries are dropped at load and re-tuned under the new stamp."""
    p = tmp_path / "stale.json"
    key = autotune.matmul_key(64, 6912, 256, N_SM)
    p.write_text(json.dumps(
        {key: {"plan": {"splits": 7, "k_chunk": 100},
               "v": autotune.SCHEMA_VERSION - 1}}))
    c = autotune.AutotuneCache(path=p, seed_path=None)
    assert c.lookup(key) is None
    fresh = autotune.matmul_plan(64, 6912, 256, N_SM, cache=c)
    assert fresh != {"splits": 7, "k_chunk": 100}
    assert json.loads(p.read_text())[key]["v"] == autotune.SCHEMA_VERSION


@pytest.mark.parametrize("L", [1, 50, 127, 128, 129, 448, 1024, 2047, 2048])
def test_decode_plans(cache, L):
    cands = autotune.decode_candidates(L)
    assert [c["n_split"] for c in cands] == list(range(1, -(-L // 128) + 1))
    for c in cands:
        assert da.check_plan(L, c) == c["n_split"]
    for B, KV, G, D in [(8, 8, 4, 128), (8, 20, 1, 64), (1, 8, 2, 256)]:
        assert {"n_split": da.split_l(B, KV, L, N_SM)} in cands
        for dtype in ("bfloat16", "float32"):
            plan = autotune.decode_plan(B, KV, G, D, D, L, dtype, N_SM,
                                        cache=cache)
            assert plan in cands
    # the key holds what fixes a plan: B x KV, G, D, Dv, L, dtype, SMs
    assert autotune.decode_key(8, 8, 4, 128, 128, L, "bfloat16", N_SM) != \
        autotune.decode_key(8, 8, 4, 128, 128, L, "float32", N_SM)


def test_analytic_pick_leaves_the_formula_only_beyond_the_resolution(cache):
    for M, K, N in autotune.MATMUL_BATTERY:
        plan = autotune.matmul_plan(M, K, N, N_SM, cache=cache)
        formula = autotune.matmul_formula(M, K, N, N_SM)
        if plan != formula:
            assert autotune.matmul_cost_us(M, K, N, N_SM, plan) * (
                1 + autotune._RESOLUTION) < autotune.matmul_cost_us(
                    M, K, N, N_SM, formula)


def test_committed_seed_matches_battery():
    """``python -m repro_torch.kernels.autotune --check`` as a test."""
    committed = json.loads(autotune.SEED_PATH.read_text())
    swept = autotune.hot_path_battery()
    assert {k: v["plan"] for k, v in committed.items()} == \
        {k: v["plan"] for k, v in swept.items()}
    assert all(k.endswith(f"/sm{N_SM}") and v["mode"] == "analytic"
               for k, v in committed.items())
    assert autotune.main(["--check"]) == 0


def test_plain_path_ignores_the_cache_on_the_cpu(monkeypatch):
    def poisoned(*args, **kwargs):
        raise AssertionError("the CPU path read the autotune cache")
    monkeypatch.setattr(autotune, "get_cache", poisoned)
    monkeypatch.setattr(autotune, "matmul_plan", poisoned)
    monkeypatch.setattr(autotune, "decode_plan", poisoned)
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn((13, 200), generator=g), torch.randn((200, 37),
                                                              generator=g)
    torch.testing.assert_close(mm.matmul(a, b, epilogue="tanh"),
                               mm.matmul_plain(a, b, epilogue="tanh"))
    q = torch.randn((2, 1, 8, 16), generator=g)
    k = torch.randn((2, 300, 2, 16), generator=g)
    lens = torch.tensor([300, 17])
    torch.testing.assert_close(
        da.decode_attention(q, k, k, kv_len=lens, plan={"n_split": 3}),
        da.decode_attention_plain(q, k, k, kv_len=lens))


def test_measured_mode_raises_without_a_card(cache, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        autotune.matmul_plan(8, 256, 128, N_SM, cache=cache, mode="measured")
    with pytest.raises(RuntimeError, match="CUDA card"):
        autotune.decode_plan(8, 8, 4, 128, 128, 2048, "bfloat16", N_SM,
                             cache=cache, mode="measured")
    assert not cache.path.is_file()                 # nothing stored
    with pytest.raises(ValueError):
        autotune.matmul_plan(8, 256, 128, N_SM, cache=cache, mode="timed")
