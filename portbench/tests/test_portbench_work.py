"""The frozen counts reproduce the bound times of the port's chip runs
(PERF.md, the kernel table), and the window arithmetic of the serving
driver."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "portbench")]

from benchkit import configs, harness, peaks, work  # noqa: E402
from benchkit.stats import percentile  # noqa: E402


def test_flash_backward_bound_64_8_heads():
    # chameleon-34b's training shape, q (4, 1024, 64, 128), kv 8 heads
    ms = 1e3 * work.bound_s(*work.flash_bwd(1024, 64, 8, 128, B=4))
    assert ms == pytest.approx(0.173879, abs=5e-7)


def test_decode_attention_bound_g8():
    # q (8, 1, 64, 128) over a (8, 2048, 8, 128) cache at these lengths
    entries = [0, 1, 2048, 552, 630, 83, 154, 33]
    ms = 1e3 * work.bound_s(*work.decode_attention(entries, 64, 8, 128))
    assert ms == pytest.approx(0.004359, abs=5e-7)


def test_mamba_prefill_bound():
    nbytes, flops, exps = work.mamba_prefill(1024, 8192, 16)
    ms = 1e3 * work.bound_s(nbytes, flops, peaks.FP32_FLOP_S, exps)
    assert ms == pytest.approx(0.032096, abs=5e-7)


def test_flash_forward_bound_64_heads():
    ms = 1e3 * work.bound_s(*work.flash_fwd(1024, 64, 8, 128))
    assert ms == pytest.approx(0.017388, abs=5e-7)


def test_model_flops_dense():
    cfg = configs.load_config("chameleon-34b.pp12")
    d, f, V = 8192, 22016, 65536
    per_layer = d * 64 * 128 * 2 + 2 * d * 8 * 128 + 3 * d * f
    S = 4096
    want = 3 * (2 * S * (4 * per_layer + d * V)
                + 4 * 4 * 64 * 128 * S * (S + 1) // 2)
    assert work.train_step_flops(cfg, 1, S) == want


def test_layer_kinds_jamba():
    kinds = work.layer_kinds(configs.load_config("jamba-v0.1-52b"))
    assert len(kinds) == 16
    assert [k for k, _ in kinds].count("attn") == 2
    assert [i for i, (_, m) in enumerate(kinds) if m] == list(range(1, 16, 2))


def test_percentile_is_linear_between_ranks():
    assert percentile([1, 2, 3, 4, 5], 50) == 3
    assert percentile(range(101), 95) == 95
    assert percentile([0.0, 10.0], 95) == pytest.approx(9.5)


def serve_window():
    return harness.driver("serve_closed").window_metrics


def steady(stall: float):
    """Four requests, a token each every 0.1 s (20 each, the first at
    0.01 r), each due 0.05 s before its first; after 0.45 s the engine
    stalls ``stall`` s (a long prefill), which shifts every later token."""
    times, due = {}, {}
    for r in range(4):
        ts = [0.1 * i + 0.01 * r for i in range(20)]
        times[r] = [t + stall if t > 0.45 else t for t in ts]
        due[r] = ts[0] - 0.05
    return times, due


def test_window_metrics_steady():
    times, due = steady(0.0)
    m, n = serve_window()(times, due, 0.0, 2.0)
    assert n["tokens"] == 80 and n["ttft_n"] == 4 and n["itl_n"] == 76
    assert m["output_tokens_per_s"] == pytest.approx(40.0)
    assert m["ttft_p95_ms"] == pytest.approx(50.0)
    assert m["itl_p95_ms"] == pytest.approx(100.0)


def test_a_stall_lowers_the_rate_and_raises_the_tail():
    base, _ = serve_window()(*steady(0.0), 0.0, 2.0)
    stalled, _ = serve_window()(*steady(0.5), 0.0, 2.0)
    assert stalled["output_tokens_per_s"] < base["output_tokens_per_s"]
    assert stalled["itl_p95_ms"] > base["itl_p95_ms"] + 10


def test_tokens_outside_the_window_do_not_count():
    times, due = steady(0.0)
    m, n = serve_window()(times, due, 0.5, 1.5)
    assert n["tokens"] == 11 + 10 + 10 + 10   # 0.5 <= t <= 1.5
    assert n["ttft_n"] == 0                   # every first token before


def test_every_seed_asks_for_the_same_lengths_in_another_order():
    from benchkit import traffic
    tr = configs.load_traffic("chat")

    def lengths(seed):
        return [[(len(p), n) for p, n in c]
                for c in traffic.serve_requests(tr, 1000, seed)]
    a, b = lengths(2_200_000_011), lengths(4_000_000_123)
    assert a == lengths(2_200_000_011)
    assert a != b and sorted(a) == sorted(b)
    ids = traffic.serve_requests(tr, 1000, 2_200_000_011)[0][0][0]
    assert ids.dtype.name == "int32" and ids.max() < 1000
