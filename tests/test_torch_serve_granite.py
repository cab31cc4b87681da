"""The serving-engine cases of ``test_torch_serve.py`` on the granite-moe-3b-a800m
smoke config (MoE MLPs of 8 experts top-4 and tied embeddings): the port's engine against the JAX
engine, float32 on the CPU, with the same noisy weights on every leaf.
Greedy streams must be equal for both schedulers x ``fast_path``, with
the ledger equal to the counters. The cases are the llama file's own
functions, collected here under this module's ``arch`` fixture, so
that another pytest-xdist worker carries them.
"""
import pytest

from test_torch_serve import (  # noqa: F401  (collected here for granite-moe-3b-a800m)
    models,
    test_cache_len_768_matches_the_jax_engine,
    test_decode_d2h_roundtrips_collapse_with_batching,
    test_degrade_ladder_and_max_queue_match_the_jax_engine,
    test_greedy_streams_equal_the_jax_engine,
    test_max_tokens_one_emits_exactly_one_token,
    test_mid_flight_admit_joins_without_perturbing_residents,
    test_respects_cache_capacity,
    test_transfer_ledger_accounts_every_d2h_byte,
    test_ttft_samples_cover_all_requests_and_latency_report,
)


@pytest.fixture(scope="module")
def arch():
    return "granite-moe-3b-a800m"
