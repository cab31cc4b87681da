"""The serving-engine cases of ``test_torch_serve.py`` on the gemma3-12b
smoke config (five sliding-window layers of window 8 with rolling decode
caches to one global layer, q/k norm, GELU, scaled tied embeddings): the
port's engine against the JAX engine, float32 on the CPU, with the same
noisy weights on every leaf. Greedy streams must be equal for both
schedulers x ``fast_path``, with the ledger equal to the counters; the
prompts of 3 to 30 tokens fall on both sides of the window, and the
decode runs past it, so the rolling caches wrap.

The reference's ``_roll_window`` raises for a prompt shorter than the
window (``test_torch_attention.py`` pins that), so the JAX engine runs here
with it as its docstring states it
(``test_torch_models.roll_window_as_documented``). The cases are the llama
file's own functions, collected here under this module's ``arch`` fixture,
so that another pytest-xdist worker carries them.
"""
import pytest

from test_torch_models import roll_window_as_documented
from test_torch_serve import (  # noqa: F401  (collected here for gemma3-12b)
    build_models,
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
from repro.models import attention as jax_attn


@pytest.fixture(scope="module")
def arch():
    return "gemma3-12b"


@pytest.fixture(scope="module")
def models(arch):
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_attn, "_roll_window", roll_window_as_documented)
    yield build_models(arch)
    patch.undo()
