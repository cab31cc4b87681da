"""The serving-engine cases of ``test_torch_serve.py`` on the
jamba-v0.1-52b smoke config (Mamba and attention mixers, dense and MoE
MLPs): the port's engine against the JAX engine, float32 on the CPU.
Greedy streams must be equal for both schedulers x ``fast_path``, with
the ledger equal to the counters. The cases are the llama file's own
functions, collected here under this module's ``arch`` fixture, so that
another pytest-xdist worker carries them.

The weights are the reference's ``Model.init`` tree with every zeros- or
ones-initialised leaf (norm scales, conv bias, dt_bias, A_log, D) moved
by N(0, 0.2) from a numpy seed and the drawn leaves at their init scale:
noise on every matrix, as the llama and RWKV files add it, makes the
random Mamba mixers amplify the packages' float32 rounding differences
past the point where greedy argmaxes can be held equal
(``test_torch_mamba.py`` says by how much).
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model

from repro_torch import configs
from repro_torch.models.model import Model, params_from_jax

from test_torch_mamba import _noisy
from test_torch_serve import (  # noqa: F401  (collected here for jamba)
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
    return "jamba-v0.1-52b"


@pytest.fixture(scope="module")
def models(arch):
    cfg = jax_get_config(arch, smoke=True).replace(dtype="float32")
    jm = jax_build_model(cfg)
    jp = _noisy(jm.init(jax.random.PRNGKey(0)), seed=0)
    pcfg = configs.get_config(arch, smoke=True).replace(dtype="float32")
    pm = Model(pcfg, device="cpu")
    pp = params_from_jax(pcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, pm, pp, pcfg
