"""The port's llama3-8b model (repro_torch.models) against the JAX package.

The reference's ``Model.init`` tree is carried across with
``params_from_jax`` (as numpy arrays), so both packages run the same
weights; the smoke config runs in float32 on the CPU, where the attention
ops take their plain versions. The reference runs its default XLA path.
Tolerance: 1e-4 relative to the largest value compared (summation order
differs between XLA and PyTorch matmuls).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models.model import build_model as jax_build_model

from repro_torch import configs
from repro_torch.models import layers
from repro_torch.models.model import Model, params_from_jax

RTOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params, cfg) on the CPU."""
    cfg = jax_get_config("llama3-8b", smoke=True).replace(dtype="float32")
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    pcfg = configs.get_config("llama3-8b", smoke=True).replace(dtype="float32")
    pm = Model(pcfg, device="cpu")
    pp = params_from_jax(pcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, pm, pp, pcfg


def _rel_close(got: torch.Tensor, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n) for n in lens]


# ---- configs ------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-3b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_config_copy_equals_reference(smoke, arch):
    ref = jax_get_config(arch, smoke=smoke)
    port = configs.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_counts() == ref.param_counts()
    assert port.n_repeats == ref.n_repeats


def test_unported_archs_raise_not_ported_yet():
    assert configs.list_configs() == ["llama3-8b", "jamba-v0.1-52b",
                                      "rwkv6-3b"]
    for name in set(configs.ARCHS) - set(configs.list_configs()):
        with pytest.raises(KeyError, match="not ported yet"):
            configs.get_config(name)
    with pytest.raises(KeyError, match="unknown"):
        configs.get_config("no-such-model")


def test_unported_families_raise():
    cfg = configs.get_config("llama3-8b", smoke=True)
    with pytest.raises(NotImplementedError):
        Model(cfg.replace(block_pattern=(configs.LayerSpec(window=8),)),
              device="cpu")
    moe = configs.MoEConfig(n_experts=4, top_k=2, d_expert=32)
    for variant in ({"qkv_bias": True}, {"qk_norm": True},
                    {"norm": "layernorm"}, {"act": "gelu"},
                    {"tie_embeddings": True}, {"embed_scale": True},
                    {"mla": configs.MLAConfig(8, 8, 8, 8, 8)},
                    {"block_pattern": (configs.LayerSpec(moe=True),),
                     "moe": dataclasses.replace(moe, n_shared=1)},
                    {"block_pattern": (configs.LayerSpec(kind="mamba"),),
                     "mlp_kind": "plain"}):
        with pytest.raises(NotImplementedError):
            Model(cfg.replace(**variant), device="cpu")


def test_mamba_and_moe_blocks_run_in_a_llama_config():
    """What the jamba slice made run: Mamba mixers and MoE MLPs beside
    attention, under llama's RMSNorm and SiLU GLU; an MoE block without
    an MoE config is refused."""
    cfg = configs.get_config("llama3-8b", smoke=True).replace(
        dtype="float32", n_layers=4,
        block_pattern=(configs.LayerSpec(kind="mamba", moe=True),
                       configs.LayerSpec()),
        moe=configs.MoEConfig(n_experts=4, top_k=2, d_expert=32),
        ssm_state=4)
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    tokens = torch.from_numpy(np.arange(6, dtype=np.int64)[None] % 256)
    logits, cache = model.prefill(params, {"tokens": tokens}, cache_len=8)
    assert logits.shape == (1, cfg.vocab_size)
    assert set(cache["blocks"]) == {"conv", "h", "k", "v"}
    assert cache["blocks"]["h"].shape[0] == 2         # the 2 Mamba layers
    logits, _ = model.decode_step(params, cache, tokens[:, :1])
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError):
        Model(cfg.replace(moe=None), device="cpu")


# ---- parameters ---------------------------------------------------------

def test_params_from_jax_carries_every_leaf(pair):
    jm, jp, pm, pp, cfg = pair
    assert len(pp["blocks"]) == cfg.n_layers
    n = sum(t.numel() for t in layers.tree_leaves(pp))
    assert n == jm.n_params() == pm.n_params()
    for r in range(cfg.n_repeats):
        np.testing.assert_array_equal(
            pp["blocks"][r]["mix"]["wq"].numpy(),
            np.asarray(jp["blocks"]["l0"]["mix"]["wq"][r]))


def test_init_draws_on_the_device_with_reference_scales_and_dtypes():
    cfg = configs.get_config("llama3-8b", smoke=True)          # bfloat16
    model = Model(cfg, device="cpu")
    p = model.init(seed=3)
    assert p["embed"]["tok"].dtype == torch.bfloat16
    # the reference casts the stacked block leaves, norm scales included
    assert p["blocks"][0]["ln1"]["w"].dtype == torch.bfloat16
    assert torch.equal(p["ln_f"]["w"], torch.ones(cfg.d_model))
    tok = p["embed"]["tok"].float()
    wq = p["blocks"][1]["mix"]["wq"].float()
    assert abs(tok.std().item() - 1.0) < 0.05                   # scale 1.0
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    again = model.init(seed=3)
    assert torch.equal(again["blocks"][1]["mlp"]["wo"],
                       p["blocks"][1]["mlp"]["wo"])
    assert not torch.equal(model.init(seed=4)["embed"]["tok"], p["embed"]["tok"])


def test_cuda_model_without_a_card_raises_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("this container check needs a machine without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(configs.get_config("llama3-8b", smoke=True))


# ---- layers -------------------------------------------------------------

def test_rmsnorm_and_rope_equal_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 2000, (2, 5))
    _rel_close(layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)),
               jax_layers.rmsnorm(jnp.asarray(x), jnp.asarray(w)), 1e-6)
    _rel_close(layers.rope(torch.from_numpy(x), torch.from_numpy(pos),
                           500_000.0),
               jax_layers.rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0),
               1e-5)


# ---- model passes -------------------------------------------------------

@pytest.mark.parametrize("S,cache_len", [(10, 24), (24, 24), (7, 48)])
def test_prefill_logits_and_cache(pair, S, cache_len):
    jm, jp, pm, pp, cfg = pair
    (prompt,) = _prompts(cfg, [S], seed=S)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt[None])},
                        cache_len=cache_len)
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(prompt[None])},
                        cache_len=cache_len)
    _rel_close(pl, jl)
    for name in ("k", "v"):
        _rel_close(pc["blocks"][name], jc["blocks"]["l0"][name])
    assert pc["cur_len"] == int(jc["cur_len"]) == S


def test_decode_step_lockstep(pair):
    jm, jp, pm, pp, cfg = pair
    prompts = _prompts(cfg, [9, 9], seed=11)
    toks = np.stack(prompts)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=20)
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks)}, cache_len=20)
    for step in range(3):
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt))
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(nxt))
        _rel_close(pl, jl)
    _rel_close(pc["blocks"]["k"], jc["blocks"]["l0"]["k"])
    assert pc["cur_len"] == int(jc["cur_len"]) == 12


def test_decode_step_ragged_mixed_lengths_and_insert_prefill(pair):
    jm, jp, pm, pp, cfg = pair
    L, lens = 32, [5, 17, 1, 11]
    prompts = _prompts(cfg, lens, seed=13)
    jblocks = jm.init_cache(len(lens), L)["blocks"]
    pblocks = pm.init_cache(len(lens), L)["blocks"]
    last = []
    for slot, p in enumerate(prompts):
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(p[None])}, cache_len=L)
        pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(p[None])},
                            cache_len=L)
        jblocks = jm.insert_prefill(jblocks, jc["blocks"],
                                    jnp.asarray(slot, jnp.int32))
        assert pm.insert_prefill(pblocks, pc["blocks"], slot) is pblocks
        last.append(int(jnp.argmax(jl[0])))
    for name in ("k", "v"):
        _rel_close(pblocks[name], jblocks["l0"][name])
    kv_len = np.asarray(lens, np.int32)
    tokens = np.asarray(last, np.int32)[:, None]
    for _ in range(2):
        jl, jblocks = jm.decode_step_ragged(jp, jblocks, jnp.asarray(tokens),
                                            jnp.asarray(kv_len))
        pl, pblocks = pm.decode_step_ragged(pp, pblocks,
                                            torch.from_numpy(tokens),
                                            torch.from_numpy(kv_len))
        _rel_close(pl, jl)
        tokens = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        kv_len = kv_len + 1
    for name in ("k", "v"):
        _rel_close(pblocks[name], jblocks["l0"][name])
