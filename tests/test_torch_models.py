"""The port's dense-attention models (repro_torch.models) against the JAX
package: llama3-8b, and qwen2.5-14b (q/k/v bias), chameleon-34b (q/k
norm) and granite-moe-3b (MoE, tied embeddings), the ``test_zoo_*`` cases.

The reference's ``Model.init`` tree is carried across with
``params_from_jax`` (as numpy arrays), so both packages run the same
weights; for the zoo archs every zeros- or ones-initialised leaf (the
biases, the norm scales) is first moved by N(0, 0.2) from a numpy seed,
so that the bias and the norm scales are exercised. The smoke configs run
in float32 on the CPU, where the attention ops take their plain versions.
The reference runs its default XLA path. Tolerance: 1e-4 relative to the
largest value compared (summation order differs between XLA and PyTorch
matmuls).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.models.model import build_model as jax_build_model

from repro_torch import configs
from repro_torch.models import layers, moe
from repro_torch.models.model import Model, params_from_jax

RTOL = 1e-4


# the archs this file holds beside llama3-8b, each with the feature it adds
ZOO = ["qwen2.5-14b", "chameleon-34b", "granite-moe-3b-a800m"]


def _moved_constants(tree, seed: int, scale: float = 0.2):
    """A reference tree as float32 numpy with every constant leaf (biases,
    norm scales) plus N(0, scale) from ``seed``."""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a, np.float32)
        return (a + scale * rng.standard_normal(a.shape) if np.ptp(a) == 0
                else a).astype(np.float32)

    return jax.tree.map(leaf, tree)


def _pair(arch: str, moved: bool):
    cfg = jax_get_config(arch, smoke=True).replace(dtype="float32")
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jp = (_moved_constants(jp, seed=2) if moved
          else jax.tree.map(np.asarray, jp))
    pcfg = configs.get_config(arch, smoke=True).replace(dtype="float32")
    pm = Model(pcfg, device="cpu")
    pp = params_from_jax(pcfg, jp, device="cpu")
    return jm, jax.tree.map(jnp.asarray, jp), pm, pp, pcfg


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params, cfg) on the CPU."""
    return _pair("llama3-8b", moved=False)


@pytest.fixture(scope="module", params=ZOO)
def zoo(request):
    """As :func:`pair`, for each arch of :data:`ZOO`."""
    return _pair(request.param, moved=True)


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

@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-3b", "jamba-v0.1-52b",
                                  *ZOO])
@pytest.mark.parametrize("smoke", [False, True])
def test_config_copy_equals_reference(smoke, arch):
    ref = jax_get_config(arch, smoke=smoke)
    port = configs.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_counts() == ref.param_counts()
    assert port.n_repeats == ref.n_repeats


def test_unported_archs_raise_not_ported_yet():
    assert configs.list_configs() == [
        "llama3-8b", "qwen2.5-14b", "chameleon-34b", "jamba-v0.1-52b",
        "rwkv6-3b", "granite-moe-3b-a800m"]
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
    for variant in ({"pos": "sincos"}, {"frontend": "audio", "encdec": True},
                    {"norm": "layernorm"}, {"act": "gelu"},
                    {"mlp_kind": "plain"}, {"embed_scale": True},
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


def test_zoo_params_from_jax_carries_every_leaf(zoo):
    """The feature leaves cross: q/k/v bias (qwen2.5), q/k norm scales
    (chameleon), no ``head`` with tied embeddings (granite)."""
    jm, jp, pm, pp, cfg = zoo
    assert len(pp["blocks"]) == cfg.n_layers
    n = sum(t.numel() for t in layers.tree_leaves(pp))
    assert n == jm.n_params() == pm.n_params()
    mix = set(pp["blocks"][0]["mix"])
    assert mix == set(jp["blocks"]["l0"]["mix"])
    assert {"bq", "bk", "bv"} <= mix if cfg.qkv_bias else not mix & {"bq"}
    assert {"qn", "kn"} <= mix if cfg.qk_norm else "qn" not in mix
    assert ("head" in pp["embed"]) == (not cfg.tie_embeddings) \
        == ("head" in jp["embed"])
    for r in range(cfg.n_repeats):
        for name in sorted(mix - {"qn", "kn"}):
            np.testing.assert_array_equal(
                pp["blocks"][r]["mix"][name].numpy(),
                np.asarray(jp["blocks"]["l0"]["mix"][name][r]))


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_full_config_counts_the_reference_parameters(arch):
    """At full width, nothing drawn: the port's parameters are the
    reference config's ``param_counts()`` total plus the norm scales it
    leaves out, held in bf16 but for the float32 final norm. (The
    reference model's own ``n_params()`` wraps at 2^32 at these sizes.)"""
    cfg = configs.get_config(arch)
    assert cfg.param_counts() == jax_get_config(arch).param_counts()
    model = Model(cfg, device="cpu")
    n = model.n_params()
    norms = cfg.d_model * (2 * cfg.n_layers + 1) \
        + (2 * cfg.head_dim * cfg.n_layers if cfg.qk_norm else 0)
    assert n - norms == cfg.param_counts()["total"]
    assert model.weight_bytes() == 2 * n + 2 * cfg.d_model


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

PREFILL_CASES = [(10, 24), (24, 24), (7, 48)]


@pytest.mark.parametrize("S,cache_len", PREFILL_CASES)
def test_prefill_logits_and_cache(pair, S, cache_len):
    _check_prefill(pair, S, cache_len)


@pytest.mark.parametrize("S,cache_len", PREFILL_CASES)
def test_zoo_prefill_logits_and_cache(zoo, S, cache_len):
    _check_prefill(zoo, S, cache_len)


def test_decode_step_lockstep(pair):
    _check_decode_lockstep(pair)


def test_zoo_decode_step_lockstep(zoo):
    _check_decode_lockstep(zoo)


def test_decode_step_ragged_mixed_lengths_and_insert_prefill(pair):
    _check_decode_ragged_and_insert(pair)


def test_zoo_decode_step_ragged_mixed_lengths_and_insert_prefill(zoo):
    _check_decode_ragged_and_insert(zoo)


def _check_prefill(pair, S, cache_len):
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


def _check_decode_lockstep(pair):
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


def _check_decode_ragged_and_insert(pair):
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


# ---- granite's MoE: 40 experts top-8 -------------------------------------

@pytest.mark.parametrize("E,K,S", [(40, 8, 1), (40, 8, 33), (8, 4, 7)])
def test_zoo_moe_at_granite_expert_counts_equals_reference(E, K, S):
    """The MoE MLP with granite's 40 experts top-8 (and its smoke config's
    8 top-4) at the smoke width, float32 numpy weights at the reference's
    init scales: the routes and the outputs agree; at S = 33 some experts
    overflow their capacity of 8 and drop tokens in both packages."""
    cfg = configs.get_config("granite-moe-3b-a800m", smoke=True).replace(
        dtype="float32",
        moe=configs.MoEConfig(n_experts=E, top_k=K, d_expert=32))
    rng = np.random.default_rng(E + S)
    d, f = cfg.d_model, cfg.moe.d_expert
    p = {"router": rng.normal(size=(d, E)) * d**-0.5,
         "wg": rng.normal(size=(E, d, f)) * d**-0.5,
         "wi": rng.normal(size=(E, d, f)) * d**-0.5,
         "wo": rng.normal(size=(E, f, d)) * f**-0.5}
    p = {n: a.astype(np.float32) for n, a in p.items()}
    x = rng.normal(size=(2, S, d)).astype(np.float32)
    jy, jaux = jax_moe.moe_apply(cfg, {n: jnp.asarray(a) for n, a in p.items()},
                                 jnp.asarray(x))
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    ty, taux = moe.moe_apply(cfg, tp, torch.from_numpy(x))
    _, _, idx = moe.route(cfg, tp, torch.from_numpy(x))
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ p["router"]), K)
    assert idx.tolist() == np.asarray(jidx).tolist()
    _rel_close(ty, jy)
    _rel_close(taux, jaux)
    if S == 33:
        counts = np.bincount(idx.reshape(2, -1)[0].numpy(), minlength=E)
        assert counts.max() > moe._capacity(cfg, S) == 8
