"""The port's RWKV6 model (repro_torch.models.ssm and the rwkv6-3b path
through transformer/model) against the JAX package, and the compute-dtype
cast of carried weights.

Weights: the reference's ``Model.init`` tree with every leaf moved off its
initial value by numpy noise from a seed, the zeros/ones-initialised
token-shift mixes ``mu``, bonus ``u``, decay bias ``w0`` and groupnorm
scales included (left at zero, the token shift and the bonus go
untested), carried across with ``params_from_jax``. The smoke config
runs in float32 on the CPU, where the scan ops take their plain versions;
the reference runs its default XLA path. Tolerance: 1e-4 relative to the
largest value compared, as the llama tests (summation order differs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models import ssm as jax_ssm
from repro.models.model import build_model as jax_build_model

from repro_torch import configs
from repro_torch.models import layers, ssm
from repro_torch.models import transformer as tf
from repro_torch.models.model import Model, params_from_jax

RTOL = 1e-4


def _noisy(tree, seed: int, scale: float = 0.2):
    """Every leaf of a reference tree, as float32 numpy, plus N(0, scale)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + scale * rng.standard_normal(a.shape)).astype(np.float32),
        tree)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params, cfg) on the CPU."""
    cfg = jax_get_config("rwkv6-3b", smoke=True).replace(dtype="float32")
    jm = jax_build_model(cfg)
    jp = _noisy(jm.init(jax.random.PRNGKey(0)), seed=1)
    pcfg = configs.get_config("rwkv6-3b", smoke=True).replace(dtype="float32")
    pm = Model(pcfg, device="cpu")
    pp = params_from_jax(pcfg, jp, device="cpu")
    return jm, jp, pm, pp, pcfg


def _rel_close(got: torch.Tensor, want, rtol=RTOL):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n) for n in lens]


# ---- the compute-dtype cast of carried weights ---------------------------

@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-3b", "jamba-v0.1-52b"])
def test_bf16_params_equal_the_reference_cast_of_the_stacked_tree(arch):
    """Every leaf of ``params_from_jax`` in bf16 has the dtype and value
    that the reference's ``cast_params`` gives it in the stacked tree it
    computes with: every float32 block leaf (norm scales, ``u``, ``w0``
    included) in bf16, the final norm in float32. Values are N(0, 1)
    draws, none of them representable in bf16."""
    jcfg = jax_get_config(arch, smoke=True)
    assert jcfg.dtype == "bfloat16"
    jm = jax_build_model(jcfg)
    rng = np.random.default_rng(3)
    tree = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jm.init(jax.random.PRNGKey(0)))
    want = jax_layers.cast_params(jax.tree.map(jnp.asarray, tree),
                                  jnp.bfloat16)
    pcfg = configs.get_config(arch, smoke=True)
    got = params_from_jax(pcfg, tree, device="cpu")
    n_pat = len(pcfg.block_pattern)

    def same(g: torch.Tensor, w):
        assert str(g.dtype).split(".")[1] == str(w.dtype), (g.dtype, w.dtype)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w.astype(jnp.float32)))

    for part in ("embed", "ln_f"):
        jax.tree.map(same, got[part], want[part])
    for i, block in enumerate(got["blocks"]):
        r, j = divmod(i, n_pat)
        jax.tree.map(lambda g, w, r=r: same(g, w[r]), block,
                     want["blocks"][f"l{j}"])
    assert got["blocks"][0]["ln1"]["w"].dtype == torch.bfloat16
    assert got["ln_f"]["w"].dtype == torch.float32
    # Model.init holds every leaf in the same dtype
    drawn = Model(pcfg, device="cpu").init(seed=0)
    assert [t.dtype for t in layers.tree_leaves(drawn)] == \
        [t.dtype for t in layers.tree_leaves(got)]
    if arch == "rwkv6-3b":
        mix = got["blocks"][0]["mix"]
        assert {mix[n].dtype for n in ("u", "w0", "gn_w", "gn_b")} == \
            {torch.bfloat16}
    if arch == "jamba-v0.1-52b":       # pinned float32 in the metadata
        mix = got["blocks"][0]["mix"]
        assert {mix[n].dtype for n in ("dt_bias", "A_log", "D")} == \
            {torch.bfloat16}
        assert got["blocks"][1]["mlp"]["wg"].ndim == 3     # (E, d, f)


# ---- configs and parameters ----------------------------------------------

def test_full_config_counts_the_reference_parameters():
    cfg = configs.get_config("rwkv6-3b")
    n = Model(cfg, device="cpu").n_params()
    assert n == jax_build_model(jax_get_config("rwkv6-3b")).n_params() \
        == 3_073_561_600


def test_params_from_jax_carries_every_leaf(pair):
    jm, jp, pm, pp, cfg = pair
    assert len(pp["blocks"]) == cfg.n_layers
    assert sum(t.numel() for t in layers.tree_leaves(pp)) == jm.n_params() \
        == pm.n_params()
    for r in range(cfg.n_repeats):
        np.testing.assert_array_equal(pp["blocks"][r]["mix"]["u"].numpy(),
                                      jp["blocks"]["l0"]["mix"]["u"][r])


# ---- layers ---------------------------------------------------------------

def test_layernorm_and_groupnorm_equal_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32) * 3 + 1
    w, b = (rng.normal(size=(16,)).astype(np.float32) for _ in range(2))
    t = [torch.from_numpy(a) for a in (x, w, b)]
    j = [jnp.asarray(a) for a in (x, w, b)]
    _rel_close(layers.layernorm(*t), jax_layers.layernorm(*j), 1e-5)
    _rel_close(layers.groupnorm_heads(*t), jax_layers.groupnorm_heads(*j),
               1e-5)
    cfg = configs.get_config("rwkv6-3b", smoke=True)
    assert set(layers.norm_meta(cfg)) == {"w", "b"}
    p = {"w": t[1], "b": t[2]}
    _rel_close(layers.apply_norm(cfg, p, t[0]),
               jax_layers.apply_norm(cfg, {"w": j[1], "b": j[2]}, j[0]), 1e-5)


def _layer(pair):
    """Layer 1's time-mix and channel-mix parameters, both packages."""
    jm, jp, pm, pp, cfg = pair
    jl = jax.tree.map(lambda a: jnp.asarray(a[1]), jp["blocks"]["l0"])
    return jl, pp["blocks"][1], cfg


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_equals_reference(pair, with_state):
    jl, pl, cfg = _layer(pair)
    B, S = 2, 11
    x = _x(cfg, B, S, seed=5)
    H, K = ssm._rwkv_dims(cfg)
    rng = np.random.default_rng(6)
    h0 = rng.normal(size=(B, H, K, K)).astype(np.float32) * 0.1
    xp = rng.normal(size=(B, cfg.d_model)).astype(np.float32)
    kw_j = (dict(h0=jnp.asarray(h0), x_prev=jnp.asarray(xp))
            if with_state else {})
    kw_t = (dict(h0=torch.from_numpy(h0), x_prev=torch.from_numpy(xp))
            if with_state else {})
    jy, jc = jax_ssm.rwkv_apply(cfg, jl["mix"], jnp.asarray(x),
                                return_cache=True, **kw_j)
    ty, tc = ssm.rwkv_apply(cfg, pl["mix"], torch.from_numpy(x),
                            return_cache=True, **kw_t)
    _rel_close(ty, jy)
    for name in ("x_tm", "h"):
        _rel_close(tc[name], jc[name])
    # one more token through the decode path, cache updated in place
    x1 = _x(cfg, B, 1, seed=7)
    jy1, jc1 = jax_ssm.rwkv_decode(cfg, jl["mix"], jnp.asarray(x1), jc)
    cache = {n: t.clone() for n, t in tc.items()}
    ty1, tc1 = ssm.rwkv_decode(cfg, pl["mix"], torch.from_numpy(x1), cache)
    assert tc1 is cache
    _rel_close(ty1, jy1)
    for name in ("x_tm", "h"):
        _rel_close(cache[name], jc1[name])


def test_channel_mix_equals_reference(pair):
    jl, pl, cfg = _layer(pair)
    x = _x(cfg, 2, 9, seed=8)
    xp = _x(cfg, 2, 1, seed=9)[:, 0]
    _rel_close(ssm.rwkv_cm_apply(cfg, pl["mlp"], torch.from_numpy(x)),
               jax_ssm.rwkv_cm_apply(cfg, jl["mlp"], jnp.asarray(x)))
    _rel_close(ssm.rwkv_cm_apply(cfg, pl["mlp"], torch.from_numpy(x),
                                 torch.from_numpy(xp)),
               jax_ssm.rwkv_cm_apply(cfg, jl["mlp"], jnp.asarray(x),
                                     jnp.asarray(xp)))
    _rel_close(ssm.rwkv_cm_decode(cfg, pl["mlp"], torch.from_numpy(x[:, :1]),
                                  torch.from_numpy(xp)),
               jax_ssm.rwkv_cm_decode(cfg, jl["mlp"], jnp.asarray(x[:, :1]),
                                      jnp.asarray(xp)))


def test_mamba_and_rwkv_layers_cannot_share_the_h_leaf():
    """Both kinds name their state ``h``, of other shapes: a pattern with
    both is refused before any cache is built, so no layer can reuse the
    other kind's leaf."""
    cfg = configs.get_config("rwkv6-3b", smoke=True).replace(
        block_pattern=(configs.LayerSpec(kind="rwkv"),
                       configs.LayerSpec(kind="mamba")))
    with pytest.raises(ValueError, match="'h'"):
        tf.cache_leaf_kinds(cfg)
    with pytest.raises(ValueError, match="'h'"):
        tf.init_cache_blocks(cfg, 1, 8, torch.float32, "cpu")
    assert tf.cache_leaf_kinds(configs.get_config("rwkv6-3b"))["h"] == "rwkv"
    assert tf.cache_leaf_kinds(configs.get_config("jamba-v0.1-52b")) == {
        "conv": "mamba", "h": "mamba", "k": "attn", "v": "attn"}


# ---- model passes -------------------------------------------------------

def _blocks_close(pblocks, jblocks):
    assert set(pblocks) == {"x_tm", "x_cm", "h"}
    for name, t in pblocks.items():
        _rel_close(t, jblocks["l0"][name])


@pytest.mark.parametrize("S", [1, 10, 37])
def test_prefill_logits_and_cache(pair, S):
    jm, jp, pm, pp, cfg = pair
    (prompt,) = _prompts(cfg, [S], seed=S)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt[None])},
                        cache_len=48)
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(prompt[None])},
                        cache_len=48)
    _rel_close(pl, jl)
    _blocks_close(pc["blocks"], jc["blocks"])
    assert pc["cur_len"] == int(jc["cur_len"]) == S


def test_decode_step_lockstep(pair):
    jm, jp, pm, pp, cfg = pair
    toks = np.stack(_prompts(cfg, [9, 9], seed=11))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=20)
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks)}, cache_len=20)
    for _ in range(4):
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt))
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(nxt))
        _rel_close(pl, jl)
    _blocks_close(pc["blocks"], jc["blocks"])
    assert pc["cur_len"] == int(jc["cur_len"]) == 13


def test_decode_step_ragged_and_insert_prefill(pair):
    jm, jp, pm, pp, cfg = pair
    L, lens = 32, [5, 17, 1, 11]
    jblocks = jm.init_cache(len(lens), L)["blocks"]
    pblocks = pm.init_cache(len(lens), L)["blocks"]
    assert {n: (tuple(t.shape), t.dtype) for n, t in pblocks.items()} == {
        n: (tuple(jblocks["l0"][n].shape), torch.float32) for n in pblocks}
    last = []
    for slot, p in enumerate(_prompts(cfg, lens, seed=13)):
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(p[None])}, cache_len=L)
        pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(p[None])},
                            cache_len=L)
        jblocks = jm.insert_prefill(jblocks, jc["blocks"],
                                    jnp.asarray(slot, jnp.int32))
        assert pm.insert_prefill(pblocks, pc["blocks"], slot) is pblocks
        last.append(int(jnp.argmax(jl[0])))
    _blocks_close(pblocks, jblocks)
    kv_len = np.asarray(lens, np.int32)
    tokens = np.asarray(last, np.int32)[:, None]
    for _ in range(3):
        jl, jblocks = jm.decode_step_ragged(jp, jblocks, jnp.asarray(tokens),
                                            jnp.asarray(kv_len))
        pl, pblocks = pm.decode_step_ragged(pp, pblocks,
                                            torch.from_numpy(tokens),
                                            torch.from_numpy(kv_len))
        _rel_close(pl, jl)
        tokens = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        kv_len = kv_len + 1
    _blocks_close(pblocks, jblocks)


def test_bf16_cache_leaves_keep_the_state_in_float32():
    cfg = configs.get_config("rwkv6-3b", smoke=True)          # bfloat16
    blocks = Model(cfg, device="cpu").init_cache(3, 64)["blocks"]
    H, K = ssm._rwkv_dims(cfg)
    assert blocks["h"].dtype == torch.float32
    assert tuple(blocks["h"].shape) == (cfg.n_layers, 3, H, K, K)
    assert blocks["x_tm"].dtype == blocks["x_cm"].dtype == torch.bfloat16
    assert tuple(blocks["x_cm"].shape) == (cfg.n_layers, 3, cfg.d_model)
