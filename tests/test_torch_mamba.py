"""The port's Mamba scan, Mamba mixer, MoE MLP and the jamba-v0.1-52b smoke
model against the JAX package.

Scan: on the CPU the wrappers take their plain versions,
``mamba_scan_plain`` (the sequential recurrence in float32) and
``mamba_decode_step_plain`` (the reference's one-step formula, written
into the state in place). They are held to the reference's Pallas kernel
in interpret mode (S a multiple of its 16-step tile, Di of its 128
lanes), to ``ref.mamba_scan`` and to the XLA chunked scan at ragged S,
on inputs made from a numpy seed: step sizes softplus(N(0, 1)),
A = -exp(N(0, 0.5)), a random initial state. The CUDA kernel is held to
the plain versions by the ``gpu``-marked tests of ``test_torch_gpu.py``
and by chip_smoke.py on the card.

Model: the reference's ``Model.init`` tree with every leaf moved off its
initial value by numpy noise from a seed (A_log, dt_bias, D and the conv
bias included), carried across with ``params_from_jax``; float32 on the
CPU, the reference on its default XLA path.

The bf16 cast of every jamba leaf (``dt_bias``, ``A_log`` and ``D``
included) is held to the reference's by the jamba case of
``test_torch_rwkv.py::test_bf16_params_equal_the_reference_cast_of_the_stacked_tree``.

Tolerances, relative to the largest value compared: float32 1e-5 for the
scan (summation order differs), bfloat16 1e-2 (both sides compute in
float32 from the same bf16 inputs and round y to bf16; one bf16 ulp is
2^-8), 1e-4 for the model passes (XLA and PyTorch matmuls sum in other
orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import linear_scan as jax_ls
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import moe as jax_moe
from repro.models import ssm as jax_ssm
from repro.models.model import build_model as jax_build_model

from repro_torch import configs
from repro_torch.kernels import linear_scan as ls
from repro_torch.kernels import ops
from repro_torch.models import layers, moe, ssm
from repro_torch.models import transformer as tf
from repro_torch.models.model import Model, params_from_jax

RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
MODEL_RTOL = 1e-4
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCH = "jamba-v0.1-52b"


def _rel_close(got: torch.Tensor, want, rtol):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


def _to_torch(j) -> torch.Tensor:
    """A jax array as a torch tensor of the same dtype and values."""
    t = torch.from_numpy(np.array(jnp.asarray(j).astype(jnp.float32)))
    return t.to(TORCH[str(j.dtype)])


# ---- the scan ------------------------------------------------------------

def _scan_inputs(B, S, Di, N, dtype, seed=0):
    """delta, A, Bt, Ct, x, h0 as (jax arrays, torch tensors) of the same
    values: delta, Bt, Ct, x in ``dtype`` (rounded once, then shared), A
    and h0 in float32, as the model feeds the scan's wrapper."""
    rng = np.random.default_rng(seed)
    delta = np.log1p(np.exp(rng.normal(size=(B, S, Di))))
    A = -np.exp(0.5 * rng.normal(size=(Di, N)))
    Bt, Ct = rng.normal(size=(B, S, N)), rng.normal(size=(B, S, N))
    x = rng.normal(size=(B, S, Di))
    h0 = 0.5 * rng.normal(size=(B, Di, N))
    js = [jnp.asarray(a.astype(np.float32)).astype(JNP[dtype])
          for a in (delta, Bt, Ct, x)]
    jA, jh = (jnp.asarray(a.astype(np.float32)) for a in (A, h0))
    jd, jb, jc, jx = js
    jax_args = (jd, jA, jb, jc, jx, jh)
    return jax_args, tuple(_to_torch(a) for a in jax_args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Di,N,with_h0", [(2, 32, 128, 4, True),
                                              (1, 48, 256, 16, False)])
def test_plain_scan_equals_pallas_kernel_in_interpret_mode(B, S, Di, N,
                                                           with_h0, dtype):
    (jd, jA, jb, jc, jx, jh), (td, tA, tb, tc, tx, th) = _scan_inputs(
        B, S, Di, N, dtype, seed=S)
    jy, jhf = jax_ls.mamba_scan(jd, jA, jb, jc, jx, jh if with_h0 else None,
                                interpret=True)
    ty, thf = ls.mamba_scan_plain(td, tA, tb, tc, tx, th if with_h0 else None)
    assert ty.dtype == TORCH[dtype] and thf.dtype == torch.float32
    _rel_close(ty, jy, RTOL[dtype])
    _rel_close(thf, jhf, RTOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [1, 37])
def test_plain_scan_equals_reference_and_xla_at_ragged_lengths(S, with_h0,
                                                               dtype):
    (jd, jA, jb, jc, jx, jh), (td, tA, tb, tc, tx, th) = _scan_inputs(
        2, S, 24, 4, dtype, seed=S + 1)
    jh, th = (jh, th) if with_h0 else (None, None)
    ty, thf = ls.mamba_scan_plain(td, tA, tb, tc, tx, th)
    # the eager reference rounds delta x to bf16 as the plain scan does; the
    # jitted XLA scan keeps it in float32 (XLA's excess precision on the
    # CPU), so its bf16 state is held at the bf16 tolerance
    for (jy, jhf), state_rtol in (
            (jax_ref.mamba_scan(jd, jA, jb, jc, jx, jh), RTOL["float32"]),
            (jax_ops.mamba_scan(jd, jA, jb, jc, jx, jh, impl="xla"),
             RTOL[dtype])):
        _rel_close(ty, jy, RTOL[dtype])
        _rel_close(thf, jhf, state_rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_equals_reference_and_updates_the_state_in_place(dtype):
    (jd, jA, jb, jc, jx, jh), (td, tA, tb, tc, tx, th) = _scan_inputs(
        3, 1, 40, 16, dtype, seed=5)
    jy, jhn = jax_ops.mamba_decode_step(jd[:, 0], jA, jb[:, 0], jc[:, 0],
                                        jx[:, 0], jh)
    state = th.clone()
    sy, sh = ls.mamba_scan_plain(td, tA, tb, tc, tx, th)
    ty, out = ops.mamba_decode_step(td[:, 0], tA, tb[:, 0], tc[:, 0],
                                    tx[:, 0], state)
    assert out is state                                  # written in place
    _rel_close(ty, jy, RTOL[dtype])
    _rel_close(state, jhn, RTOL["float32"])
    _rel_close(ty, sy[:, 0].float().numpy(), RTOL[dtype])   # the scan, S=1
    _rel_close(state, sh.numpy(), RTOL["float32"])


def test_dx_is_rounded_to_the_input_dtype_before_it_is_widened():
    """delta x in bf16 is rounded before the state takes it, as the
    reference rounds it: a pair whose exact product is no bf16 value."""
    d = torch.tensor([[[1.0 + 2**-7]]], dtype=torch.bfloat16)
    x = torch.tensor([[[1.0 + 2**-6]]], dtype=torch.bfloat16)
    ones = torch.ones((1, 1, 1), dtype=torch.bfloat16)
    A = torch.full((1, 1), -1e-30)
    _, h = ls.mamba_scan_plain(d, A, ones, ones, x)
    exact = (1.0 + 2**-7) * (1.0 + 2**-6)
    assert float(h) == float((d * x).float()) != exact


def test_prefix_then_continuation_equals_the_whole_scan():
    _, (d, A, b, c, x, h0) = _scan_inputs(2, 40, 32, 16, "float32", seed=9)
    y_all, h_all = ops.mamba_scan(d, A, b, c, x, h0)
    y1, h1 = ops.mamba_scan(d[:, :23], A, b[:, :23], c[:, :23], x[:, :23], h0)
    y2, h2 = ops.mamba_scan(d[:, 23:], A, b[:, 23:], c[:, 23:], x[:, 23:], h1)
    _rel_close(torch.cat([y1, y2], dim=1), y_all.numpy(), RTOL["float32"])
    _rel_close(h2, h_all.numpy(), RTOL["float32"])
    state = h1.clone()                     # token by token, in place
    for t in range(23, 40):
        yt, _ = ops.mamba_decode_step(d[:, t], A, b[:, t], c[:, t], x[:, t],
                                      state)
        _rel_close(yt, y_all[:, t].numpy(), RTOL["float32"])
    _rel_close(state, h_all.numpy(), RTOL["float32"])


def test_state_out_is_written_and_may_be_h0():
    _, (d, A, b, c, x, h0) = _scan_inputs(1, 5, 16, 4, "float32", seed=3)
    want_y, want_h = ls.mamba_scan_plain(d, A, b, c, x, h0)
    state = h0.clone()
    y, got = ls.mamba_scan(d, A, b, c, x, state, state_out=state)
    assert got is state
    assert torch.equal(y, want_y) and torch.equal(state, want_h)


def test_cpu_tensors_take_the_plain_scan_and_count_no_launch():
    _, (d, A, b, c, x, h0) = _scan_inputs(1, 4, 16, 4, "float32", seed=4)
    before = ls.mamba_scan.launches
    ops.mamba_scan(d, A, b, c, x, h0)
    ops.mamba_decode_step(d[:, 0], A, b[:, 0], c[:, 0], x[:, 0], h0.clone())
    assert ls.mamba_scan.launches == before


def test_the_wrapper_rejects_shapes_it_does_not_take():
    _, (d, A, b, c, x, h0) = _scan_inputs(1, 4, 16, 4, "float32", seed=4)
    bad = [(d[..., :8], A, b, c, x, h0),                   # Di differs
           (d, A, b[:, :3], c, x, h0),                     # S differs
           (d, A[:, :2], b, c, x, h0),                     # N differs
           (d, A, b, c, x, h0[..., :2]),                   # h0 (B, Di, 2)
           (d[:, :0], A, b[:, :0], c[:, :0], x[:, :0], h0)]   # S = 0
    for args in bad:
        with pytest.raises(ValueError):
            ls.mamba_scan(*args)
    with pytest.raises(ValueError):
        ls.mamba_scan(d, A, b, c, x, h0,
                      state_out=torch.empty(h0.shape, dtype=torch.float64))


# ---- the mixer and the MoE MLP -------------------------------------------

def _noisy(tree, seed: int, scale: float = 0.2):
    """A reference tree as float32 numpy, every zeros- or ones-initialised
    leaf (norm scales, conv bias, dt_bias, A_log, D) plus N(0, scale); the
    drawn leaves stay at their init scale. (N(0, 0.2) on every matrix, as
    the llama and RWKV tests add it, makes jamba's random Mamba mixers
    gain ~100x a layer: each layer still agrees within ~5e-7, but eight of
    them amplify that past 1e-4 of the logits.)"""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a, np.float32)
        noise = scale * rng.standard_normal(a.shape)
        return (a + noise if np.ptp(a) == 0 else a).astype(np.float32)

    return jax.tree.map(leaf, tree)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params, cfg) on the CPU."""
    cfg = jax_get_config(ARCH, smoke=True).replace(dtype="float32")
    jm = jax_build_model(cfg)
    jp = _noisy(jm.init(jax.random.PRNGKey(0)), seed=1)
    pcfg = configs.get_config(ARCH, smoke=True).replace(dtype="float32")
    pm = Model(pcfg, device="cpu")
    pp = params_from_jax(pcfg, jp, device="cpu")
    return jm, jp, pm, pp, pcfg


def _layer(pair, j: int, r: int = 0):
    """Pattern position ``j`` of repeat ``r``: (jax params, port params)."""
    jm, jp, pm, pp, cfg = pair
    jl = jax.tree.map(lambda a: jnp.asarray(a[r]), jp["blocks"][f"l{j}"])
    return jl, pp["blocks"][r * len(cfg.block_pattern) + j]


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_pre_equals_reference(pair, dtype):
    """The projection path: the causal conv as four products summed in the
    compute dtype, softplus in its logaddexp form, and A = -exp(A_log) in
    the compute dtype, from weights cast as the model holds them."""
    cfg = pair[4].replace(dtype=dtype)
    jl, pl = _layer(pair, 0)
    jmix = jax.tree.map(lambda a: a.astype(JNP[dtype]), jl["mix"])
    pmix = {n: _to_torch(a) for n, a in jmix.items()}
    di, dtr, N, K = ssm._mamba_dims(cfg)
    rng = np.random.default_rng(2)
    xz = jnp.asarray(rng.normal(size=(2, 9, 2 * di)).astype(np.float32)
                     ).astype(JNP[dtype])
    tail = jnp.asarray(rng.normal(size=(2, K - 1, di)).astype(np.float32)
                       ).astype(JNP[dtype])
    want = jax_ssm._mamba_pre(cfg, jmix, xz, tail)
    got = ssm._mamba_pre(cfg, pmix, _to_torch(xz), _to_torch(tail))
    for g, w in zip(got, want):
        assert g.dtype == TORCH[dtype]
        _rel_close(g, w, RTOL[dtype])
    # the conv in the reference's order (ssm.py:58-59): bitwise equal
    xw = jnp.concatenate([tail, xz[..., :di]], axis=1)
    jconv = sum(xw[:, k:k + 9] * jmix["conv_w"][k].astype(xw.dtype)
                for k in range(K))
    conv = ssm.causal_conv(_to_torch(xw), pmix["conv_w"])
    assert torch.equal(conv, _to_torch(jconv))
    if dtype == "bfloat16":        # a float32 sum, as F.conv1d's, differs
        wide = ssm.causal_conv(_to_torch(xw).float(), pmix["conv_w"].float())
        assert not torch.equal(conv, wide.to(conv.dtype))
    # A = -exp(A_log) in the compute dtype, not widened first: in bf16 the
    # same rounded values (float32 exp may differ by an ulp)
    a, ja = -torch.exp(pmix["A_log"]), _to_torch(-jnp.exp(jmix["A_log"]))
    assert a.dtype == ja.dtype == TORCH[dtype]
    if dtype == "bfloat16":
        assert torch.equal(a, ja)
    torch.testing.assert_close(a, ja, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softplus_equals_jax_at_the_paths_values(dtype):
    x = jnp.asarray(np.linspace(-30, 30, 20001, dtype=np.float32)
                    ).astype(JNP[dtype])
    got = ssm.softplus(_to_torch(x))
    want = _to_torch(jax.nn.softplus(x))
    if dtype == "bfloat16":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_apply_and_decode_equal_reference(pair, with_state):
    cfg = pair[4]
    jl, pl = _layer(pair, 2)
    B, S = 2, 11
    x = _x(cfg, B, S, seed=5)
    di, dtr, N, K = ssm._mamba_dims(cfg)
    rng = np.random.default_rng(6)
    h0 = rng.normal(size=(B, di, N)).astype(np.float32) * 0.3
    tail = rng.normal(size=(B, K - 1, di)).astype(np.float32)
    kw_j = (dict(h0=jnp.asarray(h0), conv_tail=jnp.asarray(tail))
            if with_state else {})
    kw_t = (dict(h0=torch.from_numpy(h0), conv_tail=torch.from_numpy(tail))
            if with_state else {})
    jy, jc = jax_ssm.mamba_apply(cfg, jl["mix"], jnp.asarray(x),
                                 return_cache=True, **kw_j)
    ty, tc = ssm.mamba_apply(cfg, pl["mix"], torch.from_numpy(x),
                             return_cache=True, **kw_t)
    _rel_close(ty, jy, MODEL_RTOL)
    for name in ("conv", "h"):
        _rel_close(tc[name], jc[name], MODEL_RTOL)
    # two more tokens through the decode path, the cache updated in place
    cache = {n: t.clone() for n, t in tc.items()}
    for seed in (7, 8):
        x1 = _x(cfg, B, 1, seed=seed)
        jy1, jc = jax_ssm.mamba_decode(cfg, jl["mix"], jnp.asarray(x1), jc)
        ty1, out = ssm.mamba_decode(cfg, pl["mix"], torch.from_numpy(x1),
                                    cache)
        assert out is cache
        _rel_close(ty1, jy1, MODEL_RTOL)
        for name in ("conv", "h"):
            _rel_close(cache[name], jc[name], MODEL_RTOL)


def _moe_case(pair, x: np.ndarray, router=None):
    """moe_apply of both packages on x (B, S, d) with layer 1's experts
    (and ``router`` in place of its router, when given): y and aux agree.
    Returns (cfg, port params, x as a tensor)."""
    cfg = pair[4]
    jl, pl = _layer(pair, 1)
    jp, tp = dict(jl["mlp"]), dict(pl["mlp"])
    if router is not None:
        jp["router"] = jnp.asarray(router)
        tp["router"] = torch.from_numpy(router)
    jy, jaux = jax_moe.moe_apply(cfg, jp, jnp.asarray(x))
    ty, taux = moe.moe_apply(cfg, tp, torch.from_numpy(x))
    assert taux.dtype == torch.float32 and taux.ndim == 0
    _rel_close(ty, jy, MODEL_RTOL)
    _rel_close(taux, jaux, MODEL_RTOL)
    return cfg, tp, torch.from_numpy(x)


def _router_to(cfg, expert: int) -> np.ndarray:
    """A router that puts ``expert`` first for any all-positive input."""
    router = np.random.default_rng(4).normal(
        size=(cfg.d_model, cfg.moe.n_experts)).astype(np.float32) * 0.01
    router[:, expert] = 1.0
    return router


@pytest.mark.parametrize("S", [1, 7, 16])
def test_moe_apply_equals_reference(pair, S):
    _moe_case(pair, _x(pair[4], 2, S, seed=S))


def test_moe_drops_the_same_tokens_when_capacity_overflows(pair):
    """Every token routed to expert 0 first: 16 tokens for a capacity of
    12, so tokens 12-15 of each example lose expert 0 and keep only their
    second expert's share, in both packages."""
    cfg = pair[4]
    x = np.abs(_x(cfg, 2, 16, seed=12))
    cfg, tp, xt = _moe_case(pair, x, router=_router_to(cfg, 0))
    assert moe._capacity(cfg, 16) == 12
    _, _, idx = moe.route(cfg, tp, xt)
    assert bool((idx[..., 0] == 0).all())
    roomy = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    y, y_all = moe.moe_apply(cfg, tp, xt)[0], moe.moe_apply(roomy, tp, xt)[0]
    torch.testing.assert_close(y[:, :12], y_all[:, :12], rtol=1e-5,
                               atol=1e-6)
    for b in range(2):
        for t in range(12, 16):
            assert not torch.allclose(y[b, t], y_all[b, t], rtol=1e-2)


def test_moe_top_k_ties_keep_the_lower_expert_first(pair):
    """All-zero router logits tie every expert: lax.top_k takes experts 0
    and 1, so does the port, and the outputs agree."""
    cfg = pair[4]
    router = np.zeros((cfg.d_model, cfg.moe.n_experts), np.float32)
    cfg, tp, x = _moe_case(pair, _x(cfg, 2, 5, seed=13), router=router)
    probs, gate, idx = moe.route(cfg, tp, x)
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), cfg.moe.top_k)
    assert idx.tolist() == np.asarray(jidx).tolist()
    assert bool((idx == torch.tensor([0, 1])).all())


def test_moe_decode_capacity_is_per_example(pair):
    """At decode (S = 1) each row has its own capacity of 4: a batch of 8
    rows all routed to one expert drops none, as under the reference's
    vmap (one capacity pooled over the batch would drop 4)."""
    cfg = pair[4]
    assert moe._capacity(cfg, 1) == 4
    x = np.abs(_x(cfg, 8, 1, seed=14))
    cfg, tp, xt = _moe_case(pair, x, router=_router_to(cfg, 2))
    _, _, idx = moe.route(cfg, tp, xt)
    assert bool((idx[..., 0] == 2).all())
    y = moe.moe_apply(cfg, tp, xt)[0]
    for b in range(8):                     # each row alone: the same output
        torch.testing.assert_close(y[b:b + 1],
                                   moe.moe_apply(cfg, tp, xt[b:b + 1])[0],
                                   rtol=1e-5, atol=1e-6)


# ---- the jamba smoke model ------------------------------------------------

def test_configs_and_parameters(pair):
    jm, jp, pm, pp, cfg = pair
    assert [s.kind for s in cfg.block_pattern].count("mamba") == 7
    assert len(pp["blocks"]) == cfg.n_layers
    assert sum(t.numel() for t in layers.tree_leaves(pp)) == jm.n_params() \
        == pm.n_params()
    exp = pp["blocks"][1]["mlp"]
    assert tuple(exp["wg"].shape) == (cfg.moe.n_experts, cfg.d_model,
                                      cfg.moe.d_expert)
    np.testing.assert_array_equal(
        pp["blocks"][3]["mix"]["A_log"].numpy(),
        jp["blocks"]["l3"]["mix"]["A_log"][0])
    full = configs.get_config(ARCH)
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        jax_build_model(jax_get_config(ARCH)).abstract_params()))
    assert Model(full, device="cpu").n_params() == want == 51_570_315_264


def _blocks_close(pblocks, jblocks, cfg):
    """The port's flat cache against the reference's per-position tree:
    layer r * 8 + j of kind k is slice [slot] of the port's leaf."""
    assert set(pblocks) == {"conv", "h", "k", "v"}
    slots = tf.cache_slots(cfg)
    for i, spec in enumerate(tf.layer_specs(cfg)):
        r, j = divmod(i, len(cfg.block_pattern))
        for name in tf.CACHE_LEAVES[spec.kind]:
            _rel_close(pblocks[name][slots[i]],
                       jblocks[f"l{j}"][name][r], MODEL_RTOL)


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n) for n in lens]


@pytest.mark.parametrize("S", [1, 10, 37])
def test_prefill_logits_and_cache(pair, S):
    jm, jp, pm, pp, cfg = pair
    (prompt,) = _prompts(cfg, [S], seed=S)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt[None])},
                        cache_len=48)
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(prompt[None])},
                        cache_len=48)
    _rel_close(pl, jl, MODEL_RTOL)
    _blocks_close(pc["blocks"], jc["blocks"], cfg)
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
        _rel_close(pl, jl, MODEL_RTOL)
    _blocks_close(pc["blocks"], jc["blocks"], cfg)
    assert pc["cur_len"] == int(jc["cur_len"]) == 13


def test_decode_step_ragged_and_insert_prefill(pair):
    jm, jp, pm, pp, cfg = pair
    L, lens = 32, [5, 17, 1, 11]
    jblocks = jm.init_cache(len(lens), L)["blocks"]
    pblocks = pm.init_cache(len(lens), L)["blocks"]
    assert pm.cache_bytes(len(lens), L) == sum(
        t.nbytes for t in pblocks.values())
    last = []
    for slot, p in enumerate(_prompts(cfg, lens, seed=13)):
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(p[None])}, cache_len=L)
        pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(p[None])},
                            cache_len=L)
        jblocks = jm.insert_prefill(jblocks, jc["blocks"],
                                    jnp.asarray(slot, jnp.int32))
        assert pm.insert_prefill(pblocks, pc["blocks"], slot) is pblocks
        last.append(int(jnp.argmax(jl[0])))
    _blocks_close(pblocks, jblocks, cfg)
    kv_len = np.asarray(lens, np.int32)
    tokens = np.asarray(last, np.int32)[:, None]
    for _ in range(3):
        jl, jblocks = jm.decode_step_ragged(jp, jblocks, jnp.asarray(tokens),
                                            jnp.asarray(kv_len))
        pl, pblocks = pm.decode_step_ragged(pp, pblocks,
                                            torch.from_numpy(tokens),
                                            torch.from_numpy(kv_len))
        _rel_close(pl, jl, MODEL_RTOL)
        tokens = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        kv_len = kv_len + 1
    _blocks_close(pblocks, jblocks, cfg)


def test_bf16_cache_leaves_keep_the_states_in_float32():
    cfg = configs.get_config(ARCH, smoke=True)                # bfloat16
    blocks = Model(cfg, device="cpu").init_cache(3, 64)["blocks"]
    di, dtr, N, K = ssm._mamba_dims(cfg)
    assert blocks["h"].dtype == torch.float32
    assert tuple(blocks["h"].shape) == (7, 3, di, N)
    assert blocks["conv"].dtype == blocks["k"].dtype == torch.bfloat16
    assert tuple(blocks["conv"].shape) == (7, 3, K - 1, di)
    assert tuple(blocks["k"].shape) == (1, 3, 64, cfg.n_kv_heads,
                                        cfg.head_dim)


def test_init_draws_as_many_rows_at_once_as_the_limit_holds(monkeypatch):
    """A long table over the whole-draw limit is drawn in as few slices of
    its leading axis as the limit allows, not a row a draw: a (250, 64)
    float32 table under a 4 KiB limit in 15 draws of 16 rows and one of
    10; deterministic, at its scale."""
    monkeypatch.setattr(layers, "WHOLE_DRAW_BYTES", 1 << 12)
    shapes = []
    randn = torch.randn

    def counted(shape, **kw):
        shapes.append(tuple(shape))
        return randn(shape, **kw)

    monkeypatch.setattr(torch, "randn", counted)
    meta = {"tok": layers.P((250, 64), ("vocab", "embed"), scale=1.0)}

    def tok():
        g = torch.Generator().manual_seed(3)
        return layers.init_params(meta, g, torch.float32)["tok"]
    t = tok()
    assert shapes == [(16, 64)] * 15 + [(10, 64)]
    assert t.dtype == torch.float32 and tuple(t.shape) == (250, 64)
    assert torch.equal(tok(), t)
    assert abs(t.std().item() - 1.0) < 0.05


def test_init_draws_a_large_stack_slice_by_slice(monkeypatch):
    """A leaf over the whole-draw limit is drawn slice by slice from the
    same generator: deterministic, at the reference's scale, in the cast
    dtype."""
    cfg = configs.get_config(ARCH, smoke=True)                # bfloat16
    monkeypatch.setattr(layers, "WHOLE_DRAW_BYTES", 1 << 16)
    model = Model(cfg, device="cpu")
    p = model.init(seed=3)
    wg = p["blocks"][1]["mlp"]["wg"]
    assert wg.dtype == torch.bfloat16 and 4 * wg.numel() > (1 << 16)
    assert abs(wg.float().std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert torch.equal(model.init(seed=3)["blocks"][1]["mlp"]["wg"], wg)
    assert [t.dtype for t in layers.tree_leaves(p)] == \
        [t.dtype for t in layers.tree_leaves(
            params_from_jax(cfg, jax.tree.map(
                np.asarray, jax_build_model(jax_get_config(ARCH, smoke=True))
                .init(jax.random.PRNGKey(0))), device="cpu"))]
