"""The port's attention kernels' plain versions against the JAX package.

On the CPU the wrappers of ``repro_torch.kernels.flash_attention`` and
``decode_attention`` take their plain versions; those are held here to the
reference's Pallas kernels run in interpret mode and to its XLA path, on
inputs made from a numpy seed. The CUDA kernels themselves are held to the
plain versions by the ``gpu``-marked tests of ``test_torch_gpu.py`` and by
chip_smoke.py on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import decode_attention as jax_da
from repro.kernels import flash_attention as jax_fa
from repro.kernels import ops as jax_ops

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

# tolerances: float32 differs from the reference only in summation order;
# bfloat16 outputs are rounded to bfloat16 by both sides
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(B, Sq, Skv, H, KV, D, seed=0, Dv=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Skv, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, Skv, KV, Dv or D)).astype(np.float32)
    return q, k, v


def _both(arrs, dtype):
    """The same values as jax arrays and torch tensors of ``dtype`` (bf16
    rounding happens once, in numpy's float32 -> jax cast, then is shared)."""
    js = [jnp.asarray(a).astype(JNP[dtype]) for a in arrs]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH[dtype])
          for j in js]
    return js, ts


def _close(got: torch.Tensor, want, dtype):
    assert got.dtype == TORCH[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=0)


# ---- flash attention (prefill) --------------------------------------------

# (B, Sq, Skv, H, KV, D, kwargs): tile-divisible shapes for the Pallas kernel
FLASH_PALLAS = [
    (1, 128, 128, 4, 2, 32, {"causal": True}),
    (2, 128, 128, 4, 4, 16, {"causal": True}),                 # MHA
    (1, 128, 128, 8, 2, 32, {"causal": True, "window": 48}),
    (1, 64, 128, 4, 2, 32, {"causal": True, "q_offset": 64}),
    (1, 128, 128, 4, 1, 32, {"causal": False}),                # MQA
    (1, 128, 128, 4, 2, 32, {"causal": True, "scale": 0.3}),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,kw", FLASH_PALLAS)
def test_flash_plain_vs_pallas_interpret(dtype, B, Sq, Skv, H, KV, D, kw):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(B, Sq, Skv, H, KV, D), dtype)
    want = jax_fa.flash_attention(jq, jk, jv, blk_q=64, blk_k=64,
                                  interpret=True, **kw)
    _close(ops.attention(tq, tk, tv, **kw), want, dtype)


# ragged prompt lengths the engine prefills at (the Pallas kernel asserts
# that its tiles divide them, so the reference here is its XLA path)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,kw", [(37, {}), (13, {}), (37, {"window": 8}),
                                   (13, {"q_offset": 5})])
def test_flash_plain_vs_jax_xla_on_ragged_lengths(dtype, Sq, kw):
    Skv = Sq + kw.get("q_offset", 0)
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, Sq, Skv, 8, 2, 16, seed=1),
                                       dtype)
    want = jax_ops.attention(jq, jk, jv, causal=True, impl="xla", **kw)
    _close(fa.flash_attention(tq, tk, tv, causal=True, **kw), want, dtype)


def test_flash_plain_takes_a_value_width_other_than_the_key_width():
    q, k, v = _qkv(1, 64, 64, 4, 2, 24, seed=2, Dv=16)
    want = jax_fa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), blk_q=32, blk_k=32,
                                  interpret=True)
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == (1, 64, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---- decode attention -------------------------------------------------------

DECODE_CASES = [
    (768, [0, 1, 768, 300, 17, 511], None),
    (768, [5, 768, 0, 400, 383, 384], 100),
    (96, [96, 1, 40, 0, 95, 64], None),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,lens,window", DECODE_CASES)
def test_decode_plain_vs_pallas_interpret(dtype, L, lens, window):
    """L = 768 is no multiple of the kernel's default tile (legal_blk_k);
    kv_len = 0 rows are compared with the Pallas run only, whose contract
    (l = 0 -> zeros) the plain version keeps."""
    B = len(lens)
    rng = np.random.default_rng(3)
    q = rng.normal(size=(B, 1, 8, 32)).astype(np.float32)
    k = rng.normal(size=(B, L, 2, 32)).astype(np.float32)
    v = rng.normal(size=(B, L, 2, 32)).astype(np.float32)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    n = np.asarray(lens, np.int32)
    want = jax_da.decode_attention(jq, jk, jv, kv_len=jnp.asarray(n),
                                   window=window, interpret=True)
    got = ops.decode_attention(tq, tk, tv, kv_len=torch.from_numpy(n),
                               window=window)
    _close(got, want, dtype)
    assert (got[torch.from_numpy(n == 0)] == 0).all()


@pytest.mark.parametrize("window", [None, 16])
def test_decode_plain_vs_jax_xla_where_rows_are_not_empty(window):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(4, 1, 4, 16)).astype(np.float32)
    k = rng.normal(size=(4, 50, 4, 16)).astype(np.float32)
    v = rng.normal(size=(4, 50, 4, 16)).astype(np.float32)
    n = np.asarray([1, 50, 23, 7], np.int32)
    want = jax_ops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), kv_len=jnp.asarray(n),
                                    window=window, impl="xla")
    got = da.decode_attention(*map(torch.from_numpy, (q, k, v)),
                              kv_len=torch.from_numpy(n), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# the zoo's (G, D) pairs: granite-moe-3b G = 3 at D = 64, qwen2.5-14b G = 5
# and chameleon-34b G = 8 at D = 128 (two kv heads here, the configs' 8 on
# the card)
ZOO_PAIRS = [(3, 64), (5, 128), (8, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,D", ZOO_PAIRS)
def test_decode_plain_vs_pallas_and_xla_at_the_zoo_pairs(dtype, G, D):
    """All rows against the Pallas kernel in interpret mode, the rows with
    kv_len > 0 against the XLA path too (an empty row averages V there)."""
    rng = np.random.default_rng(10 + G)
    B, L, KV = 5, 256, 2
    q = rng.normal(size=(B, 1, KV * G, D)).astype(np.float32)
    k = rng.normal(size=(B, L, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, L, KV, D)).astype(np.float32)
    n = np.asarray([0, 1, L, 131, 40], np.int32)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    got = ops.decode_attention(tq, tk, tv, kv_len=torch.from_numpy(n))
    want = jax_da.decode_attention(jq, jk, jv, kv_len=jnp.asarray(n),
                                   interpret=True)
    _close(got, want, dtype)
    assert (got[0] == 0).all()
    xla = jax_ops.decode_attention(jq, jk, jv, kv_len=jnp.asarray(n),
                                   impl="xla")
    _close(got[1:], xla[1:], dtype)


# ---- dispatch and arguments --------------------------------------------------

def _counts():
    return (fa.flash_attention.launches,
            dict(fa.flash_attention.launches_by_route),
            da.decode_attention.launches,
            dict(da.decode_attention.launches_by_route))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 64, 128])
def test_cpu_tensors_take_the_plain_attention_and_count_no_launch(dtype, D):
    """At the tensor-core routes' widths too: a CPU tensor never reaches a
    kernel and moves no route's count."""
    before = _counts()
    _, (q, k, v) = _both(_qkv(1, 8, 8, 4, 2, D), dtype)
    ops.attention(q, k, v)
    ops.decode_attention(q[:, :1], k, v, kv_len=torch.tensor([3]))
    assert _counts() == before


def test_attention_wrappers_reject_what_does_not_fit():
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 8, 4, 2, 16))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[..., :8], v)              # D mismatch
    with pytest.raises(ValueError):
        fa.flash_attention(q[:, :, :3], k, v)             # H % KV != 0
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError):
        da.decode_attention(q, k, v, kv_len=torch.tensor([3]))   # Sq != 1
    with pytest.raises(ValueError):
        da.decode_attention(q[:, :1], k, v, kv_len=torch.tensor([3, 4]))


def test_decode_split_fills_the_card_without_empty_tiny_splits():
    assert da.split_l(8, 8, 2048, n_sm=132) == 5      # 320 blocks
    assert da.split_l(8, 8, 768, n_sm=132) == 5
    assert da.split_l(8, 8, 256, n_sm=132) == 2       # >= 128 entries a block
    assert da.split_l(1, 2, 48, n_sm=132) == 1
    assert da.split_l(64, 8, 4096, n_sm=132) == 1


# ---- the route a CUDA call takes: chosen by dtype and shape ---------------

@pytest.mark.parametrize("dtype,D,Dv,route", [
    (torch.bfloat16, 128, 128, "wgmma"),       # llama3-8b, jamba
    (torch.bfloat16, 64, 64, "wgmma"),
    (torch.float32, 128, 128, "simt"),
    (torch.float32, 64, 64, "simt"),
    (torch.bfloat16, 16, 16, "simt"),          # the smoke configs
    (torch.bfloat16, 192, 128, "simt"),        # MLA's widths
    (torch.bfloat16, 128, 64, "simt"),
    (torch.float32, 256, 128, "simt")])
def test_flash_route_by_dtype_and_width(dtype, D, Dv, route):
    assert fa._route(dtype, D, Dv) == route


@pytest.mark.parametrize("dtype,D,Dv", [(torch.bfloat16, 320, 128),
                                        (torch.float32, 128, 192),
                                        (torch.float16, 128, 128),
                                        (torch.bfloat16, 0, 64)])
def test_flash_route_raises_where_no_kernel_takes_the_shape(dtype, D, Dv):
    with pytest.raises(ValueError):
        fa._route(dtype, D, Dv)


@pytest.mark.parametrize("dtype,G,D,Dv,route", [
    (torch.bfloat16, 4, 128, 128, "mma"),      # llama3-8b, jamba
    (torch.bfloat16, 4, 64, 64, "mma"),
    (torch.bfloat16, 2, 16, 16, "mma"),        # the smoke configs
    (torch.bfloat16, 2, 32, 32, "mma"),
    (torch.bfloat16, 3, 64, 64, "mma"),        # granite-moe-3b
    (torch.bfloat16, 5, 128, 128, "mma"),      # qwen2.5-14b
    (torch.bfloat16, 8, 128, 128, "mma"),      # chameleon-34b
    (torch.bfloat16, 3, 16, 16, "mma"),        # below the built 64
    (torch.float32, 3, 64, 64, "simt"),
    (torch.float32, 5, 128, 128, "simt"),
    (torch.float32, 8, 128, 128, "simt"),
    (torch.float32, 4, 128, 128, "simt"),
    (torch.float32, 2, 16, 16, "simt"),
    (torch.bfloat16, 4, 72, 72, "simt"),       # not a multiple of 16
    (torch.bfloat16, 2, 24, 16, "simt")])
def test_decode_route_by_dtype_and_width(dtype, G, D, Dv, route):
    assert da._route(dtype, G, D, Dv) == route


@pytest.mark.parametrize("dtype,G,D,Dv", [(torch.bfloat16, 6, 128, 128),
                                          (torch.bfloat16, 3, 128, 128),
                                          (torch.bfloat16, 2, 64, 64),
                                          (torch.float32, 4, 144, 128),
                                          (torch.float16, 4, 128, 128)])
def test_decode_route_raises_where_no_kernel_takes_the_shape(dtype, G, D, Dv):
    with pytest.raises(ValueError):
        da._route(dtype, G, D, Dv)


# ---- the tensor-core kernels' numerics, emulated, against the reference ----
#
# The wgmma flash kernel and the mma.sync decode kernel differ from the
# reference in where they round: the bf16 q.k products are summed in fp32
# unscaled and multiplied by the scale after, and P is rounded to bf16 (in
# each tile, against the running max) before P @ V, which accumulates in
# fp32. These emulations repeat that arithmetic in plain float32, tile by
# tile, so that the bf16 tolerance is tested at llama3-8b's head shape on
# the CPU; the kernels themselves are held to the plain versions on the card.

def _online_softmax_pv(s, valid, vf, tile):
    """s (..., Sk) fp32 scores with NEG_INF where masked, valid (..., Sk),
    vf (..., Sk, Dv): the online softmax over key tiles of ``tile``, P
    rounded to bf16 for P @ V, (m, l, acc) in fp32."""
    m = torch.full(s.shape[:-1], fa.NEG_INF)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros((*s.shape[:-1], vf.shape[-1]))
    for t in range(0, s.shape[-1], tile):
        st = s[..., t:t + tile]
        m_new = torch.maximum(m, st.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None]) * valid[..., t:t + tile]
        l = l * alpha + p.sum(-1)
        pb = p.to(torch.bfloat16).float()
        acc = acc * alpha[..., None] + (pb[..., None, :]
                                        @ vf[..., t:t + tile, :])[..., 0, :]
        m = m_new
    return acc / torch.clamp_min(l, 1e-30)[..., None]


def _tc_flash_emulation(q, k, v, *, causal=True, window=None, q_offset=0):
    B, Sq, H, D = q.shape
    Skv, G = k.shape[1], H // k.shape[2]
    kf = k.float().repeat_interleave(G, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, dim=2).transpose(1, 2)
    s = (q.float().transpose(1, 2) @ kf.transpose(-1, -2)) * (1.0 / D**0.5)
    q_pos = torch.arange(Sq)[:, None] + q_offset
    k_pos = torch.arange(Skv)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    s = s.masked_fill(~ok, fa.NEG_INF)
    o = _online_softmax_pv(s, ok.float().expand_as(s), vf[:, :, None], 64)
    return o.transpose(1, 2).to(q.dtype)


def _tc_decode_emulation(q, k, v, kv_len, *, window=None):
    B, _, H, D = q.shape
    L, G = k.shape[1], H // k.shape[2]
    kf = k.float().repeat_interleave(G, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, dim=2).transpose(1, 2)
    s = (q[:, 0].float()[:, :, None, :] @ kf.transpose(-1, -2))[:, :, 0]
    s = s * (1.0 / D**0.5)
    pos = torch.arange(L)[None, :]
    ok = pos < kv_len[:, None]
    if window is not None:
        ok &= pos > kv_len[:, None] - 1 - window
    ok = ok[:, None, :].expand_as(s)
    s = s.masked_fill(~ok, fa.NEG_INF)
    return _online_softmax_pv(s, ok.float(), vf, 16)[:, None].to(q.dtype)


@pytest.mark.parametrize("kw", [{}, {"window": 96}, {"causal": False}])
def test_tensor_core_flash_numerics_vs_pallas_interpret_at_llama_heads(kw):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 256, 256, 32, 8, 128, seed=5),
                                       "bfloat16")
    want = jax_fa.flash_attention(jq, jk, jv, blk_q=128, blk_k=128,
                                  interpret=True, **kw)
    _close(_tc_flash_emulation(tq, tk, tv, **kw), want, "bfloat16")


@pytest.mark.parametrize("window", [None, 100])
def test_tensor_core_decode_numerics_vs_jax_xla_at_llama_heads(window):
    rng = np.random.default_rng(6)
    q = rng.normal(size=(4, 1, 32, 128)).astype(np.float32)
    k = rng.normal(size=(4, 256, 8, 128)).astype(np.float32)
    v = rng.normal(size=(4, 256, 8, 128)).astype(np.float32)
    n = np.asarray([1, 256, 131, 40], np.int32)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "bfloat16")
    want = jax_ops.decode_attention(jq, jk, jv, kv_len=jnp.asarray(n),
                                    window=window, impl="xla")
    got = _tc_decode_emulation(tq, tk, tv, torch.from_numpy(n), window=window)
    _close(got, want, "bfloat16")


@pytest.mark.parametrize("G,D", ZOO_PAIRS)
def test_tensor_core_decode_numerics_vs_jax_xla_at_the_zoo_pairs(G, D):
    rng = np.random.default_rng(7 + G)
    q = rng.normal(size=(4, 1, 8 * G, D)).astype(np.float32)
    k = rng.normal(size=(4, 256, 8, D)).astype(np.float32)
    v = rng.normal(size=(4, 256, 8, D)).astype(np.float32)
    n = np.asarray([1, 256, 131, 40], np.int32)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "bfloat16")
    want = jax_ops.decode_attention(jq, jk, jv, kv_len=jnp.asarray(n),
                                    impl="xla")
    got = _tc_decode_emulation(tq, tk, tv, torch.from_numpy(n))
    _close(got, want, "bfloat16")
