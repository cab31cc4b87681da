"""The port's attention kernels' plain versions against the JAX package.

On the CPU the wrappers of ``repro_torch.kernels.flash_attention`` and
``decode_attention`` take their plain versions; those are held here to the
reference's Pallas kernels run in interpret mode and to its XLA path, on
inputs made from a numpy seed. The CUDA kernels themselves are held to the
plain versions by the ``gpu``-marked tests of ``test_torch_gpu.py`` and by
chip_smoke.py on the card.

The attention layers' sliding-window and MLA paths are held here too:
gemma3's rolling decode cache through the decode kernel's plain version
against the reference's ``_masked_decode``, the reference's
``_roll_window`` fault (it raises for a prompt shorter than the window)
against the port's rolling cache, and deepseek-v2's MLA prefill and
absorbed decode against ``_mla_apply`` / ``_mla_decode``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.kernels import decode_attention as jax_da
from repro.kernels import flash_attention as jax_fa
from repro.kernels import ops as jax_ops
from repro.models import attention as jax_attn

from repro_torch import configs
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention as attn

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
# and chameleon-34b and qwen1.5-110b G = 8 at D = 128, gemma3-12b G = 2 at
# D = 256 (two kv heads here, the configs' 8 on the card)
ZOO_PAIRS = [(3, 64), (5, 128), (8, 128), (2, 256)]


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,lens", [(448, [0, 1, 448, 187, 300, 64]),
                                    (96, [96, 5, 0, 40, 95, 17])])
def test_decode_plain_vs_pallas_and_xla_at_g1(dtype, L, lens):
    """whisper's decoder self-attention: an MHA (G = 1) at D = 64, against
    the Pallas kernel in interpret mode (all rows) and the XLA path (the
    rows with kv_len > 0)."""
    B = len(lens)
    rng = np.random.default_rng(31)
    q = rng.normal(size=(B, 1, 4, 64)).astype(np.float32)
    k = rng.normal(size=(B, L, 4, 64)).astype(np.float32)
    v = rng.normal(size=(B, L, 4, 64)).astype(np.float32)
    n = np.asarray(lens, np.int32)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    got = ops.decode_attention(tq, tk, tv, kv_len=torch.from_numpy(n))
    _close(got, jax_da.decode_attention(jq, jk, jv, kv_len=jnp.asarray(n),
                                        interpret=True), dtype)
    live = n > 0
    xla = jax_ops.decode_attention(jq, jk, jv, kv_len=jnp.asarray(n),
                                   impl="xla")
    _close(got[torch.from_numpy(live)], np.asarray(
        xla.astype(jnp.float32))[live], dtype)
    assert (got[torch.from_numpy(~live)] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,pallas", [(64, 128, True), (128, 64, True),
                                           (7, 12, False), (1, 12, False),
                                           (187, 1500, False)])
def test_flash_plain_non_causal_with_sq_unlike_skv(dtype, Sq, Skv, pallas):
    """whisper's cross attention (decoder rows against the encoder's
    frames; one row in decode) and its encoder's bidirectional attention:
    non-causal, MHA, Sq != Skv. Tile-divisible shapes against the Pallas
    kernel in interpret mode, ragged ones against the XLA path."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, Sq, Skv, 4, 4, 16, seed=6),
                                       dtype)
    if pallas:
        want = jax_fa.flash_attention(jq, jk, jv, causal=False, blk_q=64,
                                      blk_k=64, interpret=True)
    else:
        want = jax_ops.attention(jq, jk, jv, causal=False, impl="xla")
    _close(ops.attention(tq, tk, tv, causal=False), want, dtype)


# (B, Sq, Skv, H, KV, D, kwargs) of the backward's checks: causal, non-causal
# with Sq != Skv, sliding window, GQA, an offset chunk, a custom scale; Dv
# != D with a custom scale, as MLA's (192 | 128) at 192 ** -0.5 (``"Dv"`` in
# kwargs is v's width, not an attention option); a window past one query
# chunk of the plain version (Q_CHUNK = 1,024)
FLASH_BWD = [
    (2, 16, 16, 4, 2, 16, {"causal": True}),
    (2, 7, 12, 4, 4, 16, {"causal": False}),
    (1, 1, 12, 4, 4, 16, {"causal": False}),
    (1, 24, 24, 8, 2, 16, {"causal": True, "window": 5}),
    (1, 9, 20, 4, 1, 8, {"causal": True, "q_offset": 11}),
    (1, 16, 16, 4, 2, 16, {"causal": True, "scale": 0.3}),
    (1, 20, 20, 4, 4, 24, {"causal": True, "scale": 0.2, "Dv": 16}),
    (1, 1100, 1100, 2, 1, 16, {"causal": True, "window": 300}),
]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,kw", FLASH_BWD)
def test_flash_bwd_plain_vs_autograd_and_jax_vjp(B, Sq, Skv, H, KV, D, kw):
    """The backward kernel's formulas in plain PyTorch (float32) against
    torch autograd of the plain forward, against ``FlashAttentionFn`` on
    CPU tensors, and against ``jax.vjp`` of the reference's XLA attention
    (the gradient the JAX package trains with: it has no backward
    kernel). Tolerance 1e-5 of the largest gradient."""
    import jax
    kw = dict(kw)
    Dv = kw.pop("Dv", D)
    q, k, v = _qkv(B, Sq, Skv, H, KV, D, seed=8, Dv=Dv)
    do = np.random.default_rng(9).normal(size=(B, Sq, H, Dv)).astype(
        np.float32)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o = fa.flash_attention_plain(tq, tk, tv, **kw)
    lse = fa.flash_attention_lse_plain(tq, tk, tv, **kw)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, **kw)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(fa.flash_attention_plain(*leaves, **kw),
                               leaves, tdo)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = fa.FlashAttentionFn.apply(*leaves, kw["causal"], kw.get("window"),
                                    kw.get("q_offset", 0), kw.get("scale"))
    through = torch.autograd.grad(out, leaves, tdo)
    _, vjp = jax.vjp(lambda a, b, c: jax_ops.attention(a, b, c, impl="xla",
                                                       **kw),
                     *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(do))
    for a, b, c, d in zip(got, auto, through, ref):
        d = np.asarray(d)
        tol = 1e-5 * float(np.abs(d).max())
        for x in (a, b, c):
            assert float(np.abs(x.detach().numpy() - d).max()) <= tol


# ---- dispatch and arguments --------------------------------------------------

@pytest.mark.parametrize("dtype,D,Dv,route", [
    (torch.bfloat16, 128, 128, "wgmma"),     # llama3-8b and the GQA archs
    (torch.bfloat16, 64, 64, "wgmma"),       # whisper, granite
    (torch.bfloat16, 16, 16, "mma"),         # the smoke configs
    (torch.bfloat16, 32, 32, "mma"),         # D = Dv off the wgmma widths
    (torch.bfloat16, 128, 64, "mma"),        # D != Dv
    (torch.bfloat16, 96, 112, "mma"),
    (torch.bfloat16, 40, 24, "simt"),        # not multiples of 16
    (torch.float32, 128, 128, "simt"),
    (torch.float32, 64, 64, "simt"),
    (torch.bfloat16, 256, 256, "wgmma_split"),   # gemma3-12b
    (torch.bfloat16, 192, 128, "wgmma_kv128")])  # deepseek-v2's MLA
def test_flash_bwd_route_by_dtype_and_width(dtype, D, Dv, route):
    assert fa._bwd_route(dtype, D, Dv) == route


@pytest.mark.parametrize("dtype,D,Dv", [(torch.float32, 256, 256),
                                        (torch.float32, 192, 128),
                                        (torch.float32, 144, 128),
                                        (torch.float16, 64, 64),
                                        (torch.bfloat16, 288, 288)])
def test_flash_bwd_route_raises_where_no_kernel_takes_the_shape(dtype, D, Dv):
    """float32 above D, Dv = 128 (gemma3's and MLA's widths among it), a
    bf16 width above the split route's, and float16 have no backward
    kernel."""
    with pytest.raises(ValueError):
        fa._bwd_route(dtype, D, Dv)


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
    (torch.bfloat16, 192, 128, "wgmma"),       # MLA's widths (deepseek-v2)
    (torch.float32, 192, 128, "simt"),
    (torch.bfloat16, 128, 192, "simt"),
    (torch.bfloat16, 128, 64, "simt"),
    (torch.float32, 256, 128, "simt"),
    (torch.bfloat16, 256, 256, "wgmma"),       # gemma3-12b
    (torch.float32, 256, 256, "simt"),
    (torch.bfloat16, 256, 128, "simt")])
def test_flash_route_by_dtype_and_width(dtype, D, Dv, route):
    assert fa._route(dtype, D, Dv) == route


@pytest.mark.parametrize("dtype,D,Dv", [(torch.bfloat16, 320, 128),
                                        (torch.float32, 128, 320),
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
    (torch.bfloat16, 8, 128, 128, "mma"),      # chameleon-34b, qwen1.5-110b
    (torch.bfloat16, 2, 256, 256, "mma"),      # gemma3-12b
    (torch.bfloat16, 2, 64, 64, "mma"),        # below the built 256
    (torch.float32, 2, 256, 256, "simt"),
    (torch.bfloat16, 3, 16, 16, "mma"),        # below the built 64
    (torch.float32, 3, 64, 64, "simt"),
    (torch.float32, 5, 128, 128, "simt"),
    (torch.float32, 8, 128, 128, "simt"),
    (torch.float32, 4, 128, 128, "simt"),
    (torch.float32, 2, 16, 16, "simt"),
    (torch.bfloat16, 4, 72, 72, "simt"),       # not a multiple of 16
    (torch.bfloat16, 2, 24, 16, "simt"),
    (torch.bfloat16, 1, 64, 64, "mma"),        # whisper-large-v3 (MHA)
    (torch.bfloat16, 1, 16, 16, "mma"),        # its smoke config
    (torch.float32, 1, 64, 64, "simt")])
def test_decode_route_by_dtype_and_width(dtype, G, D, Dv, route):
    assert da._route(dtype, G, D, Dv) == route


@pytest.mark.parametrize("dtype,G,D,Dv", [(torch.bfloat16, 6, 128, 128),
                                          (torch.bfloat16, 1, 128, 128),
                                          (torch.bfloat16, 3, 128, 128),
                                          (torch.bfloat16, 2, 272, 272),
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


# ---- D = Dv = 256 (gemma3-12b) ----------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [{"window": 48}, {}])
def test_flash_plain_at_the_gemma_width_vs_pallas_interpret_and_xla(dtype, kw):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 128, 128, 4, 2, 256, seed=8),
                                       dtype)
    got = ops.attention(tq, tk, tv, causal=True, **kw)
    _close(got, jax_fa.flash_attention(jq, jk, jv, blk_q=64, blk_k=64,
                                       interpret=True, causal=True, **kw),
           dtype)
    _close(got, jax_ops.attention(jq, jk, jv, causal=True, impl="xla", **kw),
           dtype)


@pytest.mark.parametrize("kw", [{"window": 96}, {}])
def test_tensor_core_flash_numerics_vs_pallas_interpret_at_gemma_heads(kw):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 256, 256, 16, 8, 256, seed=9),
                                       "bfloat16")
    want = jax_fa.flash_attention(jq, jk, jv, blk_q=128, blk_k=128,
                                  interpret=True, **kw)
    _close(_tc_flash_emulation(tq, tk, tv, **kw), want, "bfloat16")


# ---- sliding-window layers: the rolling decode cache -----------------------

def _rolling_valid(L: int, t: np.ndarray) -> np.ndarray:
    """The reference's validity mask of a rolling cache of L slots at
    tokens-so-far t (``attn_decode``): slot s holds position
    s + L floor((t - s) / L), valid where that is >= 0."""
    s = np.arange(L)[None]
    return s + L * ((t[:, None] - s) // L) >= 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,D", [(2, 32), (2, 256)])
def test_rolling_decode_through_the_kernel_equals_the_masked_decode(dtype, G,
                                                                    D):
    """A window layer's decode runs the decode kernel with
    kv_len = min(t + 1, L) and no window; the reference masks the rolling
    cache explicitly (``_masked_decode``). Rows at t < L - 1, t = L - 1
    and t >= L (the cache wrapped once and more)."""
    L, KV = 16, 2
    t = np.asarray([0, 3, L - 2, L - 1, L, L + 5, 3 * L + 7])
    rng = np.random.default_rng(21)
    q = rng.normal(size=(len(t), 1, KV * G, D)).astype(np.float32)
    k = rng.normal(size=(len(t), L, KV, D)).astype(np.float32)
    v = rng.normal(size=(len(t), L, KV, D)).astype(np.float32)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    cfg = jax_get_config("gemma3-12b", smoke=True)
    want = jax_attn._masked_decode(cfg, jq, jk, jv,
                                   jnp.asarray(_rolling_valid(L, t)))
    n = torch.from_numpy(np.minimum(t + 1, L).astype(np.int32))
    _close(ops.decode_attention(tq, tk, tv, kv_len=n), want, dtype)


@pytest.mark.parametrize("S", [3, 5, 8, 11, 20])
def test_rolling_prefill_cache_where_the_reference_raises(S):
    """The reference's ``_roll_window`` raises a broadcast error for a
    prompt shorter than the window W; what its docstring states (slot =
    position % W) is ``_fit(t, W)`` there, which the port builds. From
    S = W on the port equals the reference's roll."""
    W = 8
    t = np.random.default_rng(S).normal(size=(2, S, 2, 4)).astype(np.float32)
    got = attn._roll_window(torch.from_numpy(t), W).numpy()
    if S < W:
        with pytest.raises(ValueError, match="Incompatible shapes"):
            jax_attn._roll_window(jnp.asarray(t), W)
        want = jax_attn._fit(jnp.asarray(t), W)
    else:
        want = jax_attn._roll_window(jnp.asarray(t), W)
    np.testing.assert_array_equal(got, np.asarray(want))
    for p in range(max(0, S - W), S):
        np.testing.assert_array_equal(got[:, p % W], t[:, p])


# ---- MLA (deepseek-v2-236b) -------------------------------------------------

def _mla_params(seed: int):
    """The smoke config's MLA weights from numpy at the reference's init
    scales, the norm scales moved off 1 by N(0, 0.2): (jax cfg, port cfg,
    jax params, port params)."""
    cfg = jax_get_config("deepseek-v2-236b", smoke=True).replace(
        dtype="float32")
    pcfg = configs.get_config("deepseek-v2-236b", smoke=True).replace(
        dtype="float32")
    rng = np.random.default_rng(seed)

    def draw(p):
        if p.init == "ones":
            return (1 + 0.2 * rng.standard_normal(p.shape)).astype(np.float32)
        return (rng.standard_normal(p.shape)
                * p.shape[-2] ** -0.5).astype(np.float32)

    meta = attn.attn_meta(pcfg)
    flat = {n: ({"w": draw(m["w"])} if isinstance(m, dict) else draw(m))
            for n, m in meta.items()}
    jp = {n: ({"w": jnp.asarray(a["w"])} if isinstance(a, dict)
              else jnp.asarray(a)) for n, a in flat.items()}
    tp = {n: ({"w": torch.from_numpy(a["w"])} if isinstance(a, dict)
              else torch.from_numpy(a)) for n, a in flat.items()}
    return cfg, pcfg, jp, tp


def _rel(got: torch.Tensor, want, rtol=1e-4):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert float(np.abs(got.float().numpy() - want).max()) <= \
        rtol * float(np.abs(want).max())


def test_mla_prefill_equals_the_reference():
    cfg, pcfg, jp, tp = _mla_params(31)
    x = np.random.default_rng(32).normal(size=(2, 13, cfg.d_model)) \
        .astype(np.float32)
    jy, (jckv, jkr) = jax_attn._mla_apply(cfg, jp, jnp.asarray(x),
                                          jnp.arange(13))
    ty, (tckv, tkr) = attn._mla_apply(pcfg, tp, torch.from_numpy(x),
                                      torch.arange(13))
    _rel(ty, jy)
    _rel(tckv, jckv)
    _rel(tkr, jkr)


@pytest.mark.parametrize("cur_len", [5, [0, 3, 23, 7]])
def test_mla_absorbed_decode_equals_the_reference(cur_len):
    """Lock-step and ragged: the output, and the caches written in place
    at each row's position."""
    cfg, pcfg, jp, tp = _mla_params(33)
    m, B, L = cfg.mla, 4, 24
    rng = np.random.default_rng(34)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.normal(size=(B, L, m.kv_lora)).astype(np.float32)
    kr = rng.normal(size=(B, L, m.qk_rope)).astype(np.float32)
    ragged = isinstance(cur_len, list)
    jcur = jnp.asarray(cur_len, jnp.int32) if ragged else cur_len
    tcur = torch.tensor(cur_len) if ragged else cur_len
    jy, jc = jax_attn._mla_decode(cfg, jp, jnp.asarray(x),
                                  {"ckv": jnp.asarray(ckv),
                                   "kr": jnp.asarray(kr)}, jcur)
    cache = {"ckv": torch.from_numpy(ckv.copy()),
             "kr": torch.from_numpy(kr.copy())}
    ty, tc = attn._mla_decode(pcfg, tp, torch.from_numpy(x), cache, tcur)
    assert tc["ckv"] is cache["ckv"]
    _rel(ty, jy)
    _rel(tc["ckv"], jc["ckv"])
    _rel(tc["kr"], jc["kr"])


# ---- the plain version's query chunks ----------------------------------------

# (Sq, kwargs), GQA 4 | 2 heads; with q_offset the keys run Sq + offset long
CHUNK_CASES = [(Sq, kw) for Sq in (1024, 1025, 2500)
               for kw in ({"causal": True}, {"causal": True, "window": 300},
                          {"causal": True, "q_offset": 77},
                          {"causal": False})]


@pytest.mark.parametrize("Sq,kw", CHUNK_CASES)
def test_chunked_plain_equals_one_block(monkeypatch, Sq, kw):
    """The plain version over query chunks of 1,024 (with the window's key
    band) against the same function as one block of every row, float32,
    o and each row's log-sum-exp within 1e-6."""
    Skv = Sq + kw.get("q_offset", 0)
    q, k, v = map(torch.from_numpy, _qkv(1, Sq, Skv, 4, 2, 16, seed=31))
    got = fa.flash_attention_plain(q, k, v, **kw)
    got_lse = fa.flash_attention_lse_plain(q, k, v, **kw)
    monkeypatch.setattr(fa, "Q_CHUNK", 1 << 30)
    assert len(fa._chunks(Sq, Skv, kw.get("window"), 0)) == 1
    want = fa.flash_attention_plain(q, k, v, **kw)
    want_lse = fa.flash_attention_lse_plain(q, k, v, **kw)
    assert float((got - want).abs().max()) <= 1e-6
    assert float((got_lse - want_lse).abs().max()) <= 1e-6


@pytest.mark.parametrize("Sq,Skv,window,q_offset,want", [
    (1024, 1024, None, 0, [(0, 1024, 0, 1024, 0)]),
    (1025, 1025, None, 5, [(0, 1024, 0, 1025, 5), (1024, 1025, 0, 1025, 1029)]),
    # band 1024 + 300 padded to 1408, clipped into [0, Skv - band]
    (2500, 2500, 300, 0, [(0, 1024, 0, 1408, 0), (1024, 2048, 725, 2133, 299),
                          (2048, 2500, 1092, 2500, 956)]),
    # no band where the keys are not longer than it
    (2048, 1300, 300, 0, [(0, 1024, 0, 1300, 0), (1024, 2048, 0, 1300, 1024)]),
])
def test_chunks_follow_the_reference_scan(Sq, Skv, window, q_offset, want):
    """Row chunks of 1,024 and, with a window, the reference's key band:
    start = clip(offset - window + 1, 0, Skv - band)."""
    assert fa._chunks(Sq, Skv, window, q_offset) == want


@pytest.mark.parametrize("kw", [{"causal": True, "window": 300},
                                {"causal": True}])
def test_chunked_plain_vs_jax_xla_attention_past_one_chunk(kw):
    """Past one chunk (Sq = 2,500) the port's plain version against the
    reference's chunked XLA attention, float32."""
    q, k, v = _qkv(1, 2500, 2500, 4, 2, 16, seed=32)
    want = jax_ops.attention(*map(jnp.asarray, (q, k, v)), impl="xla", **kw)
    got = ops.attention(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_chunked_plain_under_a_two_by_four_mesh(tmp_path):
    """On an 8-rank gloo (2, 4) mesh (``tests/torch_mesh_worker.py``), each
    rank's shard of the batch and the heads in query chunks, gathered,
    against the one-block plain version on one device, within 1e-6."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    arrays = {}
    for i, (Sq, kw) in enumerate(CHUNK_CASES):
        if Sq == 1024:
            continue
        Skv = Sq + kw.get("q_offset", 0)
        q, k, v = _qkv(2, Sq, Skv, 4, 2, 16, seed=40 + i)
        arrays.update({f"c{i}/q": q, f"c{i}/k": k, f"c{i}/v": v,
                       f"c{i}/kw": np.array(json.dumps(kw))})
    np.savez(tmp_path / "inputs.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run(
        [sys.executable, str(root / "tests" / "torch_mesh_worker.py"),
         "--world", "8", str(tmp_path), "attention"], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    errs = json.loads((tmp_path / "result.json").read_text())["attention"]
    assert len(errs) == len(arrays) // 4 and max(errs.values()) <= 1e-6, errs
