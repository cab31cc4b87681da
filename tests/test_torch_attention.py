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


# ---- dispatch and arguments --------------------------------------------------

def test_cpu_tensors_take_the_plain_attention_and_count_no_launch():
    before = (fa.flash_attention.launches, da.decode_attention.launches)
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 8, 4, 2, 16))
    ops.attention(q, k, v)
    ops.decode_attention(q[:, :1], k, v, kv_len=torch.tensor([3]))
    assert (fa.flash_attention.launches, da.decode_attention.launches) \
        == before


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
