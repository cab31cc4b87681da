"""Whisper-style encoder-decoder backbone (counterpart of
``repro.models.encdec``).

The audio frontend (mel + conv downsampling) is a stub, as in the
reference: callers pass precomputed frame embeddings ``frames`` (B, S_enc,
d); the encoder projects them (``enc_in``), adds sinusoidal positions and
runs ``n_enc_layers`` bidirectional blocks. The decoder is a causal
transformer with per-layer cross attention over the encoder states.

Parameters: ``embed``, ``enc_in``, ``enc`` (a list, one dict per encoder
layer: ``ln1``, ``attn``, ``ln2``, ``mlp``), ``ln_enc``, ``dec`` (one dict
per decoder layer: ``ln1``, ``attn``, ``lnx``, ``xattn``, ``ln2``,
``mlp``) and ``ln_f``; the reference stacks ``enc`` and ``dec`` over their
layers. LayerNorm, the plain MLP (biases, GELU), MHA with q/k/v biases and
no RoPE.

Every attention call goes through :mod:`repro_torch.kernels.ops`: the
encoder's self-attention and the decoder's cross attention as
``ops.attention(causal=False)``, the decoder's self-attention as
``ops.attention(causal=True)`` in prefill and training, and as
``ops.decode_attention`` with ``kv_len = cur_len + 1`` in decode, whose
cross attention is ``ops.attention`` with Sq = 1 against the encoder's
``cross_seq`` states, as the reference's.

The decode cache is lock-step, as the reference's: ``{"dec": {"k", "v",
"xk", "xv"}, "cur_len": int}``, each leaf stacked over the decoder layers
like the reference's (``k``/``v`` (n, B, cache_len, H, D) the
self-attention cache, ``xk``/``xv`` (n, B, S_enc, H, D) the cross keys
and values, computed once at prefill). Decode writes the new token's k, v
into the cache in place.

Training (:func:`encdec_forward`) takes float32 master parameters and
casts each layer's leaves to the compute dtype inside the layer
(:func:`repro_torch.models.layers.cast_params`), which gives the numbers of
the reference's per-call ``cast_params``; with ``remat`` each layer runs
under ``torch.utils.checkpoint``. Serving takes parameters cast once at
load (:meth:`repro_torch.models.model.Model.init`), on which the casts are
no-ops.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (
    merge_last, shard, split_last, write_at,
)
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    DTYPES, P, apply_norm, cast_params, embed_meta, embed_tokens, mlp_apply,
    mlp_meta, norm_meta, sincos_positions, unembed,
)

# the parts of the parameter tree that hold one dict per layer (stacked in
# the reference, so every float32 leaf of theirs is cast)
STACKED = ("enc", "dec")


def check_supported(cfg) -> None:
    """Raise for encoder-decoder variants neither package runs: the blocks
    are whisper's (LayerNorm, plain MLP, MHA without RoPE)."""
    if (cfg.norm, cfg.mlp_kind) != ("layernorm", "plain"):
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoders are ported with LayerNorm and the "
            "plain MLP only")
    if cfg.n_kv_heads != cfg.n_heads or cfg.mla is not None or cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoders are ported with MHA only")


def _xattn_meta(cfg) -> dict:
    d, H, D = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {"wq": P((d, H * D), ("embed", "heads")),
            "wk": P((d, H * D), ("embed", "heads")),
            "wv": P((d, H * D), ("embed", "heads")),
            "wo": P((H * D, d), ("heads", "embed"))}


def encdec_meta(cfg) -> dict:
    enc_layer = {"ln1": norm_meta(cfg), "attn": attn.attn_meta(cfg),
                 "ln2": norm_meta(cfg), "mlp": mlp_meta(cfg)}
    dec_layer = {"ln1": norm_meta(cfg), "attn": attn.attn_meta(cfg),
                 "lnx": norm_meta(cfg), "xattn": _xattn_meta(cfg),
                 "ln2": norm_meta(cfg), "mlp": mlp_meta(cfg)}
    return {"embed": embed_meta(cfg),
            "enc_in": P((cfg.d_model, cfg.d_model), ("embed", None)),
            "enc": [enc_layer] * cfg.n_enc_layers,
            "ln_enc": norm_meta(cfg),
            "dec": [dec_layer] * cfg.n_layers,
            "ln_f": norm_meta(cfg)}


def encdec_cache_meta(cfg, batch: int, cache_len: int) -> dict:
    """The decode cache's leaves, name -> shape (compute dtype), each
    stacked over the decoder layers."""
    H, D, n = cfg.n_heads, cfg.head_dim, cfg.n_layers
    return {"k": (n, batch, cache_len, H, D), "v": (n, batch, cache_len, H, D),
            "xk": (n, batch, cfg.cross_seq, H, D),
            "xv": (n, batch, cfg.cross_seq, H, D)}


def encdec_cache_axes(cfg) -> dict:
    """The logical axes of :func:`encdec_cache_meta`'s leaves, the leading
    layer axis None (the reference's stacked leaves)."""
    self_kv = (None, "batch", "kv_seq", "heads", None)
    cross_kv = (None, "batch", None, "heads", None)
    return {"k": self_kv, "v": self_kv, "xk": cross_kv, "xv": cross_kv}


def _layers(fn, x, layers, remat: bool):
    """``x = fn(layer, x)`` over ``layers``, each under
    ``torch.utils.checkpoint`` when ``remat`` and grad is enabled."""
    remat = remat and torch.is_grad_enabled()
    for lp in layers:
        x = (checkpoint(fn, lp, x, use_reentrant=False) if remat
             else fn(lp, x))
    return x


def _enc_block(cfg, lp, x):
    lp = cast_params(lp, x.dtype, stacked=True)
    x = shard(x, "batch", "seq", None)
    h = apply_norm(cfg, lp["ln1"], x)
    q, k, v = attn._project_qkv(cfg, lp["attn"], h, None)
    o = ops.attention(q, k, v, causal=False)
    x = x + merge_last(o) @ lp["attn"]["wo"]
    h = apply_norm(cfg, lp["ln2"], x)
    return shard(x + mlp_apply(cfg, lp["mlp"], h), "batch", "seq_block", None)


def encode(cfg, params, frames: torch.Tensor, *,
           remat: bool = True) -> torch.Tensor:
    """frames (B, S_enc, d) stub embeddings -> encoder states (B, S_enc, d)
    in the compute dtype."""
    dtype = DTYPES[cfg.dtype]
    B, S, d = frames.shape
    x = frames.to(dtype) @ params["enc_in"].to(dtype)
    x = x + sincos_positions(S, d, device=x.device).to(dtype)[None]
    x = shard(x, "batch", "seq", None)
    x = _layers(functools.partial(_enc_block, cfg), x, params["enc"], remat)
    return apply_norm(cfg, params["ln_enc"], shard(x, "batch", "seq", None))


def _cross_kv(cfg, lp, enc):
    H, D = cfg.n_heads, cfg.head_dim
    k = split_last(enc @ lp["xattn"]["wk"], H, D)
    v = split_last(enc @ lp["xattn"]["wv"], H, D)
    return k, v


def _cross(cfg, lp, x, xk, xv):
    """The decoder layer's cross attention and MLP on x (B, S, d)."""
    h = apply_norm(cfg, lp["lnx"], x)
    q = split_last(h @ lp["xattn"]["wq"], cfg.n_heads, cfg.head_dim)
    o = ops.attention(q, xk, xv, causal=False)
    x = x + merge_last(o) @ lp["xattn"]["wo"]
    h = apply_norm(cfg, lp["ln2"], x)
    return shard(x + mlp_apply(cfg, lp["mlp"], h), "batch", "seq", None)


def _dec_prefill_layer(cfg, lp, x, enc):
    """One decoder layer over the whole sequence: (x, (k, v, xk, xv))."""
    xk, xv = _cross_kv(cfg, lp, enc)
    h = apply_norm(cfg, lp["ln1"], x)
    q, k, v = attn._project_qkv(cfg, lp["attn"], h, None)
    o = ops.attention(q, k, v, causal=True)
    x = x + merge_last(o) @ lp["attn"]["wo"]
    return _cross(cfg, lp, x, xk, xv), (k, v, xk, xv)


def _dec_train_block(cfg, lp, x, enc):
    lp = cast_params(lp, x.dtype, stacked=True)
    x = shard(x, "batch", "seq", None)
    return shard(_dec_prefill_layer(cfg, lp, x, enc)[0],
                 "batch", "seq_block", None)


def _embed_dec(cfg, params, tokens, offset: int = 0):
    dtype = DTYPES[cfg.dtype]
    embed = cast_params(params["embed"], dtype)
    x = embed_tokens(cfg, embed, tokens, dtype)
    S = tokens.shape[1]
    return x + sincos_positions(S, cfg.d_model, offset,
                                device=x.device).to(dtype)[None]


def encdec_forward(cfg, params, frames, tokens, *, remat: bool = True):
    """Training forward. Returns (decoder hidden (B, S_dec, d), aux = 0)."""
    enc = encode(cfg, params, frames, remat=remat)
    x = _embed_dec(cfg, params, tokens)

    def block(lp, x):
        return _dec_train_block(cfg, lp, x, enc)

    x = shard(_layers(block, x, params["dec"], remat), "batch", "seq", None)
    return (apply_norm(cfg, params["ln_f"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def encdec_prefill(cfg, params, frames, tokens, *, cache_len: int):
    """Encode + decoder prefill. Returns (last logits (B, V), cache)."""
    enc = encode(cfg, params, frames, remat=False)
    x = _embed_dec(cfg, params, tokens)
    leaves = {"k": [], "v": [], "xk": [], "xv": []}
    for lp in params["dec"]:
        lp = cast_params(lp, x.dtype, stacked=True)
        x, (k, v, xk, xv) = _dec_prefill_layer(cfg, lp, x, enc)
        for name, t in (("k", attn._fit(k, cache_len)),
                        ("v", attn._fit(v, cache_len)), ("xk", xk),
                        ("xv", xv)):
            leaves[name].append(t)
    x = apply_norm(cfg, params["ln_f"], x)
    logits = unembed(cfg, params["embed"], x[:, -1:])[:, 0]
    return logits, {"dec": {n: torch.stack(ts) for n, ts in leaves.items()},
                    "cur_len": tokens.shape[1]}


def encdec_decode_step(cfg, params, cache, tokens):
    """tokens (B, 1) -> (logits (B, V), cache at cur_len + 1); the cache's
    self-attention leaves are written in place."""
    cur_len = int(cache["cur_len"])
    x = _embed_dec(cfg, params, tokens, offset=cur_len)
    B = tokens.shape[0]
    c = cache["dec"]
    kv_len = torch.full((B,), cur_len + 1, dtype=torch.int32, device=x.device)
    for i, lp in enumerate(params["dec"]):
        lp = cast_params(lp, x.dtype, stacked=True)
        h = apply_norm(cfg, lp["ln1"], x)
        q, k, v = attn._project_qkv(cfg, lp["attn"], h, None)
        ck, cv = c["k"][i], c["v"][i]
        for cache, new in ((ck, k[:, 0]), (cv, v[:, 0])):
            if not write_at(cache, new, cur_len, False):
                cache[:, cur_len] = new
        ck = shard(ck, "batch", "kv_seq", "heads", None)
        cv = shard(cv, "batch", "kv_seq", "heads", None)
        o = ops.decode_attention(q, ck, cv, kv_len=kv_len)
        x = x + merge_last(o) @ lp["attn"]["wo"]
        x = _cross(cfg, lp, x, c["xk"][i], c["xv"][i])
    x = apply_norm(cfg, params["ln_f"], x)
    logits = unembed(cfg, params["embed"], x[:, -1:])[:, 0]
    return logits, {"dec": c, "cur_len": cur_len + 1}
