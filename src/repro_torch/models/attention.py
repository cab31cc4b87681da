"""GQA attention layer: prefill and decode (counterpart of
``repro.models.attention``).

Two entry modes per layer:
  * prefill: full forward through :func:`repro_torch.kernels.ops.attention`
    (the flash kernel on the card), returning the layer's decode cache;
  * decode: one new token against the cache through
    :func:`repro_torch.kernels.ops.decode_attention` (the decode kernel).

The reference's decode returns a new cache (JAX donates the old one);
here the new token's K and V are written into the cache tensors in place
(``index_put_`` for the ragged per-row insert) and the same tensors are
returned. Sliding-window layers (rolling caches) and MLA are not ported
yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import P, rope


def check_supported(cfg, spec) -> None:
    """Raise for the attention variants the port does not run yet."""
    if cfg.mla is not None:
        raise NotImplementedError(f"{cfg.name}: MLA attention is not ported yet")
    if spec.window:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window attention (rolling decode cache) is "
            "not ported yet")
    if cfg.qkv_bias or cfg.qk_norm or cfg.pos != "rope":
        raise NotImplementedError(
            f"{cfg.name}: q/k/v bias, q/k norm and non-RoPE positions are not "
            "ported yet")


def attn_meta(cfg) -> dict:
    d, H, KV, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": P((d, H * D)), "wk": P((d, KV * D)), "wv": P((d, KV * D)),
            "wo": P((H * D, d))}


def _project_qkv(cfg, p, x, positions):
    B, S, _ = x.shape
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, D)
    k = (x @ p["wk"]).reshape(B, S, KV, D)
    v = (x @ p["wv"]).reshape(B, S, KV, D)
    return rope(q, positions, cfg.rope_theta), rope(k, positions,
                                                    cfg.rope_theta), v


def _fit(t: torch.Tensor, L: int) -> torch.Tensor:
    """Pad with zeros or trim (keeping the last L) a (B, S, ...) tensor to
    cache length L along axis 1."""
    S = t.shape[1]
    if S == L:
        return t
    if S > L:
        return t[:, -L:].contiguous()
    out = t.new_zeros((t.shape[0], L, *t.shape[2:]))
    out[:, :S] = t
    return out


def attn_prefill(cfg, spec, p, x, positions, cache_len: int):
    """Forward + this layer's decode cache (length ``cache_len``)."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    o = ops.attention(q, k, v, causal=True, window=spec.window)
    B, S = x.shape[:2]
    y = o.reshape(B, S, -1) @ p["wo"]
    return y, {"k": _fit(k, cache_len), "v": _fit(v, cache_len)}


def attn_decode(cfg, spec, p, x, cache, cur_len):
    """One-token decode. x: (B, 1, d); ``cache`` {"k", "v"} (B, L, KV, D),
    updated in place.

    ``cur_len`` is the tokens-so-far count: an int (lock-step, every row
    at the same position) or a (B,) integer tensor on x's device
    (continuous batching, each row at its own length). The new token goes
    to position ``cur_len`` of its row, and the decode kernel reads
    ``cur_len + 1`` entries.
    """
    B = x.shape[0]
    H, D = cfg.n_heads, cfg.head_dim
    ragged = isinstance(cur_len, torch.Tensor) and cur_len.ndim == 1
    if ragged:
        slot = cur_len.to(torch.int64)
        pos = slot[:, None]
    else:
        slot = int(cur_len)
        pos = torch.full((B, 1), slot, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, pos)
    ck, cv = cache["k"], cache["v"]
    if ragged:
        rows = torch.arange(B, device=x.device)
        ck.index_put_((rows, slot), k[:, 0])
        cv.index_put_((rows, slot), v[:, 0])
        kv_len = (slot + 1).to(torch.int32)
    else:
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]
        kv_len = torch.full((B,), slot + 1, dtype=torch.int32, device=x.device)
    o = ops.decode_attention(q, ck, cv, kv_len=kv_len)
    y = o.reshape(B, 1, H * D) @ p["wo"]
    return y, cache
