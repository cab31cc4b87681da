"""Attention mixers: GQA, sliding-window and MLA (DeepSeek-V2), prefill and
decode (counterpart of ``repro.models.attention``).

Two entry modes per layer:
  * prefill: full forward through :func:`repro_torch.kernels.ops.attention`
    (the flash kernel on the card), returning the layer's decode cache;
  * decode: one new token against the cache.

GQA layers project q, k and v through :func:`_project_qkv`, as the
reference does: the optional q/k/v bias (qwen2.5, whisper) is added to the
compute-dtype product, the heads are split, the optional per-head q/k
RMSNorm over D (chameleon, gemma3) runs, then RoPE where ``cfg.pos`` is
``"rope"`` (whisper's sinusoidal positions are added to the embeddings
instead, :mod:`repro_torch.models.encdec`). Their decode goes
through :func:`repro_torch.kernels.ops.decode_attention` (the decode
kernel).

A sliding-window layer (``spec.window = W``, gemma3's local layers) keeps
a rolling cache of L = min(W, cache_len) entries, position p at slot
p % L. Prefill runs flash with the window; when cache_len >= W the cache
holds the last W keys at slot ``position % W`` (:func:`_roll_window`).
For a prompt shorter than W that is positions 0..S-1 at slots 0..S-1
with zeros after, which is what the reference's docstring states; the
reference's ``_roll_window`` raises there instead (a broadcast error for
S < W), a difference that ``tests/test_torch_attention.py`` pins. Decode
writes the token at slot ``cur_len % L`` and runs the decode kernel with
``kv_len = min(cur_len + 1, L)`` and no window: the reference's
``_masked_decode`` keeps slots 0..t while t < L and all L slots after,
which is the same set, and keys carry their RoPE positions already, so
the order of the slots does not change the softmax.

MLA (deepseek-v2) projects q through a low-rank ``wq_a``/``wq_b`` and
keeps a compressed cache: the normed 512-d latent ``ckv`` (B, L,
kv_lora) and the shared RoPE key ``kr`` (B, L, qk_rope). Prefill expands
k and v from the latent and runs flash at D = qk_nope + qk_rope, Dv =
v_head with the scale (qk_nope + qk_rope) ** -0.5. Decode is the
reference's absorbed-matrix attention over the latent, plain ``torch``
einsums on every device: the reference computes it with einsums outside
any Pallas kernel, so there is no kernel of it to port.

The reference's decode returns a new cache (JAX donates the old one);
here the new token's entries are written into the cache tensors in place
(``index_put_`` for the ragged per-row insert) and the same tensors are
returned. A cache laid out on a mesh (a DTensor, sequence-sharded under
the serve rules) is written shard by shard: each rank writes the
positions it holds (:func:`repro_torch.distributed.sharding.write_at`).

The ``shard()`` constraints sit where the reference's do (q and k after
the projection, the prefill cache, the decode cache after its update,
MLA's expanded q and k and its latent cache); outside a sharding context
or on a mesh of one device each returns its argument.

:func:`attn_apply` is the training forward: :func:`attn_prefill` without
the cache.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import (
    merge_last, shard, split_last, write_at,
)
from repro_torch.kernels import ops
from repro_torch.models.layers import P, apply_norm, norm_meta, rope

NEG_INF = -1e30


def check_supported(cfg, spec) -> None:
    """Raise for the attention variants neither package runs."""
    if cfg.mla is not None and spec.window:
        raise NotImplementedError(
            f"{cfg.name}: MLA with a sliding window is in neither package")


def attn_meta(cfg) -> dict:
    d, H, KV, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.mla is not None:
        m = cfg.mla
        return {"wq_a": P((d, m.q_lora), ("embed", "lora")),
                "q_norm": norm_meta(cfg, m.q_lora),
                "wq_b": P((m.q_lora, H * (m.qk_nope + m.qk_rope)),
                          ("lora", "heads")),
                "wkv_a": P((d, m.kv_lora + m.qk_rope), ("embed", None)),
                "kv_norm": norm_meta(cfg, m.kv_lora),
                "wkv_b": P((m.kv_lora, H * (m.qk_nope + m.v_head)),
                           ("lora", "heads")),
                "wo": P((H * m.v_head, d), ("heads", "embed"))}
    meta = {"wq": P((d, H * D), ("embed", "heads")),
            "wk": P((d, KV * D), ("embed", "kv_heads")),
            "wv": P((d, KV * D), ("embed", "kv_heads")),
            "wo": P((H * D, d), ("heads", "embed"))}
    if cfg.qkv_bias:
        meta["bq"] = P((H * D,), ("heads",), "zeros")
        meta["bk"] = P((KV * D,), ("kv_heads",), "zeros")
        meta["bv"] = P((KV * D,), ("kv_heads",), "zeros")
    if cfg.qk_norm:
        meta["qn"] = norm_meta(cfg, D)
        meta["kn"] = norm_meta(cfg, D)
    return meta


def attn_cache_meta(cfg, spec, batch: int, cache_len: int) -> dict:
    """One attention layer's cache leaves, under the reference's names:
    name -> (shape, dtype (None for the compute dtype), logical axes)."""
    if cfg.mla is not None:
        m = cfg.mla
        axes = ("batch", "kv_seq", None)
        return {"ckv": ((batch, cache_len, m.kv_lora), None, axes),
                "kr": ((batch, cache_len, m.qk_rope), None, axes)}
    L = min(spec.window, cache_len) if spec.window else cache_len
    shape = (batch, L, cfg.n_kv_heads, cfg.head_dim)
    axes = ("batch", "kv_seq", "kv_heads", None)
    return {"k": (shape, None, axes), "v": (shape, None, axes)}


def _project_qkv(cfg, p, x, positions):
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q, k, v = split_last(q, H, D), split_last(k, KV, D), split_last(v, KV, D)
    if cfg.qk_norm:
        q = apply_norm(cfg, p["qn"], q)
        k = apply_norm(cfg, p["kn"], k)
    if cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


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


def _roll_window(t: torch.Tensor, W: int) -> torch.Tensor:
    """The rolling cache of a (B, S, ...) prefill: its last W entries at
    slot = position % W. For S < W that is positions 0..S-1 at slots
    0..S-1 and zeros after (:func:`_fit`)."""
    S = t.shape[1]
    if S <= W:
        return _fit(t, W)
    # position S - W + i goes to slot (S - W + i) % W = (i + S) % W
    return torch.roll(t[:, S - W:], shifts=S % W, dims=1).contiguous()


def _positions(cur_len, B: int, device):
    """(ragged, slot-or-length, positions (B, 1)) for ``cur_len``, an int
    (lock-step) or a (B,) integer tensor (ragged slots)."""
    ragged = isinstance(cur_len, torch.Tensor) and cur_len.ndim == 1
    if ragged:
        cur = cur_len.to(torch.int64)
        return True, cur, cur[:, None]
    cur = int(cur_len)
    return False, cur, torch.full((B, 1), cur, dtype=torch.int64,
                                  device=device)


def _insert(cache: torch.Tensor, new: torch.Tensor, slot, ragged: bool):
    """Write ``new`` (B, ...) at ``slot`` (an int, or one per row) of a
    (B, L, ...) cache, in place (shard by shard for a DTensor cache)."""
    if write_at(cache, new, slot, ragged):
        return
    if ragged:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache.index_put_((rows, slot), new)
    else:
        cache[:, slot] = new


def attn_apply(cfg, spec, p, x, positions):
    """Full-sequence (training) attention: the prefill's output, no cache."""
    if cfg.mla is not None:
        return _mla_apply(cfg, p, x, positions)[0]
    q, k, v = _project_qkv(cfg, p, x, positions)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    o = ops.attention(q, k, v, causal=True, window=spec.window)
    return merge_last(o) @ p["wo"]


def attn_prefill(cfg, spec, p, x, positions, cache_len: int):
    """Forward + this layer's decode cache (length ``cache_len``, or
    min(W, cache_len) for a window of W)."""
    if cfg.mla is not None:
        y, (ckv, kr) = _mla_apply(cfg, p, x, positions)
        return y, {n: shard(_fit(c, cache_len), "batch", "kv_seq", None)
                   for n, c in (("ckv", ckv), ("kr", kr))}
    q, k, v = _project_qkv(cfg, p, x, positions)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    o = ops.attention(q, k, v, causal=True, window=spec.window)
    y = merge_last(o) @ p["wo"]
    if spec.window and cache_len >= spec.window:
        cache = {"k": _roll_window(k, spec.window),
                 "v": _roll_window(v, spec.window)}
    else:
        cache = {"k": _fit(k, cache_len), "v": _fit(v, cache_len)}
    cache = {n: shard(c, "batch", "kv_seq", "kv_heads", None)
             for n, c in cache.items()}
    return y, cache


def attn_decode(cfg, spec, p, x, cache, cur_len):
    """One-token decode. x: (B, 1, d); ``cache`` this layer's leaves
    (``k``/``v`` (B, L, KV, D), or MLA's ``ckv``/``kr``), updated in place.

    ``cur_len`` is the tokens-so-far count: an int (lock-step, every row
    at the same position) or a (B,) integer tensor on x's device
    (continuous batching, each row at its own length). The new token sits
    at position ``cur_len``: at cache slot ``cur_len`` (``cur_len % L`` in
    a rolling cache), and the decode kernel reads ``cur_len + 1`` entries
    (``min(cur_len + 1, L)``).
    """
    if cfg.mla is not None:
        return _mla_decode(cfg, p, x, cache, cur_len)
    B = x.shape[0]
    ragged, cur, pos = _positions(cur_len, B, x.device)
    q, k, v = _project_qkv(cfg, p, x, pos)
    ck, cv = cache["k"], cache["v"]
    L = ck.shape[1]
    slot = cur % L if spec.window else cur
    _insert(ck, k[:, 0], slot, ragged)
    _insert(cv, v[:, 0], slot, ragged)
    ck = shard(ck, "batch", "kv_seq", "kv_heads", None)
    cv = shard(cv, "batch", "kv_seq", "kv_heads", None)
    n = cur + 1
    if spec.window:
        n = torch.clamp(n, max=L) if ragged else min(n, L)
    kv_len = (n.to(torch.int32) if ragged else
              torch.full((B,), n, dtype=torch.int32, device=x.device))
    o = ops.decode_attention(q, ck, cv, kv_len=kv_len)
    y = merge_last(o) @ p["wo"]
    return y, cache


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank compressed KV cache, absorbed decode
# --------------------------------------------------------------------------

def _mla_project(cfg, p, x, positions):
    m = cfg.mla
    H = cfg.n_heads
    cq = apply_norm(cfg, p["q_norm"], x @ p["wq_a"])
    q = split_last(cq @ p["wq_b"], H, m.qk_nope + m.qk_rope)
    q_nope, q_rope = q[..., :m.qk_nope], q[..., m.qk_nope:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    kv = x @ p["wkv_a"]
    ckv = apply_norm(cfg, p["kv_norm"], kv[..., :m.kv_lora])
    kr = rope(kv[..., m.kv_lora:][:, :, None], positions,
              cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, ckv, kr


def _mla_apply(cfg, p, x, positions):
    """Prefill MLA: k and v expanded from the compressed latent, flash at
    D = qk_nope + qk_rope, Dv = v_head. Returns (y, (ckv, kr))."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope, ckv, kr = _mla_project(cfg, p, x, positions)
    kvb = split_last(ckv @ p["wkv_b"], H, m.qk_nope + m.v_head)
    k_nope, v = kvb[..., :m.qk_nope], kvb[..., m.qk_nope:].contiguous()
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr[:, :, None].expand(B, S, H, m.qk_rope)],
                  dim=-1)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "heads", None)
    scale = (m.qk_nope + m.qk_rope) ** -0.5
    o = ops.attention(q, k, v, causal=True, scale=scale)
    y = merge_last(o) @ p["wo"]
    return y, (ckv, kr)


def _mla_decode(cfg, p, x, cache, cur_len):
    """Absorbed-matrix decode over the latent: ``wkv_b``'s key half folded
    into q, scores against ``ckv`` and ``kr`` in float32, the softmax's
    weights applied to ``ckv`` and then ``wkv_b``'s value half. ``cur_len``
    as in :func:`attn_decode`; the cache is written in place."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    ragged, cur, pos = _positions(cur_len, B, x.device)
    q_nope, q_rope, ckv_t, kr_t = _mla_project(cfg, p, x, pos)
    ckv, kr = cache["ckv"], cache["kr"]
    _insert(ckv, ckv_t[:, 0], cur, ragged)
    _insert(kr, kr_t[:, 0], cur, ragged)
    ckv = shard(ckv, "batch", "kv_seq", None)
    kr = shard(kr, "batch", "kv_seq", None)
    wkv_b = split_last(p["wkv_b"], H, m.qk_nope + m.v_head)
    wk = wkv_b[..., :m.qk_nope]            # (lora, H, nope)
    wv = wkv_b[..., m.qk_nope:]            # (lora, H, v)
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0], wk)
    scale = (m.qk_nope + m.qk_rope) ** -0.5
    ckv_f = ckv.float()
    s = (torch.einsum("bhl,bsl->bhs", q_lat.float(), ckv_f)
         + torch.einsum("bhr,bsr->bhs", q_rope[:, 0].float(),
                        kr.float())) * scale
    k_pos = torch.arange(ckv.shape[1], device=x.device)
    bound = cur[:, None, None] if ragged else cur
    s = s.masked_fill(~(k_pos[None, None, :] <= bound), NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsl->bhl", pr, ckv_f)
    o = torch.einsum("bhl,lhv->bhv", o_lat.to(x.dtype), wv)
    y = merge_last(o[:, None]) @ p["wo"]
    return y, cache
