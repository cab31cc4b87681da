"""Decoder-only LM: prefill and decode over a stack of blocks (counterpart
of ``repro.models.transformer``).

The reference stacks each block-pattern position's parameters over
``n_repeats`` and runs one ``lax.scan``; here ``params["blocks"]`` is a
list with one dict per layer (layer ``i`` has the pattern's spec
``i % len(block_pattern)``) and the scan is a Python loop. The reference
casts the parameters on every call (``cast_params``); here they were cast
once when loaded (:func:`repro_torch.models.layers.cast_leaf`), which
gives the same numbers.

Ported: dense GQA attention blocks (RMSNorm, SiLU GLU MLP) of llama3-8b,
qwen2.5-14b (q/k/v bias) and chameleon-34b (per-head q/k RMSNorm); the
same blocks with MoE MLPs of granite-moe-3b (40 experts top-8, tied
embeddings); RWKV6 blocks (LayerNorm, time-mix, channel-mix); and the
hybrid family of jamba, whose pattern mixes Mamba and attention mixers
with dense and MoE MLPs (RMSNorm, SiLU GLU experts). Embeddings are
unscaled, untied or tied. Other layers and variants (sliding windows,
MLA, shared experts, scaled embeddings, encoder-decoders) raise
``NotImplementedError``.

The decode cache is a flat dict of tensors, one per leaf name, whose
leading axis runs over the layers of the kind that owns the leaf:
attention's ``k``/``v`` (n_attn, B, L, KV, D) in the compute dtype,
Mamba's ``conv`` (n_mamba, B, ssm_conv - 1, Di) in the compute dtype and
``h`` (n_mamba, B, Di, N) in float32, RWKV's ``x_tm``/``x_cm`` (n_rwkv,
B, d) in the compute dtype and ``h`` (n_rwkv, B, H, K, K) in float32.
Layer ``i`` works in place on the contiguous slice ``[j]`` of its kind's
leaves, ``j`` its index among the layers of that kind
(:func:`cache_slots`). The names are not qualified by kind, so a name
must belong to one kind of a config's pattern: :func:`cache_leaf_kinds`
raises where two kinds share one (Mamba's and RWKV's ``h``, of other
shapes), and :func:`check_supported` and :func:`init_cache_blocks` call
it, so no config can build a cache in which one kind's layers would
reuse another kind's leaf.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.layers import (
    apply_norm, embed_meta, embed_tokens, mlp_apply, mlp_meta, norm_meta,
    unembed,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}

# cache leaves of each ported layer kind
CACHE_LEAVES = {"attn": ("k", "v"), "mamba": ("conv", "h"),
                "rwkv": ("x_tm", "x_cm", "h")}


def cache_leaf_kinds(cfg) -> dict[str, str]:
    """Cache leaf name -> the layer kind that owns it, for the kinds of
    ``cfg``'s pattern; raises ``ValueError`` where two kinds share a
    name."""
    owner: dict[str, str] = {}
    for kind in dict.fromkeys(spec.kind for spec in cfg.block_pattern):
        for name in CACHE_LEAVES.get(kind, ()):
            if owner.setdefault(name, kind) != kind:
                raise ValueError(
                    f"{cfg.name}: cache leaf {name!r} belongs to both "
                    f"{owner[name]!r} and {kind!r} layers")
    return owner


def check_supported(cfg) -> None:
    """Raise for the model families the port does not run yet."""
    if cfg.encdec:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are "
                                  "not ported yet")
    if cfg.embed_scale:
        raise NotImplementedError(
            f"{cfg.name}: scaled embeddings are not ported yet")
    for spec in cfg.block_pattern:
        if spec.moe:
            if cfg.moe is None:
                raise ValueError(f"{cfg.name}: an MoE block needs cfg.moe")
            if cfg.moe.n_shared:
                raise NotImplementedError(
                    f"{cfg.name}: shared experts are not ported yet")
        if spec.kind in ("attn", "mamba"):
            if (cfg.norm, cfg.mlp_kind, cfg.act) != ("rmsnorm", "glu", "silu"):
                raise NotImplementedError(
                    f"{cfg.name}: attention and Mamba blocks are ported with "
                    "RMSNorm and the SiLU GLU MLP (dense or MoE) only")
            if spec.kind == "attn":
                attn.check_supported(cfg, spec)
        elif spec.kind == "rwkv":
            if (cfg.norm, cfg.mlp_kind) != ("layernorm", "rwkv") or spec.moe:
                raise NotImplementedError(
                    f"{cfg.name}: RWKV blocks are ported with LayerNorm and "
                    "the RWKV channel-mix only")
        else:
            raise NotImplementedError(f"{cfg.name}: {spec.kind} blocks are "
                                      "not ported yet")
    cache_leaf_kinds(cfg)


def layer_specs(cfg) -> list:
    return [cfg.block_pattern[i % len(cfg.block_pattern)]
            for i in range(cfg.n_layers)]


def cache_slots(cfg) -> list[int]:
    """For each layer, its index among the layers of its kind: the slice
    of its kind's cache leaves that it owns."""
    seen: dict[str, int] = {}
    out = []
    for spec in layer_specs(cfg):
        out.append(seen.get(spec.kind, 0))
        seen[spec.kind] = out[-1] + 1
    return out


_MIXER_META = {"attn": attn.attn_meta, "mamba": ssm.mamba_meta,
               "rwkv": ssm.rwkv_meta}


def _block_meta(cfg, spec) -> dict:
    if spec.moe:
        mlp = moe.moe_meta(cfg)
    elif cfg.mlp_kind == "rwkv":
        mlp = ssm.rwkv_cm_meta(cfg)
    else:
        mlp = mlp_meta(cfg)
    return {"ln1": norm_meta(cfg), "mix": _MIXER_META[spec.kind](cfg),
            "ln2": norm_meta(cfg), "mlp": mlp}


def lm_meta(cfg) -> dict:
    check_supported(cfg)
    return {"embed": embed_meta(cfg),
            "blocks": [_block_meta(cfg, spec) for spec in layer_specs(cfg)],
            "ln_f": norm_meta(cfg)}


def _layer_cache_meta(cfg, spec, batch: int, cache_len: int) -> dict:
    """One layer's cache leaves, name -> (shape, dtype; None for the
    compute dtype)."""
    if spec.kind == "attn":
        shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": (shape, None), "v": (shape, None)}
    if spec.kind == "mamba":
        return ssm.mamba_cache_meta(cfg, batch)
    return ssm.rwkv_cache_meta(cfg, batch)


def init_cache_blocks(cfg, batch: int, cache_len: int, dtype: torch.dtype,
                      device) -> dict:
    """Zeroed decode-cache leaves for ``batch`` rows (see the module
    docstring for the layout: each leaf name belongs to one layer kind,
    :func:`cache_leaf_kinds`)."""
    owner = cache_leaf_kinds(cfg)
    blocks = {}
    specs = layer_specs(cfg)
    for kind in dict.fromkeys(s.kind for s in specs):
        spec = next(s for s in specs if s.kind == kind)
        n = sum(s.kind == kind for s in specs)
        for name, (shape, dt) in _layer_cache_meta(cfg, spec, batch,
                                                   cache_len).items():
            assert owner[name] == kind, (name, kind)
            blocks[name] = torch.zeros((n, *shape), dtype=dt or dtype,
                                       device=device)
    return blocks


def _mlp_prefill(cfg, spec, lp, h, cache):
    if spec.moe:
        return moe.moe_apply(cfg, lp["mlp"], h)[0]
    if cfg.mlp_kind == "rwkv":
        cache["x_cm"] = h[:, -1]
        return ssm.rwkv_cm_apply(cfg, lp["mlp"], h)
    return mlp_apply(lp["mlp"], h)


def _apply_layer_prefill(cfg, spec, lp, x, positions, cache_len):
    h = apply_norm(cfg, lp["ln1"], x)
    if spec.kind == "attn":
        mix, cache = attn.attn_prefill(cfg, spec, lp["mix"], h, positions,
                                       cache_len)
    elif spec.kind == "mamba":
        mix, cache = ssm.mamba_apply(cfg, lp["mix"], h, return_cache=True)
    else:
        mix, cache = ssm.rwkv_apply(cfg, lp["mix"], h, return_cache=True)
    x = x + mix
    return x + _mlp_prefill(cfg, spec, lp, apply_norm(cfg, lp["ln2"], x),
                            cache), cache


def _apply_layer_decode(cfg, spec, lp, x, cache, cur_len):
    """One token through one layer; ``cache`` (this layer's slices) is
    updated in place."""
    h = apply_norm(cfg, lp["ln1"], x)
    if spec.kind == "attn":
        mix, _ = attn.attn_decode(cfg, spec, lp["mix"], h, cache, cur_len)
    elif spec.kind == "mamba":
        mix, _ = ssm.mamba_decode(cfg, lp["mix"], h, cache)
    else:
        mix, _ = ssm.rwkv_decode(cfg, lp["mix"], h, cache)
    x = x + mix
    h = apply_norm(cfg, lp["ln2"], x)
    if spec.moe:
        out, _ = moe.moe_apply(cfg, lp["mlp"], h)
    elif cfg.mlp_kind == "rwkv":
        out = ssm.rwkv_cm_decode(cfg, lp["mlp"], h, cache["x_cm"])
        cache["x_cm"].copy_(h[:, 0])
    else:
        out = mlp_apply(lp["mlp"], h)
    return x + out


def lm_prefill(cfg, params, tokens: torch.Tensor, *,
               cache_len: int | None = None):
    """tokens (B, S) -> (last-position logits (B, V), cache)."""
    dtype = DTYPES[cfg.dtype]
    B, S = tokens.shape
    cache_len = cache_len or S
    x = embed_tokens(cfg, params["embed"], tokens, dtype)
    positions = torch.arange(S, device=tokens.device)
    leaves: dict[str, list] = {}
    for spec, lp in zip(layer_specs(cfg), params["blocks"]):
        x, c = _apply_layer_prefill(cfg, spec, lp, x, positions, cache_len)
        for name in CACHE_LEAVES[spec.kind]:
            leaves.setdefault(name, []).append(c[name])
    x = apply_norm(cfg, params["ln_f"], x)
    logits = unembed(cfg, params["embed"], x[:, -1:])[:, 0]
    return logits, {"blocks": {n: torch.stack(ts) for n, ts in leaves.items()},
                    "cur_len": S}


def _lm_decode_blocks(cfg, params, blocks, tokens, cur_len):
    """Shared decode body: one token per row against the block caches,
    written in place. ``cur_len`` is an int (lock-step) or a (B,) tensor
    (ragged slots), as in :func:`attention.attn_decode`; the state-space
    layers do not read it."""
    dtype = DTYPES[cfg.dtype]
    x = embed_tokens(cfg, params["embed"], tokens, dtype)
    for spec, j, lp in zip(layer_specs(cfg), cache_slots(cfg),
                           params["blocks"]):
        cache = {n: blocks[n][j] for n in CACHE_LEAVES[spec.kind]}
        x = _apply_layer_decode(cfg, spec, lp, x, cache, cur_len)
    x = apply_norm(cfg, params["ln_f"], x)
    logits = unembed(cfg, params["embed"], x[:, -1:])[:, 0]
    return logits, blocks


def lm_decode_step(cfg, params, cache, tokens):
    """tokens: (B, 1). Returns (logits (B, V), cache at cur_len + 1)."""
    cur_len = cache["cur_len"]
    logits, blocks = _lm_decode_blocks(cfg, params, cache["blocks"], tokens,
                                       cur_len)
    return logits, {"blocks": blocks, "cur_len": cur_len + 1}


def lm_decode_step_ragged(cfg, params, blocks, tokens, kv_len):
    """Continuous-batching decode: every slot at its own cache length.

    ``blocks`` is the batched block cache (no ``cur_len``: the scheduler
    owns per-slot occupancy on the host), ``tokens`` (B, 1), ``kv_len``
    (B,) integer tokens-so-far per slot, on the cache's device. Returns
    (logits (B, V), blocks); the caller advances its own lengths.
    """
    return _lm_decode_blocks(cfg, params, blocks, tokens, kv_len)
