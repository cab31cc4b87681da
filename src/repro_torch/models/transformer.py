"""Decoder-only LM: prefill and decode over a stack of dense blocks
(counterpart of ``repro.models.transformer``).

The reference stacks each block-pattern position's parameters over
``n_repeats`` and runs one ``lax.scan``; here ``params["blocks"]`` is a
list with one dict per layer (layer ``i`` has the pattern's spec
``i % len(block_pattern)``) and the scan is a Python loop. The reference
casts the parameters on every call (``cast_params``); here they were cast
once when loaded (:func:`repro_torch.models.layers.cast_params`), which
gives the same numbers. The decode cache is ``{"k", "v"}`` tensors of
shape (n_layers, B, L, KV, D); layer ``i`` works on the contiguous view
``[i]``. Dense GQA blocks of the llama family only (RMSNorm, SiLU GLU
MLP, untied embeddings): other layers and variants raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    embed_meta, embed_tokens, mlp_apply, mlp_meta, norm_meta, rmsnorm,
    unembed,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def check_supported(cfg) -> None:
    """Raise for the model families the port does not run yet."""
    if cfg.encdec:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are "
                                  "not ported yet")
    if (cfg.norm, cfg.mlp_kind, cfg.act) != ("rmsnorm", "glu", "silu") \
            or cfg.tie_embeddings or cfg.embed_scale:
        raise NotImplementedError(
            f"{cfg.name}: only RMSNorm, the SiLU GLU MLP and untied, unscaled "
            "embeddings are ported yet")
    for spec in cfg.block_pattern:
        if spec.kind != "attn" or spec.moe:
            raise NotImplementedError(
                f"{cfg.name}: {spec.kind}{' + MoE' if spec.moe else ''} "
                "blocks are not ported yet")
        attn.check_supported(cfg, spec)


def layer_specs(cfg) -> list:
    return [cfg.block_pattern[i % len(cfg.block_pattern)]
            for i in range(cfg.n_layers)]


def lm_meta(cfg) -> dict:
    check_supported(cfg)
    block = {"ln1": norm_meta(cfg), "mix": attn.attn_meta(cfg),
             "ln2": norm_meta(cfg), "mlp": mlp_meta(cfg)}
    return {"embed": embed_meta(cfg),
            "blocks": [block for _ in range(cfg.n_layers)],
            "ln_f": norm_meta(cfg)}


def _apply_layer_prefill(cfg, spec, lp, x, positions, cache_len):
    h = rmsnorm(x, lp["ln1"]["w"])
    mix, cache = attn.attn_prefill(cfg, spec, lp["mix"], h, positions,
                                   cache_len)
    x = x + mix
    return x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"]["w"])), cache


def _apply_layer_decode(cfg, spec, lp, x, cache, cur_len):
    h = rmsnorm(x, lp["ln1"]["w"])
    mix, _ = attn.attn_decode(cfg, spec, lp["mix"], h, cache, cur_len)
    x = x + mix
    return x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"]["w"]))


def lm_prefill(cfg, params, tokens: torch.Tensor, *,
               cache_len: int | None = None):
    """tokens (B, S) -> (last-position logits (B, V), cache)."""
    dtype = DTYPES[cfg.dtype]
    B, S = tokens.shape
    cache_len = cache_len or S
    x = embed_tokens(params["embed"], tokens, dtype)
    positions = torch.arange(S, device=tokens.device)
    ks, vs = [], []
    for spec, lp in zip(layer_specs(cfg), params["blocks"]):
        x, c = _apply_layer_prefill(cfg, spec, lp, x, positions, cache_len)
        ks.append(c["k"])
        vs.append(c["v"])
    x = rmsnorm(x, params["ln_f"]["w"])
    logits = unembed(params["embed"], x[:, -1:])[:, 0]
    return logits, {"blocks": {"k": torch.stack(ks), "v": torch.stack(vs)},
                    "cur_len": S}


def _lm_decode_blocks(cfg, params, blocks, tokens, cur_len):
    """Shared decode body: one token per row against the block caches,
    written in place. ``cur_len`` is an int (lock-step) or a (B,) tensor
    (ragged slots), as in :func:`attention.attn_decode`."""
    dtype = DTYPES[cfg.dtype]
    x = embed_tokens(params["embed"], tokens, dtype)
    for i, (spec, lp) in enumerate(zip(layer_specs(cfg), params["blocks"])):
        cache = {"k": blocks["k"][i], "v": blocks["v"][i]}
        x = _apply_layer_decode(cfg, spec, lp, x, cache, cur_len)
    x = rmsnorm(x, params["ln_f"]["w"])
    logits = unembed(params["embed"], x[:, -1:])[:, 0]
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
