"""Decoder-only LM: training forward and loss, prefill and decode over a
stack of blocks (counterpart of ``repro.models.transformer``).

The reference stacks each block-pattern position's parameters over
``n_repeats`` and runs one ``lax.scan``; here ``params["blocks"]`` is a
list with one dict per layer (layer ``i`` has the pattern's spec
``i % len(block_pattern)``) and the scan is a Python loop. The reference
casts the parameters on every call (``cast_params``); here they were cast
once when loaded (:func:`repro_torch.models.layers.cast_leaf`), which
gives the same numbers.

Ported: dense GQA attention blocks (RMSNorm, GLU MLP) of llama3-8b,
qwen2.5-14b and qwen1.5-110b (q/k/v bias), chameleon-34b (per-head q/k
RMSNorm) and gemma3-12b (q/k RMSNorm, GELU GLU, embeddings scaled by
sqrt(d_model) and tied, five sliding-window layers to one global); MLA
attention with MoE MLPs and shared experts of deepseek-v2-236b; the same
GQA blocks with MoE MLPs of granite-moe-3b (40 experts top-8, tied
embeddings); RWKV6 blocks (LayerNorm, time-mix, channel-mix); and the
hybrid family of jamba, whose pattern mixes Mamba and attention mixers
with dense and MoE MLPs (RMSNorm, SiLU GLU experts). :func:`check_supported`
hands encoder-decoders (whisper) to :mod:`repro_torch.models.encdec`.

Training (:func:`lm_forward`, :func:`lm_loss`) takes float32 master
parameters and casts each layer's leaves inside the layer, under
``torch.utils.checkpoint`` (the reference's per-block remat), so the
compute-dtype copies of a layer live only while it runs; the loss is the
reference's chunked cross entropy (chunks of 512 positions, each under
checkpoint) plus the MoE aux loss.

The decode cache is a flat dict of tensors, one per leaf name, whose
leading axis runs over the layers that hold the leaf. A leaf is named by
what fixes its shape (:func:`cache_names`): global attention's ``k``/
``v`` (n, B, L, KV, D) and sliding-window attention's ``kw``/``vw``
(n, B, min(W, L), KV, D) in the compute dtype; MLA's ``ckv`` (n, B, L,
kv_lora) and ``kr`` (n, B, L, qk_rope) in the compute dtype; Mamba's
``conv`` (n, B, ssm_conv - 1, Di) in the compute dtype and ``h`` (n, B,
Di, N) in float32; RWKV's ``x_tm``/``x_cm`` (n, B, d) in the compute
dtype and ``h`` (n, B, H, K, K) in float32. A layer sees its leaves under
the reference's names (``k``, ``v``, ``ckv``, ...): layer ``i`` works in
place on the contiguous slice ``[j]`` of its leaves, ``j`` its index
among the layers that hold them (:func:`cache_slots`).
:func:`cache_by_pattern` gives the reference's layout (one subtree per
pattern position ``l{j}``, each leaf stacked over the repeats), which is
how the tests compare the two leaf by leaf. A leaf name must belong to
one kind of layer and one shape: :func:`cache_leaf_kinds` raises where
two kinds share one (Mamba's and RWKV's ``h``, of other shapes) or where
windowed layers have different windows, and :func:`check_supported` and
:func:`init_cache_blocks` call it, so no config can build a cache in
which one layer would reuse a leaf of another shape.
"""
from __future__ import annotations

import collections
import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (
    is_dtensor, pick_last, shard, sharded_context,
)
from repro_torch.models import attention as attn
from repro_torch.models import encdec
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.layers import (  # noqa: F401  (DTYPES re-exported)
    DTYPES, apply_norm, cast_params, embed_meta, embed_tokens, mlp_apply,
    mlp_meta, norm_meta, unembed,
)


# cache leaves of each ported layer kind, under the reference's names
CACHE_LEAVES = {"attn": ("k", "v"), "mamba": ("conv", "h"),
                "rwkv": ("x_tm", "x_cm", "h")}


def cache_names(cfg, spec) -> dict[str, str]:
    """A layer's cache leaves: the reference's name -> the port's leaf name
    (the same but for sliding-window attention's ``kw``/``vw`` and MLA's
    ``ckv``/``kr``)."""
    if spec.kind == "attn" and cfg.mla is not None:
        return {"ckv": "ckv", "kr": "kr"}
    if spec.kind == "attn" and spec.window:
        return {"k": "kw", "v": "vw"}
    return {n: n for n in CACHE_LEAVES.get(spec.kind, ())}


def cache_leaf_kinds(cfg) -> dict[str, str]:
    """Cache leaf name -> the layer kind that owns it, for the layers of
    ``cfg``'s pattern; raises ``ValueError`` where two kinds share a name
    or windowed layers of different windows would share ``kw``/``vw``."""
    owner: dict[str, str] = {}
    for spec in cfg.block_pattern:
        for name in cache_names(cfg, spec).values():
            if owner.setdefault(name, spec.kind) != spec.kind:
                raise ValueError(
                    f"{cfg.name}: cache leaf {name!r} belongs to both "
                    f"{owner[name]!r} and {spec.kind!r} layers")
    windows = {s.window for s in cfg.block_pattern
               if s.kind == "attn" and s.window}
    if len(windows) > 1:
        raise ValueError(f"{cfg.name}: windowed layers of windows "
                         f"{sorted(windows)} would share one cache leaf")
    return owner


def check_supported(cfg) -> None:
    """Raise for the model families the port does not run; an
    encoder-decoder is :func:`encdec.check_supported`'s to judge."""
    if cfg.encdec:
        encdec.check_supported(cfg)
        return
    for spec in cfg.block_pattern:
        if spec.moe and cfg.moe is None:
            raise ValueError(f"{cfg.name}: an MoE block needs cfg.moe")
        if spec.kind in ("attn", "mamba"):
            if (cfg.norm, cfg.mlp_kind) != ("rmsnorm", "glu") \
                    or cfg.act not in ("silu", "gelu"):
                raise NotImplementedError(
                    f"{cfg.name}: attention and Mamba blocks are ported with "
                    "RMSNorm and the SiLU or GELU GLU MLP (dense or MoE) "
                    "only")
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
    """For each layer, its index among the layers that hold the same
    cache leaves (:func:`cache_names`): the slice of them that it owns."""
    seen: dict[tuple, int] = {}
    out = []
    for spec in layer_specs(cfg):
        group = tuple(cache_names(cfg, spec).values())
        out.append(seen.get(group, 0))
        seen[group] = out[-1] + 1
    return out


def cache_by_pattern(cfg, blocks: dict) -> dict:
    """The port's block cache in the reference's layout: {``l{j}``:
    {reference name: the leaf's slices of layers ``r * len(pattern) + j``
    stacked over r}} (views stacked into new tensors)."""
    n_pat = len(cfg.block_pattern)
    slots = cache_slots(cfg)
    return {f"l{j}": {ref: torch.stack([
        blocks[leaf][slots[r * n_pat + j]] for r in range(cfg.n_repeats)])
        for ref, leaf in cache_names(cfg, spec).items()}
        for j, spec in enumerate(cfg.block_pattern)}


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
    """One layer's cache leaves under the reference's names, name ->
    (shape, dtype (None for the compute dtype), logical axes)."""
    if spec.kind == "attn":
        return attn.attn_cache_meta(cfg, spec, batch, cache_len)
    if spec.kind == "mamba":
        return ssm.mamba_cache_meta(cfg, batch)
    return ssm.rwkv_cache_meta(cfg, batch)


def cache_axes(cfg) -> dict:
    """The logical axes of each block-cache leaf, (None, *the layer's
    axes): the leading axis runs over the layers that hold the leaf, as
    the reference's stacked leaves carry a leading None."""
    out = {}
    for spec in layer_specs(cfg):
        meta = _layer_cache_meta(cfg, spec, 2, 8)
        for ref, leaf in cache_names(cfg, spec).items():
            out[leaf] = (None, *meta[ref][2])
    return out


def init_cache_blocks(cfg, batch: int, cache_len: int, dtype: torch.dtype,
                      device) -> dict:
    """Zeroed decode-cache leaves for ``batch`` rows (see the module
    docstring for the layout: each leaf name belongs to one kind of layer
    and one shape, :func:`cache_leaf_kinds`)."""
    cache_leaf_kinds(cfg)
    specs = layer_specs(cfg)
    counts = collections.Counter(tuple(cache_names(cfg, s).values())
                                 for s in specs)
    blocks = {}
    for spec in specs:
        names = cache_names(cfg, spec)
        if names and next(iter(names.values())) in blocks:
            continue
        n = counts[tuple(names.values())]
        for ref, (shape, dt, _) in _layer_cache_meta(cfg, spec, batch,
                                                     cache_len).items():
            blocks[names[ref]] = torch.zeros((n, *shape), dtype=dt or dtype,
                                             device=device)
    return blocks


def _mlp_prefill(cfg, spec, lp, h, cache):
    if spec.moe:
        return moe.moe_apply(cfg, lp["mlp"], h)[0]
    if cfg.mlp_kind == "rwkv":
        cache["x_cm"] = h[:, -1]
        return ssm.rwkv_cm_apply(cfg, lp["mlp"], h)
    return mlp_apply(cfg, lp["mlp"], h)


def _apply_layer_prefill(cfg, spec, lp, x, positions, cache_len):
    h = apply_norm(cfg, lp["ln1"], x)
    if spec.kind == "attn":
        mix, cache = attn.attn_prefill(cfg, spec, lp["mix"], h, positions,
                                       cache_len)
    elif spec.kind == "mamba":
        mix, cache = ssm.mamba_apply(cfg, lp["mix"], h, return_cache=True)
    else:
        mix, cache = ssm.rwkv_apply(cfg, lp["mix"], h, return_cache=True)
    x = shard(x + mix, "batch", "seq", None)
    out = _mlp_prefill(cfg, spec, lp, apply_norm(cfg, lp["ln2"], x), cache)
    return shard(x + out, "batch", "seq", None), cache


def _apply_layer_train(cfg, spec, lp, x, positions, aux):
    """One layer of the training forward: (x, aux + the layer's MoE aux)."""
    h = apply_norm(cfg, lp["ln1"], x)
    if spec.kind == "attn":
        mix = attn.attn_apply(cfg, spec, lp["mix"], h, positions)
    elif spec.kind == "mamba":
        mix = ssm.mamba_apply(cfg, lp["mix"], h)
    else:
        mix = ssm.rwkv_apply(cfg, lp["mix"], h)
    x = shard(x + mix, "batch", "seq", None)
    h = apply_norm(cfg, lp["ln2"], x)
    if spec.moe:
        out, a = moe.moe_apply(cfg, lp["mlp"], h)
        aux = aux + a
    elif cfg.mlp_kind == "rwkv":
        out = ssm.rwkv_cm_apply(cfg, lp["mlp"], h)
    else:
        out = mlp_apply(cfg, lp["mlp"], h)
    return shard(x + out, "batch", "seq", None), aux


def _train_block(cfg, spec, lp, x, positions, aux):
    """:func:`_apply_layer_train` on the layer's leaves cast to x's dtype
    (the reference's ``cast_params`` of the stacked tree). On a mesh the
    residual saved at the layer boundary (sequence-sharded under the train
    rules) is gathered first, as the reference's remat'd block recovers
    it."""
    lp = cast_params(lp, x.dtype, stacked=True)
    x = shard(x, "batch", "seq", None)
    return _apply_layer_train(cfg, spec, lp, x, positions, aux)


def lm_forward(cfg, params, tokens: torch.Tensor, *, remat: bool = True):
    """Training forward: tokens (B, S) -> (hidden (B, S, d) after the final
    norm, aux loss float32). With ``remat`` (and grad enabled) each layer
    runs under ``torch.utils.checkpoint(use_reentrant=False)``: only its
    input is kept, and the backward runs it again."""
    dtype = DTYPES[cfg.dtype]
    S = tokens.shape[1]
    x = embed_tokens(cfg, cast_params(params["embed"], dtype), tokens, dtype)
    x = shard(x, "batch", "seq", None)
    positions = torch.arange(S, device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat and torch.is_grad_enabled()
    for spec, lp in zip(layer_specs(cfg), params["blocks"]):
        fn = functools.partial(_train_block, cfg, spec)
        x, aux = (checkpoint(fn, lp, x, positions, aux, use_reentrant=False)
                  if remat else fn(lp, x, positions, aux))
        # sequence-parallel layer boundary: the residual saved for the
        # backward is sharded over the model axis under the train rules
        x = shard(x, "batch", "seq_block", None)
    x = shard(x, "batch", "seq", None)
    return apply_norm(cfg, params["ln_f"], x), aux


def lm_logits(cfg, params, hidden: torch.Tensor) -> torch.Tensor:
    """Logits of ``hidden`` (B, S, d) in the compute dtype."""
    return unembed(cfg, cast_params(params["embed"], DTYPES[cfg.dtype]),
                   hidden)


def label_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each row's logit at its label (labels < 0 read index 0). Under a
    sharding context on a mesh the logits' vocab dim may be sharded, which
    DTensor's gather does not take in every torch version; there each rank
    picks from its own block of the vocab
    (:func:`repro_torch.distributed.sharding.pick_last`)."""
    idx = labels.long().clamp_min(0)
    if sharded_context() and is_dtensor(logits):
        return pick_last(logits, idx)
    return torch.gather(logits, -1, idx[..., None])[..., 0]


def _chunk_loss(cfg, emb, h, lab):
    """(sum of the chunk's cross entropies over labels >= 0, their count)."""
    logits = shard(unembed(cfg, emb, h).float(), "batch", "seq", "vocab")
    lse = torch.logsumexp(logits, dim=-1)
    ll = label_logits(logits, lab)
    valid = (lab >= 0).float()
    return torch.sum((lse - ll) * valid), valid.sum()


def lm_loss(cfg, params, tokens: torch.Tensor, labels: torch.Tensor, *,
            chunk: int = 512, remat: bool = True) -> torch.Tensor:
    """Chunked softmax cross entropy (the (B, S, V) logits never exist at
    once): the sequence in chunks of ``chunk`` positions (labels padded
    with -1), each chunk's logits in float32 under checkpoint with
    ``remat``; mean over the labels >= 0, plus the aux loss."""
    hidden, aux = lm_forward(cfg, params, tokens, remat=remat)
    emb = cast_params(params["embed"], DTYPES[cfg.dtype])
    B, S, d = hidden.shape
    C = min(chunk, S)
    n = -(-S // C)
    pad = n * C - S
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    remat = remat and torch.is_grad_enabled()
    fn = functools.partial(_chunk_loss, cfg, emb)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        h, lab = hidden[:, i * C:(i + 1) * C], labels[:, i * C:(i + 1) * C]
        t, c = (checkpoint(fn, h, lab, use_reentrant=False) if remat
                else fn(h, lab))
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp_min(cnt, 1.0) + aux


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
    x = shard(x + mix, "batch", "seq", None)
    h = apply_norm(cfg, lp["ln2"], x)
    if spec.moe:
        out, _ = moe.moe_apply(cfg, lp["mlp"], h)
    elif cfg.mlp_kind == "rwkv":
        out = ssm.rwkv_cm_decode(cfg, lp["mlp"], h, cache["x_cm"])
        cache["x_cm"].copy_(h[:, 0])
    else:
        out = mlp_apply(cfg, lp["mlp"], h)
    return shard(x + out, "batch", "seq", None)


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
        for ref, leaf in cache_names(cfg, spec).items():
            leaves.setdefault(leaf, []).append(c[ref])
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
        cache = {ref: blocks[leaf][j]
                 for ref, leaf in cache_names(cfg, spec).items()}
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
