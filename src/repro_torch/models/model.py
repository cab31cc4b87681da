"""Model interface: build once, then init, train, prefill and decode
(counterpart of ``repro.models.model``).

:class:`Model` holds a config and a device; parameters are a separate tree
(as in the reference) passed to every call. :meth:`Model.init` draws them
on the model's device from a seeded ``torch.Generator``;
:func:`params_from_jax` carries the reference's ``Model.init`` tree across
(as numpy arrays), which is how the tests hold the two packages to the
same weights. For serving, every leaf is held as the reference's per-call
``cast_params`` gives it (:func:`repro_torch.models.layers.cast_leaf`):
each float32 leaf of the blocks, and each float32 matrix outside them, in
the config's compute dtype; the final norm's vectors in float32. For
training (``masters=True``) every leaf stays float32, and
:meth:`Model.forward` and :meth:`Model.loss` cast each layer's leaves
inside the layer, as the reference's ``cast_params`` does on every call.

Decoder-only families run through :mod:`repro_torch.models.transformer`,
the encoder-decoder (whisper) through :mod:`repro_torch.models.encdec`;
its batches carry ``frames`` (B, S_enc, d) beside ``tokens``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (
    P, cast_leaf, cast_params, init_params, map_tree, meta_axes, tree_leaves,
)

# the parts of a parameter tree that hold one dict per layer, which the
# reference stacks over the layers (or repeats) before it casts
STACKED = ("blocks", *ed.STACKED)


def _by_part(fn, tree: dict) -> dict:
    """``fn(subtree, stacked)`` over the parts of a model tree: ``stacked``
    for the per-layer parts (:data:`STACKED`)."""
    return {name: fn(sub, name in STACKED) for name, sub in tree.items()}


class Model:
    """A decoder-only LM or an encoder-decoder of ``cfg`` on ``device`` (the
    card unless the caller passes ``device="cpu"``)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        tf.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = tf.DTYPES[cfg.dtype]

    # ---- parameters ----
    def param_meta(self):
        if self.cfg.encdec:
            return ed.encdec_meta(self.cfg)
        return tf.lm_meta(self.cfg)

    def init(self, seed: int = 0, *, masters: bool = False):
        """Random weights with the reference's init scales, drawn tensor by
        tensor on the model's device from a ``torch.Generator`` seeded with
        ``seed`` (a leaf over 2 GiB in float32, as jamba's expert stacks,
        slice by slice: :func:`~repro_torch.models.layers.init_params`).
        With ``masters`` every leaf stays float32 (training's master
        weights); else each is cast as the reference's ``cast_params``."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        dtype = torch.float32 if masters else self.dtype
        return _by_part(lambda meta, stacked: init_params(
            meta, generator, dtype, stacked=stacked), self.param_meta())

    def param_axes(self):
        """Tree of the parameters' logical-axes tuples (one per layer in
        the per-layer lists, without the reference's leading stack None)."""
        return meta_axes(self.param_meta())

    def abstract_params(self, dtype: torch.dtype | None = None):
        """Meta tensors shaped as :meth:`init`'s leaves, nothing drawn:
        float32 masters for ``dtype=None``, else each leaf as
        :func:`~repro_torch.models.layers.cast_leaf` casts it to
        ``dtype``."""
        def part(meta, stacked):
            return map_tree(lambda p: cast_leaf(
                torch.empty(p.shape, device="meta"), dtype or torch.float32,
                stacked), meta)
        return _by_part(part, self.param_meta())

    def n_params(self) -> int:
        return sum(math.prod(p.shape) for p in tree_leaves(self.param_meta()))

    def weight_bytes(self) -> int:
        """Bytes of the parameters as :meth:`init` holds them (each leaf in
        the dtype :func:`~repro_torch.models.layers.cast_leaf` gives it),
        from the metadata alone: nothing is drawn."""
        def part(meta, stacked):
            return sum(cast_leaf(torch.empty(p.shape, device="meta"),
                                 self.dtype, stacked).nbytes
                       for p in tree_leaves(meta))
        return sum(_by_part(part, self.param_meta()).values())

    def cache_bytes(self, batch: int, cache_len: int) -> int:
        """Bytes of :meth:`init_cache`'s leaves, from their shapes alone."""
        leaves = self._cache_leaves(batch, cache_len, "meta")
        return sum(t.nbytes for t in leaves.values())

    # ---- caches ----
    def _cache_part(self) -> str:
        return "dec" if self.cfg.encdec else "blocks"

    def cache_axes(self) -> dict:
        """Logical axes of the cache tree (``cur_len`` replicated)."""
        axes = (ed.encdec_cache_axes(self.cfg) if self.cfg.encdec
                else tf.cache_axes(self.cfg))
        return {self._cache_part(): axes, "cur_len": ()}

    def cache_meta(self, batch: int, cache_len: int) -> dict:
        """The cache leaves as :class:`~repro_torch.models.layers.P`
        (shape, logical axes, zeros), ``cur_len`` left out."""
        axes = self.cache_axes()[self._cache_part()]
        leaves = self._cache_leaves(batch, cache_len, "meta")
        return {self._cache_part(): {
            n: P(tuple(t.shape), axes[n], "zeros") for n, t in leaves.items()}}

    def abstract_cache(self, batch: int, cache_len: int) -> dict:
        """Meta tensors shaped as :meth:`init_cache`'s leaves, and a meta
        int32 ``cur_len``."""
        return {self._cache_part(): self._cache_leaves(batch, cache_len,
                                                       "meta"),
                "cur_len": torch.empty((), dtype=torch.int32, device="meta")}

    def _cache_leaves(self, batch: int, cache_len: int, device) -> dict:
        if self.cfg.encdec:
            return {name: torch.zeros(shape, dtype=self.dtype, device=device)
                    for name, shape in ed.encdec_cache_meta(
                        self.cfg, batch, cache_len).items()}
        return tf.init_cache_blocks(self.cfg, batch, cache_len, self.dtype,
                                    device)

    def init_cache(self, batch: int, cache_len: int) -> dict:
        """Zeroed decode cache for ``batch`` rows: an LM's ``blocks``, each
        kind of layer with its own leaves (:func:`transformer.init_cache_blocks`;
        ``cache_len`` sizes the attention leaves only, min(W, cache_len) for
        a window of W), or an encoder-decoder's ``dec`` leaves
        (:func:`encdec.encdec_cache_meta`)."""
        return {self._cache_part(): self._cache_leaves(batch, cache_len,
                                                       self.device),
                "cur_len": 0}

    # ---- entry points ----
    def forward(self, params, batch: dict):
        """Training forward: batch {"tokens"[, "frames"]} -> (hidden (B, S,
        d), aux loss), each layer rematerialised in the backward."""
        if self.cfg.encdec:
            return ed.encdec_forward(self.cfg, params, batch["frames"],
                                     batch["tokens"])
        return tf.lm_forward(self.cfg, params, batch["tokens"])

    def loss(self, params, batch: dict) -> torch.Tensor:
        """Mean next-token cross entropy over the labels >= 0, plus the MoE
        aux loss: batch {"tokens", "labels"[, "frames"]}."""
        if self.cfg.encdec:
            hidden, aux = self.forward(params, batch)
            return _hidden_loss(self.cfg, params, hidden,
                                batch["labels"]) + aux
        return tf.lm_loss(self.cfg, params, batch["tokens"], batch["labels"])

    def prefill(self, params, batch: dict, *, cache_len: int | None = None):
        """batch {"tokens": (B, S) integer tensor on the model's device[,
        "frames": (B, S_enc, d) for an encoder-decoder]} -> (last-position
        logits (B, V), cache of length ``cache_len``)."""
        if self.cfg.encdec:
            return ed.encdec_prefill(
                self.cfg, params, batch["frames"], batch["tokens"],
                cache_len=cache_len or batch["tokens"].shape[1])
        return tf.lm_prefill(self.cfg, params, batch["tokens"],
                             cache_len=cache_len)

    def decode_step(self, params, cache: dict, tokens: torch.Tensor):
        """tokens (B, 1) -> (logits (B, V), cache one longer); the cache
        tensors are updated in place."""
        if self.cfg.encdec:
            return ed.encdec_decode_step(self.cfg, params, cache, tokens)
        return tf.lm_decode_step(self.cfg, params, cache, tokens)

    def decode_step_ragged(self, params, blocks: dict, tokens: torch.Tensor,
                           kv_len: torch.Tensor):
        """Continuous-batching decode over a batched block cache: ``kv_len``
        (B,) per-slot tokens-so-far on the model's device; the cache rows
        are updated in place. Decoder-only models only (the
        encoder-decoder cache keeps its lock-step scalar)."""
        if self.cfg.encdec:
            raise NotImplementedError(
                "ragged decode requires a decoder-only cache layout")
        return tf.lm_decode_step_ragged(self.cfg, params, blocks, tokens,
                                        kv_len)

    def insert_prefill(self, blocks: dict, one_blocks: dict,
                       slot: int) -> dict:
        """Copy a batch-1 prefill cache (leaves (n, 1, ...)) into row
        ``slot`` of a batched block cache, every leaf, in place; the other
        rows are untouched."""
        for name, big in blocks.items():
            big[:, slot].copy_(one_blocks[name][:, 0])
        return blocks


    # ---- dry-run stand-ins ----
    def input_specs(self, shape) -> dict:
        """Meta tensors standing in for every model input of ``shape`` (a
        ``configs.ShapeConfig``), as the reference's ``input_specs``: an
        encoder-decoder's batches carry ``seq_len`` frames and
        max(seq_len // dec_ratio, 8) tokens; decode is one token a row."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def tok(*s):
            return torch.empty(s, dtype=torch.int32, device="meta")

        def emb(*s):
            return torch.empty(s, dtype=self.dtype, device="meta")
        if shape.kind == "decode":
            return {"tokens": tok(B, 1)}
        if cfg.encdec:
            Sd = max(S // cfg.dec_ratio, 8)
            out = {"frames": emb(B, S, cfg.d_model), "tokens": tok(B, Sd)}
        else:
            out = {"tokens": tok(B, S)}
        if shape.kind == "train":
            out["labels"] = tok(*out["tokens"].shape)
        return out


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg, device)


def _hidden_loss(cfg, params, hidden, labels):
    """Cross entropy of the logits of ``hidden`` over the labels >= 0, in
    one piece (the reference's ``_hidden_loss``)."""
    logits = tf.lm_logits(cfg, params, hidden).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = tf.label_logits(logits, labels)
    valid = (labels >= 0).float()
    return torch.sum((lse - ll) * valid) / torch.clamp_min(valid.sum(), 1.0)


def params_from_jax(cfg: ModelConfig, tree, device="cuda", *,
                    masters: bool = False):
    """The reference's ``Model.init`` tree (nested dicts; leaves numpy
    arrays, or any array numpy can read) -> the port's parameter tree on
    ``device``.

    The reference stacks each block-pattern position ``l{j}`` over
    ``n_repeats``; layer ``r * len(block_pattern) + j`` of the port is
    slice ``r`` of ``l{j}`` (an encoder-decoder's ``enc`` and ``dec``,
    stacked over their layers: layer ``i`` is slice ``i``). Leaves are
    cast as :meth:`Model.init` casts them (the reference's ``cast_params``
    of the stacked tree), or, with ``masters``, kept float32.
    """
    tf.check_supported(cfg)
    dev = resolve_device(device)

    def to_torch(a):
        return torch.from_numpy(np.array(a)).to(dev)

    def layers(stack, n):
        return [map_tree(lambda a, i=i: to_torch(np.asarray(a)[i]), stack)
                for i in range(n)]

    if cfg.encdec:
        depth = {"enc": cfg.n_enc_layers, "dec": cfg.n_layers}
        params = {name: (layers(sub, depth[name]) if name in depth
                         else map_tree(to_torch, sub))
                  for name, sub in tree.items()}
    else:
        n_pat = len(cfg.block_pattern)
        blocks = []
        for r in range(cfg.n_repeats):
            for j in range(n_pat):
                blocks.append(map_tree(
                    lambda a, r=r: to_torch(np.asarray(a)[r]),
                    tree["blocks"][f"l{j}"]))
        params = {"embed": map_tree(to_torch, tree["embed"]),
                  "blocks": blocks, "ln_f": map_tree(to_torch, tree["ln_f"])}
    if masters:
        return params
    dtype = tf.DTYPES[cfg.dtype]
    return _by_part(lambda sub, stacked: cast_params(sub, dtype,
                                                     stacked=stacked), params)
