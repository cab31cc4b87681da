"""Model interface: build once, then init, prefill and decode (counterpart of
``repro.models.model``).

:class:`Model` holds a config and a device; parameters are a separate tree
(as in the reference) passed to every call. :meth:`Model.init` draws them
on the model's device from a seeded ``torch.Generator``;
:func:`params_from_jax` carries the reference's ``Model.init`` tree across
(as numpy arrays), which is how the tests hold the two packages to the
same weights. Either way every leaf is held as the reference's per-call
``cast_params`` gives it (:func:`repro_torch.models.layers.cast_leaf`):
each float32 leaf of the blocks, and each float32 matrix outside them, in
the config's compute dtype; the final norm's vectors in float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (
    cast_leaf, cast_params, init_params, map_tree, tree_leaves,
)


def _by_part(fn, tree: dict) -> dict:
    """``fn(subtree, stacked)`` over the parts of an LM tree: ``stacked``
    for the blocks, whose leaves the reference stacks over ``n_repeats``."""
    return {name: fn(sub, name == "blocks") for name, sub in tree.items()}


class Model:
    """A decoder-only LM of ``cfg`` on ``device`` (the card unless the
    caller passes ``device="cpu"``)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        tf.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = tf.DTYPES[cfg.dtype]

    # ---- parameters ----
    def param_meta(self):
        return tf.lm_meta(self.cfg)

    def init(self, seed: int = 0):
        """Random weights with the reference's init scales, drawn tensor by
        tensor on the model's device from a ``torch.Generator`` seeded with
        ``seed`` (a leaf over 2 GiB in float32, as jamba's expert stacks,
        slice by slice: :func:`~repro_torch.models.layers.init_params`)."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        return _by_part(lambda meta, stacked: init_params(
            meta, generator, self.dtype, stacked=stacked), self.param_meta())

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
        blocks = tf.init_cache_blocks(self.cfg, batch, cache_len, self.dtype,
                                      "meta")
        return sum(t.nbytes for t in blocks.values())

    # ---- caches ----
    def init_cache(self, batch: int, cache_len: int) -> dict:
        """Zeroed decode cache for ``batch`` rows, each kind of layer with
        its own leaves (:func:`transformer.init_cache_blocks`); ``cache_len``
        sizes the attention leaves only (min(W, cache_len) for a window of
        W)."""
        return {"blocks": tf.init_cache_blocks(self.cfg, batch, cache_len,
                                               self.dtype, self.device),
                "cur_len": 0}

    # ---- entry points ----
    def prefill(self, params, batch: dict, *, cache_len: int | None = None):
        """batch {"tokens": (B, S) integer tensor on the model's device} ->
        (last-position logits (B, V), cache of length ``cache_len``)."""
        return tf.lm_prefill(self.cfg, params, batch["tokens"],
                             cache_len=cache_len)

    def decode_step(self, params, cache: dict, tokens: torch.Tensor):
        """tokens (B, 1) -> (logits (B, V), cache one longer); the cache
        tensors are updated in place."""
        return tf.lm_decode_step(self.cfg, params, cache, tokens)

    def decode_step_ragged(self, params, blocks: dict, tokens: torch.Tensor,
                           kv_len: torch.Tensor):
        """Continuous-batching decode over a batched block cache: ``kv_len``
        (B,) per-slot tokens-so-far on the model's device; the cache rows
        are updated in place."""
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


def params_from_jax(cfg: ModelConfig, tree, device="cuda"):
    """The reference's ``Model.init`` tree (nested dicts; leaves numpy
    arrays, or any array numpy can read) -> the port's parameter tree on
    ``device``.

    The reference stacks each block-pattern position ``l{j}`` over
    ``n_repeats``; layer ``r * len(block_pattern) + j`` of the port is
    slice ``r`` of ``l{j}``. Leaves are cast as :meth:`Model.init` casts
    them (the reference's ``cast_params`` of the stacked tree).
    """
    tf.check_supported(cfg)
    dev = resolve_device(device)

    def to_torch(a):
        return torch.from_numpy(np.array(a)).to(dev)

    n_pat = len(cfg.block_pattern)
    blocks = []
    for r in range(cfg.n_repeats):
        for j in range(n_pat):
            blocks.append(map_tree(lambda a, r=r: to_torch(np.asarray(a)[r]),
                                   tree["blocks"][f"l{j}"]))
    params = {"embed": map_tree(to_torch, tree["embed"]), "blocks": blocks,
              "ln_f": map_tree(to_torch, tree["ln_f"])}
    dtype = tf.DTYPES[cfg.dtype]
    return _by_part(lambda sub, stacked: cast_params(sub, dtype,
                                                     stacked=stacked), params)
