"""Serving-step factories: prefill and single-token decode under shardings
(counterpart of ``repro.serve.serve_step``).

Decode is the latency-critical path the paper's AI-tax analysis targets:
the KV cache is updated in place (the reference donates it) and
sequence-sharded under the serve rules, so the cache softmax reduces over
a sharded axis, each rank holding a slice of the keys.

There is no jit. Each factory returns an eager function that runs the
model under ``use_sharding(mesh, rules)``: on a mesh of more than one
device its parameters, cache and tokens are DTensors laid out by
:class:`ServeShardings`, and DTensor propagates the layouts op by op; on a
mesh of one device (one card) every tensor stays plain and the kernels
run as they do outside any mesh. Capturing the decode step in a CUDA graph
is separate work (the decode step as one device program).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from repro_torch.distributed import sharding as shd


@dataclass(frozen=True)
class ServeShardings:
    params: Any
    cache: Any
    mesh: Any
    rules: shd.Rules


def make_serve_shardings(model, mesh, batch: int, cache_len: int,
                         rules: shd.Rules | None = None) -> ServeShardings:
    """The :class:`~repro_torch.distributed.sharding.NamedSharding` of every
    parameter (as :meth:`Model.init` holds them) and cache leaf of a
    ``batch`` x ``cache_len`` decode cache, under ``rules`` (the serve
    rules by default)."""
    rules = rules or shd.SERVE_RULES
    psh = shd.tree_shardings(model.param_axes(),
                             model.abstract_params(model.dtype), mesh, rules)
    csh = shd.tree_shardings(model.cache_axes(),
                             model.abstract_cache(batch, cache_len), mesh,
                             rules)
    return ServeShardings(psh, csh, mesh, rules)


def make_prefill(model, sh: ServeShardings, cache_len: int):
    """``prefill(params, batch) -> (logits, cache)`` under ``sh``; the cache
    comes back laid out by ``sh.cache``."""
    def prefill(params, batch):
        with shd.use_sharding(sh.mesh, sh.rules):
            logits, cache = model.prefill(params, batch, cache_len=cache_len)
            return logits, shd.lay_out_tree(cache, sh.cache)
    return prefill


def make_decode_step(model, sh: ServeShardings):
    """``decode_step(params, cache, tokens) -> (logits, cache)`` under
    ``sh``; the cache is written in place."""
    def decode_step(params, cache, tokens):
        with shd.use_sharding(sh.mesh, sh.rules):
            return model.decode_step(params, cache, tokens)
    return decode_step


def placed_decode_step(model, sh: ServeShardings, batch: int):
    """The counterpart of the reference's ``jit_decode_step``: the decode
    step of ``sh`` with the tokens laid out by ``("batch", None)`` and the
    logits by ``("batch", "vocab")`` (its in/out shardings), the cache
    laid out by ``sh.cache`` and updated in place (its donation)."""
    tok_sh = shd.NamedSharding(sh.mesh, shd.spec_for(
        ("batch", None), (batch, 1), sh.mesh, sh.rules))
    logit_sh = shd.NamedSharding(sh.mesh, shd.spec_for(
        ("batch", "vocab"), (batch, model.cfg.vocab_size), sh.mesh,
        sh.rules))
    step = make_decode_step(model, sh)

    def decode_step(params, cache, tokens):
        logits, cache = step(params, cache, shd.lay_out(tokens, tok_sh))
        with shd.use_sharding(sh.mesh, sh.rules):
            return shd.lay_out(logits, logit_sh), cache
    return decode_step
