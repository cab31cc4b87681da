"""Mixture-of-Experts MLP with capacity-based, sort-free gather dispatch
(counterpart of ``repro.models.moe``).

Dispatch is per example: the reference vmaps it over the batch, here the
batch axis is written out, and each example has its own per-expert
capacity C = ceil4(S * top_k / E * capacity_factor), at least 4, from
its raw length S (C = 4 at decode, S = 1). Pooling the slots of a decode
batch into one capacity would change which tokens drop. Tokens beyond
capacity are dropped (Switch/GShard semantics): within an expert,
positions follow a stable argsort of the flat (token, k) expert ids, so
the earlier tokens keep their places. The router's top-k takes the
largest probabilities with ties to the lower expert index, as
``jax.lax.top_k`` does. The expert contractions are plain batched
products (``torch.einsum``), as the reference leaves them to XLA: there
is no kernel of this module. Every expert runs on its whole (B, C, d)
slice of the dispatch buffer, so a decode tick reads every expert's
weights.

With ``n_shared > 0`` (deepseek-v2) a shared GLU of width
``d_expert * n_shared``, which every token takes, is added to the routed
output, as the reference adds it. Returns (y, aux); aux is the Switch
load-balance loss.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (
    is_dtensor, reduce_partial, shard, sharded_context,
)
from repro_torch.models.layers import P, act_fn, mlp_apply, mlp_meta


def moe_meta(cfg) -> dict:
    m = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_expert
    meta = {"router": P((d, e), ("embed", None), scale=d**-0.5),
            "wg": P((e, d, f), ("experts", "embed", "mlp")),
            "wi": P((e, d, f), ("experts", "embed", "mlp")),
            "wo": P((e, f, d), ("experts", "mlp", "embed"))}
    if m.n_shared:
        meta["shared"] = mlp_meta(cfg, f * m.n_shared)
    return meta


def _capacity(cfg, S: int) -> int:
    m = cfg.moe
    c = int(S * m.top_k / m.n_experts * m.capacity_factor)
    return max(4, -(-c // 4) * 4)


def route(cfg, p, x: torch.Tensor):
    """The router: x (B, S, d) -> (probs (B, S, E) float32, gate (B, S, K)
    renormalised over the top k, idx (B, S, K) expert ids)."""
    K = cfg.moe.top_k
    logits = (x @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: equal probabilities keep the lower index
    # first, as jax.lax.top_k orders them
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[..., :K], idx[..., :K]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def _dispatch(cfg, p, x: torch.Tensor):
    """Route and dispatch, per example: x (B, S, d) -> (probs, idx, the
    dispatch buffer (B, E, C, d), and each (token, k) slot's place
    ``dest``, gate ``flat_g`` and ``keep``)."""
    m = cfg.moe
    B, S, d = x.shape
    E, K = m.n_experts, m.top_k
    C = _capacity(cfg, S)
    probs, gate, idx = route(cfg, p, x)
    # each kept (token, k) slot gets a unique place flat_e * C + pos in its
    # example's buffer; dropped ones the overflow place E * C, cut off
    flat_e = idx.reshape(B, S * K)
    flat_t = torch.arange(S, device=x.device).repeat_interleave(K)
    flat_g = gate.reshape(B, S * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(E, device=x.device).expand(B, E).contiguous()
    start = torch.searchsorted(sorted_e, experts)                 # (B, E)
    pos_sorted = (torch.arange(S * K, device=x.device)[None]
                  - torch.gather(start, 1, sorted_e))
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    keep = pos < C
    dest = torch.where(keep, flat_e * C + pos, E * C)             # (B, S K)
    rows = torch.arange(B, device=x.device)[:, None] * (E * C + 1)
    src = x[:, flat_t] * keep[..., None].to(x.dtype)
    buf = x.new_zeros((B * (E * C + 1), d)).index_add_(
        0, (rows + dest).reshape(-1), src.reshape(-1, d))
    buf = buf.view(B, E * C + 1, d)[:, :-1].reshape(B, E, C, d)
    return probs, idx, buf, dest, flat_g, keep


def _combine(cfg, out: torch.Tensor, dest, flat_g, keep) -> torch.Tensor:
    """Each slot's expert output (out (B, E, C, d)) times its gate (zero
    if dropped), in the compute dtype, summed over k in order."""
    B, E, C, d = out.shape
    K = cfg.moe.top_k
    S = dest.shape[1] // K
    flat = torch.cat([out.reshape(B, E * C, d), out.new_zeros((B, 1, d))],
                     dim=1)
    contrib = torch.gather(flat, 1, dest[..., None].expand(B, S * K, d)) \
        * (flat_g * keep).to(out.dtype)[..., None]
    contrib = contrib.view(B, S, K, d)
    return sum(contrib[:, :, k] for k in range(K))


def _experts(cfg, p, buf: torch.Tensor) -> torch.Tensor:
    """The experts' GLU on the dispatch buffer (B, E, C, d)."""
    h = act_fn(cfg.act)(torch.einsum("becd,edf->becf", buf, p["wg"])) * \
        torch.einsum("becd,edf->becf", buf, p["wi"])
    return torch.einsum("becf,efd->becd", h, p["wo"])


def _experts_on_mesh(cfg, p, buf):
    """:func:`_experts` on a mesh: the buffer laid out (batch, experts) as
    the reference constrains it, each expert weight keeping its split of
    the experts (or, where E does not divide, of the mlp dim) and gathered
    over the embed dim (FSDP), then each rank's products on its own
    shards; the output is a partial sum where the mlp dim was split.
    DTensor's einsum cannot take these layouts in every torch version."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    buf = shard(buf, "batch", "experts", None, None)
    mesh = buf.device_mesh

    def gathered(w, d_dim):
        w = reduce_partial(w)
        return w.redistribute(mesh, [
            Replicate() if isinstance(q, Shard) and q.dim == d_dim else q
            for q in w.placements])
    wg, wi, wo = gathered(p["wg"], 1), gathered(p["wi"], 1), \
        gathered(p["wo"], 2)
    out = _experts(cfg, {"wg": wg.to_local(), "wi": wi.to_local(),
                         "wo": wo.to_local()}, buf.to_local())
    pl = [bq if isinstance(bq, Shard) else
          Partial() if isinstance(wq, Shard) and wq.dim == 1 else Replicate()
          for bq, wq in zip(buf.placements, wo.placements)]
    shape = tuple(buf.shape)
    return DTensor.from_local(out, mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=(
                                  shape[1] * shape[2] * shape[3],
                                  shape[2] * shape[3], shape[3], 1))


def moe_apply(cfg, p, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux scalar float32)."""
    m = cfg.moe
    if sharded_context() and is_dtensor(x):
        y, aux = _moe_on_mesh(cfg, p, x)
    else:
        probs, idx, buf, dest, flat_g, keep = _dispatch(cfg, p, x)
        # Switch aux loss: E * sum_e fraction_routed_e * mean_prob_e
        E = m.n_experts
        frac = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))
        aux = E * torch.sum(frac * probs.mean(dim=(0, 1))) \
            * m.router_aux_weight
        y = _combine(cfg, _experts(cfg, p, buf), dest, flat_g, keep)
    if m.n_shared:
        y = y + mlp_apply(cfg, p["shared"], x)
    return y, aux.float()


def _moe_on_mesh(cfg, p, x):
    """:func:`moe_apply`'s routed part on a mesh. The routing bookkeeping
    (top-k sort, argsort, searchsorted, scatter and index-add) is per
    example and has no DTensor sharding strategy, so each rank runs it on
    its own rows of the batch (x laid out by rows, the router whole), as
    the reference's vmap over the batch would on a device; the expert
    products run on DTensors laid out (batch, experts) as the reference
    constrains them, and the combine runs on the rank's rows again. The
    aux loss's two means are partial sums over the ranks that split the
    batch, reduced before their product."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    m = cfg.moe
    B, S, d = x.shape
    E = m.n_experts
    xr = shard(reduce_partial(x), "batch", None, None)
    mesh, rows = xr.device_mesh, xr.placements
    router = {"router": reduce_partial(p["router"]).redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local()}
    probs, idx, buf, dest, flat_g, keep = _dispatch(cfg, router,
                                                    xr.to_local())
    split = [Partial() if isinstance(q, Shard) else Replicate()
             for q in rows]

    def mean_over_rows(t):
        return reduce_partial(DTensor.from_local(
            t.sum(dim=(0, 1)) / (B * S), mesh, split, run_check=False))
    frac = mean_over_rows(F.one_hot(idx[..., 0], E).float())
    aux = E * torch.sum(frac * mean_over_rows(probs)) * m.router_aux_weight

    def rows_dtensor(t, shape):
        stride = [1] * len(shape)
        for i in range(len(shape) - 2, -1, -1):
            stride[i] = stride[i + 1] * shape[i + 1]
        return DTensor.from_local(t, mesh, rows, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=tuple(stride))
    out = _experts_on_mesh(cfg, p, rows_dtensor(buf, (B, *buf.shape[1:])))
    out = shard(reduce_partial(out), "batch", "experts", None, None)
    out = shard(out, "batch", None, None, None).to_local()
    y = _combine(cfg, out, dest, flat_g, keep)
    return rows_dtensor(y, (B, S, d)), aux
