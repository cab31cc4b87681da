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

from repro_torch.models.layers import P, act_fn, mlp_apply, mlp_meta


def moe_meta(cfg) -> dict:
    m = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_expert
    meta = {"router": P((d, e), scale=d**-0.5),
            "wg": P((e, d, f)),
            "wi": P((e, d, f)),
            "wo": P((e, f, d))}
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


def moe_apply(cfg, p, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux scalar float32)."""
    m = cfg.moe
    B, S, d = x.shape
    E, K = m.n_experts, m.top_k
    C = _capacity(cfg, S)
    probs, gate, idx = route(cfg, p, x)

    # Switch aux loss: E * sum_e fraction_routed_e * mean_prob_e
    frac = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(frac * probs.mean(dim=(0, 1))) * m.router_aux_weight

    # dispatch, per example: each kept (token, k) slot gets a unique place
    # flat_e * C + pos in its example's buffer; dropped ones the overflow
    # place E * C, which is cut off
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

    h = act_fn(cfg.act)(torch.einsum("becd,edf->becf", buf, p["wg"])) * \
        torch.einsum("becd,edf->becf", buf, p["wi"])
    out = torch.einsum("becf,efd->becd", h, p["wo"])              # (B,E,C,d)

    # combine: each slot's expert output times its gate (zero if dropped),
    # in the compute dtype, summed over k in order
    flat = torch.cat([out.reshape(B, E * C, d), out.new_zeros((B, 1, d))],
                     dim=1)
    contrib = torch.gather(flat, 1, dest[..., None].expand(B, S * K, d)) \
        * (flat_g * keep).to(out.dtype)[..., None]
    contrib = contrib.view(B, S, K, d)
    y = sum(contrib[:, :, k] for k in range(K))
    if m.n_shared:
        y = y + mlp_apply(cfg, p["shared"], x)
    return y, aux.float()
