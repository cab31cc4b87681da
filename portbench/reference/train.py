"""The plain reference of a training step, in float32: the loss, the
gradients through autograd, and AdamW, for the dense attention models.

The forward is :mod:`reference.lm`'s blocks on float32 master weights drawn
from the seed (the program's masters are the same draws), each layer under
``torch.utils.checkpoint`` and the attention of each group of heads under a
checkpoint of its own, so that the backward holds one layer's activations
at a time; the loss is the mean next-token cross entropy over every label,
in chunks of 1,024 positions. AdamW as the traffic file states it: the
gradient scaled by min(1, clip / (its global norm + 1e-9)); m and v with
bias corrections; the update m^ / (sqrt(v^) + eps), plus weight decay
times the parameter on every leaf of a layer and every matrix outside the
layers; the learning rate warmed up linearly, then a cosine to
lr * min_lr_ratio at total_steps.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchkit.weights import draw_layer, leaf_specs
from benchkit.work import layer_kinds
from reference.lm import Ops, exact_fp32, glu, rms, rope


def lr_at(tr: dict, step: int) -> float:
    """The learning rate of step ``step`` (1-based)."""
    warm = tr["warmup_steps"]
    if step < warm:
        return tr["lr"] * step / max(warm, 1)
    prog = min(max((step - warm) / max(tr["total_steps"] - warm, 1), 0.0),
               1.0)
    r = tr["min_lr_ratio"]
    return tr["lr"] * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * prog)))


def _attn_group(q, k, v):
    """Causal attention of one key head's group: q (S, G, D), k, v (S, D)."""
    S, D = k.shape
    s = torch.einsum("qgd,td->gqt", q, k) * D ** -0.5
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
    return torch.einsum("gqt,td->qgd", p, v)


def _block(cfg, ops, names, x, *leaves):
    """One attention block on x (S, d); ``leaves`` in ``names``' order."""
    w = dict(zip(names, leaves))
    eps = cfg["rms_norm_eps"]
    H, KV, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                cfg["head_dim"])
    S = x.shape[0]
    h = rms(x, w["ln1.w"], eps)
    q = ops.mm(h, w["mix.wq"]).view(S, H, D)
    k = ops.mm(h, w["mix.wk"]).view(S, KV, D)
    v = ops.mm(h, w["mix.wv"]).view(S, KV, D)
    if cfg.get("qk_norm"):
        q, k = rms(q, w["mix.qn.w"], eps), rms(k, w["mix.kn.w"], eps)
    pos = torch.arange(S, device=x.device)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    G = H // KV
    q = q.view(S, KV, G, D)
    o = torch.stack([checkpoint(_attn_group, q[:, j], k[:, j], v[:, j],
                                use_reentrant=False) for j in range(KV)],
                    dim=1)
    x = x + ops.mm(o.reshape(S, H * D), w["mix.wo"])
    h = rms(x, w["ln2.w"], eps)
    return x + glu(h, w["mlp.wg"], w["mlp.wi"], w["mlp.wo"], ops)


def _chunk_ce(ops, h, head, labels):
    return F.cross_entropy(ops.mm(h, head), labels, reduction="sum")


def _loss(cfg, ops, params, names, tokens, labels, chunk=1024):
    top, layers = params
    eps = cfg["rms_norm_eps"]
    total = torch.zeros((), device=tokens.device)
    n = 0
    for row, lab in zip(tokens, labels):
        x = top["embed.tok"][row]
        for i, leaves in enumerate(layers):
            x = checkpoint(_block, cfg, ops, names[i], x, *leaves,
                           use_reentrant=False)
        h = rms(x, top["ln_f.w"], eps)
        for a in range(0, h.shape[0], chunk):
            total = total + checkpoint(_chunk_ce, ops, h[a:a + chunk],
                                       top["embed.head"], lab[a:a + chunk],
                                       use_reentrant=False)
        n += lab.numel()
    return total / n


def train_reference(cfg: dict, tr: dict, seed: int, batches: torch.Tensor,
                    device, quant: str | None = None,
                    fault: str | None = None) -> dict:
    """Follow the program's first ``len(batches)`` steps from the same
    masters: {"losses": [...], "grad": {leaf: norm of the clipped gradient
    of step 1}, "raw_grad": {leaf: its unclipped norm}, "change": {leaf:
    norm of the parameter's change after the last step}}. ``batches``
    (steps, B, S + 1) token ids; leaves named ``blocks.<i>.<name>`` and
    ``<name>`` outside the layers. ``quant="fp8"`` is the control;
    ``fault="half_batch"`` plants a fault, the loss taken over the first
    half of every row's positions (the batch's other half left out, the
    mean over the rest)."""
    if any(k != "attn" or m for k, m in layer_kinds(cfg)):
        raise NotImplementedError("the training reference covers dense "
                                  "attention models")
    ops = Ops(quant)
    n_layers = cfg["num_hidden_layers"]
    names = [[n for n, _, _ in leaf_specs(cfg, i)] for i in range(n_layers)]
    with exact_fp32():
        top = {k: v.float().requires_grad_(True) for k, v in
               draw_layer(cfg, seed, -1, torch.float32, device).items()}
        layers = []
        for i in range(n_layers):
            d = draw_layer(cfg, seed, i, torch.float32, device)
            layers.append([d[n].requires_grad_(True) for n in names[i]])
        flat = {**{k: t for k, t in top.items()},
                **{f"blocks.{i}.{n}": t for i in range(n_layers)
                   for n, t in zip(names[i], layers[i])}}
        decay = {k: k.startswith("blocks.") or t.ndim >= 2
                 for k, t in flat.items()}
        init = {k: t.detach().norm().item() for k, t in flat.items()}
        m = {k: torch.zeros_like(t) for k, t in flat.items()}
        v = {k: torch.zeros_like(t) for k, t in flat.items()}
        out = {"losses": []}
        for step, batch in enumerate(batches, start=1):
            tokens, labels = batch[:, :-1], batch[:, 1:]
            if fault == "half_batch":
                half = tokens.shape[1] // 2
                tokens, labels = tokens[:, :half], labels[:, :half]
            elif fault is not None:
                raise ValueError(f"unknown fault {fault!r}")
            loss = _loss(cfg, ops, (top, layers), names, tokens, labels)
            grads = torch.autograd.grad(loss, list(flat.values()))
            out["losses"].append(loss.item())
            with torch.no_grad():
                gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
                scale = min(1.0, tr["clip_norm"] / (gnorm.item() + 1e-9))
                lr = lr_at(tr, step)
                b1, b2 = tr["b1"], tr["b2"]
                if step == 1:
                    out["raw_grad"] = {k: g.norm().item()
                                       for k, g in zip(flat, grads)}
                    out["grad"] = {k: scale * out["raw_grad"][k]
                                   for k in flat}
                for (k, p), g in zip(flat.items(), grads):
                    g.mul_(scale)
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    den = torch.div(v[k], 1 - b2 ** step).sqrt_().add_(
                        tr["eps"])
                    upd = torch.div(m[k], 1 - b1 ** step).div_(den)
                    del den
                    if decay[k]:
                        upd.add_(p, alpha=tr["weight_decay"])
                    p.sub_(upd.mul_(lr))
                    del upd
            del grads
        del m, v
        out["change"] = change_norms(cfg, seed, flat, device)
        out["init"] = init
    return out


@torch.no_grad()
def change_norms(cfg: dict, seed: int, flat: dict, device) -> dict:
    """{leaf: norm of (its value - its draw from the seed)}, the draws made
    again layer by layer; ``flat`` names leaves as :func:`train_reference`
    does."""
    out = {}
    for i in range(-1, cfg["num_hidden_layers"]):
        pre = "" if i < 0 else f"blocks.{i}."
        for n, t0 in draw_layer(cfg, seed, i, torch.float32, device).items():
            out[pre + n] = (flat[pre + n].float() - t0).norm().item()
    return out
