"""A configuration's weights, drawn on the device from the seed.

The benchmark, not the program, makes the weights. Every layer (and the
parts outside the layers, index -1) has its own ``torch.Generator`` on the
device, seeded from (seed, layer), which fills one flat buffer of the
layer's elements in one call, in the dtype the weights are held in; each
leaf is then cut from the buffer, scaled or shaped as its kind says, and
kept as a tensor of its own. So a layer can be drawn again, bit for bit,
without the others: the reference draws each layer when it reaches it,
and no weight passes from the program to the reference.

Leaf kinds (the scale of a ``normal`` leaf is fan_in ** -0.5, fan_in the
second-last dim): ``normal``; ``embed`` (standard normal rows);
``norm`` (1 + z / 10: norm scales and Mamba's D off their init, so a wrong
scale shows); ``bias`` (z / 10); ``a_log`` (log 1..N along the state axis,
Mamba's S4D-real init; its draws are cut and dropped); ``dt_bias`` (the
inverse softplus of a step size exp(u), u between log 1e-3 and log 0.1).
"""
from __future__ import annotations

import math

import torch

from benchkit.work import layer_kinds


def leaf_specs(cfg: dict, layer: int) -> list[tuple[str, tuple, str]]:
    """(dotted name, shape, kind) of every leaf of ``layer`` (-1: the
    embedding, the head and the final norm), in drawing order."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    if layer < 0:
        return [("embed.tok", (V, d), "embed"),
                ("embed.head", (d, V), "normal"),
                ("ln_f.w", (d,), "norm")]
    kind, moe = layer_kinds(cfg)[layer]
    H, KV, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                cfg["head_dim"])
    out = [("ln1.w", (d,), "norm")]
    if kind == "attn":
        out += [("mix.wq", (d, H * D), "normal"),
                ("mix.wk", (d, KV * D), "normal"),
                ("mix.wv", (d, KV * D), "normal"),
                ("mix.wo", (H * D, d), "normal")]
        if cfg.get("qk_norm"):
            out += [("mix.qn.w", (D,), "norm"), ("mix.kn.w", (D,), "norm")]
    else:
        di, N = cfg["mamba_expand"] * d, cfg["mamba_d_state"]
        K, dtr = cfg["mamba_d_conv"], cfg["mamba_dt_rank"]
        out += [("mix.in_proj", (d, 2 * di), "normal"),
                ("mix.conv_w", (K, di), "normal"),
                ("mix.conv_b", (di,), "bias"),
                ("mix.x_proj", (di, dtr + 2 * N), "normal"),
                ("mix.dt_w", (dtr, di), "normal"),
                ("mix.dt_bias", (di,), "dt_bias"),
                ("mix.A_log", (di, N), "a_log"),
                ("mix.D", (di,), "norm"),
                ("mix.out_proj", (di, d), "normal")]
    out.append(("ln2.w", (d,), "norm"))
    if moe:
        E, f = cfg["num_experts"], cfg["expert_intermediate_size"]
        out += [("mlp.router", (d, E), "normal"),
                ("mlp.wg", (E, d, f), "normal"),
                ("mlp.wi", (E, d, f), "normal"),
                ("mlp.wo", (E, f, d), "normal")]
    else:
        f = cfg["intermediate_size"]
        out += [("mlp.wg", (d, f), "normal"), ("mlp.wi", (d, f), "normal"),
                ("mlp.wo", (f, d), "normal")]
    return out


def layer_seed(seed: int, layer: int) -> int:
    """The generator seed of ``layer`` (-1 for the parts outside the
    layers): any whole-number seed, mixed with the layer and kept in 63
    bits."""
    return (int(seed) * 1_000_003 + (layer + 1) * 7_919 + 12_345) % (1 << 63)


def _shape(kind: str, z: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Leaf of ``kind`` from its standard-normal draws ``z`` (computed in
    float32 where it is not a plain scale, then cast to ``z``'s dtype)."""
    if kind == "normal":
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        return z.mul(fan_in ** -0.5)
    if kind == "embed":
        return z.clone()
    if kind == "norm":
        return (1 + z.float() / 10).to(z.dtype)
    if kind == "bias":
        return z.mul(0.1)
    if kind == "a_log":
        n = torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                         device=z.device)
        return torch.log(n).expand(shape).to(z.dtype).contiguous()
    if kind == "dt_bias":
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(lo + (hi - lo) * torch.sigmoid(z.float()))
        return (dt + torch.log(-torch.expm1(-dt))).to(z.dtype)
    raise ValueError(f"unknown leaf kind {kind!r}")


def draw_layer(cfg: dict, seed: int, layer: int, dtype: torch.dtype,
               device) -> dict[str, torch.Tensor]:
    """{dotted name: tensor} of ``layer`` (-1: outside the layers), every
    leaf in ``dtype`` on ``device``, from one generator call."""
    specs = leaf_specs(cfg, layer)
    total = sum(math.prod(s) for _, s, _ in specs)
    gen = torch.Generator(device=device).manual_seed(layer_seed(seed, layer))
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    out, at = {}, 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        out[name] = _shape(kind, flat[at:at + n].view(shape), shape)
        at += n
    del flat
    return out


def nest(flat: dict[str, torch.Tensor]) -> dict:
    """{"a.b.c": t} -> {"a": {"b": {"c": t}}}."""
    tree: dict = {}
    for name, t in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def port_tree(cfg: dict, seed: int, dtype: torch.dtype, device, *,
              final_norm_dtype: torch.dtype | None = None) -> dict:
    """The whole model in the port's parameter layout: {"embed": {"tok",
    "head"}, "blocks": [one dict a layer], "ln_f": {"w"}}. The final norm's
    scale is held in ``final_norm_dtype`` where given (the port serves it
    in float32), after its draw in ``dtype``."""
    top = draw_layer(cfg, seed, -1, dtype, device)
    if final_norm_dtype is not None:
        top["ln_f.w"] = top["ln_f.w"].to(final_norm_dtype)
    tree = nest(top)
    tree["blocks"] = [nest(draw_layer(cfg, seed, i, dtype, device))
                      for i in range(cfg["num_hidden_layers"])]
    return {"embed": tree["embed"], "blocks": tree["blocks"],
            "ln_f": tree["ln_f"]}
