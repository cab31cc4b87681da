"""Parameter metadata and primitive layers (counterpart of ``repro.models.layers``
for the layers the ported configs use: RMSNorm and LayerNorm, the RWKV
per-head GroupNorm, half-split RoPE, the SiLU GLU MLP, unscaled
embeddings, untied or tied).

Parameters are declared as trees (nested dicts and lists) of :class:`P`:
a shape and an init kind. :func:`init_params` draws every tensor from one
explicit ``torch.Generator`` on the target device, in the tree's order,
and casts each one once, as the reference's per-call ``cast_params``
casts it (:func:`cast_leaf`). Weights carried over from the JAX package
take the same cast (:func:`cast_params`), so a model holds its
compute-dtype weights for its lifetime.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class P:
    """Parameter metadata: shape and initializer."""
    shape: tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float | None = None    # stddev; default fan_in**-0.5


def map_tree(fn, tree):
    """``fn`` over the leaves of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    map_tree(out.append, tree)
    return out


def cast_leaf(t: torch.Tensor, dtype: torch.dtype,
              stacked: bool) -> torch.Tensor:
    """The reference's compute-dtype cast of one leaf (``cast_params``):
    a float32 leaf with ``ndim > 1`` goes to ``dtype``, whatever dtype the
    reference's metadata pins it to. ``stacked`` marks a leaf of one layer
    under ``params["blocks"]``: the reference stacks those over
    ``n_repeats`` before it casts, so every block leaf has ``ndim > 1``
    there and every float32 one (norm scales, RWKV's ``u`` and ``w0``
    included) is cast."""
    if t.dtype == torch.float32 and (stacked or t.ndim > 1):
        return t.to(dtype)
    return t


def cast_params(params, dtype: torch.dtype, *, stacked: bool = False):
    """:func:`cast_leaf` over a tree."""
    return map_tree(lambda a: cast_leaf(a, dtype, stacked), params)


# a normal draw larger than this in float32 is drawn slice by slice
WHOLE_DRAW_BYTES = 1 << 31


def init_params(tree, generator: torch.Generator, dtype: torch.dtype, *,
                stacked: bool = False):
    """Materialize a metadata tree on ``generator``'s device: normal draws
    scaled by ``scale`` (default fan_in**-0.5), zeros, ones, each drawn in
    float32 and then cast by :func:`cast_leaf`.

    A normal leaf whose float32 draw would exceed
    :data:`WHOLE_DRAW_BYTES` (jamba's (16, 4096, 14336) expert stacks, 3.76
    GB in float32) is drawn in slices of its leading axis, in order from
    the same generator, each slice cast into the leaf as it is drawn: the
    float32 copy of the whole leaf never exists beside the cast one. The
    draws are as deterministic as whole ones, though not the same
    numbers."""
    device = generator.device

    def draw(shape, scale):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device).mul_(scale)

    def make(p: P) -> torch.Tensor:
        if p.init == "zeros":
            t = torch.zeros(p.shape, dtype=torch.float32, device=device)
        elif p.init == "ones":
            t = torch.ones(p.shape, dtype=torch.float32, device=device)
        else:
            fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
            scale = p.scale if p.scale is not None else fan_in ** -0.5
            if 4 * math.prod(p.shape) <= WHOLE_DRAW_BYTES:
                t = draw(p.shape, scale)
            else:                 # a matrix stack: cast_leaf casts it
                assert len(p.shape) > 1, p.shape
                t = torch.empty(p.shape, dtype=dtype, device=device)
                for i in range(p.shape[0]):
                    t[i] = draw(p.shape[1:], scale)
                return t
        return cast_leaf(t, dtype, stacked)

    return map_tree(make, tree)


# --------------------------------------------------------------------------
# primitive layers
# --------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    n = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (n * w.float()).to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    n = (xf - mu) * torch.rsqrt(var + eps)
    return (n * w.float() + b.float()).to(x.dtype)


def groupnorm_heads(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    eps: float = 64e-5) -> torch.Tensor:
    """Per-head groupnorm (RWKV output norm). x: (..., H, V)."""
    return layernorm(x, w, b, eps)


def norm_meta(cfg, d: int | None = None) -> dict:
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"w": P((d,), "ones"), "b": P((d,), "zeros")}
    return {"w": P((d,), "ones")}


def apply_norm(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["w"], p["b"])
    return rmsnorm(x, p["w"])


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         rot_dims: int | None = None) -> torch.Tensor:
    """Rotary embedding, half-split convention.

    x: (B, S, H, D); positions: (S,) or (B, S). Rotates the first
    ``rot_dims`` dims of D (default: all), in float32.
    """
    D = x.shape[-1]
    R = rot_dims or D
    half = R // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions.float()[:, :, None] * freqs[None, None]     # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr = x[..., :R].float()
    x1, x2 = xr[..., :half], xr[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated.to(x.dtype), x[..., R:]], dim=-1)


# ---- GLU MLP ---------------------------------------------------------------

def mlp_meta(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"wg": P((d, f)), "wi": P((d, f)), "wo": P((f, d))}


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


# ---- embeddings (unscaled; untied, or tied to the token table) ----------

def embed_meta(cfg) -> dict:
    m = {"tok": P((cfg.vocab_size, cfg.d_model), scale=1.0)}
    if not cfg.tie_embeddings:
        m["head"] = P((cfg.d_model, cfg.vocab_size))
    return m


def embed_tokens(cfg, p: dict, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    return p["tok"].to(dtype)[tokens.long()]


def unembed(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits: ``x @ head``, or ``x @ tok.T`` with tied embeddings (no
    ``head`` leaf then)."""
    if cfg.tie_embeddings:
        return x @ p["tok"].to(x.dtype).T
    return x @ p["head"].to(x.dtype)
