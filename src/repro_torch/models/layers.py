"""Parameter metadata and primitive layers (counterpart of ``repro.models.layers``
for the layers llama3-8b uses: RMSNorm, half-split RoPE, the SiLU GLU MLP,
untied embeddings).

Parameters are declared as trees (nested dicts and lists) of :class:`P`:
a shape and an init kind. :func:`init_params` draws every tensor from one
explicit ``torch.Generator`` on the target device, in the tree's order,
and casts once: matrices to the model's compute dtype, 1-D tensors kept
in float32, which is what the reference's per-call ``cast_params`` gives.
Weights carried over from the JAX package take the same cast
(:func:`cast_params`), so a model holds its compute-dtype weights for its
lifetime.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class P:
    """Parameter metadata: shape and initializer."""
    shape: tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float | None = None    # stddev; default fan_in**-0.5
    dtype: str | None = None      # "float32" pins a tensor (norm scales)


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


def cast_params(params, dtype: torch.dtype):
    """Compute-dtype cast: float32 matrices -> ``dtype``, 1-D stays put."""
    return map_tree(lambda a: a.to(dtype)
                    if a.ndim > 1 and a.dtype == torch.float32 else a, params)


def init_params(tree, generator: torch.Generator, dtype: torch.dtype):
    """Materialize a metadata tree on ``generator``'s device: normal draws
    scaled by ``scale`` (default fan_in**-0.5), zeros, ones; then the
    compute-dtype cast of :func:`cast_params`."""
    device = generator.device

    def make(p: P) -> torch.Tensor:
        if p.init == "zeros":
            t = torch.zeros(p.shape, dtype=torch.float32, device=device)
        elif p.init == "ones":
            t = torch.ones(p.shape, dtype=torch.float32, device=device)
        else:
            fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
            scale = p.scale if p.scale is not None else fan_in ** -0.5
            t = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                            device=device).mul_(scale)
        if p.dtype is None and t.ndim > 1:
            t = t.to(dtype)
        return t

    return map_tree(make, tree)


# --------------------------------------------------------------------------
# primitive layers
# --------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    n = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (n * w.float()).to(x.dtype)


def norm_meta(cfg, d: int | None = None) -> dict:
    return {"w": P((d or cfg.d_model,), "ones", dtype="float32")}


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


# ---- embeddings (untied, unscaled) ---------------------------------------

def embed_meta(cfg) -> dict:
    return {"tok": P((cfg.vocab_size, cfg.d_model), scale=1.0),
            "head": P((cfg.d_model, cfg.vocab_size))}


def embed_tokens(p: dict, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    return p["tok"].to(dtype)[tokens.long()]


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["head"].to(x.dtype)
