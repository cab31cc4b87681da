"""Parameter metadata and primitive layers (counterpart of ``repro.models.layers``
for the layers the ported configs use: RMSNorm and LayerNorm, the RWKV
per-head GroupNorm, half-split RoPE and whisper's sinusoidal positions, the
GLU MLP with SiLU or GELU and whisper's plain MLP (biases, GELU),
embeddings, unscaled or scaled by sqrt(d_model) (gemma3), untied or tied).

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

from repro_torch.distributed.sharding import (
    is_dtensor, reduce_partial, shard, sharded_context,
)


# the configs' compute dtypes
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclass(frozen=True)
class P:
    """Parameter metadata: shape, the logical axis of each dim (the
    reference's names, :mod:`repro_torch.distributed.sharding`) and
    initializer."""
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float | None = None    # stddev; default fan_in**-0.5

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


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


def meta_axes(tree):
    """Tree of logical-axes tuples, same structure as the parameters."""
    return map_tree(lambda p: p.axes, tree)


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
    GB in float32; qwen1.5-110b's (152064, 8192) embedding) is drawn in
    slices of its leading axis, as many rows a draw as fit in
    WHOLE_DRAW_BYTES (a draw a row costs seconds of launches at 152,064
    rows), in order from the same generator, each slice cast into the leaf
    as it is drawn: the float32 copy of the whole leaf never exists beside
    the cast one. The draws are as deterministic as whole ones,
    though not the same numbers."""
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
            else:                 # a matrix stack or a long table
                assert len(p.shape) > 1, p.shape
                t = torch.empty(p.shape, dtype=dtype, device=device)
                row = tuple(p.shape[1:])
                rows = max(1, WHOLE_DRAW_BYTES // (4 * math.prod(row)))
                for i in range(0, p.shape[0], rows):
                    t[i:i + rows] = draw((min(rows, p.shape[0] - i),) + row,
                                         scale)
                return t
        return cast_leaf(t, dtype, stacked)

    return map_tree(make, tree)


# --------------------------------------------------------------------------
# primitive layers
# --------------------------------------------------------------------------

def _rms_expr(x, w, eps):
    xf = x.float()
    n = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (n * w.float()).to(x.dtype)


def _ln_expr(x, w, b, eps):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    n = (xf - mu) * torch.rsqrt(var + eps)
    return (n * w.float() + b.float()).to(x.dtype)


def _rms_in_place(x, w, eps):
    t = x.to(torch.float32, copy=True)
    r = torch.rsqrt(torch.mean(t.mul_(t), dim=-1, keepdim=True) + eps)
    return t.copy_(x).mul_(r).mul_(w.float()).to(x.dtype)


def _ln_in_place(x, w, b, eps):
    # the squared deviations for the variance overwrite the copy, and it is
    # refilled from x
    t = x.to(torch.float32, copy=True)
    mu = torch.mean(t, dim=-1, keepdim=True)
    r = torch.rsqrt(torch.mean(t.sub_(mu).pow_(2), dim=-1, keepdim=True)
                    + eps)
    return t.copy_(x).sub_(mu).mul_(r).mul_(w.float()).add_(
        b.float()).to(x.dtype)


def _in_place(x: torch.Tensor, *params) -> bool:
    """Whether a norm takes the in-place ops on one float32 copy of x
    (:func:`_rms_in_place`, :func:`_ln_in_place`: the same bits as the
    expressions written out, which eagerly keep three such copies; XLA
    fuses them away): where nothing will differentiate it and x has no
    pending sums (in-place ops cannot reduce them; the expression's
    nonlinear ops do, as the reference's do). Under grad every device and
    mesh takes the expression, so autograd and the dry run's counts see
    the same ops."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, *params)):
        return False
    return not (is_dtensor(x) and any(p.is_partial() for p in x.placements))


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if _in_place(x, w):
        return _rms_in_place(x, w, eps)
    return _rms_expr(x, w, eps)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    if _in_place(x, w, b):
        return _ln_in_place(x, w, b, eps)
    return _ln_expr(x, w, b, eps)


def groupnorm_heads(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    eps: float = 64e-5) -> torch.Tensor:
    """Per-head groupnorm (RWKV output norm). x: (..., H, V)."""
    return layernorm(x, w, b, eps)


def norm_meta(cfg, d: int | None = None) -> dict:
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"w": P((d,), (None,), "ones"),
                "b": P((d,), (None,), "zeros")}
    return {"w": P((d,), (None,), "ones")}


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


def sincos_positions(S: int, d: int, offset: int = 0,
                     device=None) -> torch.Tensor:
    """Fixed sinusoidal position embeddings (whisper-style), float32
    (S, d): positions ``offset .. offset + S - 1``, d/2 sines then d/2
    cosines of frequencies exp(-ln(10000) i / (d/2 - 1))."""
    pos = torch.arange(S, dtype=torch.float32, device=device) + offset
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=device)
                      / (half - 1))
    ang = pos[:, None] * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def act_fn(name: str):
    """The GLU's activation: SiLU, or GELU in the tanh approximation, which
    is ``jax.nn.gelu``'s default and so the reference's."""
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    return {"silu": F.silu}[name]


# ---- dense MLP: GLU, or plain with biases (``mlp_kind="plain"``) ----------

def mlp_meta(cfg, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_kind == "plain":
        return {"wi": P((d, f), ("embed", "mlp")),
                "bi": P((f,), ("mlp",), "zeros"),
                "wo": P((f, d), ("mlp", "embed")),
                "bo": P((d,), (None,), "zeros")}
    return {"wg": P((d, f), ("embed", "mlp")),
            "wi": P((d, f), ("embed", "mlp")),
            "wo": P((f, d), ("mlp", "embed"))}


def mlp_apply(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    act = act_fn(cfg.act)
    if cfg.mlp_kind == "plain":
        h = act(x @ p["wi"] + p["bi"].to(x.dtype))
        return h @ p["wo"] + p["bo"].to(x.dtype)
    return (act(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


# ---- embeddings (untied, or tied to the token table) ---------------------

def embed_meta(cfg) -> dict:
    m = {"tok": P((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                  scale=1.0)}
    if not cfg.tie_embeddings:
        m["head"] = P((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return m


def embed_tokens(cfg, p: dict, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Token rows in ``dtype``; with ``cfg.embed_scale`` times sqrt(d_model)
    rounded to ``dtype`` first, as the reference's ``jnp.asarray(d ** 0.5,
    dtype)`` (sqrt(3840) = 61.97 is 62.0 in bf16). On a mesh the lookup is
    ``F.embedding`` of ids split over the batch against the table split over
    the vocab alone (its embed dim gathered first), which DTensor takes
    forward and backward, as it does not the indexing of hybrid-sharded
    ids: each rank looks up its own rows, never the whole batch (replicated
    ids against the FSDP-split table gave every rank all the rows, whose
    gather over the batch took 8.6 GB a rank at llama3-8b's prefill_32k)."""
    if sharded_context():
        table = shard(p["tok"].to(dtype), "vocab", None)
        x = F.embedding(shard(tokens.long(), "batch", None), table)
        x = shard(reduce_partial(x), "batch", "seq", None)
    else:
        x = p["tok"].to(dtype)[tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype, device=x.device)
    return x


def unembed(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits: ``x @ head``, or ``x @ tok.T`` with tied embeddings (no
    ``head`` leaf then)."""
    if cfg.tie_embeddings:
        return x @ p["tok"].to(x.dtype).T
    return x @ p["head"].to(x.dtype)
