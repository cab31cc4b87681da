"""State-space mixers (counterpart of ``repro.models.ssm``): the RWKV6
(Finch) time-mix with data-dependent decay and its channel-mix FFN.

The time-mix reduces to the matrix-state recurrence of
:func:`repro_torch.kernels.ops.rwkv_scan` (the scan kernel on the card);
decode is one recurrence step, :func:`repro_torch.kernels.ops.rwkv_decode_step`,
which writes the new state into the cache in place. The decode cache is
O(1) in sequence length: per layer the normed mixer input of the last
token (``x_tm``), the normed channel-mix input of the last token
(``x_cm``) and the (H, K, K) float32 state (``h``). Where the reference
returns a new cache, the port's decode functions write into the cache
tensors they are given. The casts are the reference's: the projections
and the decay LoRA run in the compute dtype, the decay itself in float32.

The Mamba half of the reference module comes with the jamba slice; its
functions raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import P, groupnorm_heads


# --------------------------------------------------------------------------
# Mamba (not ported yet)
# --------------------------------------------------------------------------

def _not_ported(*_args, **_kwargs):
    raise NotImplementedError("Mamba layers (jamba) are not ported yet")


mamba_meta = mamba_cache_meta = mamba_apply = mamba_decode = _not_ported


# --------------------------------------------------------------------------
# RWKV6 (Finch): time-mix with data-dependent decay + channel-mix FFN
# --------------------------------------------------------------------------

def _rwkv_dims(cfg) -> tuple[int, int]:
    K = cfg.rwkv_head_dim
    return cfg.d_model // K, K


def rwkv_meta(cfg) -> dict:
    d = cfg.d_model
    H, K = _rwkv_dims(cfg)
    da = H * K
    lora = 64
    return {
        "mu": P((5, d), "zeros"),          # r, w, k, v, g token-shift mixes
        "wr": P((d, da)),
        "wk": P((d, da)),
        "wv": P((d, da)),
        "wg": P((d, da)),
        "w0": P((da,), "zeros"),
        "w1": P((d, lora)),
        "w2": P((lora, da), scale=0.01),
        "u": P((H, K), "zeros"),
        "gn_w": P((da,), "ones"),
        "gn_b": P((da,), "zeros"),
        "wo": P((da, d)),
    }


def rwkv_cm_meta(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"mu": P((2, d), "zeros"),      # k, r mixes
            "wk": P((d, f)),
            "wv": P((f, d)),
            "wr": P((d, d))}


def rwkv_cache_meta(cfg, batch: int) -> dict:
    """One layer's decode state, name -> (shape, dtype): ``x_tm`` and
    ``x_cm`` (B, d) in the compute dtype (None), ``h`` (B, H, K, K) in
    float32."""
    H, K = _rwkv_dims(cfg)
    d = cfg.d_model
    return {"x_tm": ((batch, d), None), "x_cm": ((batch, d), None),
            "h": ((batch, H, K, K), torch.float32)}


def _shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Previous-token tensor: (B, S, d) shifted right, first slot x_prev."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _lerp(x: torch.Tensor, xp: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + (xp - x) * mu.to(x.dtype)


def _rwkv_project(cfg, p, x, xp):
    B, S, d = x.shape
    H, K = _rwkv_dims(cfg)
    mu = p["mu"]
    r = _lerp(x, xp, mu[0]) @ p["wr"]
    xw = _lerp(x, xp, mu[1])
    k = _lerp(x, xp, mu[2]) @ p["wk"]
    v = _lerp(x, xp, mu[3]) @ p["wv"]
    g = F.silu(_lerp(x, xp, mu[4]) @ p["wg"])
    w = torch.exp(-torch.exp(
        p["w0"] + (torch.tanh(xw @ p["w1"]) @ p["w2"]).float()))
    shp = (B, S, H, K)
    return (r.reshape(shp), w.reshape(shp), k.reshape(shp), v.reshape(shp),
            g)


def _rwkv_out(cfg, p, o, g):
    """Per-head groupnorm, gate, output projection: o (B, S, H, K)."""
    B, S = o.shape[:2]
    H, K = _rwkv_dims(cfg)
    o = groupnorm_heads(o, p["gn_w"].reshape(H, K), p["gn_b"].reshape(H, K))
    return (o.reshape(B, S, H * K) * g) @ p["wo"]


def rwkv_apply(cfg, p, x, h0=None, x_prev=None, return_cache=False):
    """Time-mix over a sequence. x: (B, S, d) (the normed block input).
    Returns y, or (y, {"x_tm": x[:, -1], "h": final state}) with
    ``return_cache``."""
    B, S, d = x.shape
    if x_prev is None:
        x_prev = x.new_zeros((B, d))
    r, w, k, v, g = _rwkv_project(cfg, p, x, _shift(x, x_prev))
    o, h = ops.rwkv_scan(r, w, k, v, p["u"], h0)
    out = _rwkv_out(cfg, p, o, g)
    if not return_cache:
        return out
    return out, {"x_tm": x[:, -1], "h": h}


def rwkv_decode(cfg, p, x, cache):
    """One token. x: (B, 1, d); ``cache`` {"x_tm" (B, d), "h" (B, H, K, K)}
    is updated in place and returned."""
    r, w, k, v, g = _rwkv_project(cfg, p, x, cache["x_tm"][:, None])
    o, _ = ops.rwkv_decode_step(r[:, 0], w[:, 0], k[:, 0], v[:, 0], p["u"],
                                cache["h"])
    out = _rwkv_out(cfg, p, o[:, None], g)
    cache["x_tm"].copy_(x[:, 0])
    return out, cache


def rwkv_cm_apply(cfg, p, x, x_prev=None):
    """Channel-mix FFN over a sequence. x: (B, S, d)."""
    B, S, d = x.shape
    if x_prev is None:
        x_prev = x.new_zeros((B, d))
    xp = _shift(x, x_prev)
    k = torch.square(F.relu(_lerp(x, xp, p["mu"][0]) @ p["wk"]))
    return torch.sigmoid(_lerp(x, xp, p["mu"][1]) @ p["wr"]) * (k @ p["wv"])


def rwkv_cm_decode(cfg, p, x, x_prev):
    """Channel-mix FFN for one token. x: (B, 1, d), x_prev (B, d)."""
    xp = x_prev[:, None]
    k = torch.square(F.relu(_lerp(x, xp, p["mu"][0]) @ p["wk"]))
    return torch.sigmoid(_lerp(x, xp, p["mu"][1]) @ p["wr"]) * (k @ p["wv"])
