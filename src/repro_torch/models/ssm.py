"""State-space mixers (counterpart of ``repro.models.ssm``): the Mamba
mixer of the hybrid family (jamba's SSM layers), and the RWKV6 (Finch)
time-mix with data-dependent decay and its channel-mix FFN.

Both reduce to first-order recurrences: Mamba's diagonal (Di, N) state
through :func:`repro_torch.kernels.ops.mamba_scan`, RWKV6's matrix
state through :func:`repro_torch.kernels.ops.rwkv_scan` (the scan kernels
on the card). Decode is one recurrence step,
:func:`~repro_torch.kernels.ops.mamba_decode_step` or
:func:`~repro_torch.kernels.ops.rwkv_decode_step`, which writes the new
state into the cache in place. The decode caches are O(1) in sequence
length. Mamba's, per layer: the last ``ssm_conv - 1`` inputs of the
causal conv (``conv``, in the compute dtype) and the (Di, N) float32
state (``h``). RWKV's: the normed mixer input of the last token
(``x_tm``), the normed channel-mix input of the last token (``x_cm``)
and the (H, K, K) float32 state (``h``). Where the reference returns a
new cache, the port's decode functions write into the cache tensors they
are given. The casts and the order of operations are the reference's:
the projections, Mamba's causal conv (four products summed in the
compute dtype, rounding after each add), ``A = -exp(A_log)`` and the
softplus of the step sizes in the compute dtype; RWKV's decay in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import merge_last, shard, split_last
from repro_torch.kernels import ops
from repro_torch.models.layers import P, groupnorm_heads


# --------------------------------------------------------------------------
# Mamba
# --------------------------------------------------------------------------

def _mamba_dims(cfg) -> tuple[int, int, int, int]:
    """(d_inner, dt rank, state size N, conv width)."""
    di = cfg.ssm_expand * cfg.d_model
    dtr = cfg.ssm_dt_rank or max(cfg.d_model // 16, 1)
    return di, dtr, cfg.ssm_state, cfg.ssm_conv


def mamba_meta(cfg) -> dict:
    d = cfg.d_model
    di, dtr, N, K = _mamba_dims(cfg)
    return {
        "in_proj": P((d, 2 * di), ("embed", "inner")),
        "conv_w": P((K, di), (None, "inner"), scale=K**-0.5),
        "conv_b": P((di,), ("inner",), "zeros"),
        "x_proj": P((di, dtr + 2 * N), ("inner", None)),
        "dt_w": P((dtr, di), (None, "inner")),
        "dt_bias": P((di,), ("inner",), "ones"),
        "A_log": P((di, N), ("inner", None), "zeros"),
        "D": P((di,), ("inner",), "ones"),
        "out_proj": P((di, d), ("inner", "embed")),
    }


def mamba_cache_meta(cfg, batch: int) -> dict:
    """One layer's decode state, name -> (shape, dtype, logical axes):
    ``conv`` (B, K - 1, Di) in the compute dtype (None), ``h`` (B, Di, N)
    in float32."""
    di, dtr, N, K = _mamba_dims(cfg)
    return {"conv": ((batch, K - 1, di), None, ("batch", None, "inner")),
            "h": ((batch, di, N), torch.float32, ("batch", "inner", None))}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s form, logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|)), in x's dtype."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def causal_conv(xw: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The depthwise causal conv over xw (B, S + K - 1, Di), the K - 1
    carried inputs first, with taps w (K, Di): sum_k w[k] x[t + k], a
    Python sum of K products in xw's dtype (rounding after each add, as
    the reference; ``F.conv1d`` sums in float32 and differs in bf16)."""
    K = w.shape[0]
    S = xw.shape[1] - (K - 1)
    return sum(xw[:, k:k + S] * w[k].to(xw.dtype) for k in range(K))


def _mamba_pre(cfg, p, xz, conv_tail):
    """Shared projection path. xz (B, S, 2 Di), conv_tail (B, K - 1, Di);
    returns delta, Bt, Ct (contiguous, as the scan kernel takes them), the
    conv output xc, the gate z and the conv input x_in."""
    di, dtr, N, K = _mamba_dims(cfg)
    x_in, z = xz[..., :di], xz[..., di:]
    xc = causal_conv(torch.cat([conv_tail, x_in], dim=1), p["conv_w"])
    xc = F.silu(xc + p["conv_b"].to(xc.dtype))
    xdb = xc @ p["x_proj"]
    delta = softplus(xdb[..., :dtr] @ p["dt_w"] + p["dt_bias"].to(xdb.dtype))
    Bt = xdb[..., dtr:dtr + N].contiguous()
    Ct = xdb[..., dtr + N:].contiguous()
    return delta, Bt, Ct, xc, z, x_in


def _mamba_out(p, y, xc, z):
    y = y + xc * p["D"].to(y.dtype)
    return (y * F.silu(z)) @ p["out_proj"]


def mamba_apply(cfg, p, x, h0=None, conv_tail=None, return_cache=False):
    """Mixer over a sequence. x: (B, S, d) (the normed block input).
    Returns y, or (y, {"conv": last K - 1 conv inputs, "h": final state})
    with ``return_cache``."""
    B = x.shape[0]
    di, dtr, N, K = _mamba_dims(cfg)
    xz = shard(x @ p["in_proj"], "batch", "seq", "inner")
    if conv_tail is None:
        conv_tail = xz.new_zeros((B, K - 1, di))
    delta, Bt, Ct, xc, z, x_in = _mamba_pre(cfg, p, xz, conv_tail)
    A = -torch.exp(p["A_log"])
    y, h = ops.mamba_scan(delta, A, Bt, Ct, xc, h0)
    out = _mamba_out(p, y, xc, z)
    if not return_cache:
        return out
    # the last K - 1 conv inputs, from the last K - 1 rows of x_in alone: a
    # slice of the whole concatenation would keep all S rows alive in the
    # cache (XLA keeps only the slice)
    tail = torch.cat([conv_tail, x_in[:, -(K - 1):]], dim=1)[:, -(K - 1):]
    return out, {"conv": tail, "h": h}


def mamba_decode(cfg, p, x, cache):
    """One token. x: (B, 1, d); ``cache`` {"conv" (B, K - 1, Di), "h"
    (B, Di, N)} is updated in place and returned."""
    xz = x @ p["in_proj"]
    delta, Bt, Ct, xc, z, x_in = _mamba_pre(cfg, p, xz, cache["conv"])
    A = -torch.exp(p["A_log"])
    y, _ = ops.mamba_decode_step(delta[:, 0], A, Bt[:, 0], Ct[:, 0],
                                 xc[:, 0], cache["h"])
    out = _mamba_out(p, y[:, None], xc, z)
    cache["conv"].copy_(torch.cat([cache["conv"], x_in], dim=1)[:, 1:])
    return out, cache


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
        "mu": P((5, d), (None, "embed"), "zeros"),   # r, w, k, v, g mixes
        "wr": P((d, da), ("embed", "inner")),
        "wk": P((d, da), ("embed", "inner")),
        "wv": P((d, da), ("embed", "inner")),
        "wg": P((d, da), ("embed", "inner")),
        "w0": P((da,), ("inner",), "zeros"),
        "w1": P((d, lora), ("embed", None)),
        "w2": P((lora, da), (None, "inner"), scale=0.01),
        "u": P((H, K), (None, None), "zeros"),
        "gn_w": P((da,), ("inner",), "ones"),
        "gn_b": P((da,), ("inner",), "zeros"),
        "wo": P((da, d), ("inner", "embed")),
    }


def rwkv_cm_meta(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"mu": P((2, d), (None, "embed"), "zeros"),   # k, r mixes
            "wk": P((d, f), ("embed", "mlp")),
            "wv": P((f, d), ("mlp", "embed")),
            "wr": P((d, d), ("embed", None))}


def rwkv_cache_meta(cfg, batch: int) -> dict:
    """One layer's decode state, name -> (shape, dtype, logical axes):
    ``x_tm`` and ``x_cm`` (B, d) in the compute dtype (None), ``h``
    (B, H, K, K) in float32."""
    H, K = _rwkv_dims(cfg)
    d = cfg.d_model
    return {"x_tm": ((batch, d), None, ("batch", "embed")),
            "x_cm": ((batch, d), None, ("batch", "embed")),
            "h": ((batch, H, K, K), torch.float32,
                  ("batch", None, None, None))}


def _shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Previous-token tensor: (B, S, d) shifted right, first slot x_prev."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _lerp(x: torch.Tensor, xp: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + (xp - x) * mu.to(x.dtype)


def _rwkv_project(cfg, p, x, xp):
    H, K = _rwkv_dims(cfg)
    mu = p["mu"]
    r = _lerp(x, xp, mu[0]) @ p["wr"]
    xw = _lerp(x, xp, mu[1])
    k = _lerp(x, xp, mu[2]) @ p["wk"]
    v = _lerp(x, xp, mu[3]) @ p["wv"]
    g = F.silu(_lerp(x, xp, mu[4]) @ p["wg"])
    w = torch.exp(-torch.exp(
        p["w0"] + (torch.tanh(xw @ p["w1"]) @ p["w2"]).float()))
    return (split_last(r, H, K), split_last(w, H, K), split_last(k, H, K),
            split_last(v, H, K), g)


def _rwkv_out(cfg, p, o, g):
    """Per-head groupnorm, gate, output projection: o (B, S, H, K)."""
    H, K = _rwkv_dims(cfg)
    o = groupnorm_heads(o, split_last(p["gn_w"], H, K),
                        split_last(p["gn_b"], H, K))
    return (merge_last(o) * g) @ p["wo"]


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
