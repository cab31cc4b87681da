"""Frozen counts of the work the traffic asks for: a kernel call's bytes and
operations, and a model's FLOPs, from shapes alone.

Each function counts what the call needs, whoever implements it: every
input byte read once and every output byte written once, and the
operations of the algorithm (for attention, the (query, key) pairs the
mask leaves visible). :func:`bound_s` is the least time the card could
take for them. The formulas are those the port's chip runs used for their
bound times (``chip_smoke.bwd_work`` and the kernel table's bytes), copied
so that a change to the program cannot move them.
"""
from __future__ import annotations

from benchkit import peaks


def bound_s(nbytes: float, flops: float, flop_s: float = peaks.BF16_FLOP_S,
            exps: float = 0.0) -> float:
    """The larger of the bytes over HBM's rate, the operations over their
    peak and the exponentials over the SFU's rate, in seconds."""
    return max(nbytes / peaks.HBM_BYTES_S, flops / flop_s,
               exps / peaks.SFU_EXP_S)


def causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


def flash_fwd(S: int, H: int, KV: int, D: int, Dv: int | None = None,
              es: int = 2, B: int = 1) -> tuple[float, float]:
    """(bytes, FLOP) of one causal prefill attention call over S tokens: q,
    k, v read, o written; 2 (D + Dv) FLOP a visible pair a head."""
    Dv = Dv or D
    nbytes = es * B * S * (H * D + KV * D + KV * Dv + H * Dv)
    return nbytes, 2 * (D + Dv) * B * H * causal_pairs(S)


def flash_bwd(S: int, H: int, KV: int, D: int, Dv: int | None = None,
              es: int = 2, B: int = 1) -> tuple[float, float]:
    """(bytes, FLOP) of one causal flash backward call: q, k, v, o, dO read
    and dQ, dK, dV written in their dtype, the float32 log-sum-exp read;
    2 (3 D + 2 Dv) FLOP (S, dP, dV, dK, dQ) a visible pair a head."""
    Dv = Dv or D
    q, k, v = B * S * H * D, B * S * KV * D, B * S * KV * Dv
    nbytes = es * (2 * q + 2 * k + 2 * v + 2 * B * S * H * Dv) + 4 * B * H * S
    return nbytes, 2 * (3 * D + 2 * Dv) * B * H * causal_pairs(S)


def decode_attention(entries: list[int], H: int, KV: int, D: int,
                     es: int = 2) -> tuple[float, float]:
    """(bytes, FLOP) of one decode attention call over rows that read
    ``entries`` cached keys each: those keys and values read, q read and o
    written; 4 D FLOP a key a head."""
    n = sum(entries)
    nbytes = es * (2 * n * KV * D + 2 * len(entries) * H * D)
    return nbytes, 4 * D * H * n


def mamba_prefill(S: int, Di: int, N: int, es: int = 2, es_a: int = 4,
                  B: int = 1) -> tuple[float, float, float]:
    """(bytes, FLOP, exponentials) of one Mamba scan over S steps from a
    zero state: delta and x read and y written in their dtype, B and C
    read, A read, the float32 final state written; 6 FLOP a state element
    a step and 1 a channel a step, one exponential a state element a
    step."""
    n = B * S * Di
    nbytes = (3 * es * n + 2 * es * B * S * N + es_a * Di * N
              + 4 * B * Di * N)
    return nbytes, n * (6 * N + 1), n * N


# ---- model FLOPs -----------------------------------------------------------

def _layer_matmul_params(cfg: dict, kind: str, moe: bool) -> int:
    """Parameters a token multiplies through in one layer (active experts
    only), from the configuration file's sizes."""
    d, H, KV, D = (cfg["hidden_size"], cfg["num_attention_heads"],
                   cfg["num_key_value_heads"], cfg["head_dim"])
    if kind == "attn":
        mix = d * H * D + 2 * d * KV * D + H * D * d
    else:
        di, N = cfg["mamba_expand"] * d, cfg["mamba_d_state"]
        dtr = cfg["mamba_dt_rank"]
        mix = d * 2 * di + di * (dtr + 2 * N) + dtr * di + di * d
    if moe:
        mlp = (cfg["num_experts_per_tok"] * 3 * d
               * cfg["expert_intermediate_size"] + d * cfg["num_experts"])
    else:
        mlp = 3 * d * cfg["intermediate_size"]
    return mix + mlp


def layer_kinds(cfg: dict) -> list[tuple[str, bool]]:
    """(mixer kind, MoE MLP) of every layer: attention unless the file gives
    an attention period (then Mamba elsewhere), MoE at the expert period's
    offset where it gives one."""
    out = []
    for i in range(cfg["num_hidden_layers"]):
        kind = "attn"
        if "attn_layer_period" in cfg:
            kind = ("attn" if i % cfg["attn_layer_period"]
                    == cfg["attn_layer_offset"] else "mamba")
        moe = ("expert_layer_period" in cfg and i % cfg["expert_layer_period"]
               == cfg["expert_layer_offset"])
        out.append((kind, moe))
    return out


def token_flops(cfg: dict, n_tokens: int, keys: int) -> float:
    """Forward FLOPs of ``n_tokens`` tokens that together attend ``keys``
    (query, key) pairs in each attention layer: 2 a parameter multiplied
    (the head included, the embedding lookup not), 4 D a pair a head, and
    the Mamba layers' conv (2 K a channel) and scan (6 N + 1 a channel)."""
    H, D = cfg["num_attention_heads"], cfg["head_dim"]
    total = 2 * n_tokens * cfg["hidden_size"] * cfg["vocab_size"]
    for kind, moe in layer_kinds(cfg):
        total += 2 * n_tokens * _layer_matmul_params(cfg, kind, moe)
        if kind == "attn":
            total += 4 * H * D * keys
        else:
            di = cfg["mamba_expand"] * cfg["hidden_size"]
            total += n_tokens * di * (2 * cfg["mamba_d_conv"]
                                      + 6 * cfg["mamba_d_state"] + 1)
    return float(total)


def prefill_flops(cfg: dict, S: int) -> float:
    """Forward FLOPs of a causal pass over S tokens."""
    return token_flops(cfg, S, causal_pairs(S))


def decode_flops(cfg: dict, entries: list[int]) -> float:
    """Forward FLOPs of one decode tick over rows reading ``entries`` keys."""
    return token_flops(cfg, len(entries), sum(entries))


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: three times the forward (forward,
    and the backward's two products), no recomputation counted."""
    return 3.0 * batch * prefill_flops(cfg, seq)
