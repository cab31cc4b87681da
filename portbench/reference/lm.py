"""The plain reference of the benchmark's language models, in float32.

Written from the configuration file's equations, in plain ``torch``: no
kernel, no cache, no batching of the program's kind, nothing of the
program. It draws each layer's weights itself from the seed
(:func:`benchkit.weights.draw_layer`, the same draws the program was
given) and runs the layers one at a time, so that its memory is one
layer's weights and the activations.

The blocks (pre-norm residual): RMSNorm; attention (q, k, v projections,
the heads split, a per-head RMSNorm over the head dim on q and k where
``qk_norm`` is set, half-split RoPE, causal softmax attention with each
group of H / KV query heads on one key head, the output projection) or the
Mamba mixer (in_proj into x and z, a causal depthwise conv of width K over
x with bias and SiLU, x_proj into the step's dt rank, B and C, the step
size softplus(dt @ dt_w + dt_bias), the scan h = exp(delta A) h + delta x
B with A = -exp(A_log), y = h . C + D x, gated by SiLU(z), out_proj);
RMSNorm; the SiLU GLU MLP, or top-k experts (softmax router, the top k
renormalised, each expert a SiLU GLU, a dispatch of n tokens giving each
expert int(n k / E cf) slots rounded up to a multiple of 4, at least 4,
its slots taken by (token, choice) in order and the rest dropped). A
served sequence is dispatched as the program serves it: its prompt in one
dispatch, each generated token alone.

``quant="fp8"`` is the control: every matrix product's operands rounded to
float8 e4m3 (weights by output channel, activations by row, each scaled to
the format's range) before a float32 product.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from benchkit.configs import moe_capacity
from benchkit.weights import draw_layer, nest
from benchkit.work import layer_kinds

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """Float32 products in float32: TF32 off for matmuls and convolutions."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale along ``dim``'s slices
    (the scale maps each slice's largest magnitude to 448)."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Ops:
    """The matrix product of the reference, exact or through fp8."""

    def __init__(self, quant: str | None = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.quant = quant

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.quant and w.ndim >= 2:
            return fp8_round(w, dim=-2)
        return w

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.quant:
            x = fp8_round(x, dim=-1)
        return x @ w


def rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """Half-split rotary embedding of x (S, heads, D) at positions pos."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.float()[:, None] * freqs[None]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(cfg, w, h, ops, q_block: int = 1024):
    """Causal GQA attention of one sequence h (S, d) -> (S, d)."""
    S = h.shape[0]
    H, KV, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                cfg["head_dim"])
    G = H // KV
    eps = cfg["rms_norm_eps"]
    q = ops.mm(h, w["wq"]).view(S, H, D)
    k = ops.mm(h, w["wk"]).view(S, KV, D)
    v = ops.mm(h, w["wv"]).view(S, KV, D)
    if cfg.get("qk_norm"):
        q, k = rms(q, w["qn"]["w"], eps), rms(k, w["kn"]["w"], eps)
    pos = torch.arange(S, device=h.device)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    q = q.view(S, KV, G, D)
    out = torch.empty((S, KV, G, D), device=h.device)
    for a in range(0, S, q_block):
        b = min(S, a + q_block)
        s = torch.einsum("qkgd,tkd->kgqt", q[a:b], k[:b]) * D ** -0.5
        mask = torch.arange(b, device=h.device)[None, :] > \
            torch.arange(a, b, device=h.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
        out[a:b] = torch.einsum("kgqt,tkd->qkgd", torch.softmax(s, -1),
                                v[:b])
    return ops.mm(out.reshape(S, H * D), w["wo"])


def glu(x, wg, wi, wo, ops):
    return ops.mm(F.silu(ops.mm(x, wg)) * ops.mm(x, wi), wo)


def moe(cfg, w, x, ops, capacity: int | None):
    """Top-k experts over one dispatch x (n, d); ``capacity`` None: no
    token dropped (a single token never overflows)."""
    E, K = cfg["num_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(ops.mm(x, w["router"]), dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :K], idx[:, :K]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    y = torch.zeros_like(x)
    flat = idx.reshape(-1)
    for e in range(E):
        hit = flat == e
        if not bool(hit.any()):
            continue
        rank = torch.cumsum(hit.long(), 0) - 1
        keep = hit & (rank < capacity) if capacity is not None else hit
        slots = keep.nonzero()[:, 0]
        if slots.numel() == 0:
            continue
        tok, choice = slots // K, slots % K
        out = glu(x[tok], w["wg"][e], w["wi"][e], w["wo"][e], ops)
        y.index_add_(0, tok, out * gate[tok, choice][:, None])
    return y


def mamba(cfg, w, hs: list[torch.Tensor], ops, chunk: int = 128):
    """The Mamba mixer over sequences ``hs`` (each (S_i, d)), from zero
    state; the scan runs over all of them at once, padded at the end."""
    d = cfg["hidden_size"]
    di, N = cfg["mamba_expand"] * d, cfg["mamba_d_state"]
    K, dtr = cfg["mamba_d_conv"], cfg["mamba_dt_rank"]
    lens = [h.shape[0] for h in hs]
    S = max(lens)
    xz = torch.zeros((len(hs), S, 2 * di), device=hs[0].device)
    for i, h in enumerate(hs):
        xz[i, :lens[i]] = ops.mm(h, w["in_proj"])
    x, z = xz[..., :di], xz[..., di:]
    xp = F.pad(x, (0, 0, K - 1, 0))
    xc = sum(xp[:, j:j + S] * w["conv_w"][j] for j in range(K))
    xc = F.silu(xc + w["conv_b"])
    xdb = ops.mm(xc, w["x_proj"])
    delta = F.softplus(ops.mm(xdb[..., :dtr], w["dt_w"]) + w["dt_bias"])
    Bt, Ct = xdb[..., dtr:dtr + N], xdb[..., dtr + N:]
    A = -torch.exp(w["A_log"])
    h = torch.zeros((len(hs), di, N), device=x.device)
    y = torch.empty((len(hs), S, di), device=x.device)
    for a in range(0, S, chunk):
        b = min(S, a + chunk)
        dA = torch.exp(delta[:, a:b, :, None] * A)
        dBx = (delta[:, a:b] * xc[:, a:b])[..., None] * Bt[:, a:b, None, :]
        for t in range(b - a):
            h = torch.addcmul(dBx[:, t], dA[:, t], h)
            y[:, a + t] = torch.einsum("bdn,bn->bd", h, Ct[:, a + t])
    y = (y + xc * w["D"]) * F.silu(z)
    return [ops.mm(y[i, :lens[i]], w["out_proj"]) for i in range(len(hs))]


def _layer_weights(cfg, seed, layer, wdtype, device, ops):
    flat = draw_layer(cfg, seed, layer, wdtype, device)
    return nest({k: ops.weight(v) for k, v in flat.items()})


def serve_logits(cfg: dict, seed: int, seqs: list[torch.Tensor],
                 prompt_lens: list[int], wdtype: torch.dtype, device,
                 quant: str | None = None) -> list[torch.Tensor]:
    """Logits (T_i, V) of each served sequence at the positions that
    produced its served tokens: ``seqs[i]`` is the prompt followed by all
    served tokens but the last, ``prompt_lens[i]`` its prompt's length, so
    the positions are prompt_len - 1 .. len - 1. Weights drawn in
    ``wdtype`` (the dtype the program serves) and widened to float32."""
    ops = Ops(quant)
    eps = cfg["rms_norm_eps"]
    with torch.no_grad(), exact_fp32():
        top = _layer_weights(cfg, seed, -1, wdtype, device, ops)
        xs = [top["embed"]["tok"][s.to(device)] for s in seqs]
        head, ln_f = top["embed"]["head"], top["ln_f"]["w"]
        del top
        for i, (kind, is_moe) in enumerate(layer_kinds(cfg)):
            w = _layer_weights(cfg, seed, i, wdtype, device, ops)
            hs = [rms(x, w["ln1"]["w"], eps) for x in xs]
            if kind == "attn":
                mix = [attention(cfg, w["mix"], h, ops) for h in hs]
            else:
                mix = mamba(cfg, w["mix"], hs, ops)
            xs = [x + m for x, m in zip(xs, mix)]
            hs = [rms(x, w["ln2"]["w"], eps) for x in xs]
            if is_moe:
                out = []
                for h, S in zip(hs, prompt_lens):
                    y = torch.empty_like(h)
                    y[:S] = moe(cfg, w["mlp"], h[:S], ops,
                                moe_capacity(cfg, S))
                    if h.shape[0] > S:
                        y[S:] = moe(cfg, w["mlp"], h[S:], ops, None)
                    out.append(y)
            else:
                m = w["mlp"]
                out = [glu(h, m["wg"], m["wi"], m["wo"], ops) for h in hs]
            xs = [x + o for x, o in zip(xs, out)]
            del w
        return [ops.mm(rms(x[S - 1:], ln_f, eps), head)
                for x, S in zip(xs, prompt_lens)]


def served_gaps(logits: list[torch.Tensor], served: list[list[int]]):
    """For each served token, how far its logit lies below the row's best
    (0 where it is the best): a list of floats a sequence."""
    out = []
    for lg, toks in zip(logits, served):
        t = torch.tensor(toks, device=lg.device)
        best = lg.max(dim=-1).values
        out.append((best - lg.gather(1, t[:, None])[:, 0]).tolist())
    return out

