"""Decode attention in the traced window's ticks: the least time of the
calls the busy rows asked for (benchkit.work.decode_attention over each
row's cached keys, one call an attention layer a tick), over the device
time of the decode kernels launched inside the tick spans, %."""
from benchkit import work
from benchkit.window import roofline_pct


def is_decode(name):
    return "decode_mma_kernel" in name or "decode_kernel" in name \
        or "decode_combine" in name


def read(ctx):
    cfg = ctx.config
    n_attn = sum(k == "attn" for k, _ in work.layer_kinds(cfg))
    H, KV, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                cfg["head_dim"])
    least = sum(n_attn * work.bound_s(*work.decode_attention(e, H, KV, D))
                for _, _, e in ctx.ticks)
    dev = ctx.device_s([(a, b) for a, b, _ in ctx.ticks], is_decode)
    return roofline_pct(least, dev)
