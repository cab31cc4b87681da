"""Flash attention's backward in the traced window's training steps: the
least time of the calls the steps asked for (benchkit.work.flash_bwd, one
call an attention layer a step), over the device time of the backward's
kernels launched inside the steps, %."""
from benchkit import work
from benchkit.window import roofline_pct


def read(ctx):
    cfg, tr = ctx.config, ctx.traffic
    n_attn = sum(k == "attn" for k, _ in work.layer_kinds(cfg))
    H, KV, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                cfg["head_dim"])
    one = work.bound_s(*work.flash_bwd(tr["seq_len"], H, KV, D,
                                       B=tr["batch"]))
    least = len(ctx.steps) * n_attn * one
    dev = ctx.device_s(ctx.steps, lambda name: "flash_bwd" in name)
    return roofline_pct(least, dev)
