"""Flash attention's forward in the prefills of the traced window: the
least time of the calls the prompts asked for (benchkit.work.flash_fwd,
one call an attention layer a prefill), over the device time of the
forward kernels launched inside the prefill spans, %."""
from benchkit import work
from benchkit.window import roofline_pct


def is_flash_fwd(name):
    return ("flash_wgmma_kernel" in name or "flash_kernel" in name) \
        and "bwd" not in name


def read(ctx):
    cfg = ctx.config
    n_attn = sum(k == "attn" for k, _ in work.layer_kinds(cfg))
    H, KV, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                cfg["head_dim"])
    least = sum(n_attn * work.bound_s(*work.flash_fwd(s, H, KV, D))
                for s, _, _ in ctx.prefills)
    dev = ctx.device_s([(a, b) for _, a, b in ctx.prefills], is_flash_fwd)
    return roofline_pct(least, dev)
