"""Model FLOPs of the traced window's training steps (benchkit.work's
formula: three forwards, no recomputation), over the window times the
card's bf16 peak, %."""
from benchkit import peaks, work


def read(ctx):
    if not ctx.steps:
        return None
    tr = ctx.traffic
    flops = len(ctx.steps) * work.train_step_flops(ctx.config, tr["batch"],
                                                   tr["seq_len"])
    return 100.0 * flops / (ctx.window_s * peaks.BF16_FLOP_S)
