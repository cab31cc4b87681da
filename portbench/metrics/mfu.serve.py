"""Model FLOPs of every prefill token and decode row of the traced window
(benchkit.work's formula), over the window times the card's bf16 peak,
%."""
from benchkit import peaks, work


def read(ctx):
    flops = sum(work.prefill_flops(ctx.config, s) for s, _, _ in ctx.prefills)
    flops += sum(work.decode_flops(ctx.config, e) for _, _, e in ctx.ticks)
    if not flops:
        return None
    return 100.0 * flops / (ctx.window_s * peaks.BF16_FLOP_S)
