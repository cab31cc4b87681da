"""The Mamba scan's segmented route in the traced window's prefills: the
least time of the scans the prompts asked for (benchkit.work.mamba_prefill
on the fp32 CUDA cores and the SFU, one scan a Mamba layer a prefill),
over the device time of the segmented kernels launched inside the
prefill spans, %."""
from benchkit import peaks, work
from benchkit.window import roofline_pct


def read(ctx):
    cfg = ctx.config
    n_mamba = sum(k == "mamba" for k, _ in work.layer_kinds(cfg))
    if not n_mamba:
        return None
    Di, N = cfg["mamba_expand"] * cfg["hidden_size"], cfg["mamba_d_state"]
    least = 0.0
    for s, _, _ in ctx.prefills:
        nbytes, flops, exps = work.mamba_prefill(s, Di, N)
        least += n_mamba * work.bound_s(nbytes, flops, peaks.FP32_FLOP_S,
                                        exps)
    dev = ctx.device_s([(a, b) for _, a, b in ctx.prefills],
                       lambda name: "mamba_segmented_kernel" in name)
    return roofline_pct(least, dev)
