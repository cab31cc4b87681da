"""CUDA-event time of global_norm + TrainStep.update, a step, ms (mean
over the traced window's steps)."""


def read(ctx):
    if not ctx.update_ms:
        return None
    return sum(ctx.update_ms) / len(ctx.update_ms)
