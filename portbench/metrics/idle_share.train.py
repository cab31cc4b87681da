"""1 - (the union of device activity) / the traced window, in a training
cell, %."""


def read(ctx):
    if ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.window_s)
