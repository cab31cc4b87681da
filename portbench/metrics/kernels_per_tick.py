"""Device kernels launched from inside the engine's decode-tick spans (by
the host launch's time), over the ticks of the traced window."""


def read(ctx):
    if not ctx.ticks:
        return None
    n = len(ctx.launched_in([(a, b) for a, b, _ in ctx.ticks],
                            lambda name: True))
    return n / len(ctx.ticks) if n else None
