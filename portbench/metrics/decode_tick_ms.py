"""Mean of the serve engine's own decode-tick spans in the traced window
(each closes after the tick's tokens are on the host), ms."""


def read(ctx):
    if not ctx.ticks:
        return None
    return 1e3 * sum(b - a for a, b, _ in ctx.ticks) / len(ctx.ticks)
