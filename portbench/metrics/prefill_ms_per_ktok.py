"""The serve engine's prefill spans in the traced window, summed, per
1,000 prompt tokens, ms."""


def read(ctx):
    n = sum(s for s, _, _ in ctx.prefills)
    if not n:
        return None
    return 1e6 * sum(b - a for _, a, b in ctx.prefills) / n
