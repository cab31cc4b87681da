"""The chat cell's rate: tokens landed in the window over its length, on
the host's clock, tokens/s (the traced run's whole window, its profiled
first seconds included). The decode tick that sets it is paced by the
host's launches, and the host's speed drifts by a fifth from run to run,
so it is read here and not bounded."""


def read(ctx):
    return ctx.host.get("output_tokens_per_s")
