"""The 95th percentile of every gap between consecutive tokens of a
request, both in the window, over the whole window on the host's clock,
ms: where a prefill stalls the decoding rows. In a closed loop that keeps
every slot busy the cell is saturated, so the tail is read here beside
the rate and not bounded."""


def read(ctx):
    return ctx.host.get("itl_p95_ms")
