"""The 95th percentile of the time to first token of every request whose
first token landed in the window, from when it was due, on the host's
clock, ms, in the code cell: there prefills queue behind each other and
the tail swings with them, so it is read beside the rate and not
bounded (in the chat cell the same tail is an end-to-end metric)."""


def read(ctx):
    return ctx.host.get("ttft_p95_ms")
