"""The 95th percentile of every request's latency in the untraced window, issue to top-k ids and scores on the host."""


def read(ctx):
    return ctx.window["p95_ms"]
