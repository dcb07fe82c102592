"""engine.busy_pct.serve: the service's busy_s (host time around its
search_many calls, as /healthz counts it) gained over the window, as a
share of the window's host seconds (from its start until every request
due in it was answered)."""


def read(ctx):
    if ctx.health is None:
        return None
    h0, h1, span_s = ctx.health
    return 100.0 * (h1["busy_s"] - h0["busy_s"]) / span_s \
        if span_s > 0 else None
