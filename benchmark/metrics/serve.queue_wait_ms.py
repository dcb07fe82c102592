"""serve.queue_wait_ms: the mean wait of a request in the service's queue,
from being queued to the start of the dispatch that takes it, over the
requests dispatched in the window: /healthz `queue_wait_s` over `waited`
(the service's own counters), their differences over the window, in ms.
None where the service keeps no such counters."""


def read(ctx):
    if ctx.health is None:
        return None
    h0, h1, _ = ctx.health
    if "queue_wait_s" not in h1:
        return None
    n = h1["waited"] - h0["waited"]
    return 1e3 * (h1["queue_wait_s"] - h0["queue_wait_s"]) / n \
        if n > 0 else None
