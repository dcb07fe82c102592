"""latency_p95_ms: the 95th percentile, nearest rank, of every request due
in the window, each timed from when it was due to be sent to its answer; a
request with no answer is infinite there."""

from perfkit.accounting import percentile


def read(ctx):
    if ctx.latencies_ms is None:
        return None
    return percentile(ctx.latencies_ms, 95)
