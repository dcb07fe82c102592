"""latency_p50_ms: the median, nearest rank, of the same requests as
latency_p95_ms."""

from perfkit.accounting import percentile


def read(ctx):
    if ctx.latencies_ms is None:
        return None
    return percentile(ctx.latencies_ms, 50)
