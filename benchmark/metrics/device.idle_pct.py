"""device.idle_pct (and its splits by the end-to-end metric they move,
`device.idle_pct.<part>`): the share of the traced window in which nothing
ran on the card: 1 - (the union of every kernel, copy and memset interval
of the torch.profiler trace) / (the traced window)."""

from perfkit.trace import idle_pct


def read(ctx):
    return idle_pct(ctx.trace)
