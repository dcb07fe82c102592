"""sw_kernels_roofline (and its splits, `sw_kernels_roofline.<part>`): the
least time the card could take for the Smith-Waterman cells of the
search_many calls that ran wholly inside the traced window
(`perfkit.bound`: 5.5 instructions a cell at 33.5e12 a second, true
residues), as a share of the time the card was busy in that window (every
operation, whatever its name)."""

from perfkit.bound import roofline_pct


def read(ctx):
    return roofline_pct(ctx.trace, ctx.db_residues)
