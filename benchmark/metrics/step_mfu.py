"""step_mfu (and its splits, `step_mfu.<part>`): the least time the card
could take for the Smith-Waterman cells of the traced window (as
`sw_kernels_roofline` counts them) as a share of the whole traced window,
idle time included: the whole path's share of the card's peak, which
bounds what the kernels' roofline can give end to end."""

from perfkit.bound import mfu_pct


def read(ctx):
    return mfu_pct(ctx.trace, ctx.db_residues)
