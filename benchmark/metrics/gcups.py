"""gcups (and its splits, `gcups.<part>`): true query residues x true
database residues of every batch that completed in the window, over the
window's seconds (it runs in whole batches), / 1e9.  `gcups.peptides` is
the peptide batch's own, with its own bound: a third of that window is
host work a query, whose runs spread some ten times wider than a batch the
kernels fill."""

from perfkit.accounting import gcups


def read(ctx):
    if ctx.mode != "batch":
        return None
    return gcups(ctx.query_residues, ctx.db_residues, ctx.window_s)
