"""The least time the card could take for a number of Smith-Waterman
cells, from the throughput of its instructions: the table of peaks of the
kernels' roofline (metrics `sw_kernels_roofline.*`, `step_mfu.*`), a copy of the
constants of `oswald_tpu_torch.lab.bound` (PERF.md, "The bound").

- 5.5 instructions a cell: the fewest known for one cell of the engine's
  column body (one VIADDMNMX with the relu for the diagonal term, one
  each for c, H, E' and F', half a VIMNMX3 for the running best);
- 33.5e12 instructions a second: what the NVIDIA H100 SXM starts, four
  warp instructions (128 lanes) a clock on each of 132 SMs at its maximum
  SM clock of 1.98 GHz; the data sheet's 67 TFLOP/s of float32 is the
  same rate counted as 2 FLOP a lane (one FMA).

The bytes (each residue once, each score once) bound a search at under
1% of this, so the instructions bound it.  Cells are counted from the
inputs the benchmark sent, over true residues, whatever implements them.
"""

INSTR_PER_CELL = 5.5
INSTR_PER_S = 67e12 / 2


def bound_seconds(query_residues: int, db_residues: int) -> float:
    return query_residues * db_residues * INSTR_PER_CELL / INSTR_PER_S


def roofline_pct(trace, db_residues):
    """The cells' bound over the time the card was busy in the traced
    window, as a percentage; None with nothing to read."""
    if trace is None or trace["busy_s"] <= 0 or not trace["query_residues"]:
        return None
    return 100.0 * bound_seconds(trace["query_residues"], db_residues) / \
        trace["busy_s"]


def mfu_pct(trace, db_residues):
    """The cells' bound over the whole traced window, idle time included,
    as a percentage; None with nothing to read."""
    if trace is None or trace["window_s"] <= 0 or \
            not trace["query_residues"]:
        return None
    return 100.0 * bound_seconds(trace["query_residues"], db_residues) / \
        trace["window_s"]
