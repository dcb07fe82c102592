"""The arithmetic of the end-to-end metrics.

`gcups` is a frozen copy of `oswald_tpu_torch.utils.metrics.gcups`: query
residues x database residues over seconds, / 1e9, over true residues.
`percentile` is the nearest-rank percentile: the smallest value that at
least p% of the values do not exceed (a request that got no answer is
infinite there, and so counts as missing every limit).
"""

import math


def gcups(query_residues: int, db_residues: int, seconds: float) -> float:
    """GCUPS = Q * D / (t * 1e9)."""
    if seconds <= 0:
        return float("inf")
    return query_residues * db_residues / (seconds * 1e9)


def percentile(values, p: float) -> float:
    v = sorted(values)
    if not v:
        return math.nan
    return v[max(0, math.ceil(p / 100.0 * len(v)) - 1)]
