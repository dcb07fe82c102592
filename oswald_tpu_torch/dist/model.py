"""Shard-geometry scaling model (the port's own copy of oswald_tpu.dist.model,
semantics unchanged).

A projection of distributed search time from measured one-device
quantities and the database's exact shard geometry.  It prints every term,
so a first run on N devices can confirm or refute it:

  T(N) = t_single * cells(N) / cells(1) / N         compute
       + t_overhead                                 measured N = 1
                                                    distributed overhead
       + (N-1)*hop + ag_bytes(N)/bw                 one ring all-gather of
                                                    the packed [2, k+4]
                                                    int32 candidates per
                                                    search

cells(N) is the padded lane-residue count of the re-cut bin geometry at N
shards (dist/repack.py: bins re-cut by the DP, group counts rounded up to
N * group_block), so both the rounding and the length padding the re-cut
trades for it appear.  cells(1) is the geometry with groups rounded to
group_block only, the geometry t_single is measured on.

The N = 1 term reproduces the measured N = 1 time by construction (that
calibrates t_overhead).  Every N > 1 term is a prediction from geometry,
not a measurement of any device: the link rate and hop latency are
parameters, and the defaults below are order-of-magnitude placeholders
(at k = 10 the payload is ~100 B a shard, so the terms are
latency-dominated and insensitive to the rate).
"""

import dataclasses

from oswald_tpu_torch.dist.repack import (mesh_bin_plan, plan_sharded_cells,
                                          group_geometry)
from oswald_tpu_torch.io.db import GROUP_LANES

# placeholder link: bytes per second per direction, seconds per hop
LINK_BYTES_PER_S = 45e9
LINK_HOP_S = 1e-6
# trailing moment columns of a packed top-k (engine.search.MOM_COLS)
MOM_COLS = 4


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


@dataclasses.dataclass
class Projection:
    n_bins: int             # bins in the one-device geometry
    dispatches: int         # programs per search (1: one launch)
    t_single_s: float       # measured one-device search seconds
    t_mesh1_s: float        # measured N = 1 distributed search seconds
    overhead_s: float       # t_mesh1 - modelled N=1 compute
    base_cells: int         # one-device padded lane-residues
    merged_bins: dict       # N -> bin count after the re-cut
    inflation: dict         # N -> cells(N) / base_cells (>= 1)
    ag_bytes_per_dev: dict  # N -> all-gather bytes per device per search
    t_proj_s: dict          # N -> projected seconds (single query)
    efficiency: dict        # N -> (t_single/N) / t_proj  (latency)
    gcups: dict             # N -> projected GCUPS (true cells)
    # sustained stream (per-search overhead amortised over a batch);
    # empty when no batch measurement was supplied
    batch_n: int = 0
    t_batch_s: float = 0.0
    efficiency_sustained: dict = dataclasses.field(default_factory=dict)
    gcups_sustained: dict = dataclasses.field(default_factory=dict)

    def rows(self):
        out = []
        for n, t in self.t_proj_s.items():
            row = {"devices": n, "projected_s": round(t, 5),
                   "efficiency": round(self.efficiency[n], 3),
                   "projected_gcups": round(self.gcups[n], 1),
                   "merged_bins": self.merged_bins[n],
                   "inflation": round(self.inflation[n], 4)}
            if n in self.efficiency_sustained:
                row["efficiency_sustained"] = \
                    round(self.efficiency_sustained[n], 3)
                row["gcups_sustained"] = round(self.gcups_sustained[n], 1)
            out.append(row)
        return out


def scaling_projection(db, k: int, qlen: int, t_single_s: float,
                       t_mesh1_s: float, n_list=(1, 8, 64, 256),
                       group_block: int = 2,
                       t_batch_s: float = 0.0, batch_n: int = 0,
                       ici_bytes_per_s: float = LINK_BYTES_PER_S,
                       ici_hop_s: float = LINK_HOP_S) -> Projection:
    """Project distributed search time and efficiency at shard counts
    n_list from measured one-device and N = 1 times (see the module
    docstring).  t_batch_s/batch_n: optional measured one-device wall time
    of a batch_n-query batch (same qlen); adds the sustained rows, where
    the per-search overhead is paid once per batch.  ici_bytes_per_s and
    ici_hop_s are the link's rate and hop latency (the reference's
    argument names)."""
    geoms = [(L, int(db.bins[L]["seq"].shape[0])) for L in db.bin_lengths]
    # the geometry t_single was measured on: groups padded to group_block
    base = sum(_round_up(g, group_block) * L * GROUP_LANES
               for L, g in geoms) or 1
    payload = 8 * (k + MOM_COLS)     # packed [2, k+MOM_COLS] int32/shard
    group_Ls = group_geometry(db)    # group-granular re-cut geometry

    def cells(n):
        quanta = n * group_block
        plan = mesh_bin_plan(group_Ls, quanta)
        return plan_sharded_cells(group_Ls, quanta, plan), len(plan)

    cells1, _ = cells(1)
    # calibration: overhead is whatever the measured N = 1 time carries
    # beyond the modelled N = 1 compute, so t_proj[1] == t_mesh1 exactly
    overhead = max(t_mesh1_s - t_single_s * cells1 / base, 0.0)
    merged_bins, inflation, ag_b, t_proj, eff, gc = {}, {}, {}, {}, {}, {}
    eff_sus, gc_sus = {}, {}
    for n in n_list:
        c_n, nb = cells(n)
        merged_bins[n] = nb
        inflation[n] = c_n / base
        ag = payload * (n - 1)
        ag_b[n] = ag
        t_comp = t_single_s * (c_n / base) / n
        # one collective per search: a ring all-gather of the shard-local
        # candidate block
        t_ici = (n - 1) * ici_hop_s + ag / ici_bytes_per_s
        t = t_comp + overhead + t_ici
        t_proj[n] = t
        eff[n] = (t_single_s / n) / t if t > 0 else 0.0
        gc[n] = qlen * db.n_residues / t / 1e9 if t > 0 else 0.0
        if t_batch_s and batch_n:
            # sustained: the whole batch pays one overhead and batch_n
            # collectives; compute scales by the same cells
            tb = t_batch_s * (c_n / base) / n + overhead + batch_n * t_ici
            eff_sus[n] = (t_batch_s / n) / tb if tb > 0 else 0.0
            gc_sus[n] = batch_n * qlen * db.n_residues / tb / 1e9 \
                if tb > 0 else 0.0
    return Projection(n_bins=len(geoms), dispatches=1,
                      t_single_s=t_single_s, t_mesh1_s=t_mesh1_s,
                      overhead_s=overhead, base_cells=base,
                      merged_bins=merged_bins, inflation=inflation,
                      ag_bytes_per_dev=ag_b, t_proj_s=t_proj,
                      efficiency=eff, gcups=gc,
                      batch_n=batch_n, t_batch_s=t_batch_s,
                      efficiency_sustained=eff_sus,
                      gcups_sustained=gc_sus)
