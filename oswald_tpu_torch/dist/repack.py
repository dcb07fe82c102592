"""Mesh-adaptive bin geometry: re-cut the bins so shard rounding vanishes
(the port's own copy of oswald_tpu.dist.repack, semantics unchanged).

A sharded engine that pads every bin's group count to a multiple of the
shard quanta (`quanta` below) computes that padding on every search.  On a
small database the rounding dominates: bins of ~17 groups at quanta 16 pad
to 32 groups, 1.9x the real work.  Re-partitioning the sorted group stream
(groups are fixed 1024-sequence blocks of the length-ascending order; only
bin boundaries and each bin's padded length move) trades a little length
padding for the rounding: cuts may fall so that nearly every bin's group
count is an exact multiple of the quanta.  Merging whole bins cannot do
this (17-group bins merge into 34-group bins, still not multiples of 16);
cuts at group granularity can (a 16-group bin next to an 18-group bin
re-cuts into 16 + 16 + 2-into-the-next).  Dummy residues score 0 against
everything and padding lanes carry id -1, so the re-partition is exact:
same scores, same ids, same tie-breaks.

`mesh_bin_plan` finds the optimal contiguous partition by the DP of the
pack-time bin partitioner (io/db.py _partition_bins), over runs of equal
quantised per-group max length, with the cost of a bin being its
shard-rounded padded cells:

    cost(range i..j) = round_up(sum G, quanta) * L_j * 1024 + bin_cost

`repack_for_mesh` recovers each group's true quantised max length from the
packed per-slot lengths, runs the DP, and applies the plan to a PackedDB
without copying the (possibly memory-mapped) residue arrays: re-cut bins
expose a lazy group-sliceable view that column-pads (or column-truncates:
trailing columns past a group's true max are all DUMMY) each source span on
read.  `dist/model.py` runs the same DP per shard count.

The port's distributed engine (dist/shard.py) splits each bin's groups over
its ranks without this re-cut (its kernels take any group count); the
re-cut is kept for the geometry model and for comparing the two splits.
"""

import dataclasses

import numpy as np

from oswald_tpu_torch.alphabet import DUMMY
from oswald_tpu_torch.io.db import (PackedDB, SUBLANES, LANES,
                                    GROUP_LANES, LENGTH_QUANTUM,
                                    _BIN_COST_RESIDUES, _round_up)


# above this group count the exact O(G^2) DP switches to a restricted
# candidate-cut set (run boundaries + the global quanta grid) — within a
# few tenths of a percent of optimal while staying near-linear
_EXACT_DP_MAX_GROUPS = 20_000


def mesh_bin_plan(group_Ls, quanta: int, bin_cost: int = _BIN_COST_RESIDUES):
    """Optimal contiguous partition of the sorted group stream for a
    mesh's group quanta.

    group_Ls: per-group quantised max lengths, non-decreasing (global
    slot order).  Returns a list of (lo, hi) GROUP index ranges; each
    range is one bin of length group_Ls[hi-1].  Minimises total sharded
    padded cells (each bin's group count rounded up to `quanta`) plus
    `bin_cost` padded-residue units of fixed per-bin overhead (dispatch +
    program count) — the exact objective the distributed engine pays per
    search.  Cuts fall at ANY group index (this is what lets a 30-group
    run split into 16 + 14-carried-forward so shard rounding vanishes);
    past _EXACT_DP_MAX_GROUPS the candidate cuts are restricted to run
    boundaries plus the global quanta grid, which preserves that
    property.
    """
    Ls = np.asarray(group_Ls, np.int64)
    G = int(Ls.size)
    if G == 0:
        return []
    if np.any(Ls[1:] < Ls[:-1]):
        raise ValueError("group_Ls must be non-decreasing")
    if G <= _EXACT_DP_MAX_GROUPS:
        cand = np.arange(G + 1)
    else:
        runs = np.flatnonzero(np.diff(Ls)) + 1
        # coarsen the quanta grid so the candidate count (and the
        # quadratic DP) stays bounded on huge databases: step up in
        # whole quanta, capped at ~8k grid points
        step = _round_up(max(quanta, -(-G // 8192)), quanta)
        grid = np.arange(0, G + 1, step)
        cand = np.unique(np.concatenate([[0], runs, grid, [G]]))
    # DP over candidate cut positions (vectorised over predecessors)
    nc = cand.size
    best = np.full(nc, np.inf)
    cut = np.zeros(nc, np.int64)
    best[0] = 0.0
    for jj in range(1, nc):
        j = cand[jj]
        counts = j - cand[:jj]
        costs = best[:jj] + bin_cost + \
            ((counts + quanta - 1) // quanta) * quanta * \
            int(Ls[j - 1]) * GROUP_LANES
        ii = int(np.argmin(costs))
        best[jj] = costs[ii]
        cut[jj] = ii
    ranges = []
    jj = nc - 1
    while jj > 0:
        ii = int(cut[jj])
        ranges.append((int(cand[ii]), int(cand[jj])))
        jj = ii
    ranges.reverse()
    return ranges


def plan_sharded_cells(group_Ls, quanta: int, plan) -> int:
    """Padded cells (lane-residues) the mesh computes under a plan: sum
    over bins of round_up(group count, quanta) * L_max * 1024."""
    Ls = np.asarray(group_Ls, np.int64)
    total = 0
    for lo, hi in plan:
        total += _round_up(hi - lo, quanta) * int(Ls[hi - 1]) * GROUP_LANES
    return total


class _MergedGroups:
    """Read-only concatenation of several group spans ([G_i, L_i, 8, 128]
    array views) along the group axis, column-padded with DUMMY — or
    column-truncated, when a span's stored padding exceeds the bin's L —
    to a common L.  Truncation is exact: the plan guarantees L >= every
    spanned group's true max length, so only DUMMY columns are cut.

    Materialises only the group rows actually indexed (per-rank and per-slice group
    ranges), so mmap-backed .oswt bins keep their no-read-until-sliced
    behavior through a re-partition.
    """

    def __init__(self, parts, L: int):
        # parts: [(array [G_i, L_i, 8, 128], L_i)]; the arrays may be
        # basic-slice views of mmap-backed bins
        self._parts = parts
        self._L = int(L)
        counts = [int(p.shape[0]) for p, _ in parts]
        self._starts = np.concatenate([[0], np.cumsum(counts)])
        self.shape = (int(self._starts[-1]), self._L, SUBLANES, LANES)
        self.dtype = np.int8
        self.ndim = 4

    def __len__(self):
        return self.shape[0]

    def _slice(self, lo: int, hi: int) -> np.ndarray:
        out = np.full((hi - lo, self._L, SUBLANES, LANES), DUMMY, np.int8)
        for (arr, Lp), p_lo in zip(self._parts, self._starts[:-1]):
            a = max(lo, int(p_lo))
            b = min(hi, int(p_lo) + arr.shape[0])
            if a < b:
                w = min(Lp, self._L)
                out[a - lo:b - lo, :w] = arr[a - p_lo:b - p_lo, :w]
        return out

    def __getitem__(self, idx):
        rest = ()
        if isinstance(idx, tuple):
            idx, rest = idx[0], idx[1:]
        if isinstance(idx, slice):
            lo, hi, step = idx.indices(self.shape[0])
            if step != 1:
                raise IndexError("merged bins support unit-stride group "
                                 "slices only")
            out = self._slice(lo, hi)
            return out[(slice(None),) + rest] if rest else out
        i = int(idx)
        if i < 0:
            i += self.shape[0]
        if not (0 <= i < self.shape[0]):
            raise IndexError(i)
        out = self._slice(i, i + 1)[0]
        return out[rest] if rest else out

    def __array__(self, dtype=None, copy=None):
        out = self._slice(0, self.shape[0])
        return out.astype(dtype) if dtype is not None else out


def group_geometry(db: PackedDB) -> np.ndarray:
    """Per-group quantised max lengths in global slot (id) order — the
    DP's input.  A group's quantised length is its true max slot length
    rounded up to LENGTH_QUANTUM (recovered from the packed per-slot
    lengths — columns past it hold only DUMMY), never more than its
    bin's stored width."""
    parts = []
    for L in db.bin_lengths:
        lens = np.asarray(db.bins[L]["len"])
        G = lens.shape[0]
        if not G:
            continue
        gmax = lens.reshape(G, -1).max(axis=1)
        parts.append(np.minimum(
            L, (np.maximum(gmax, 1) + LENGTH_QUANTUM - 1)
            // LENGTH_QUANTUM * LENGTH_QUANTUM).astype(np.int64))
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def repack_for_mesh(db: PackedDB, quanta: int,
                    bin_cost: int = _BIN_COST_RESIDUES) -> PackedDB:
    """A PackedDB whose bin partition is re-cut per `mesh_bin_plan` for
    a group quanta (shards x group_block in oswald_tpu's mesh).  Exact:
    sequence contents, ids and per-sequence lengths are unchanged; re-cut
    residue arrays are lazy DUMMY-column-padded/truncated views of the
    originals (no mmap copy).  Returns `db` itself when the plan reproduces
    the existing bins exactly."""
    group_Ls = group_geometry(db)
    if not group_Ls.size:
        return db
    plan = mesh_bin_plan(group_Ls, quanta, bin_cost)
    ranges = [(lo, hi, int(group_Ls[hi - 1])) for lo, hi in plan]
    # no-op check: each new bin == one whole original bin at the same L
    orig = []
    off = 0
    for L in db.bin_lengths:
        G = int(db.bins[L]["seq"].shape[0])
        orig.append((off, off + G, L))
        off += G
    if ranges == orig:
        return db
    # an optimal plan never ends two bins inside one equal-L run
    # (round_up is superadditive, so splitting only adds bin_cost), so
    # bin lengths are unique dict keys; check rather than assume (a
    # duplicate would silently drop a bin, also under python -O)
    louts = [r[2] for r in ranges]
    if len(set(louts)) != len(louts):
        raise ValueError(f"re-cut plan gives two bins one length: {louts}")
    bins = {}
    for g_lo, g_hi, L_out in ranges:
        # contiguous spans of whole-or-partial original bins
        parts, lens_parts, ids_parts = [], [], []
        for (o_lo, o_hi, o_L), Lb in zip(orig, db.bin_lengths):
            a, b = max(g_lo, o_lo), min(g_hi, o_hi)
            if a < b:
                sl = slice(a - o_lo, b - o_lo)
                parts.append((db.bins[Lb]["seq"][sl], o_L))
                lens_parts.append(np.asarray(db.bins[Lb]["len"][sl]))
                ids_parts.append(np.asarray(db.bins[Lb]["id"][sl]))
        if len(parts) == 1 and parts[0][1] == L_out and \
                parts[0][0].shape[0] == db.bins[L_out]["seq"].shape[0]:
            bins[L_out] = db.bins[L_out]       # untouched original bin
            continue
        bins[L_out] = {
            "seq": _MergedGroups(parts, L_out),
            "len": np.concatenate(lens_parts),
            "id": np.concatenate(ids_parts),
        }
    return dataclasses.replace(db, bins=bins)
