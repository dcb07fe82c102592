"""Packed databases: length-binned, fixed-shape lane packing (the port's own
copy of oswald_tpu.io.db; both packages read and write the same `.oswt`
artifact).

- Sequences are length-sorted ascending and packed into groups of 1024
  lanes shaped [8, 128].  Lane l of group g holds one whole database
  sequence; padding lanes and positions hold the dummy residue, which every
  matrix scores 0, so they can never change a score.
- Group lengths are rounded up to LENGTH_QUANTUM (32) and groups with equal
  padded length are stacked into a bin: one [G, L, 8, 128] int8 array.
- The persisted artifact is a directory of .npy arrays + titles + meta.json.
  .npy arrays memory-map, so a large database loads without being read
  whole.

Packing uses the native C++ packer (oswald_tpu_torch.io.native) when its
library is available and numpy otherwise; io/stream.py is the out-of-core
preprocess, and `import_reference_db`/`export_reference_db` convert from
and to the FPGA tool OSWALD's `.desc/.info/.seq` format.
"""

import bisect
import dataclasses
import json
import os
import sys
import time

import numpy as np

from oswald_tpu_torch.alphabet import DUMMY
from oswald_tpu_torch.io.fasta import parse_fasta
from oswald_tpu_torch.utils.hostmem import numpy_nohuge

SUBLANES = 8
LANES = 128
GROUP_LANES = SUBLANES * LANES          # 1024 sequences per group
# Bin granularity of the `.oswt` format.  Nearly all padding is quantum
# rounding (group spread after sorting is well under 1%).
LENGTH_QUANTUM = 32

# v1: original artifact (128-quantum bins, eager titles only).
# v2: 64-quantum bins + titles_idx.npy (lazy title resolution).
# v3: 32-quantum bins.
# load_db accepts all three; v1 falls back to eager titles.
FORMAT_VERSION = 3
_SUPPORTED_VERSIONS = (1, 2, 3)


@dataclasses.dataclass
class PackedDB:
    """In-memory packed database.

    bins: {padded_len L: dict(seq=[G,L,8,128] int8, len=[G,8,128] int32,
                              id=[G,8,128] int32)}
          `id` indexes the length-sorted order; -1 marks padding lanes.
    lengths: int64[n_seqs]   true lengths in sorted order
    titles:  list[str]       titles in sorted order
    """
    bins: dict
    lengths: np.ndarray
    titles: list
    n_seqs: int
    n_residues: int

    @property
    def bin_lengths(self):
        return sorted(self.bins.keys())

    def title_of(self, sorted_id: int) -> str:
        return self.titles[sorted_id]

    def sequence_of(self, sorted_id: int) -> np.ndarray:
        """Recover one encoded sequence from the packed bins by sorted id.

        Groups hold 1024 consecutive sorted ids each, so the id maps to
        (group, sublane, lane) directly; the per-bin group index comes
        from a lazily built first-id table (reads one id scalar per
        stacked group, mmap-friendly).
        """
        if not (0 <= sorted_id < self.n_seqs):
            raise IndexError(
                f"sequence id {sorted_id} out of range 0..{self.n_seqs - 1}")
        starts = getattr(self, "_group_first_ids", None)
        if starts is None:
            starts = []                       # (first_id, L, g_in_bin)
            for L in self.bin_lengths:
                ids = self.bins[L]["id"]
                for g in range(ids.shape[0]):
                    starts.append((int(ids[g, 0, 0]), L, g))
            starts.sort()
            self._group_first_ids = starts
        pos = bisect.bisect_right(starts, (sorted_id, float("inf"))) - 1
        first_id, L, g = starts[pos]
        slot = sorted_id - first_id
        su, la = slot // LANES, slot % LANES
        b = self.bins[L]
        if int(b["id"][g, su, la]) != sorted_id:
            # explicit raise (not assert): under `python -O` a layout
            # mismatch would silently return the WRONG sequence
            raise ValueError(
                f"packed-db layout mismatch resolving sequence {sorted_id} "
                f"(bin {L}, group {g}, slot {slot}) — corrupted or "
                "incompatible artifact")
        n = int(b["len"][g, su, la])
        return np.asarray(b["seq"][g, :n, su, la])


def from_reference(ref_db) -> PackedDB:
    """The port's PackedDB for a packed database of the oswald_tpu package,
    taken by its attributes (`bins[L]["seq"|"len"|"id"]`, `lengths`,
    `titles`, `n_seqs`, `n_residues`) without importing that package.  The
    arrays are shared, not copied."""
    bins = {int(L): {k: ref_db.bins[L][k] for k in ("seq", "len", "id")}
            for L in ref_db.bin_lengths}
    return PackedDB(bins=bins, lengths=np.asarray(ref_db.lengths),
                    titles=ref_db.titles, n_seqs=int(ref_db.n_seqs),
                    n_residues=int(ref_db.n_residues))


def db_len_stats(db: PackedDB):
    """Per-sorted-id float32 ln-length table, its float64 (sum, sum^2),
    and the (unique_lengths, counts) histogram for the E-value integral."""
    lnl = np.log(np.maximum(np.asarray(db.lengths, np.float64),
                            1.0)).astype(np.float32)
    l64 = lnl.astype(np.float64)
    hist = np.unique(np.asarray(db.lengths), return_counts=True)
    return lnl, (float(l64.sum()), float((l64 * l64).sum())), hist


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


def _pack_groups_impl(seqs_flat, lengths, offsets, order, n_groups,
                      group_Ls):
    """Scatter sorted sequences into [L, 1024] lane-major groups.

    Residues are gathered into sorted order once; then the native C++
    OpenMP packer fills every group when its library is available (unless
    OSWALD_NO_NATIVE is set), else each group is one numpy scatter through
    a flat index (no Python per-slot loop)."""
    n = len(order)
    use_native = not os.environ.get("OSWALD_NO_NATIVE")
    sorted_lens = lengths[order]
    sorted_offs = np.concatenate([[0], np.cumsum(sorted_lens)])
    src_idx = (np.repeat(offsets[order], sorted_lens)
               + _ragged_arange(sorted_lens)) if n else \
        np.zeros(0, np.int64)
    sorted_flat = np.asarray(seqs_flat, np.int8)[src_idx]

    if use_native:
        from oswald_tpu_torch.io import native
        if native.available():
            group_starts = np.arange(n_groups + 1, dtype=np.int64) \
                * GROUP_LANES
            group_starts[-1] = n
            return native.pack_groups(sorted_flat, sorted_offs,
                                      group_starts, group_Ls)

    out = []
    for g in range(n_groups):
        lo, hi = g * GROUP_LANES, min((g + 1) * GROUP_LANES, n)
        L = group_Ls[g]
        cnt = hi - lo
        lens = sorted_lens[lo:hi]
        seq = np.full((L, GROUP_LANES), DUMMY, dtype=np.int8)
        # flat scatter: residue p of slot s lands at p*GROUP_LANES + s
        slots = np.repeat(np.arange(cnt), lens)
        pos = _ragged_arange(lens)
        seq.reshape(-1)[pos * GROUP_LANES + slots] = \
            sorted_flat[sorted_offs[lo]:sorted_offs[hi]]
        out.append(seq)
    return out


def _ragged_arange(lens):
    total = int(np.sum(lens))
    out = np.arange(total, dtype=np.int64)
    offs = np.repeat(np.cumsum(lens) - lens, lens)
    return out - offs


_BIN_COST_RESIDUES = 262_144


def _argsort_lengths(lengths: np.ndarray) -> np.ndarray:
    """Stable ascending argsort, via the narrowest dtype that holds the
    keys — numpy's stable sort is an O(n) radix sort for <=16-bit ints."""
    if lengths.size and int(lengths.max()) < (1 << 16):
        return np.argsort(lengths.astype(np.uint16), kind="stable")
    return np.argsort(lengths, kind="stable")


def _partition_bins(group_Ls, lane_counts, bin_cost=_BIN_COST_RESIDUES):
    """Optimal contiguous partition of ascending group lengths into bins.

    Each bin costs `bin_cost` padded-residue-equivalents of fixed overhead
    plus the padding from
    raising its groups to the bin's max length.  Exact: consecutive groups
    sharing one quantised length are first fused into runs — moving any
    cut from inside a run to the run's end only ever shrinks padding (the
    groups that move into the earlier bin drop from the later bin's larger
    L to their own), so an optimal partition with run-boundary cuts always
    exists — then an O(R^2) DP runs over the R distinct-length runs (R is
    tiny: lengths are LENGTH_QUANTUM-quantised).  Returns the padded length
    per group.
    """
    if len(group_Ls) == 0:
        return []
    # fuse runs of equal L
    run_L, run_lanes, run_groups = [], [], []
    for L, lanes in zip(group_Ls, lane_counts):
        if run_L and run_L[-1] == L:
            run_lanes[-1] += lanes
            run_groups[-1] += 1
        else:
            run_L.append(L)
            run_lanes.append(lanes)
            run_groups.append(1)
    out_runs = _partition_bins_dp(run_L, run_lanes, bin_cost)
    out = []
    for L, cnt in zip(out_runs, run_groups):
        out.extend([L] * cnt)
    return out


def _partition_bins_dp(group_Ls, lane_counts, bin_cost):
    N = len(group_Ls)
    INF = float("inf")
    best = [INF] * (N + 1)
    cut = [0] * (N + 1)
    best[0] = 0.0
    for j in range(1, N + 1):
        L_bin = group_Ls[j - 1]              # ascending => max of any run
        lanes_sum = 0
        for i in range(j - 1, -1, -1):
            lanes_sum += lane_counts[i]
            c = best[i] + bin_cost + L_bin * lanes_sum
            if c < best[j]:
                best[j] = c
                cut[j] = i
    out = [0] * N
    j = N
    while j > 0:
        i = cut[j]
        for g in range(i, j):
            out[g] = group_Ls[j - 1]
        j = i
    return out


def pack_sequences(seqs_flat, lengths, titles=None,
                   bin_cost=_BIN_COST_RESIDUES) -> PackedDB:
    """Pack encoded sequences into length-binned lane groups.

    seqs_flat: int8[D] concatenated encoded residues
    lengths:   int[n]  per-sequence lengths (order = record order)
    bin_cost:  fixed per-bin overhead (padded-residue-equivalents) for the
               bin partition optimizer; higher = fewer, more-padded bins
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    n = len(lengths)
    seqs_flat = np.asarray(seqs_flat, dtype=np.int8)
    if seqs_flat.size and (seqs_flat.min() < 0 or seqs_flat.max() > DUMMY):
        raise ValueError(
            "sequence data contains codes outside 0..23 — encode residue "
            "strings with oswald_tpu_torch.encode() first")
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    order = _argsort_lengths(lengths)                   # ascending by length
    sorted_lengths = lengths[order]
    sorted_titles = [titles[i] for i in order] if titles is not None else \
        [str(i) for i in order]

    bins = {}
    n_groups = -(-n // GROUP_LANES) if n else 0
    group_Ls = []
    lane_counts = []
    for g in range(n_groups):
        lo, hi = g * GROUP_LANES, min((g + 1) * GROUP_LANES, n)
        group_Ls.append(
            _round_up(max(int(sorted_lengths[lo:hi].max()), 1),
                      LENGTH_QUANTUM))
        lane_counts.append(GROUP_LANES)      # padded lanes all cost compute
    group_Ls = _partition_bins(group_Ls, lane_counts, bin_cost)

    packed = _pack_groups_impl(seqs_flat, lengths, offsets, order, n_groups,
                               group_Ls)

    for g in range(n_groups):
        lo, hi = g * GROUP_LANES, min((g + 1) * GROUP_LANES, n)
        L = group_Ls[g]
        lens = np.zeros(GROUP_LANES, dtype=np.int32)
        ids = np.full(GROUP_LANES, -1, dtype=np.int32)
        cnt = hi - lo
        lens[:cnt] = sorted_lengths[lo:hi]
        ids[:cnt] = np.arange(lo, hi)                    # sorted-order index
        entry = bins.setdefault(L, {"seq": [], "len": [], "id": []})
        entry["seq"].append(packed[g].reshape(L, SUBLANES, LANES))
        entry["len"].append(lens.reshape(SUBLANES, LANES))
        entry["id"].append(ids.reshape(SUBLANES, LANES))

    out = {}
    for L, e in bins.items():
        out[L] = {
            "seq": np.stack(e["seq"]),                   # [G, L, 8, 128]
            "len": np.stack(e["len"]),                   # [G, 8, 128]
            "id": np.stack(e["id"]),                     # [G, 8, 128]
        }
    return PackedDB(bins=out, lengths=sorted_lengths, titles=sorted_titles,
                    n_seqs=n, n_residues=int(lengths.sum()))


def unpack_group(db: PackedDB, L: int, g: int):
    """Decode one group back to (ids, lengths, sequences) — round-trip tests."""
    b = db.bins[L]
    seq = b["seq"][g].reshape(L, GROUP_LANES)
    lens = b["len"][g].reshape(GROUP_LANES)
    ids = b["id"][g].reshape(GROUP_LANES)
    out = []
    for slot in range(GROUP_LANES):
        if ids[slot] < 0:
            continue
        out.append((int(ids[slot]), int(lens[slot]),
                    seq[:lens[slot], slot].copy()))
    return out


# ---------------------------------------------------------------------------
# persisted artifact
# ---------------------------------------------------------------------------

def preprocess_db(fasta_path: str, out_path: str, verbose: bool = True):
    """FASTA -> packed on-disk database (directory `{out_path}.oswt/`)."""
    t0 = time.perf_counter()
    with numpy_nohuge():
        titles, seqs_flat, lengths = parse_fasta(fasta_path)
        db = pack_sequences(seqs_flat, lengths, titles)
        save_db(db, out_path)
    if verbose:
        dt = time.perf_counter() - t0
        print(f"oswald-tpu-torch preprocess: {db.n_seqs} sequences "
              f"({db.n_residues} residues) -> {out_path}.oswt "
              f"[bins: {', '.join(map(str, db.bin_lengths))}] "
              f"in {dt:.2f}s")
    return db


def save_db(db: PackedDB, out_path: str):
    d = out_path + ".oswt"
    os.makedirs(d, exist_ok=True)
    for L, e in db.bins.items():
        for k in ("seq", "len", "id"):
            np.save(os.path.join(d, f"bin{L}_{k}.npy"), e[k])
    np.save(os.path.join(d, "lengths.npy"), db.lengths)
    with open(os.path.join(d, "titles.txt"), "wb") as f:
        offs = [0]
        for i, t in enumerate(db.titles):
            if i:
                f.write(b"\n")
            f.write(t.encode("utf-8"))
            offs.append(f.tell())
    # byte offsets let huge databases resolve hit titles lazily (mmap)
    np.save(os.path.join(d, "titles_idx.npy"),
            np.asarray(offs, np.int64))
    meta = {"version": FORMAT_VERSION, "n_seqs": db.n_seqs,
            "n_residues": db.n_residues, "bins": sorted(db.bins.keys()),
            "group_lanes": GROUP_LANES}
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)


def import_reference_db(base: str, verbose: bool = True) -> PackedDB:
    """Import a database that the FPGA tool OSWALD preprocessed (its
    `.desc`/`.info`/`.seq` triple) into a PackedDB, without the raw FASTA.

    Format:
      base.info   text: "<count> <residues> <max_title_len>"
      base.desc   one title line per sequence, length-ascending order
      base.seq    binary: uint16 lengths[count], then int8 residues
                  (codes 0..22, dummy 23: this package's alphabet)
    """
    t0 = time.perf_counter()
    with open(base + ".info") as f:
        parts = f.read().split()
    if len(parts) < 2:
        raise ValueError(f"{base}.info: expected 'count residues "
                         f"[max_title_len]', got {parts!r}")
    count, D = int(parts[0]), int(parts[1])
    with open(base + ".desc", "r", errors="replace") as f:
        titles = [line.rstrip("\n") for line in f][:count]
    if len(titles) != count:
        raise ValueError(
            f"{base}.desc holds {len(titles)} titles but {base}.info "
            f"declares {count} sequences")
    with open(base + ".seq", "rb") as f:
        lengths = np.fromfile(f, dtype=np.uint16, count=count) \
            .astype(np.int64)
        seqs_flat = np.fromfile(f, dtype=np.int8, count=D)
    if int(lengths.sum()) != D or seqs_flat.size != D:
        raise ValueError(
            f"{base}.seq is inconsistent with {base}.info: lengths sum "
            f"{int(lengths.sum())}, residues read {seqs_flat.size}, "
            f"declared {D}")
    if seqs_flat.size and (seqs_flat.min() < 0 or seqs_flat.max() > DUMMY):
        raise ValueError(
            f"{base}.seq residue codes outside 0..{DUMMY} — not a "
            "preprocessed OSWALD database?")
    db = pack_sequences(seqs_flat, lengths, titles)
    if verbose:
        print(f"oswald-tpu-torch import: {db.n_seqs} sequences "
              f"({db.n_residues} residues) from the OSWALD format "
              f"{base}.desc/.info/.seq in {time.perf_counter() - t0:.2f}s")
    return db


def export_reference_db(db: PackedDB, base: str, verbose: bool = True):
    """Export a PackedDB to OSWALD's `.desc`/`.info`/`.seq` triple, the
    reverse of `import_reference_db`.

    Writes `.desc` one title per line (length-ascending order), `.info`
    "count residues max_title_len", `.seq` uint16 lengths then the
    encoded int8 residues (codes 0..22).  The uint16 length field is the
    format's cap: sequences over 65535 residues cannot be represented and
    raise.
    """
    t0 = time.perf_counter()
    lengths = np.asarray(db.lengths)
    if lengths.size and int(lengths.max()) > np.iinfo(np.uint16).max:
        raise ValueError(
            f"the OSWALD .seq format stores lengths as uint16; "
            f"sequence of length {int(lengths.max())} cannot be exported")
    max_title = 0
    with open(base + ".desc", "w") as f:
        for t in db.titles:
            t = str(t)
            max_title = max(max_title, len(t))
            f.write(t + "\n")
    with open(base + ".info", "w") as f:
        f.write(f"{db.n_seqs} {db.n_residues} {max_title}\n")
    with open(base + ".seq", "wb") as f:
        lengths.astype(np.uint16).tofile(f)
        # groups hold 1024 consecutive sorted ids each (bins ascending),
        # so walking bins/groups in order IS sorted order; one masked
        # gather per group emits its residues slot-major without a
        # per-sequence Python loop
        for L in db.bin_lengths:
            b = db.bins[L]
            for g in range(b["seq"].shape[0]):
                rows = np.asarray(b["seq"][g]).reshape(
                    L, GROUP_LANES).T                   # [1024, L]
                lens = np.asarray(b["len"][g]).reshape(GROUP_LANES)
                mask = np.arange(L)[None, :] < lens[:, None]
                rows[mask].astype(np.int8).tofile(f)
    if verbose:
        print(f"oswald-tpu-torch export: {db.n_seqs} sequences "
              f"({db.n_residues} residues) -> OSWALD format "
              f"{base}.desc/.info/.seq in {time.perf_counter() - t0:.2f}s")


class LazyTitles:
    """Sequence of titles resolved on demand from the mmap'd titles file.

    A 100M-sequence database's titles are gigabytes of text; a search only
    ever reads the k hit titles, so holding the list in RAM would waste
    most of a host's memory.
    """

    def __init__(self, path: str, offsets: np.ndarray):
        self._buf = np.memmap(path, dtype=np.uint8, mode="r") \
            if offsets[-1] else np.zeros(0, np.uint8)
        self._offs = offsets

    def __len__(self):
        return len(self._offs) - 1

    def __getitem__(self, i):
        lo, hi = self._offs[i], self._offs[i + 1]
        if i > 0:
            lo += 1                                  # drop the leading '\n'
        return self._buf[lo:hi].tobytes().decode("utf-8",
                                                 errors="replace")


def load_db(path: str, mmap: bool = True,
            lazy_titles: bool | None = None) -> PackedDB:
    """Load a packed DB; arrays are memory-mapped by default, so nothing is
    read before it is used.  lazy_titles
    (default: auto for >= 1M sequences, requires the titles_idx artifact)
    resolves titles on demand instead of loading the list into RAM."""
    d = path if path.endswith(".oswt") else path + ".oswt"
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    if meta["version"] not in _SUPPORTED_VERSIONS:
        raise ValueError(
            f"unsupported db format version {meta['version']} (this build "
            f"reads versions {_SUPPORTED_VERSIONS})")
    mm = "r" if mmap else None
    bins = {}
    for L in meta["bins"]:
        bins[L] = {k: np.load(os.path.join(d, f"bin{L}_{k}.npy"), mmap_mode=mm)
                   for k in ("seq", "len", "id")}
    lengths = np.load(os.path.join(d, "lengths.npy"))
    idx_path = os.path.join(d, "titles_idx.npy")
    if lazy_titles and not os.path.exists(idx_path):
        # v1 artifacts have no byte-offset index; honor the request as far
        # as possible rather than crashing on a missing file (stderr:
        # --json runs keep stdout machine-readable)
        print(f"oswald-tpu-torch: {d} is a v{meta['version']} artifact without "
              "titles_idx.npy; loading titles eagerly (re-run preprocess "
              "to enable lazy titles)", file=sys.stderr)
        lazy_titles = False
    if lazy_titles is None:
        lazy_titles = meta["n_seqs"] >= 1_000_000 and os.path.exists(idx_path)
    if lazy_titles:
        titles = LazyTitles(os.path.join(d, "titles.txt"),
                            np.load(idx_path))
    else:
        with open(os.path.join(d, "titles.txt")) as f:
            titles = f.read().split("\n") if meta["n_seqs"] else []
    return PackedDB(bins=bins, lengths=lengths, titles=titles,
                    n_seqs=meta["n_seqs"], n_residues=meta["n_residues"])


def load_queries(fasta_path: str):
    """Load query sequences, length-sorted ascending.

    Returns (titles, seqs) where seqs is a list of int8 arrays.
    """
    titles, flat, lengths = parse_fasta(fasta_path)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    order = np.argsort(lengths, kind="stable")
    seqs = [flat[offsets[i]:offsets[i + 1]] for i in order]
    return [titles[i] for i in order], seqs
