"""Single-device database search: the port of oswald_tpu/engine/search.py.

One search is one `sw_groups` call over every group of the database (the
CUDA kernel on a GPU, its plain PyTorch version on the CPU), then a masked
top-k with the score moments appended, read back to the host once and
turned into hits with E-values by `oswald_tpu_torch.stats`.

A batch (`search_many`) packs whole queries into bins of at most
`batch_query_pack_rows` rows (`mixed_pack_plan`) and scores each bin with
one `sw_groups_packed` call; queries too long to pack run one `sw_groups`
call each.  Every launch of the batch is queued before the first readback
blocks, and each bin is read back once.  `search_stream` keeps queries
apart but reads `stream_readback_window` of them back at a time.

`search_many`'s time is split into the spans of ENGINE_PHASES
(`utils.metrics.Metrics.phase`, in `SearchEngine.metrics`): each is a
record_function range of the same name while torch.profiler records.

`profile_mode` picks where the database lives.  `precompute` and `stream`
are the one resident path above (the kernels read the 24x24 matrix, so
there is no profile to precompute); `host_stream` keeps the database on the
host and streams it through the device in slices on every call, each slice
scored by every launch of the call, with the top-k and the moments taken on
the host; `auto` asks `engine.planner` which of the two fits the device.
"""

import dataclasses
import sys
import time

import numpy as np
import torch

from oswald_tpu_torch.alphabet import DUMMY
from oswald_tpu_torch.submat import get_submat
from oswald_tpu_torch.io.db import PackedDB, db_len_stats
from oswald_tpu_torch.io.device_db import (fill_slice, to_device,
                                           to_host_stream)
from oswald_tpu_torch.engine.planner import (device_hbm_bytes,
                                             plan_profile_mode)
from oswald_tpu_torch.kernels.sw_lanes import sw_groups, sw_groups_packed
from oswald_tpu_torch.stats import fit_score_model, tail_calibrate
from oswald_tpu_torch.utils.metrics import Metrics


@dataclasses.dataclass
class SearchConfig:
    """The fields, defaults and validation of oswald_tpu's SearchConfig, so
    the same flags pass through.  These take effect: the scoring fields
    (matrix, gaps, top, max_query_len); batch_query_pack_rows (most rows of
    one packed launch; 0 packs nothing), u_rows (the row quantum the
    packing plan counts in) and stream_readback_window (queries of a stream
    read back together); profile_mode (auto, or precompute and stream for
    the resident database, or host_stream), hbm_budget_bytes (the device
    memory `auto` plans for, in place of the card's own),
    host_stream_slice_mb (most bytes of one streamed slice) and
    host_stream_overlap (False: copy, wait, score, wait, slice by slice).
    Fields that only shape the TPU schedule (group_block, col_unroll, the
    pad quanta, interpret, acc_dtype, fused_dispatch) are validated and
    change nothing here: the kernels take each query at its true length
    and accumulate in int32, with identical scores."""
    matrix: str = "blosum62"
    open_gap: int = 10
    extend_gap: int = 2
    top: int = 10
    u_rows: int = 8
    group_block: int = 2
    col_unroll: int = 32
    query_pad_quantum: int = 64
    batch_query_pad_quantum: int = 64
    interpret: bool | None = None
    # longest query the engine accepts
    max_query_len: int = 5478
    acc_dtype: str = "float32"
    profile_mode: str = "auto"
    hbm_budget_bytes: int | None = None
    host_stream_slice_mb: int = 256
    host_stream_overlap: bool = True
    batch_query_pack_rows: int = 1024
    stream_readback_window: int = 4
    fused_dispatch: bool | None = None

    def __post_init__(self):
        u = self.u_rows
        if not (isinstance(u, int) and 1 <= u <= 64 and (u & (u - 1)) == 0):
            raise ValueError(
                f"u_rows must be a power of two in [1, 64], got {u!r} "
                "(it must divide every padded query length)")
        if not (isinstance(self.group_block, int) and self.group_block >= 1):
            raise ValueError(
                f"group_block must be a positive integer, got "
                f"{self.group_block!r}")
        cu = self.col_unroll
        if not (isinstance(cu, int) and 1 <= cu <= 32 and 32 % cu == 0):
            raise ValueError(
                f"col_unroll must be a divisor of 32, got {cu!r} (it must "
                "divide full 128-column chunks AND the 32/64/96-column "
                "tail chunks the 32-residue bin quantum produces)")
        if not (isinstance(self.batch_query_pack_rows, int) and
                self.batch_query_pack_rows >= 0):
            raise ValueError(
                f"batch_query_pack_rows must be a non-negative int, got "
                f"{self.batch_query_pack_rows!r}")
        for field in ("query_pad_quantum", "batch_query_pad_quantum"):
            q = getattr(self, field)
            if not (isinstance(q, int) and 8 <= q <= 8192 and
                    (q & (q - 1)) == 0):
                raise ValueError(
                    f"{field} must be a power of two in [8, 8192], got "
                    f"{q!r} (padded query lengths must stay multiples of "
                    "u_rows)")
        if self.top < 1:
            raise ValueError(f"top must be >= 1, got {self.top!r}")
        if not (isinstance(self.max_query_len, int) and
                self.max_query_len >= 1):
            raise ValueError(
                f"max_query_len must be a positive int, got "
                f"{self.max_query_len!r}")
        # the reference CLI's ranges: open gap 0..255, extend gap 0..127
        if not (0 <= self.open_gap <= 255):
            raise ValueError(
                f"open_gap must be in [0, 255], got {self.open_gap!r}")
        if not (0 <= self.extend_gap <= 127):
            raise ValueError(
                f"extend_gap must be in [0, 127], got {self.extend_gap!r}")
        if self.acc_dtype not in ("int32", "float32"):
            raise ValueError(
                f"acc_dtype must be 'int32' or 'float32', got "
                f"{self.acc_dtype!r}")
        if self.profile_mode not in ("auto", "precompute", "stream",
                                     "host_stream"):
            raise ValueError(
                f"profile_mode must be 'auto', 'precompute', 'stream' or "
                f"'host_stream', got {self.profile_mode!r}")
        if not (1 <= self.host_stream_slice_mb <= 2048):
            raise ValueError(
                f"host_stream_slice_mb must be in [1, 2048], got "
                f"{self.host_stream_slice_mb!r} (a slice's group table "
                "holds int32 column offsets)")
        if not (isinstance(self.stream_readback_window, int) and
                self.stream_readback_window >= 1):
            raise ValueError(
                f"stream_readback_window must be a positive int, got "
                f"{self.stream_readback_window!r}")


@dataclasses.dataclass
class SearchResult:
    """oswald_tpu's SearchResult, field for field."""
    query_title: str
    query_length: int
    scores: np.ndarray        # int32[k], descending
    seq_ids: np.ndarray       # int32[k], sorted-order ids into db.titles
    titles: list              # top-k subject titles
    elapsed: float            # wall seconds of the search call
    batch_n: int = 1          # queries sharing this elapsed (1 = alone)
    # significance statistics (None when the database is too small for a
    # meaningful fit)
    evalues: np.ndarray | None = None      # float64[k]
    bit_scores: np.ndarray | None = None   # float64[k]
    stats: object | None = None            # stats.ScoreStats


# the spans (Metrics.phase) that split search_many's time, in the order
# they run, each recorded once a call, a group or a readback window:
# engine.plan (check_lengths, batch_plan), engine.launch (the query rows'
# copy to the device, the launches, the top-k with the moments),
# engine.readback (each blocking copy back) and engine.results (unpack,
# statistics, titles).  Under host_stream a sweep is one engine.launch and
# its host top-k is in engine.results.
ENGINE_PHASES = ("engine.plan", "engine.launch", "engine.readback",
                 "engine.results")


def _load(launches, tables):
    """An engine.launch span's args: the queries and query residues of
    launches [(query rows, segs int32[S, 2] or None)], and of the work
    tables they launch with (the resident one, or a host_stream sweep's
    slices'), `cluster` (the most blocks a split slab takes; 1: none
    split, plain launches) and `split_slabs` (summed over the tables)."""
    return {"queries": sum(1 if segs is None else len(segs)
                           for _, segs in launches),
            "residues": int(sum(np.asarray(rows).size if segs is None
                                else segs[:, 1].sum()
                                for rows, segs in launches)),
            "cluster": max((t.cluster for t in tables), default=1),
            "split_slabs": sum(t.split_slabs for t in tables)}


# packed trailing moment columns: [sum, sumsq, slnl, T1] in row 0 and
# [c0, c1, T0, 0] in row 1, float32 bit patterns in the int32 array
MOM_COLS = 4
# tail thresholds for stats.tail_calibrate, in hit-excluded sd above the
# mean
TAIL_SDS0 = 1.2
TAIL_SDS = 2.5


def _result_stats(db, lnl_table, lnl_mom, len_hist,
                  top_scores, top_ids, mom, query_len):
    """Fit the length-regressed null model from the moments and score the
    hits, excluding the hits from the fit.  mom: (msum, msumsq, mslnl, T1,
    c0, c1, T0).  Returns (evalues, bit_scores, ScoreStats|None)."""
    msum, msumsq, mslnl, t1, c0, c1, t0 = [float(x) for x in mom]
    ids = np.maximum(np.asarray(top_ids, np.int64), 0)
    st = fit_score_model(db.n_seqs, msum, msumsq, mslnl,
                         lnl_mom[0], lnl_mom[1],
                         exclude_scores=top_scores,
                         exclude_lnl=lnl_table[ids])
    st = tail_calibrate(st, db.n_seqs, len_hist, t0, t1, c0, c1,
                        exclude_scores=top_scores)
    if st is None:
        return None, None, None
    ev = st.evalues(top_scores, db.n_seqs, len_hist)
    bits = st.bit_scores(top_scores, query_len,
                         db.n_residues / max(db.n_seqs, 1))
    return ev, bits, st


def _score_sums(scores, valid, lnl):
    """float32 [..., 4]: sum(S), sum(S^2), sum(S*lnL) and the valid count
    over the valid slots of `scores` [..., N], summed in float32 as the
    reference does."""
    sf = torch.where(valid, scores, 0).to(torch.float32)
    n = valid.to(torch.float32).sum()
    s1 = sf.sum(-1)
    return torch.stack([s1, (sf * sf).sum(-1), (sf * lnl).sum(-1),
                        n.expand_as(s1)], dim=-1)


# exact sums of S*lnL are integers over lnL in fixed point: every float32
# ln length (0, or at least ln 2 > 1/2) is a whole multiple of 2^-24
LNL_FIXED = 1 << 24


def _exact_sums(scores, valid, lnl):
    """int64 [..., 4]: the sums of `_score_sums` computed exactly (sum(S*lnL)
    times LNL_FIXED), so the same in any order of summation: the sums of a
    database's shards add up to the whole database's, bit for bit."""
    s = torch.where(valid, scores, 0).to(torch.int64)
    lf = torch.round(lnl.to(torch.float64) * LNL_FIXED).to(torch.int64)
    s1 = s.sum(-1)
    return torch.stack([s1, (s * s).sum(-1), (s * lf).sum(-1),
                        valid.sum().expand_as(s1)], dim=-1)


def _sums_float32(sums):
    """float32 [..., 4] of `_exact_sums`, each rounded once: the moments in
    the form `_score_sums` gives them."""
    f = sums.to(torch.float32)
    return torch.stack([f[..., 0], f[..., 1], f[..., 2] / LNL_FIXED,
                        f[..., 3]], dim=-1)


def _tail_thresholds(sums, top):
    """(T0, T1), float32 [...]: the tail thresholds of stats.tail_calibrate,
    in hit-excluded sd above the mean, from `_score_sums` [..., 4] and the
    reported hits' scores `top` [..., k] (entries < 0 are no hit)."""
    s1, s2, n = sums[..., 0], sums[..., 1], sums[..., 3]
    top = top.to(torch.float32)
    topv = top >= 0
    tf = torch.where(topv, top, 0.0)
    n_ex = torch.clamp_min(n - topv.to(torch.float32).sum(-1), 1.0)
    mean = (s1 - tf.sum(-1)) / n_ex
    var = torch.clamp_min((s2 - (tf * tf).sum(-1)) / n_ex - mean * mean, 0.0)
    sd = torch.sqrt(var)
    return torch.ceil(mean + TAIL_SDS0 * sd), torch.ceil(mean + TAIL_SDS * sd)


def _tail_counts(scores, valid, t0, t1):
    """float32 [..., 2]: the valid slots of `scores` [..., N] at or above
    T0 and T1 [...] (the counts include the hits)."""
    sf = torch.where(valid, scores, 0).to(torch.float32)
    return torch.stack(
        [(valid & (sf >= t[..., None])).to(torch.float32).sum(-1)
         for t in (t0, t1)], dim=-1)


def _append_moments(packed, scores, valid, lnl):
    """Append MOM_COLS int32 columns holding the float32 score moments
    [sum(S), sum(S^2), sum(S*lnL), T1] / [c0, c1, T0, 0] over the valid
    slots to a packed [..., 2, k] top-k array, computed in float32 as the
    reference does.  `scores` is [..., N] with the same leading batch
    dimensions; every query of a batch gets its own moments.  T0/T1 derive
    from the mean and sd without the top-k (row 0); the counts include the
    hits."""
    f = _score_sums(scores, valid, lnl)
    t0, t1 = _tail_thresholds(f, packed[..., 0, :])
    c = _tail_counts(scores, valid, t0, t1)
    mom = torch.stack([f[..., 0], f[..., 1], f[..., 2], t1,
                       c[..., 0], c[..., 1], t0, torch.zeros_like(t0)],
                      dim=-1)
    cols = mom.view(torch.int32).reshape(mom.shape[:-1] + (2, MOM_COLS))
    return torch.cat([packed, cols], dim=-1)


def _topk_slots(scores, valid, k: int):
    """Masked top-k as int32[..., 2, k]: scores in row 0, slots in row 1.
    `scores` is [..., N]; a leading batch dimension gives each query its
    own top-k.  Ties go to the lowest slot, as lax.top_k gives them: the
    order is taken over one int64 key per slot, (score << 32) | (2^31 - 1 -
    slot), with padding slots at -1 (score -1, a negative slot)."""
    slot = torch.arange(scores.shape[-1], device=scores.device,
                        dtype=torch.int64)
    key = torch.where(valid,
                      (scores.to(torch.int64) << 32) |
                      ((1 << 31) - 1 - slot), -1)
    top = torch.topk(key, k, dim=-1).values
    vals = (top >> 32).to(torch.int32)
    idx = ((1 << 31) - 1 - (top & 0xFFFFFFFF)).to(torch.int32)
    return torch.stack([vals, idx], dim=-2)


def _topk(scores, valid, lnl, k: int):
    """Masked top-k packed as int32[..., 2, k + MOM_COLS]: `_topk_slots`
    with the moments in the last columns (`_append_moments`)."""
    return _append_moments(_topk_slots(scores, valid, k), scores, valid, lnl)


def _unpack_topk(arr):
    """Host unpack of a packed readback int32[..., 2, k+MOM_COLS] ->
    (scores[..., k], slots[..., k], mom) where mom = (sum, sumsq, slnl, T1,
    c0, c1, T0) each [...]-shaped float64 (see _append_moments)."""
    mom = np.ascontiguousarray(arr[..., :, -MOM_COLS:]).view(np.float32)
    m = tuple(mom[..., r, c].astype(np.float64)
              for r, c in ((0, 0), (0, 1), (0, 2), (0, 3),
                           (1, 0), (1, 1), (1, 2)))
    return arr[..., 0, :-MOM_COLS], arr[..., 1, :-MOM_COLS], m


def _host_topk(scores_flat, ids_flat, k):
    """Top-k on the host with `_topk`'s order (score descending, ties to the
    lowest slot, padding slots at -1): host_stream scores are already in
    host memory.  The order is taken over the same int64 key per slot, so
    np.partition finds the k largest in linear time and only those are
    sorted.  Returns (scores int32[k], slots int64[k])."""
    n = scores_flat.shape[0]
    masked = np.where(ids_flat >= 0, scores_flat, -1).astype(np.int64)
    key = (masked << 32) | ((1 << 31) - 1 - np.arange(n, dtype=np.int64))
    top = np.sort(np.partition(key, n - k)[n - k:])[::-1]
    return ((top >> 32).astype(np.int32),
            (1 << 31) - 1 - (top & 0xFFFFFFFF))


def _host_sums(scores_flat, valid_mask, lnl_flat):
    """float64 (sum(S), sum(S^2), sum(S*lnL), valid count) over the valid
    slots of host scores [n] or [Q, n]: scalars or [Q] arrays."""
    sf = np.asarray(scores_flat, np.float64)[..., valid_mask]
    l = np.asarray(lnl_flat, np.float64)[valid_mask]
    msum = sf.sum(-1)
    return (msum, (sf * sf).sum(-1), (sf * l).sum(-1),
            np.full_like(msum, valid_mask.sum()))


def _host_thresholds(msum, msumsq, n_valid, top_scores):
    """(T0, T1) of `_tail_thresholds` in float64 from host sums and the
    reported hits ([k] / [Q, k]; entries < 0 are no hit)."""
    tops = np.asarray(top_scores, np.float64)
    tv = tops >= 0
    n_ex = np.maximum(n_valid - tv.sum(-1), 1)
    tf = np.where(tv, tops, 0.0)
    mean = (msum - tf.sum(-1)) / n_ex
    var = np.maximum((msumsq - (tf * tf).sum(-1)) / n_ex - mean * mean,
                     0.0)
    sd = np.sqrt(var)
    return np.ceil(mean + TAIL_SDS0 * sd), np.ceil(mean + TAIL_SDS * sd)


def _host_counts(scores_flat, valid_mask, t0, t1):
    """(c0, c1) float64: valid host scores at or above T0 and T1."""
    sf = np.asarray(scores_flat, np.float64)[..., valid_mask]
    up = (lambda t: np.asarray(t)[..., None]) if sf.ndim > 1 else \
        (lambda t: t)
    return tuple((sf >= up(t)).sum(-1).astype(np.float64) for t in (t0, t1))


def _host_moments(scores_flat, valid_mask, lnl_flat, top_scores):
    """The moments and tail counts of `_append_moments` over scores that
    are already on the host, in float64.  scores_flat: [n] or [Q, n];
    top_scores the reported hits per row ([k] / [Q, k]), left out of the
    mean and sd the tail thresholds derive from.  Returns (sum, sumsq,
    slnl, T1, c0, c1, T0) as scalars or [Q] arrays."""
    msum, msumsq, mslnl, n = _host_sums(scores_flat, valid_mask, lnl_flat)
    t0, t1 = _host_thresholds(msum, msumsq, n, top_scores)
    c0, c1 = _host_counts(scores_flat, valid_mask, t0, t1)
    return msum, msumsq, mslnl, t1, c0, c1, t0


def check_query(query, config: SearchConfig) -> np.ndarray:
    """The query as int32 codes at its true length; an empty query is one
    DUMMY row (it scores 0 everywhere).  Rejects codes outside 0..23 (an
    un-encoded string) and queries longer than config.max_query_len."""
    q = np.asarray(query, dtype=np.int32)
    if q.ndim != 1:
        raise ValueError(f"query must be a 1-D code array, got shape "
                         f"{q.shape}")
    if q.size and (q.min() < 0 or q.max() > DUMMY):
        raise ValueError(
            "query contains codes outside 0..23 — encode residue strings "
            "with oswald_tpu_torch.encode() first")
    if q.size > config.max_query_len:
        raise ValueError(
            f"query length {q.size} exceeds the engine's configured "
            f"max_query_len {config.max_query_len} — rebuild the engine "
            f"with SearchConfig(max_query_len=...) / --max-query-len")
    if q.size == 0:
        q = np.full(1, DUMMY, np.int32)
    return q


def check_lengths(queries, config: SearchConfig):
    """Refuse a batch with a query over config.max_query_len before any
    search runs."""
    cap = config.max_query_len
    for i, q in enumerate(queries):
        if np.asarray(q).size > cap:
            raise ValueError(
                f"query {i} length {np.asarray(q).size} exceeds the "
                f"engine's configured max_query_len {cap} — rebuild with "
                f"SearchConfig(max_query_len=...) / --max-query-len")


def warmup_engine(engine, max_query_len: int, batch: bool, log):
    """The steps of SearchEngine.warmup, for any engine with its device,
    config, metrics, search and search_many: on a card, build and load
    both engine kernel libraries; then one search of min(max_query_len,
    config.max_query_len) DUMMY residues and, with `batch`, one
    search_many of two such queries of at most half of
    batch_query_pack_rows (so that they pack).  Returns the libraries'
    names ([] on the CPU)."""
    from oswald_tpu_torch.kernels import build
    t0 = time.perf_counter()

    def say(msg):
        if log:
            log(f"warmup [{time.perf_counter() - t0:5.1f}s] {msg}")

    m = max(1, min(max_query_len, engine.config.max_query_len))
    loaded = []
    if engine.device.type == "cuda":
        names = ["sw_groups", "sw_groups_packed"]
        say(f"kernel libraries {', '.join(names)} in {build.build_dir()}")
        build.build_all(names)
        for name in names:
            build.load(name)
        loaded = names
    say(f"one search of {m} residues")
    engine.search(np.full(m, DUMMY, np.int8))
    if batch:
        mb = max(1, min(m, engine.config.batch_query_pack_rows // 2))
        say(f"one batch of two queries of {mb} residues")
        q = np.full(mb, DUMMY, np.int8)
        engine.search_many([q, q])
    # both searches ended with their readback: the card is idle
    engine.metrics.add("warmup", time.perf_counter() - t0)
    say("done")
    return loaded


# segment slots per packed bin: caps the queries of one packed launch (its
# score rows and the top-k fan-out scale with it) while letting a full
# 1024-row bin hold 32 tiny queries
MIXED_PACK_SEGS = 32


def mixed_pack_plan(pack_rows: int, u_rows: int, queries,
                    max_segs: int = MIXED_PACK_SEGS):
    """First-fit-decreasing bin plan for a mixed-length query batch, value
    for value that of oswald_tpu's mixed_pack_plan.

    Packs whole queries, padded only to the u_rows row quantum, into bins
    of at most pack_rows rows and max_segs queries; each bin runs as one
    packed kernel launch.  A bin's row count is rounded up to a power of
    two, never past pack_rows.

    Returns (bins, rest): bins = [(idxs, q_packed int32[m_tot],
    seg_map int32[m_tot // u_rows], used_blocks)] with idxs[s] the query in
    segment slot s, seg_map the slot of every row block and used_blocks the
    real (non-filler) row-block count; rest = indices of queries too long
    to pack (> pack_rows rows), which run unpacked.
    """
    n = len(queries)
    if not pack_rows or pack_rows // u_rows < 2 or n < 2:
        return [], list(range(n))
    r_cap = pack_rows // u_rows
    qarrs = [np.asarray(q, np.int32) for q in queries]
    for q in qarrs:
        # the guard of check_query, which packed queries bypass
        if q.size and (q.min() < 0 or q.max() > DUMMY):
            raise ValueError(
                "query contains codes outside 0..23 — encode residue "
                "strings with oswald_tpu_torch.encode() first")
    blocks = [max(1, -(-int(q.size) // u_rows)) for q in qarrs]
    rest = [i for i in range(n) if blocks[i] > r_cap]
    order = sorted((i for i in range(n) if blocks[i] <= r_cap),
                   key=lambda i: (-blocks[i], i))
    bins = []                        # [used_blocks, [query index, ...]]
    for i in order:
        for b in bins:
            if b[0] + blocks[i] <= r_cap and len(b[1]) < max_segs:
                b[0] += blocks[i]
                b[1].append(i)
                break
        else:
            bins.append([blocks[i], [i]])
    out = []
    for used, idxs in bins:
        rb = min(r_cap, max(2, 1 << (used - 1).bit_length()))
        qp = np.full(rb * u_rows, DUMMY, np.int32)
        sm = np.empty(rb, np.int32)
        off = 0
        for s, i in enumerate(idxs):
            qp[off * u_rows: off * u_rows + qarrs[i].size] = qarrs[i]
            sm[off: off + blocks[i]] = s
            off += blocks[i]
        # trailing filler blocks: a fresh all-DUMMY slot when one is free,
        # else they extend the last segment with DUMMY rows (score-inert
        # either way)
        sm[off:] = min(len(idxs), max_segs - 1)
        out.append((idxs, qp, sm, off))
    return out, rest


def plan_segments(idxs, seg_map, used_blocks, u_rows, queries):
    """int32[S, 2] (first row, row count) of each query of one plan bin in
    its q_packed, as sw_groups_packed takes them: the first row block of
    slot s in seg_map times u_rows, and the query's true length (1 for an
    empty query: its one DUMMY row).  The DUMMY rows that pad a segment to
    u_rows and the filler blocks past used_blocks get no rows."""
    seg_map = np.asarray(seg_map)[:used_blocks]
    segs = np.empty((len(idxs), 2), np.int32)
    for s, i in enumerate(idxs):
        segs[s] = (int(np.flatnonzero(seg_map == s)[0]) * u_rows,
                   max(int(np.asarray(queries[i]).size), 1))
    return segs


def batch_plan(config, queries):
    """The launches of a packed batch, group by group: [(query indices,
    [(query rows int32[m], segs int32[S, 2] or None)])].  One group per bin
    of mixed_pack_plan, one sw_groups_packed launch each; then the queries
    too long to pack, one sw_groups launch each, in groups of at most
    MIXED_PACK_SEGS.  No group has more score rows than the widest packed
    launch, which is what the planner budgets for (planner.BATCH_SEGS)."""
    bins, rest = mixed_pack_plan(config.batch_query_pack_rows,
                                 config.u_rows, queries)
    plan = [(idxs, [(q_packed, plan_segments(idxs, seg_map, used,
                                             config.u_rows, queries))])
            for idxs, q_packed, seg_map, used in bins]
    for lo in range(0, len(rest), MIXED_PACK_SEGS):
        chunk = rest[lo:lo + MIXED_PACK_SEGS]
        plan.append((chunk, [(check_query(queries[i], config), None)
                             for i in chunk]))
    return plan


class SearchEngine:
    """Searches one packed database with a fixed matrix and gap setting on
    one device.  device=None means CUDA and raises when there is none; CPU
    runs pass device="cpu" and score with the plain PyTorch version.
    long_from is the kernels' long-role threshold (`kernels.sw_lanes.
    work_table`; None: the shipped LONG_FROM), which `tune` measures.
    `mode` is the resolved profile_mode: "precompute" or "stream" (the
    database resident on the device: `state`, `valid`, `lnl`, `scratch`) or
    "host_stream" (those four are None; `_hs_slices`, `ids_flat` and
    `lnl_flat` describe the same slots from the host)."""

    def __init__(self, db: PackedDB, config: SearchConfig = None,
                 device=None, long_from: int = None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "SearchEngine: CUDA is not available; pass "
                    "device='cpu' to search on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"SearchEngine: device {self.device} "
                               "requested but CUDA is not available")
        self.db = db
        self.config = config or SearchConfig()
        self.long_from = long_from
        self.submat = get_submat(self.config.matrix)
        self.metrics = Metrics()
        cuda = self.device.type == "cuda"
        self.mode = self.config.profile_mode
        if self.mode == "auto":
            hbm = self.config.hbm_budget_bytes
            if hbm is None:
                hbm = device_hbm_bytes(self.device)
            plan = plan_profile_mode(
                db, hbm, max_query_len=self.config.max_query_len,
                config=self.config)
            self.mode = plan.mode
            # stderr: --json runs keep stdout machine-readable
            print(f"oswald-tpu-torch engine: {plan.describe()}",
                  file=sys.stderr)
        t_setup = time.perf_counter()
        self.submat_dev = torch.as_tensor(self.submat, dtype=torch.int32,
                                          device=self.device)
        self.state = self.valid = self.lnl = self.scratch = None
        self._hs_slices = []
        if self.mode == "host_stream":
            self._init_host_stream()
        else:
            self.state = to_device(db, self.device, long_from)
            self.ids_flat = self.state.ids_flat
            self.valid = self.state.valid
            self.lnl = self.state.lnl
            # kernel scratch (H and F rows between query strips), allocated
            # once; its size does not depend on the query
            if cuda:
                self.scratch = torch.empty(
                    (2,) + tuple(self.state.residues.shape),
                    dtype=torch.int32, device=self.device)
        self.n_slots = int(self.ids_flat.shape[0])
        self._lnl_by_id, self._lnl_mom, self._len_hist = db_len_stats(db)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.metrics.add("engine_setup", time.perf_counter() - t_setup)

    def _init_host_stream(self):
        """The host_stream state: the slices (io.device_db.to_host_stream),
        the per-slot vectors on the host and, on a card, what one sweep
        reuses: two pinned staging buffers and two device buffers of the
        largest slice's size, one kernel scratch of 8 times that, and a side
        stream for the copies.  At most two slices and one scratch are ever
        on the device."""
        hs = to_host_stream(self.db, self.device,
                            self.config.host_stream_slice_mb, self.long_from)
        self._hs_slices = hs.slices
        self.ids_flat = hs.ids_flat
        self.lnl_flat = hs.lnl_flat
        self._hs_valid = hs.ids_flat >= 0
        self._hs_out = None          # int32[rows, n_slots], grown on demand
        if self.device.type != "cuda":
            return
        n = hs.max_cols * 8 * 128
        self._hs_pinned = [torch.empty(n, dtype=torch.int8, pin_memory=True)
                           for _ in range(2)]
        self._hs_dev = [torch.empty(n, dtype=torch.int8, device=self.device)
                        for _ in range(2)]
        self._hs_scratch = torch.empty(2 * n, dtype=torch.int32,
                                       device=self.device)
        self._hs_copy_stream = torch.cuda.Stream(self.device)

    def _hs_rows(self, rows: int) -> torch.Tensor:
        """int32[rows, n_slots] on the host (pinned on a card) that the
        sweep drains its scores into; reused by the next sweep."""
        if self._hs_out is None or self._hs_out.shape[0] < rows:
            self._hs_out = torch.empty(
                (rows, self.n_slots), dtype=torch.int32,
                pin_memory=self.device.type == "cuda")
        return self._hs_out[:rows]

    def _host_stream_scores_multi(self, launches):
        """One sweep of the database for every launch of a call: each
        slice is transferred once and scored by every launch, one kernel
        launch per slice (the slice's group table covers its spans of
        several bins), and its scores drain to the host.  launches:
        [(rows int32[m], segs int32[S, 2] or None)]: with segs one
        sw_groups_packed launch per slice, without one sw_groups launch.
        Returns one int32[S, n_slots] numpy array per launch (S = 1 without
        segs); they are views of a buffer the next sweep overwrites.

        On a card the copies run on a side stream and the kernels on the
        current one: slice i + 1 is staged (pinned buffer filled by the
        host, copy queued) before slice i's kernels are queued, so a
        slice's copy runs under the kernels of the slice before it.  Events
        order the reuse: the host refills a pinned buffer only after the
        copy out of it has finished, the copy into a device buffer waits
        for the kernels that read it two slices ago, and the kernels wait
        for their slice's copy.  host_stream_overlap=False is the serial
        schedule: copy, wait, score, wait, slice by slice, same results."""
        cfg, dev = self.config, self.device
        n_rows = [1 if segs is None else len(segs) for _, segs in launches]
        ops = [(torch.from_numpy(np.ascontiguousarray(q, np.int32)).to(dev),
                None if segs is None else
                torch.from_numpy(np.ascontiguousarray(segs, np.int32))
                .to(dev)) for q, segs in launches]
        out = self._hs_rows(sum(n_rows))

        def score(sl, residues, scratch):
            row = 0
            for (q, segs), n in zip(ops, n_rows):
                if segs is None:
                    got = sw_groups(residues, sl.groups, q, self.submat_dev,
                                    cfg.open_gap, cfg.extend_gap, scratch,
                                    sl.work)
                else:
                    got = sw_groups_packed(
                        residues, sl.groups, q, segs, self.submat_dev,
                        cfg.open_gap, cfg.extend_gap, scratch, sl.work)
                got = got.reshape(n, -1)
                for i in range(n):
                    out[row + i, sl.slot0:sl.slot0 + sl.n_slots].copy_(
                        got[i], non_blocking=True)
                row += n

        if dev.type == "cuda":
            self._hs_sweep_cuda(score)
        else:
            for sl in self._hs_slices:
                buf = np.empty(sl.n_bytes, np.int8)
                fill_slice(self.db, sl, buf)
                score(sl, torch.from_numpy(buf).reshape(sl.n_cols, 8, 128),
                      None)
        host, res, row = out.numpy(), [], 0
        for n in n_rows:
            res.append(host[row:row + n])
            row += n
        return res

    def _hs_sweep_cuda(self, score):
        """Stream every slice through the card and call score(slice,
        residues, scratch) on each (see _host_stream_scores_multi)."""
        dev, slices = self.device, self._hs_slices
        overlap = self.config.host_stream_overlap
        cur = torch.cuda.current_stream(dev)
        copies = self._hs_copy_stream if overlap else cur
        copied, scored = [None, None], [None, None]

        def stage(i):
            b, n = (i % 2 if overlap else 0), slices[i].n_bytes
            if copied[b] is not None:
                copied[b].synchronize()      # the pinned buffer is free
            fill_slice(self.db, slices[i], self._hs_pinned[b].numpy()[:n])
            if overlap and scored[b] is not None:
                copies.wait_event(scored[b])  # the device buffer is free
            with torch.cuda.stream(copies):
                self._hs_dev[b][:n].copy_(self._hs_pinned[b][:n],
                                          non_blocking=True)
                copied[b] = torch.cuda.Event()
                copied[b].record(copies)

        def run(i):
            b, sl = (i % 2 if overlap else 0), slices[i]
            cur.wait_event(copied[b])
            score(sl, self._hs_dev[b][:sl.n_bytes].view(sl.n_cols, 8, 128),
                  self._hs_scratch[:2 * sl.n_bytes].view(2, sl.n_cols, 8,
                                                         128))
            scored[b] = torch.cuda.Event()
            scored[b].record(cur)

        if overlap:
            for i in range(len(slices)):
                if i == 0:
                    stage(0)
                if i + 1 < len(slices):
                    stage(i + 1)
                run(i)
        else:
            for i in range(len(slices)):
                stage(i)
                cur.synchronize()
                run(i)
                cur.synchronize()
        cur.synchronize()                    # the scores are on the host

    def _host_stream_scores(self, query) -> np.ndarray:
        """int32[n_slots] scores of one checked query under host_stream."""
        return self._host_stream_scores_multi([(query, None)])[0][0]

    def _host_reduce(self, scores, k):
        """(top scores [Q, k], top slots [Q, k], moments of [Q]) of
        host-side scores int32[Q, n_slots]."""
        top_scores = np.empty((len(scores), k), np.int32)
        top_slots = np.empty((len(scores), k), np.int64)
        for row in range(len(scores)):
            top_scores[row], top_slots[row] = _host_topk(
                scores[row], self.ids_flat, k)
        return top_scores, top_slots, _host_moments(
            scores, self._hs_valid, self.lnl_flat, top_scores)

    def _tables(self):
        """The work tables a launch of this engine runs with."""
        if self.mode == "host_stream":
            return [sl.work for sl in self._hs_slices]
        return [self.state.work]

    def _launch(self, rows, segs=None) -> torch.Tensor:
        """Queue one kernel launch over the resident database: query rows
        int32[m] (host), and with segs int32[S, 2] one sw_groups_packed
        launch of S packed queries, else one sw_groups launch.  Returns
        the int32 scores [S, n_slots] on the device (S = 1 without segs),
        not read back."""
        cfg, st = self.config, self.state
        q = torch.from_numpy(np.ascontiguousarray(rows, np.int32)).to(
            self.device)
        if segs is None:
            return sw_groups(st.residues, st.groups, q, self.submat_dev,
                             cfg.open_gap, cfg.extend_gap, self.scratch,
                             st.work).reshape(1, -1)
        return sw_groups_packed(
            st.residues, st.groups, q,
            torch.from_numpy(np.ascontiguousarray(segs, np.int32)).to(
                self.device), self.submat_dev, cfg.open_gap,
            cfg.extend_gap, self.scratch, st.work).reshape(len(segs), -1)

    def _score_groups(self, plan, reduce):
        """Score a batch_plan group by group; returns [reduce(query
        indices, int32 scores [len(indices), n_slots])] in plan order.
        For a resident database the scores are on the device, not read
        back, and a group is launched only after the group before it has
        gone through reduce and been dropped: one group's scores are live
        at a time, as the planner budgets (reduce keeps what it needs, a
        top-k say, and not the scores).  Under host_stream one sweep of the
        database scores every launch of the plan, and a group's scores are
        host rows of the sweep's reused buffer."""
        if self.mode == "host_stream":
            every = [launch for _, launches in plan for launch in launches]
            with self.metrics.phase("engine.launch",
                                    lambda: _load(every, self._tables())):
                swept = iter(self._host_stream_scores_multi(every))
            out = []
            for idxs, launches in plan:
                parts = [next(swept) for _ in launches]
                with self.metrics.phase("engine.results"):
                    out.append(reduce(idxs, parts[0] if len(parts) == 1
                                      else np.concatenate(parts)))
            return out
        out = []
        for idxs, launches in plan:
            with self.metrics.phase("engine.launch",
                                    lambda: _load(launches, self._tables())):
                parts = [self._launch(*launch) for launch in launches]
                scores = parts[0] if len(parts) == 1 else torch.cat(parts)
                del parts
                out.append(reduce(idxs, scores))
                del scores               # freed before the next launch
        return out

    def score_all(self, query) -> torch.Tensor:
        """int32 scores for every slot, in slot order, on the device."""
        if self.mode == "host_stream":
            return torch.from_numpy(self._host_stream_scores(
                check_query(query, self.config)).copy()).to(self.device)
        return self._launch(check_query(query, self.config))[0]

    def _dispatch(self, query, query_title: str):
        """Queue one query's search on the device without blocking; returns
        a pending tuple for _finish."""
        t0 = time.perf_counter()
        k = min(self.config.top, self.db.n_seqs)
        if self.mode == "host_stream":
            # the sweep has its own pipeline and ends synchronised
            scores = self._host_stream_scores(
                check_query(query, self.config))
            top_scores, top_slots, mom = self._host_reduce(scores[None], k)
            done = top_scores[0], top_slots[0], tuple(m[0] for m in mom)
            return query, query_title, t0, None, done
        packed = _topk(self.score_all(query), self.valid, self.lnl, k)
        return query, query_title, t0, packed, None

    def _result(self, query, query_title, top_scores, top_slots, mom):
        """Hits with statistics from one query's unpacked readback."""
        top_scores = np.asarray(top_scores)
        # slot order preserves id order, so the lowest-slot tie-break is a
        # lowest-id tie-break
        top_ids = self.ids_flat[np.asarray(top_slots)]
        qlen = int(np.asarray(query).size)
        ev, bits, st = _result_stats(
            self.db, self._lnl_by_id, self._lnl_mom, self._len_hist,
            top_scores, top_ids, mom, qlen)
        return SearchResult(query_title=query_title, query_length=qlen,
                            scores=top_scores, seq_ids=top_ids,
                            titles=[self.db.title_of(int(i))
                                    for i in top_ids],
                            elapsed=0.0, evalues=ev, bit_scores=bits,
                            stats=st)

    def _finish(self, pend, host=None) -> SearchResult:
        """Build a _dispatch's result from its packed array: `host` when a
        window's readback already holds it, else this query's own blocking
        readback."""
        query, query_title, t0, packed, done = pend
        if done is None:
            if host is None:
                host = packed.cpu().numpy()      # the one readback
            done = _unpack_topk(host)
        res = self._result(query, query_title, *done)
        res.elapsed = time.perf_counter() - t0
        self.metrics.add("search", res.elapsed)
        return res

    def search(self, query, query_title: str = "query") -> SearchResult:
        return self._finish(self._dispatch(query, query_title))

    def search_stream(self, queries, titles=None):
        """Queries one by one, each alone in its launch, with the results
        of [search(q) for q in queries].  The packed outputs of
        stream_readback_window consecutive queries are stacked on the
        device and read back once, after the next window has been queued,
        so a readback waits behind work the device already has."""
        titles = titles or [f"query{i}" for i in range(len(queries))]
        W = max(self.config.stream_readback_window, 1)
        results, prev = [], None
        for lo in range(0, len(queries), W):
            window = queries[lo:lo + W]
            with self.metrics.phase("engine.launch", lambda: _load(
                    [(q, None) for q in window], self._tables())):
                grp = [self._dispatch(q, t)
                       for q, t in zip(window, titles[lo:lo + W])]
                # host_stream queries are finished already: nothing to stack
                stacked = torch.stack([p[3] for p in grp]) \
                    if self.mode != "host_stream" else None
            if prev is not None:
                results.extend(self._finish_group(*prev))
            prev = (grp, stacked)
        if prev is not None:
            results.extend(self._finish_group(*prev))
        return results

    def _finish_group(self, grp, stacked):
        """Finish one readback window: one blocking transfer of the stack,
        then each query's result from its own rows."""
        if stacked is None:
            with self.metrics.phase("engine.results"):
                return [self._finish(p) for p in grp]
        with self.metrics.phase("engine.readback"):
            big = stacked.cpu().numpy()          # the one window readback
        with self.metrics.phase("engine.results"):
            return [self._finish(p, big[i]) for i, p in enumerate(grp)]

    def warmup(self, max_query_len: int = 512, batch: bool = True,
               log=None, jobs: int = 1):
        """Make the first real request pay for nothing but its search.

        On a card: build (nvcc, where the kernel directory has no build of
        these sources yet) and load both engine kernel libraries, then run
        one search of a query of min(max_query_len, max_query_len of the
        config) DUMMY residues and, with `batch`, one search_many of two
        such queries (at most half of batch_query_pack_rows each, so that
        they pack), which launches sw_groups_packed.  That pays for the
        CUDA context, the modules' load and the allocator's growth.  On the
        CPU the same searches run the plain versions once at that size.

        Deliberately unlike oswald_tpu's warmup, which compiles one XLA
        program per padded query length and returns those lengths: the
        kernels here take any length, so there is nothing per length to
        compile.  Returns the names of the kernel libraries loaded ([] on
        the CPU).  `log` gets one line per step; the seconds are added to
        metrics under "warmup".  `jobs` is accepted and ignored: the
        reference runs its steps in a thread pool against a remote compile
        service; here nvcc already builds the libraries in parallel.
        """
        return warmup_engine(self, max_query_len, batch, log)

    def align(self, query, result: SearchResult):
        """Gapped alignments (traceback) of a SearchResult's hits: a host
        pass over the k reported sequences (engine/align.py), the same in
        every mode.  It touches no device state.  Returns [Alignment]."""
        from oswald_tpu_torch.engine.align import align_hits
        return align_hits(self.db, query, result, self.submat,
                          self.config.open_gap, self.config.extend_gap)

    def search_many(self, queries, titles=None, batch: bool = True):
        """Search a list of queries.  With batch=True (default) queries are
        packed into bins of at most batch_query_pack_rows rows, one
        sw_groups_packed launch per bin over the whole database; queries
        too long to pack run one sw_groups launch each.  batch=False, or a
        single query, is search_stream.  Over-length queries fail before
        any search runs."""
        t0 = time.perf_counter()
        titles = titles or [f"query{i}" for i in range(len(queries))]
        batched = batch and len(queries) > 1
        with self.metrics.phase("engine.plan"):
            check_lengths(queries, self.config)
            plan = batch_plan(self.config, queries) if batched else None
        if not batched:
            return self.search_stream(queries, titles)

        results = [None] * len(queries)
        k = min(self.config.top, self.db.n_seqs)

        def emit(idxs, top_scores, top_slots, mom):
            for row, i in enumerate(idxs):
                results[i] = self._result(
                    queries[i], titles[i], top_scores[row], top_slots[row],
                    tuple(m[row] for m in mom))

        if self.mode == "host_stream":
            self._score_groups(plan, lambda idxs, scores: emit(
                idxs, *self._host_reduce(scores, k)))
        else:
            # two phases: every launch of the batch is queued before the
            # first readback blocks
            pending = self._score_groups(plan, lambda idxs, scores: (
                idxs, _topk(scores, self.valid, self.lnl, k)))
            for idxs, packed in pending:
                with self.metrics.phase("engine.readback"):
                    host = packed.cpu().numpy()
                with self.metrics.phase("engine.results"):
                    emit(idxs, *_unpack_topk(host))
        elapsed = time.perf_counter() - t0
        self.metrics.add("search_batch", elapsed)
        # every result carries the batch's wall time and batch_n: queries
        # shared launches, so no per-query split exists
        for r in results:
            r.elapsed = elapsed
            r.batch_n = len(queries)
        return results
