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
"""

import dataclasses
import time

import numpy as np
import torch

from oswald_tpu_torch.alphabet import DUMMY
from oswald_tpu_torch.submat import get_submat
from oswald_tpu_torch.io.db import PackedDB, db_len_stats
from oswald_tpu_torch.io.device_db import to_device
from oswald_tpu_torch.kernels.sw_lanes import sw_groups, sw_groups_packed
from oswald_tpu_torch.stats import fit_score_model, tail_calibrate
from oswald_tpu_torch.utils.metrics import Metrics


@dataclasses.dataclass
class SearchConfig:
    """The fields, defaults and validation of oswald_tpu's SearchConfig, so
    the same flags pass through.  Three of the batch fields take effect:
    batch_query_pack_rows (most rows of one packed launch; 0 packs
    nothing), u_rows (the row quantum the packing plan counts in) and
    stream_readback_window (queries of a stream read back together).
    Fields that only shape the TPU schedule or its memory modes
    (group_block, col_unroll, the pad quanta, interpret, acc_dtype,
    profile_mode, hbm_budget_bytes, host_stream_*, fused_dispatch) are
    validated and change nothing here: the kernels take each query at its
    true length and accumulate in int32, with identical scores."""
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
                f"{self.host_stream_slice_mb!r} (span byte offsets are "
                "int32 device operands, so a slice buffer must stay "
                "under 2 GiB)")
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

    def per_query_elapsed(self) -> float:
        return self.elapsed / max(self.batch_n, 1)


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


def _append_moments(packed, scores, valid, lnl):
    """Append MOM_COLS int32 columns holding the float32 score moments
    [sum(S), sum(S^2), sum(S*lnL), T1] / [c0, c1, T0, 0] over the valid
    slots to a packed [..., 2, k] top-k array, computed in float32 as the
    reference does.  `scores` is [..., N] with the same leading batch
    dimensions; every query of a batch gets its own moments.  T0/T1 derive
    from the mean and sd without the top-k (row 0); the counts include the
    hits."""
    sf = torch.where(valid, scores, 0).to(torch.float32)
    n = valid.to(torch.float32).sum()
    s1, s2 = sf.sum(-1), (sf * sf).sum(-1)
    slnl = (sf * lnl).sum(-1)
    top = packed[..., 0, :].to(torch.float32)
    topv = top >= 0
    tf = torch.where(topv, top, 0.0)
    n_ex = torch.clamp_min(n - topv.to(torch.float32).sum(-1), 1.0)
    mean = (s1 - tf.sum(-1)) / n_ex
    var = torch.clamp_min((s2 - (tf * tf).sum(-1)) / n_ex - mean * mean, 0.0)
    sd = torch.sqrt(var)
    t0 = torch.ceil(mean + TAIL_SDS0 * sd)
    t1 = torch.ceil(mean + TAIL_SDS * sd)
    c0 = (valid & (sf >= t0[..., None])).to(torch.float32).sum(-1)
    c1 = (valid & (sf >= t1[..., None])).to(torch.float32).sum(-1)
    mom = torch.stack([s1, s2, slnl, t1, c0, c1, t0, torch.zeros_like(s1)],
                      dim=-1)
    cols = mom.view(torch.int32).reshape(mom.shape[:-1] + (2, MOM_COLS))
    return torch.cat([packed, cols], dim=-1)


def _topk(scores, valid, lnl, k: int):
    """Masked top-k packed as int32[..., 2, k + MOM_COLS]: scores in row 0,
    slots in row 1, moments in the last columns.  `scores` is [..., N]; a
    leading batch dimension gives each query its own top-k.  Ties go to the
    lowest slot, as lax.top_k gives them: the order is taken over one int64
    key per slot, (score << 32) | (2^31 - 1 - slot), with padding slots at
    -1."""
    slot = torch.arange(scores.shape[-1], device=scores.device,
                        dtype=torch.int64)
    key = torch.where(valid,
                      (scores.to(torch.int64) << 32) |
                      ((1 << 31) - 1 - slot), -1)
    top = torch.topk(key, k, dim=-1).values
    vals = (top >> 32).to(torch.int32)
    idx = ((1 << 31) - 1 - (top & 0xFFFFFFFF)).to(torch.int32)
    return _append_moments(torch.stack([vals, idx], dim=-2), scores, valid,
                           lnl)


def _unpack_topk(arr):
    """Host unpack of a packed readback int32[..., 2, k+MOM_COLS] ->
    (scores[..., k], slots[..., k], mom) where mom = (sum, sumsq, slnl, T1,
    c0, c1, T0) each [...]-shaped float64 (see _append_moments)."""
    mom = np.ascontiguousarray(arr[..., :, -MOM_COLS:]).view(np.float32)
    m = tuple(mom[..., r, c].astype(np.float64)
              for r, c in ((0, 0), (0, 1), (0, 2), (0, 3),
                           (1, 0), (1, 1), (1, 2)))
    return arr[..., 0, :-MOM_COLS], arr[..., 1, :-MOM_COLS], m


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


class SearchEngine:
    """Searches one packed database with a fixed matrix and gap setting on
    one device.  device=None means CUDA and raises when there is none; CPU
    runs pass device="cpu" and score with the plain PyTorch version."""

    def __init__(self, db: PackedDB, config: SearchConfig = None,
                 device=None):
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
        self.submat = get_submat(self.config.matrix)
        self.metrics = Metrics()
        t_setup = time.perf_counter()
        self.state = to_device(db, self.device)
        self.ids_flat = self.state.ids_flat
        self.valid = self.state.valid
        self.lnl = self.state.lnl
        self.submat_dev = torch.as_tensor(self.submat, dtype=torch.int32,
                                          device=self.device)
        # kernel scratch (H and F rows between query strips), allocated
        # once; its size does not depend on the query
        self.scratch = torch.empty(
            (2,) + tuple(self.state.residues.shape), dtype=torch.int32,
            device=self.device) if self.device.type == "cuda" else None
        self._lnl_by_id, self._lnl_mom, self._len_hist = db_len_stats(db)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.metrics.add("engine_setup", time.perf_counter() - t_setup)

    def score_all(self, query) -> torch.Tensor:
        """int32 scores for every slot, in slot order, on the device."""
        q = torch.from_numpy(check_query(query, self.config)).to(self.device)
        return sw_groups(self.state.residues, self.state.groups, q,
                         self.submat_dev, self.config.open_gap,
                         self.config.extend_gap, self.scratch).reshape(-1)

    def _dispatch(self, query, query_title: str):
        """Queue one query's search on the device without blocking; returns
        a pending tuple for _finish."""
        t0 = time.perf_counter()
        k = min(self.config.top, self.db.n_seqs)
        packed = _topk(self.score_all(query), self.valid, self.lnl, k)
        return query, query_title, t0, packed

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
        query, query_title, t0, packed = pend
        if host is None:
            host = packed.cpu().numpy()          # the one readback
        res = self._result(query, query_title, *_unpack_topk(host))
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
            grp = [self._dispatch(q, t)
                   for q, t in zip(queries[lo:lo + W], titles[lo:lo + W])]
            stacked = torch.stack([p[3] for p in grp])
            if prev is not None:
                results.extend(self._finish_group(*prev))
            prev = (grp, stacked)
        if prev is not None:
            results.extend(self._finish_group(*prev))
        return results

    def _finish_group(self, grp, stacked):
        """Finish one readback window: one blocking transfer of the stack,
        then each query's result from its own rows."""
        big = stacked.cpu().numpy()              # the one window readback
        return [self._finish(p, big[i]) for i, p in enumerate(grp)]

    def search_many(self, queries, titles=None, batch: bool = True):
        """Search a list of queries.  With batch=True (default) queries are
        packed into bins of at most batch_query_pack_rows rows, one
        sw_groups_packed launch per bin over the whole database; queries
        too long to pack run one sw_groups launch each.  batch=False, or a
        single query, is search_stream.  Over-length queries fail before
        any search runs."""
        titles = titles or [f"query{i}" for i in range(len(queries))]
        cap = self.config.max_query_len
        for i, q in enumerate(queries):
            if np.asarray(q).size > cap:
                raise ValueError(
                    f"query {i} length {np.asarray(q).size} exceeds the "
                    f"engine's configured max_query_len {cap} — rebuild "
                    f"with SearchConfig(max_query_len=...) / "
                    f"--max-query-len")
        if not batch or len(queries) <= 1:
            return self.search_stream(queries, titles)

        t0 = time.perf_counter()
        results = [None] * len(queries)
        k = min(self.config.top, self.db.n_seqs)
        st, cfg = self.state, self.config
        # two phases: every launch of the batch is queued before the first
        # readback blocks
        pending = []                     # (query indices, packed [Q, 2, .])
        bins, rest = mixed_pack_plan(cfg.batch_query_pack_rows, cfg.u_rows,
                                     queries)
        for idxs, q_packed, seg_map, used in bins:
            segs = plan_segments(idxs, seg_map, used, cfg.u_rows, queries)
            scores = sw_groups_packed(
                st.residues, st.groups,
                torch.from_numpy(q_packed).to(self.device),
                torch.from_numpy(segs).to(self.device), self.submat_dev,
                cfg.open_gap, cfg.extend_gap, self.scratch)
            pending.append((idxs, _topk(scores.reshape(len(idxs), -1),
                                        self.valid, self.lnl, k)))
        if rest:
            # queries over the pack budget: one launch each, back to back
            # on the stream, then one top-k and one readback for all
            scores = torch.stack([self.score_all(queries[i]) for i in rest])
            pending.append((rest, _topk(scores, self.valid, self.lnl, k)))

        for idxs, packed in pending:
            top_scores, top_slots, mom = _unpack_topk(packed.cpu().numpy())
            for row, i in enumerate(idxs):
                results[i] = self._result(
                    queries[i], titles[i], top_scores[row], top_slots[row],
                    tuple(m[row] for m in mom))
        elapsed = time.perf_counter() - t0
        self.metrics.add("search_batch", elapsed)
        # every result carries the batch's wall time and batch_n: queries
        # shared launches, so no per-query split exists
        for r in results:
            r.elapsed = elapsed
            r.batch_n = len(queries)
        return results
