"""Distributed search over torch.distributed ranks: the counterpart of
oswald_tpu/dist/shard.py.

One rank drives one device; the process group (dist/bootstrap.py) plays the
role of the reference's device mesh.  Every rank owns a contiguous slice of
every bin's groups (`shard_bounds`): ranks differ by at most one group per
bin, and a bin's leftover groups go to the ranks with the fewest cells so
far.  Ids stay global, so the merge and the titles need no mapping.  At
world size 1 the rank owns the database as packed.  A rank reads only its
slice of the (memory-mapped) bins and builds the port's single-device
`SearchEngine` on it, resident or `host_stream`, so every launch is that
engine's: `_score_groups` of a `batch_plan` (`sw_groups_packed` /
`sw_groups`) and, for a stream, `_launch`.

A search is three steps on every rank, in the same order:

1. the rank's launches, then its top-k (lowest slot first on ties, which
   is lowest id first: slot order follows id order within a rank) and the
   score sums sum(S), sum(S^2), sum(S*lnL) and the valid count of its
   slots, read back once.  Above world size 1 a resident rank takes them
   exactly, in integers (`engine.search._exact_sums`), so that the ranks'
   sums add up to the whole database's, the same in any order, rounded to
   float32 once; under host_stream they are float64, as the single engine
   takes them there; at world size 1 they are the single engine's own;
2. one all_gather of the k candidates (score, global id) and the sums;
   every rank merges them into the global top-k (score descending, lowest
   id on ties, as the single engine orders them) and adds the sums in rank
   order, so every rank holds the same values;
3. the tail thresholds T0/T1 of stats.tail_calibrate from the global sums
   and the global top-k (the single engine's formula: float32 for a
   resident database, float64 under host_stream), then each rank counts its
   valid scores at or above them, and one all_reduce adds the counts.

So every path (single query, stream, batch, host_stream) is tail-calibrated
as the port's `SearchEngine` is on the same database, and the world size
does not change an E-value beyond the rounding of the sums: at world size
1 nothing differs, bit for bit; above it the sums are the exact ones, from
which the single engine's float32 sums (of the reference's design) differ
by their own rounding.  This differs from the reference on purpose: there, per-bin
dispatch, batches and the distributed host_stream emit the T1 = -1
sentinel and keep the moment-only fit.  One launch covers a rank's whole
shard, so there are no per-bin segments to join (the reference's
`_split_packed` has no counterpart).
"""

import dataclasses
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as tdist

from oswald_tpu_torch.submat import get_submat
from oswald_tpu_torch.io.db import PackedDB, GROUP_LANES, db_len_stats
from oswald_tpu_torch.engine.planner import (device_hbm_bytes,
                                             plan_profile_mode)
from oswald_tpu_torch.engine.search import (
    SearchConfig, SearchEngine, SearchResult, batch_plan, check_lengths,
    check_query, warmup_engine, _result_stats,
    _score_sums, _exact_sums, _sums_float32, _tail_thresholds,
    _tail_counts, _topk_slots, _host_topk, _host_sums, _host_thresholds,
    _host_counts)
from oswald_tpu_torch.dist.bootstrap import is_bootstrapped, world
from oswald_tpu_torch.utils.metrics import Metrics


def process_group_slice(n_groups: int, world_size: int, rank: int,
                        extra=None):
    """[lo, hi): the contiguous range of a bin's n_groups groups that rank
    owns.  Every rank gets n_groups // world_size groups, and the
    n_groups % world_size ranks in `extra` (default: the lowest ranks) one
    more; ranges follow rank order."""
    if not (isinstance(world_size, int) and world_size >= 1):
        raise ValueError(f"world size must be a positive int, got "
                         f"{world_size!r}")
    if not (isinstance(rank, int) and 0 <= rank < world_size):
        raise ValueError(f"rank {rank!r} is not in a world of {world_size}")
    if not (isinstance(n_groups, int) and n_groups >= 0):
        raise ValueError(f"group count must be a non-negative int, got "
                         f"{n_groups!r}")
    base, left = divmod(n_groups, world_size)
    extra = set(range(left) if extra is None else extra)
    if len(extra) != left or not extra <= set(range(world_size)):
        raise ValueError(f"{n_groups} groups over {world_size} ranks leave "
                         f"{left} extra groups; ranks {sorted(extra)} given")
    sizes = [base + (r in extra) for r in range(world_size)]
    lo = sum(sizes[:rank])
    return lo, lo + sizes[rank]


def shard_bounds(db: PackedDB, world_size: int) -> dict:
    """{L: [(lo, hi) of every rank]}: each bin split as evenly as its group
    count allows, its leftover groups to the ranks with the fewest cells
    so far (ties to the lowest rank)."""
    load = [0] * world_size
    out = {}
    for L in db.bin_lengths:
        G = int(db.bins[L]["seq"].shape[0])
        extra = sorted(range(world_size),
                       key=lambda r: (load[r], r))[:G % world_size]
        out[L] = [process_group_slice(G, world_size, r, extra)
                  for r in range(world_size)]
        for r, (lo, hi) in enumerate(out[L]):
            load[r] += (hi - lo) * L
    return out


def shard_cells(bounds: dict) -> list:
    """Padded cells a query row costs each rank: sum of L x 1024 over the
    groups it owns."""
    world_size = len(next(iter(bounds.values()), [(0, 0)]))
    return [sum((b[r][1] - b[r][0]) * L * GROUP_LANES
                for L, b in bounds.items()) for r in range(world_size)]


def shard_db(db: PackedDB, bounds: dict, rank: int) -> PackedDB:
    """The rank's share as a PackedDB: its group range of every bin (views:
    a memory-mapped bin is read only where sliced), with the database's
    global ids, lengths, titles and counts; bins that give the rank no
    group are left out."""
    bins = {}
    for L, b in bounds.items():
        lo, hi = b[rank]
        if hi > lo:
            bins[L] = {k: db.bins[L][k][lo:hi] for k in ("seq", "len", "id")}
    return dataclasses.replace(db, bins=bins)


class DistributedSearchEngine:
    """Searches one packed database across the ranks of the process group
    (one device each), with the reference's methods and results.  Every
    rank calls every method with the same arguments: each search runs
    collectives.  device=None means cuda:{LOCAL_RANK % device_count} and
    raises when there is no CUDA; CPU runs pass device="cpu".  Without a
    process group it is world size 1 with no collectives.  `engine` is the
    rank's SearchEngine over its shard (None for a rank that owns no
    group), `bounds` the split (shard_bounds)."""

    def __init__(self, db: PackedDB, config: SearchConfig = None,
                 device=None, long_from: int = None):
        self.rank, self.world_size = world()
        self._collective = is_bootstrapped()
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DistributedSearchEngine: CUDA is not available; pass "
                    "device='cpu' to search on the CPU")
            local = int(os.environ.get("LOCAL_RANK", self.rank))
            device = f"cuda:{local % torch.cuda.device_count()}"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"DistributedSearchEngine: device "
                               f"{self.device} requested but CUDA is not "
                               "available")
        self.db = db
        self.config = config or SearchConfig()
        self.submat = get_submat(self.config.matrix)
        self.metrics = Metrics()
        t_setup = time.perf_counter()
        if self.world_size == 1:
            # the database as packed: world-1 work is SearchEngine's
            self.bounds = {L: [(0, int(db.bins[L]["seq"].shape[0]))]
                           for L in db.bin_lengths}
            shard = db
        else:
            self.bounds = shard_bounds(db, self.world_size)
            shard = shard_db(db, self.bounds, self.rank)
        self.mode = self._resolve_mode(shard)
        # resident above world size 1: exact sums, which add up across
        # ranks to the whole database's (at world size 1 the single
        # engine's float32 sums are the whole database's already)
        self._exact = self.world_size > 1 and self.mode != "host_stream"
        self.engine = None
        if shard.bins:
            self.engine = SearchEngine(
                shard, dataclasses.replace(self.config,
                                           profile_mode=self.mode),
                device=self.device, long_from=long_from)
        self._lnl_by_id, self._lnl_mom, self._len_hist = db_len_stats(db)
        self._ids_flat = None
        self.metrics.add("engine_setup", time.perf_counter() - t_setup)

    # --- collectives (CPU tensors over gloo) ------------------------------

    def _gather(self, arr: np.ndarray) -> np.ndarray:
        """[world, ...]: every rank's `arr` (same shape and dtype), in rank
        order."""
        if not self._collective:
            return arr[None]
        t = torch.from_numpy(np.ascontiguousarray(arr))
        out = [torch.empty_like(t) for _ in range(self.world_size)]
        tdist.all_gather(out, t)
        return np.stack([o.numpy() for o in out])

    def _sum(self, arr: np.ndarray) -> np.ndarray:
        """The element-wise sum of every rank's float64 `arr` of whole
        numbers (exact in any order)."""
        if not self._collective:
            return arr
        t = torch.from_numpy(np.array(arr, np.float64))
        tdist.all_reduce(t)
        return t.numpy()

    def _resolve_mode(self, shard) -> str:
        """profile_mode, with `auto` planned on this rank's share
        (plan_profile_mode of its shard); host_stream if any rank's plan
        needs it, so that every rank runs the same path."""
        cfg = self.config
        if cfg.profile_mode != "auto":
            return cfg.profile_mode
        hbm = cfg.hbm_budget_bytes
        if hbm is None:
            hbm = device_hbm_bytes(self.device)
        plan = plan_profile_mode(shard, hbm,
                                 max_query_len=cfg.max_query_len, config=cfg)
        streams = self._sum(np.asarray(
            [plan.mode == "host_stream"], np.float64))[0] > 0
        mode = "host_stream" if streams else "precompute"
        if self.rank == 0:
            print(f"oswald-tpu-torch dist engine [{self.world_size} ranks]: "
                  f"rank 0 {plan.describe()}; resolved {mode}",
                  file=sys.stderr)
        return mode

    # --- the three steps of a search --------------------------------------

    def _local(self, groups, n: int, k: int) -> np.ndarray:
        """Step 1.  int64 [n, 2k + 4], one row per query of the call: the
        rank's top-k scores (k columns), their global ids (k columns; -1
        and score -1 where the rank has fewer valid slots) and its four
        sums (sum, sumsq, slnl, valid count): `_exact_sums` when
        self._exact, else as float64 bit patterns the single engine's own
        (`_score_sums` resident, `_host_sums` under host_stream).  groups:
        [(query indices, scores [Q, n_slots] of the rank's engine)]."""
        rows = np.full((n, 2 * k + 4), -1, np.int64)
        rows[:, 2 * k:] = 0
        eng = self.engine
        if eng is None:
            return rows
        kl = min(k, eng.n_slots)

        def put(i, scores, slots):
            ok = scores >= 0
            rows[i, :kl] = np.where(ok, scores, -1)
            rows[i, k:k + kl] = np.where(
                ok, eng.ids_flat[np.maximum(slots, 0)], -1)

        if self.mode == "host_stream":
            for idxs, scores in groups:
                for r, i in enumerate(idxs):
                    put(i, *_host_topk(scores[r], eng.ids_flat, kl))
                rows[idxs, 2 * k:] = np.stack(
                    _host_sums(scores, eng._hs_valid, eng.lnl_flat),
                    -1).view(np.int64)
            return rows
        sums = _exact_sums if self._exact else _score_sums
        # queued for every group before the first readback blocks
        pending = [(idxs, torch.cat(
            [_topk_slots(s, eng.valid, kl).reshape(len(idxs), 2 * kl),
             sums(s, eng.valid, eng.lnl).view(torch.int32)], -1))
            for idxs, s in groups]
        for idxs, dev in pending:
            host = dev.cpu().numpy()
            for r, i in enumerate(idxs):
                put(i, host[r, :kl], host[r, kl:2 * kl])
            got = np.ascontiguousarray(host[:, 2 * kl:])
            rows[idxs, 2 * k:] = got.view(np.int64) if self._exact else \
                got.view(np.float32).astype(np.float64).view(np.int64)
        return rows

    def _exchange(self, rows: np.ndarray, k: int):
        """Step 2.  (top scores int32 [n, k], top ids int32 [n, k], the
        whole database's sums [n, 4], int64 when self._exact, else float64)
        from every rank's step-1 rows."""
        g = self._gather(rows)
        n = rows.shape[0]
        top_s = np.full((n, k), -1, np.int32)
        top_i = np.full((n, k), -1, np.int32)
        for q in range(n):
            s, ids = g[:, q, :k].reshape(-1), g[:, q, k:2 * k].reshape(-1)
            ok = ids >= 0
            s, ids = s[ok], ids[ok]
            order = np.lexsort((ids, -s))[:k]
            top_s[q, :order.size] = s[order]
            top_i[q, :order.size] = ids[order]
        sums = np.ascontiguousarray(g[:, :, 2 * k:])
        if not self._exact:
            sums = sums.view(np.float64)
        return top_s, top_i, sums.sum(0)

    def _tails(self, groups, sums, top_s):
        """Step 3.  (moments [n, 7] as _result_stats takes them: sum,
        sumsq, slnl, T1, c0, c1, T0): the thresholds from the whole
        database's sums and hits, then the valid scores at or above them
        on every rank, added up."""
        eng = self.engine
        counts = np.zeros((len(sums), 2))
        if self.mode == "host_stream":
            f = sums
            t0, t1 = _host_thresholds(f[:, 0], f[:, 1], f[:, 3], top_s)
            for idxs, scores in groups if eng is not None else ():
                counts[idxs] = np.stack(_host_counts(
                    scores, eng._hs_valid, t0[idxs], t1[idxs]), -1)
        else:
            f = _sums_float32(torch.from_numpy(sums)) if self._exact else \
                torch.from_numpy(sums.astype(np.float32))
            t0, t1 = (t.numpy() for t in _tail_thresholds(
                f, torch.from_numpy(top_s)))
            f = f.numpy()
            pending = [(idxs, _tail_counts(
                s, eng.valid, torch.from_numpy(t0[idxs]).to(self.device),
                torch.from_numpy(t1[idxs]).to(self.device)))
                for idxs, s in (groups if eng is not None else ())]
            for idxs, c in pending:
                counts[idxs] = c.cpu().numpy()
        counts = self._sum(counts)
        return np.stack([f[:, 0], f[:, 1], f[:, 2], t1, counts[:, 0],
                         counts[:, 1], t0], -1)

    def _complete(self, queries, titles, groups):
        """Steps 1-3 and the hits with statistics of every query."""
        k = min(self.config.top, self.db.n_seqs)
        top_s, top_i, sums = self._exchange(
            self._local(groups, len(queries), k), k)
        mom = self._tails(groups, sums, top_s)
        out = []
        for q, query in enumerate(queries):
            qlen = int(np.asarray(query).size)
            ev, bits, st = _result_stats(
                self.db, self._lnl_by_id, self._lnl_mom, self._len_hist,
                top_s[q], top_i[q], mom[q], qlen)
            out.append(SearchResult(
                query_title=titles[q], query_length=qlen, scores=top_s[q],
                seq_ids=top_i[q],
                titles=[self.db.title_of(int(i)) for i in top_i[q]],
                elapsed=0.0, evalues=ev, bit_scores=bits, stats=st))
        return out

    # --- the reference's methods ------------------------------------------

    def _check(self, queries):
        """Refuse, on every rank alike and before any launch, what a rank's
        engine would refuse: over-length queries and un-encoded codes."""
        check_lengths(queries, self.config)
        for q in queries:
            check_query(q, self.config)

    def _stream_group(self, queries):
        """[(indices, scores [Q, n_slots])]: the queries one launch each,
        queued (resident) or swept one by one (host_stream, copied out of
        the sweep's reused buffer)."""
        eng, cfg = self.engine, self.config
        if eng is None:
            return []
        idxs = list(range(len(queries)))
        if self.mode == "host_stream":
            return [(idxs, np.concatenate(
                [eng._host_stream_scores_multi([(check_query(q, cfg),
                                                 None)])[0].copy()
                 for q in queries]))]
        return [(idxs, torch.cat([eng._launch(check_query(q, cfg))
                                  for q in queries]))]

    def search(self, query, query_title: str = "query") -> SearchResult:
        return self.search_stream([query], [query_title])[0]

    def search_stream(self, queries, titles=None):
        """Queries one by one, each alone in its launch, with the results
        of [search(q) for q in queries]: a window of
        stream_readback_window queries is read back and exchanged together,
        after the next window's launches are queued."""
        titles = titles or [f"query{i}" for i in range(len(queries))]
        self._check(queries)
        W = max(self.config.stream_readback_window, 1)
        results, prev = [], None

        def finish(lo, t0, groups):
            got = self._complete(queries[lo:lo + W], titles[lo:lo + W],
                                 groups)
            for r in got:
                r.elapsed = time.perf_counter() - t0
                self.metrics.add("search", r.elapsed)
            return got

        for lo in range(0, len(queries), W):
            cur = (lo, time.perf_counter(),
                   self._stream_group(queries[lo:lo + W]))
            if prev is not None:
                results.extend(finish(*prev))
            prev = cur
        if prev is not None:
            results.extend(finish(*prev))
        return results

    def search_many(self, queries, titles=None, batch: bool = True):
        """Search a list of queries.  With batch=True every rank runs the
        batch's plan (batch_plan: mixed_pack_plan's bins, one
        sw_groups_packed launch each, then one sw_groups launch per query
        too long to pack) on its shard, the same launches on every rank.
        The plan runs group by group, each group launched, then through
        steps 1-3, then dropped, so one group's scores are live on a
        device at a time, as the planner budgets.  batch=False, or a
        single query, is search_stream.  Bad queries fail before any
        search runs."""
        titles = titles or [f"query{i}" for i in range(len(queries))]
        self._check(queries)
        if not batch or len(queries) <= 1:
            return self.search_stream(queries, titles)
        t0 = time.perf_counter()
        results = [None] * len(queries)

        def complete(idxs, scores):
            # a rank that owns no group still takes part in the collectives
            got = self._complete(
                [queries[i] for i in idxs], [titles[i] for i in idxs],
                [] if scores is None else [(list(range(len(idxs))), scores)])
            for i, r in zip(idxs, got):
                results[i] = r

        plan = batch_plan(self.config, queries)
        if self.engine is not None:
            self.engine._score_groups(plan, complete)
        else:
            for idxs, _ in plan:
                complete(idxs, None)
        elapsed = time.perf_counter() - t0
        self.metrics.add("search_batch", elapsed)
        for r in results:
            r.elapsed = elapsed
            r.batch_n = len(queries)
        return results

    def score_all(self, query) -> torch.Tensor:
        """int32 scores of every slot, in ids_flat order (the single
        engine's slot order), on this rank's device, on every rank.  Not
        available under host_stream, where no rank holds its scores."""
        if self.mode == "host_stream":
            raise ValueError("score_all is not available in host_stream "
                             "mode (scores stream through each rank's "
                             "device in slices)")
        q = check_query(query, self.config)
        per_rank = [sum(b[r][1] - b[r][0] for b in self.bounds.values()) *
                    GROUP_LANES for r in range(self.world_size)]
        local = np.full(max(per_rank), -1, np.int32)
        if self.engine is not None:
            local[:per_rank[self.rank]] = \
                self.engine._launch(q)[0].cpu().numpy()
        g = self._gather(local)
        parts, off = [], [0] * self.world_size
        for b in self.bounds.values():
            for r, (lo, hi) in enumerate(b):
                n = (hi - lo) * GROUP_LANES
                parts.append(g[r, off[r]:off[r] + n])
                off[r] += n
        flat = np.concatenate(parts) if parts else np.zeros(0, np.int32)
        return torch.from_numpy(flat).to(self.device)

    @property
    def ids_flat(self) -> np.ndarray:
        """Sorted-sequence id per slot, bins ascending and groups in bin
        order: the single engine's slot order (-1 = padding)."""
        if self._ids_flat is None:
            parts = [np.asarray(self.db.bins[L]["id"], np.int32).reshape(-1)
                     for L in self.db.bin_lengths]
            self._ids_flat = np.concatenate(parts) if parts else \
                np.zeros(0, np.int32)
        return self._ids_flat

    def warmup(self, max_query_len: int = 512, batch: bool = True,
               log=None, jobs: int = 1):
        """SearchEngine.warmup across the ranks: build and load both engine
        kernel libraries (on a card), then one search and one packed batch
        of DUMMY queries through the distributed path, collectives
        included.  Every rank calls it alike.  Returns the libraries'
        names ([] on the CPU).  jobs is refused above 1 on more than one
        rank (as the reference refuses it: parallel steps would issue
        collectives in different orders on different ranks) and ignored
        otherwise."""
        if jobs > 1 and self.world_size > 1:
            raise ValueError(
                f"warmup(jobs={jobs}) is not allowed on {self.world_size} "
                "ranks: parallel steps would issue collectives in "
                "different orders on different ranks; call warmup(jobs=1) "
                "on every rank")
        return warmup_engine(self, max_query_len, batch, log)

    def align(self, query, result: SearchResult):
        """Gapped alignments of a SearchResult's hits: a host pass over the
        k reported sequences of the whole database (every rank holds it,
        memory-mapped), as SearchEngine.align.  Returns [Alignment]."""
        from oswald_tpu_torch.engine.align import align_hits
        return align_hits(self.db, query, result, self.submat,
                          self.config.open_gap, self.config.extend_gap)
