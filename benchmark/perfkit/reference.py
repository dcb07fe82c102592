"""The plain reference: Smith-Waterman scores, the top-k and the E-values of
one query against the whole database, in plain PyTorch on the card.

It shares no code with the port.  The recurrence is the one the port
states (exact int32, affine gap of open + k x extend):

    H[i,j] = max(0, H[i-1,j-1] + S(a_i, b_j), E[i,j], F[i,j])
    E[i,j] = max(H[i,j-1] - (open+extend), E[i,j-1] - extend)
    F[i,j] = max(H[i-1,j] - (open+extend), F[i-1,j] - extend)

computed row by row of the query, each row a vector over every residue of
every subject at once.  Subjects lie in rows of `Layout.width` cells (at
least `WIDTH`, and the longest subject + 1), each one
behind a sentinel cell that scores -2^22 against everything, so H is 0
there and no value crosses from one subject to the next.  The horizontal
gap E is a running maximum along the row: E[j] = max over k < j of
(H~[k] + k * extend) - j * extend - open, where H~ is H before E (an E
that comes from another E never beats extending that E, since open >= 0).
One `torch.cummax` over each row takes it for every subject at once, with
the subject's slot in its row added as `slot << 21`, so that a running
maximum never reaches back into the subject before.

The length sort of the database (stable, ascending) and the ids it gives
are worked out here again from the corpus the benchmark made.  The moments
and tail thresholds are float32 sums as the configuration states; the fit
is `refstats`, a frozen copy of the statistics.
"""

import dataclasses
import math
import os

import numpy as np
import torch

from perfkit import refstats
from perfkit.synth import ALPHABET, DUMMY

SENT = 24                 # sentinel code, before every subject and as row
NEG = -(1 << 22)          # padding: scores this against every query code
SLOT_SHIFT = 21
MAX_SLOTS = 1000          # subjects in one row: (MAX_SLOTS + 1) << 21 < 2^31
WIDTH = 8192              # cells of one row, or the longest subject + 1
TAIL_SDS0 = 1.2           # the tail thresholds, in sd above the mean
TAIL_SDS = 2.5
THRESHOLD_TOL = 1e-3      # float32 sums' reach on mean + k sd (see moments)


def load_matrix(path) -> np.ndarray:
    """[24, 25] int32: the matrix in the engine's code order (row and
    column 23, the padding residue, score 0), and column 24, the sentinel,
    at NEG.  The file gives the letters in its first line."""
    rows = [ln.split() for ln in open(path) if ln.strip()
            and not ln.startswith("#")]
    letters, body = rows[0], rows[1:]
    code = {c: i for i, c in enumerate(ALPHABET)}
    m = np.zeros((24, 25), np.int32)
    m[:, SENT] = NEG
    for r in body:
        for c, v in zip(letters, r[1:]):
            m[code[r[0]], code[c]] = int(v)
    return m


def matrix_path(root, name: str) -> str:
    return os.path.join(root, "benchmark", "matrices", name.upper())


def _ragged(lens: torch.Tensor) -> torch.Tensor:
    """0..n-1 for each n of `lens`, concatenated (int64)."""
    total = int(lens.sum())
    starts = torch.cumsum(lens, 0) - lens
    return torch.arange(total, device=lens.device) - \
        torch.repeat_interleave(starts, lens)


class Layout:
    """Subjects (segments) laid out in rows of `width` cells: a sentinel cell,
    then the subject's residues; what is left of a row is sentinel too.
    `codes` int32[n], `base` int32[n] = (slot in row << 21) + position in
    subject x extend, `seg` int64[n] = the segment of each cell (n_seg for
    padding)."""

    def __init__(self, lengths: np.ndarray, residues: torch.Tensor,
                 extend: int, open_gap: int):
        lengths = np.asarray(lengths, np.int64)
        dev = residues.device
        n_seg = lengths.size
        longest = int(lengths.max()) if n_seg else 0
        if longest * extend + (1 << 17) >= (1 << SLOT_SHIFT):
            raise ValueError("a subject is too long for the layout")
        self.width = width = max(WIDTH, longest + 1)
        start = np.empty(n_seg, np.int64)
        slot = np.empty(n_seg, np.int64)
        row_slots = []
        row = col = s_in_row = 0
        for s, n in enumerate(lengths.tolist()):
            if col + n + 1 > width or s_in_row >= MAX_SLOTS:
                row_slots.append(s_in_row)
                row, col, s_in_row = row + 1, 0, 0
            start[s] = row * width + col
            slot[s] = s_in_row
            col += n + 1
            s_in_row += 1
        row_slots.append(s_in_row)
        self.rows = len(row_slots)
        self.n = self.rows * width
        self.n_seg = n_seg
        L = torch.as_tensor(lengths, device=dev)
        st = torch.as_tensor(start, device=dev)
        sl = torch.as_tensor(slot, device=dev)
        # residue cells: start + 1 + k
        k = _ragged(L)
        cell = torch.repeat_interleave(st + 1, L) + k
        codes = torch.full((self.n,), SENT, dtype=torch.int32, device=dev)
        codes[cell] = residues.to(torch.int32)
        # padding cells take the row's next free slot, every subject's cells
        # (sentinel and residues) its own
        cslot = torch.repeat_interleave(
            torch.as_tensor(row_slots, device=dev),
            torch.full((self.rows,), width, device=dev))
        seg = torch.full((self.n,), n_seg, dtype=torch.int64, device=dev)
        whole = torch.repeat_interleave(st, L + 1) + _ragged(L + 1)
        seg_ids = torch.repeat_interleave(torch.arange(n_seg, device=dev),
                                          L + 1)
        cslot[whole] = sl[seg_ids]
        seg[whole] = seg_ids
        lpos = torch.zeros(self.n, dtype=torch.int64, device=dev)
        lpos[cell] = k
        base = (cslot << SLOT_SHIFT) + lpos * int(extend)
        self.codes = codes
        self.seg = seg
        self.seg32 = seg.to(torch.int32)
        self.base = base.to(torch.int32)
        self.baseo = (base + int(open_gap)).to(torch.int32)


def sweep(layout: Layout, n_rows: int, sub_of_row, open_gap: int,
          extend: int, saturate16: bool = False) -> torch.Tensor:
    """int32[n_seg]: the best H of every segment over `n_rows` query rows;
    sub_of_row(i) gives row i's substitution scores, int32[layout.n].
    saturate16 caps H at 32767, as 16-bit saturating lanes would."""
    n, dev, width = layout.n, layout.codes.device, layout.width
    z = lambda: torch.zeros(n, dtype=torch.int32, device=dev)  # noqa: E731
    H, F, T, V, CM, X, best = z(), z(), z(), z(), z(), z(), z()
    IDX = torch.empty((layout.rows, width), dtype=torch.int64, device=dev)
    oe = int(open_gap) + int(extend)
    for i in range(n_rows):
        sub = sub_of_row(i)
        torch.sub(H, oe, out=X)
        F.sub_(int(extend))
        torch.maximum(F, X, out=F)
        torch.add(H[:-1], sub[1:], out=T[1:])
        torch.maximum(T, F, out=T)
        T.clamp_min_(0)
        torch.add(T, layout.base, out=V)
        torch.cummax(V.view(layout.rows, width), 1,
                     out=(CM.view(layout.rows, width), IDX))
        torch.sub(CM[:-1], layout.baseo[1:], out=X[1:])
        X.view(layout.rows, width)[:, 0] = NEG    # no E across rows
        torch.maximum(T, X, out=H)
        if saturate16:
            H.clamp_max_(32767)
        torch.maximum(best, H, out=best)
    out = torch.zeros(layout.n_seg + 1, dtype=torch.int32, device=dev)
    out.scatter_reduce_(0, layout.seg, best, "amax")
    return out[:layout.n_seg]


@dataclasses.dataclass
class Expected:
    """One query's top-k as the reference works it out."""
    scores: np.ndarray      # int32[k], descending
    ids: np.ndarray         # int64[k], sorted-order ids, ties to the lowest
    evalues: list           # admissible float64[k] vectors (or None each)


class Reference:
    """The database as the reference holds it: the corpus (record order)
    sorted by length, stable and ascending, so that position = the sorted
    id the port reports; the subjects laid out for `sweep`."""

    def __init__(self, lengths, residues: torch.Tensor, titles, matrix,
                 open_gap: int, extend: int, top: int):
        lengths = np.asarray(lengths, np.int64)
        dev = residues.device
        self.order = np.argsort(lengths, kind="stable")
        self.lengths = lengths[self.order]
        self.titles = [titles[i] for i in self.order]
        self.open_gap, self.extend = int(open_gap), int(extend)
        self.k = min(int(top), lengths.size)
        self.smat = torch.as_tensor(matrix, device=dev)      # [24, 25]
        self.smat_flat = self.smat.reshape(-1)
        L = torch.as_tensor(self.lengths, device=dev)
        offs = torch.as_tensor(np.concatenate([[0], np.cumsum(lengths)]),
                               device=dev)
        src = torch.repeat_interleave(
            offs[torch.as_tensor(self.order, device=dev)], L) + _ragged(L)
        self.flat = residues[src]                          # sorted order
        self.offs = torch.cumsum(L, 0) - L
        self.layout = Layout(self.lengths, self.flat, extend, open_gap)
        lnl = np.log(np.maximum(self.lengths.astype(np.float64), 1.0)) \
            .astype(np.float32)
        self.lnl32 = lnl
        self.lnl_dev = torch.as_tensor(lnl, device=dev)
        l64 = lnl.astype(np.float64)
        self.lnl_mom = (float(l64.sum()), float((l64 * l64).sum()))
        self.len_hist = np.unique(self.lengths, return_counts=True)

    # --- scores ---------------------------------------------------------
    def scores(self, query, saturate16: bool = False) -> torch.Tensor:
        """int32[n_seqs] scores of one query against every subject."""
        q = [int(c) for c in np.asarray(query)] or [DUMMY]
        codes = self.layout.codes
        out = torch.empty_like(codes)

        def sub_of_row(i):
            return torch.index_select(self.smat[q[i]], 0, codes, out=out)
        return sweep(self.layout, len(q), sub_of_row, self.open_gap,
                     self.extend, saturate16)

    def pair_scores(self, queries, ids) -> np.ndarray:
        """int32[P]: the score of each (query, subject id) pair, all pairs
        in one sweep of as many rows as the longest query (a shorter query
        reads the padding residue, which scores 0, past its end)."""
        P = len(ids)
        if not P:
            return np.zeros(0, np.int32)
        dev = self.flat.device
        ids_t = torch.as_tensor(np.asarray(ids, np.int64), device=dev)
        L = torch.as_tensor(self.lengths[np.asarray(ids, np.int64)],
                            device=dev)
        src = torch.repeat_interleave(self.offs[ids_t], L) + _ragged(L)
        lay = Layout(self.lengths[np.asarray(ids, np.int64)], self.flat[src],
                     self.extend, self.open_gap)
        m = max(max(len(q) for q in queries), 1)
        qtab = np.full((P + 1, m), DUMMY, np.int32)
        for p, q in enumerate(queries):
            qtab[p, :len(q)] = q
        qtab = torch.as_tensor(qtab, device=dev)
        qcell = torch.empty(lay.n, dtype=torch.int32, device=dev)
        out = torch.empty(lay.n, dtype=torch.int32, device=dev)

        def sub_of_row(i):
            torch.index_select(qtab[:, i].contiguous(), 0, lay.seg32,
                               out=qcell)
            qcell.mul_(self.smat.shape[1]).add_(lay.codes)
            return torch.index_select(self.smat_flat, 0, qcell, out=out)
        return sweep(lay, m, sub_of_row, self.open_gap,
                     self.extend).cpu().numpy()

    # --- top-k and statistics -----------------------------------------
    def topk(self, scores: torch.Tensor):
        """(scores int32[k], ids int64[k]): descending, ties to the lowest
        id, over one int64 key per subject."""
        ids = torch.arange(scores.numel(), device=scores.device)
        key = (scores.to(torch.int64) << 32) | ((1 << 31) - 1 - ids)
        top = torch.topk(key, self.k).values
        return ((top >> 32).to(torch.int32).cpu().numpy(),
                ((1 << 31) - 1 - (top & 0xFFFFFFFF)).cpu().numpy())

    def moments(self, scores: torch.Tensor, top_scores, bf16: bool = False):
        """[(s1, s2, slnl, T1, c0, c1, T0)]: the float32 score sums, the
        tail thresholds T = ceil(mean + k sd) from the hit-excluded mean and
        sd, and the counts at or above them.  Float32 sums in another order
        move mean + k sd by well under THRESHOLD_TOL, so where it lies that
        close to a whole number both roundings are admissible, and each
        comes as its own tuple.  bf16 rounds each sum to bfloat16 first."""
        sf = scores.to(torch.float32)
        sums = torch.stack([sf.sum(), (sf * sf).sum(),
                            (sf * self.lnl_dev).sum()])
        if bf16:
            sums = sums.to(torch.bfloat16).to(torch.float32)
        n = torch.tensor(float(scores.numel()), device=sf.device)
        top = torch.as_tensor(np.asarray(top_scores, np.float32),
                              device=sf.device)
        topv = top >= 0
        tf = torch.where(topv, top, torch.zeros_like(top))
        n_ex = torch.clamp_min(n - topv.to(torch.float32).sum(), 1.0)
        mean = (sums[0] - tf.sum()) / n_ex
        var = torch.clamp_min((sums[1] - (tf * tf).sum()) / n_ex
                              - mean * mean, 0.0)
        sd = torch.sqrt(var)
        x0 = float(mean + TAIL_SDS0 * sd)
        x1 = float(mean + TAIL_SDS * sd)

        def choices(x):
            return sorted({math.ceil(x - THRESHOLD_TOL),
                           math.ceil(x + THRESHOLD_TOL)} |
                          {math.ceil(np.float32(x))})
        s1, s2, sl = (float(v) for v in sums.cpu().numpy())
        out = []
        for t0 in choices(x0):
            for t1 in choices(x1):
                c0, c1 = (float((sf >= t).sum()) for t in (t0, t1))
                out.append((s1, s2, sl, float(t1), c0, c1, float(t0)))
        return out

    def evalues(self, top_scores, top_ids, mom, qlen):
        s1, s2, sl, t1, c0, c1, t0 = mom
        n = self.lengths.size
        ex_l = self.lnl32[np.maximum(np.asarray(top_ids, np.int64), 0)]
        st = refstats.fit_score_model(n, s1, s2, sl, *self.lnl_mom,
                                      exclude_scores=top_scores,
                                      exclude_lnl=ex_l)
        st = refstats.tail_calibrate(st, n, self.len_hist, t0, t1, c0, c1,
                                     exclude_scores=top_scores)
        if st is None:
            return None
        return st.evalues(top_scores, n, self.len_hist)

    def search(self, query, control: bool = False) -> Expected:
        """The query's top-k with its admissible E-value vectors (see
        `moments`).  control=True is the same search one precision step
        down: 16-bit saturating scores and the moments summed to
        bfloat16."""
        s = self.scores(query, saturate16=control)
        top_s, top_i = self.topk(s)
        evs = [self.evalues(top_s, top_i, mom, len(query))
               for mom in self.moments(s, top_s, bf16=control)]
        return Expected(top_s, top_i, evs)
