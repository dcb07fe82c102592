"""Alignment traceback for reported hits: the port's copy of
oswald_tpu/engine/align.py, semantics unchanged.

The search is score-only; a user of SSEARCH/BLAST-style tools expects to
*see* the top alignments.  Traceback is a host-side post-pass over the k
reported hits only: the card scores all D sequences, the host aligns the
handful that get printed, so the O(m*n) traceback matrices exist for <= k
small problems and the device hot path is untouched.

The DP is the exact affine-gap Gotoh recurrence the kernels implement
(kernels/csrc/sw_cell.cuh), row-swept and numpy-vectorised along the
subject: the horizontal-gap state E is serial along a row, but with
open+extend >= extend it collapses to the identity

    E[i][j] = max(E[i][j-1] - ge, cur'[i][j-1] - oeg),
    cur'    = max(0, diag + s, F)        (the E-independent cell part)

which is a 1-D max-plus prefix scan: E[i][j] = max_k (cur'[i][k] + k*ge)
- (j-1)*ge, computed with one np.maximum.accumulate per row.
Traceback sources are packed into one uint8[(m+1), (n+1)] flag matrix.
Everything here is numpy on the host: it is safe to call from any thread.
"""

import dataclasses

import numpy as np

from oswald_tpu_torch.alphabet import decode

# flag layout: bits 0-1 = H source (0 stop, 1 diag, 2 E/horizontal,
# 3 F/vertical); bit 2 = E extends (else opens); bit 3 = F extends
_H_STOP, _H_DIAG, _H_E, _H_F = 0, 1, 2, 3
_E_EXT, _F_EXT = 4, 8

_NEG = np.int64(-(1 << 40))


@dataclasses.dataclass
class Alignment:
    """One gapped local alignment, BLAST-style 1-based inclusive coords."""
    score: int
    q_start: int
    q_end: int
    s_start: int
    s_end: int
    q_aln: str          # query row with '-' gaps
    s_aln: str          # subject row with '-' gaps
    midline: str        # '|' identity, '+' positive score, ' ' otherwise
    identities: int
    positives: int
    gaps: int

    @property
    def length(self) -> int:
        return len(self.q_aln)


def sw_align(query, subject, submat, open_gap: int, extend_gap: int,
             max_cells: int = 1 << 30) -> Alignment:
    """Exact affine-gap Smith-Waterman with traceback (score-parity with
    the device kernels and sw_lanes_ref).

    query, subject: int8 encoded residues (alphabet.encode)
    submat:         int[24, 24] substitution matrix
    max_cells:      size bound for the quadratic-memory flag matrix — a
                    (query x subject) problem bigger than this is routed
                    to the O(m+n)-memory divide-and-conquer path
                    (sw_align_linear) instead of allocating (m+1)(n+1)
                    traceback bytes
    """
    a = np.asarray(query, np.int64)
    b = np.asarray(subject, np.int64)
    m, n = len(a), len(b)
    if (m + 1) * (n + 1) > max_cells:
        return sw_align_linear(query, subject, submat, open_gap, extend_gap)
    if m == 0 or n == 0:
        return Alignment(0, 0, -1, 0, -1, "", "", "", 0, 0, 0)
    sub = np.asarray(submat, np.int64)
    ge = np.int64(extend_gap)
    oeg = np.int64(open_gap + extend_gap)

    flags = np.zeros((m + 1, n + 1), np.uint8)
    h_prev = np.zeros(n + 1, np.int64)          # H[i-1, :]
    f_prev = np.full(n + 1, _NEG, np.int64)     # F[i-1, :]
    jdx = np.arange(1, n + 1, dtype=np.int64)
    best, bi, bj = np.int64(0), 0, 0

    for i in range(1, m + 1):
        srow = sub[a[i - 1], b]                 # s(a_i, b_j), j = 1..n
        f = np.maximum(f_prev[1:] - ge, h_prev[1:] - oeg)       # F[i, 1..n]
        diag = h_prev[:-1] + srow
        curp = np.maximum(np.maximum(diag, 0), f)               # E-free part
        # E[i, j] = max_{k<j} (curp[k] - oeg + (j-1-k)*(-ge)) via prefix max
        # A[k] = cur'[i][k] - oeg + k*ge (k = 1..n); E[i][j] =
        # max(A[1..j-1]) - (j-1)*ge = acc[j-2] - (j-1)*ge for j >= 2
        acc = np.maximum.accumulate(curp - oeg + jdx * ge)
        e = np.empty(n + 1, np.int64)
        e[0] = e[1] = _NEG
        e[2:] = acc[:-1] - jdx[:-1] * ge
        h = np.maximum(curp, e[1:])                             # H[i, 1..n]

        frow = np.zeros(n + 1, np.uint8)
        # H source priority: diag > E > F (any max-achieving source is a
        # valid optimal traceback; the order is just a deterministic choice)
        src = np.where(h <= 0, _H_STOP,
                       np.where(h == diag, _H_DIAG,
                                np.where(h == e[1:], _H_E, _H_F)))
        frow[1:] = src.astype(np.uint8)
        frow[1:] |= np.where(e[1:] == e[:-1] - ge, _E_EXT, 0).astype(np.uint8)
        frow[1:] |= np.where(f == f_prev[1:] - ge, _F_EXT, 0).astype(np.uint8)
        flags[i] = frow

        h_full = np.concatenate([[0], h])
        rb = int(np.argmax(h))
        if h[rb] > best:
            best, bi, bj = h[rb], i, rb + 1
        h_prev, f_prev = h_full, np.concatenate([[_NEG], f])

    if best <= 0:
        return Alignment(0, 0, -1, 0, -1, "", "", "", 0, 0, 0)

    # walk back from the best cell
    qa, sa = [], []
    i, j, state = bi, bj, "H"
    while i > 0 and j > 0:
        fl = flags[i, j]
        if state == "H":
            src = fl & 3
            if src == _H_STOP:
                break
            if src == _H_DIAG:
                qa.append(int(a[i - 1]))
                sa.append(int(b[j - 1]))
                i -= 1
                j -= 1
            elif src == _H_E:
                state = "E"
            else:
                state = "F"
        elif state == "E":                       # gap in query, consumes b_j
            qa.append(-1)
            sa.append(int(b[j - 1]))
            state = "E" if fl & _E_EXT else "H"
            j -= 1
        else:                                    # gap in subject, consumes a_i
            qa.append(int(a[i - 1]))
            sa.append(-1)
            state = "F" if fl & _F_EXT else "H"
            i -= 1
    qa.reverse()
    sa.reverse()
    return _build_alignment(qa, sa, sub, best, i + 1, bi, j + 1, bj)


def _build_alignment(qa, sa, sub, best, q_start, q_end, s_start, s_end):
    """Assemble an Alignment from gapped code lists (-1 = gap)."""
    ident = pos = gaps = 0
    mid = []
    for qc, sc in zip(qa, sa):
        if qc < 0 or sc < 0:
            gaps += 1
            mid.append(" ")
        elif qc == sc:
            ident += 1
            pos += 1
            mid.append("|")
        elif sub[qc, sc] > 0:
            pos += 1
            mid.append("+")
        else:
            mid.append(" ")
    q_aln = "".join("-" if c < 0 else decode([c]) for c in qa)
    s_aln = "".join("-" if c < 0 else decode([c]) for c in sa)
    return Alignment(score=int(best),
                     q_start=q_start, q_end=q_end,
                     s_start=s_start, s_end=s_end,
                     q_aln=q_aln, s_aln=s_aln, midline="".join(mid),
                     identities=ident, positives=pos, gaps=gaps)


def _local_best_end(a, b, sub, ge, oeg):
    """Score-only local sweep: (best, bi, bj) with the END cell of an
    optimal local alignment, 1-based, earliest row then earliest column —
    the same tie-break sw_align's flagged sweep uses."""
    m, n = len(a), len(b)
    h_prev = np.zeros(n + 1, np.int64)
    f_prev = np.full(n + 1, _NEG, np.int64)
    jdx = np.arange(1, n + 1, dtype=np.int64)
    e = np.empty(n + 1, np.int64)
    e[0] = e[1] = _NEG
    best, bi, bj = np.int64(0), 0, 0
    for i in range(1, m + 1):
        srow = sub[a[i - 1], b]
        f = np.maximum(f_prev[1:] - ge, h_prev[1:] - oeg)
        diag = h_prev[:-1] + srow
        curp = np.maximum(np.maximum(diag, 0), f)
        acc = np.maximum.accumulate(curp - oeg + jdx * ge)
        e[2:] = acc[:-1] - jdx[:-1] * ge
        h = np.maximum(curp, e[1:])
        rb = int(np.argmax(h))
        if h[rb] > best:
            best, bi, bj = h[rb], i, rb + 1
        h_prev = np.concatenate([[0], h])
        f_prev = np.concatenate([[_NEG], f])
    return int(best), bi, bj


def _global_sweep(a, b, sub, ge, oeg, og, tb, track_best=False):
    """Global affine-gap (Gotoh) sweep in O(n) memory.

    Computes, for the full matrix of a vs b, the last row of
      CC[j] = best global score of a[1..m] vs b[1..j]   (any end state)
      DD[j] = best score whose last step deletes a_m    (F state)
    `tb` is the gap-OPEN cost charged to a deletion run that begins at the
    TOP boundary (Myers-Miller: 0 when the parent problem's gap continues
    across the split, og otherwise).  E-gaps (insertions) never cross a
    row split, so they always pay og.

    track_best additionally returns the maximum CC cell over ALL rows
    (earliest row, then earliest column) — used by sw_align_linear's
    anchored reverse pass to locate the local alignment's start.
    """
    m, n = len(a), len(b)
    jdx = np.arange(1, n + 1, dtype=np.int64)
    cc = np.empty(n + 1, np.int64)
    cc[0] = 0
    cc[1:] = -(og + jdx * ge)
    dd = cc - tb          # pending F candidates: F[1][j] >= CC0[j]-tb-ge
    kdx = np.arange(n, dtype=np.int64)
    x = np.empty(n, np.int64)
    best, bi, bj = _NEG, 0, 0
    for i in range(1, m + 1):
        srow = sub[a[i - 1], b]
        dd = np.maximum(dd - ge, cc - oeg)          # F[i][0..n]
        diag = cc[:-1] + srow
        curp = np.maximum(diag, dd[1:])             # E-free part, j=1..n
        # E[i][j] = max over k<j of (X[k] - oeg - (j-1-k)*ge), where X[0]
        # is column 0's H (= F[i][0]) and X[k>=1] = curp[k] — the same
        # prefix-max decomposition sw_align uses (valid because og >= 0
        # makes opening-from-E dominated by extending)
        x[0] = dd[0]
        x[1:] = curp[:-1]
        acc = np.maximum.accumulate(x - oeg + kdx * ge)
        enew = acc - (jdx - 1) * ge
        hrow = np.maximum(curp, enew)
        cc[0] = dd[0]
        cc[1:] = hrow
        if track_best:
            rb = int(np.argmax(hrow))
            if hrow[rb] > best:
                best, bi, bj = hrow[rb], i, rb + 1
    return cc, dd, int(best), bi, bj


def _mm_rec(a, b, sub, ge, oeg, og, tb, te, ops):
    """Myers-Miller divide-and-conquer global alignment (CABIOS 1988),
    score-maximising form.  Appends ("M",1)/("I",len)/("D",len) ops —
    I consumes subject (gap in query), D consumes query (gap in subject).
    tb/te: gap-open cost for deletion runs touching the top/bottom
    boundary (0 = the parent's gap continues across it)."""
    m, n = len(a), len(b)
    if m == 0:
        if n:
            ops.append(("I", n))
        return
    if n == 0:
        ops.append(("D", m))
        return
    if m == 1:
        # delete a_0 entirely (one D run + one I run) ...
        best_del = -(min(tb, te) + ge) - (og + n * ge)
        # ... or match a_0 to some b_j with insert runs either side
        j0 = np.arange(n, dtype=np.int64)
        left = np.where(j0 > 0, -(og + j0 * ge), 0)
        right = np.where(j0 < n - 1, -(og + (n - 1 - j0) * ge), 0)
        tot = left + sub[a[0], b] + right
        jb = int(np.argmax(tot))
        if int(tot[jb]) >= best_del:
            if jb:
                ops.append(("I", jb))
            ops.append(("M", 1))
            if n - 1 - jb:
                ops.append(("I", n - 1 - jb))
        else:
            ops.append(("D", 1))
            ops.append(("I", n))
        return
    mid = m // 2
    ccf, ddf, *_ = _global_sweep(a[:mid], b, sub, ge, oeg, og, tb)
    ccr, ddr, *_ = _global_sweep(a[mid:][::-1], b[::-1], sub, ge, oeg,
                                 og, te)
    t1 = ccf + ccr[::-1]
    # a deletion run spanning the split pays open twice (once in ddf,
    # once in ddr); one open is refunded so the joined run pays it once
    t2 = ddf + ddr[::-1] + og
    j1 = int(np.argmax(t1))
    j2 = int(np.argmax(t2))
    if int(t1[j1]) >= int(t2[j2]):
        _mm_rec(a[:mid], b[:j1], sub, ge, oeg, og, tb, og, ops)
        _mm_rec(a[mid:], b[j1:], sub, ge, oeg, og, og, te, ops)
    else:
        # the split cell is inside a deletion run: a_mid and a_{mid+1}
        # are both deleted; the run continues across both sub-boundaries
        _mm_rec(a[:mid - 1], b[:j2], sub, ge, oeg, og, tb, 0, ops)
        ops.append(("D", 2))
        _mm_rec(a[mid + 1:], b[j2:], sub, ge, oeg, og, 0, te, ops)


def _ops_to_codes(ops, a, b):
    """Expand ("M"/"I"/"D", len) ops into gapped code lists (-1 = gap)."""
    qa, sa = [], []
    i = j = 0
    for op, L in ops:
        if op == "M":
            for _ in range(L):
                qa.append(int(a[i]))
                sa.append(int(b[j]))
                i += 1
                j += 1
        elif op == "I":
            qa.extend([-1] * L)
            sa.extend(int(c) for c in b[j:j + L])
            j += L
        else:
            qa.extend(int(c) for c in a[i:i + L])
            sa.extend([-1] * L)
            i += L
    return qa, sa


def sw_align_linear(query, subject, submat, open_gap: int,
                    extend_gap: int) -> Alignment:
    """Exact local alignment in O(m+n) MEMORY (Hirschberg / Myers-Miller).

    Same result contract as sw_align (score parity with the device
    kernel) without the quadratic traceback matrix, so arbitrarily large
    (query x subject) problems align in bounded memory at ~4x the
    sweep time.  Three phases:
      1. score-only local sweep      -> best score + END cell (bi, bj)
      2. global-prefix sweep over the REVERSED prefixes a[:bi], b[:bj],
         maximised over all cells    -> START cell (anchored: a global
         alignment of reversed prefixes ending at its best cell begins
         with the pair (bi, bj), since boundary gaps only lose score)
      3. Myers-Miller divide-and-conquer global alignment of the
         [start..end] window, O(n) rows kept at a time
    This extends the traceback to unbounded problem sizes.
    """
    a = np.asarray(query, np.int64)
    b = np.asarray(subject, np.int64)
    if len(a) == 0 or len(b) == 0:
        return Alignment(0, 0, -1, 0, -1, "", "", "", 0, 0, 0)
    sub = np.asarray(submat, np.int64)
    ge = np.int64(extend_gap)
    og = np.int64(open_gap)
    oeg = og + ge
    best, bi, bj = _local_best_end(a, b, sub, ge, oeg)
    if best <= 0:
        return Alignment(0, 0, -1, 0, -1, "", "", "", 0, 0, 0)
    _, _, rbest, ri, rj = _global_sweep(
        a[:bi][::-1], b[:bj][::-1], sub, ge, oeg, og, og, track_best=True)
    if rbest != best:       # impossible unless the sweeps disagree
        raise RuntimeError(
            f"linear-space start search scored {rbest}, forward {best}")
    i0, j0 = bi - ri + 1, bj - rj + 1
    ops = []
    _mm_rec(a[i0 - 1:bi], b[j0 - 1:bj], sub, ge, oeg, og, og, og, ops)
    qa, sa = _ops_to_codes(ops, a[i0 - 1:bi], b[j0 - 1:bj])
    # defensive end-to-end check: rescore the emitted alignment
    sc, in_gap = 0, False
    for qc, sc_ in zip(qa, sa):
        if qc < 0 or sc_ < 0:
            sc -= int(ge + (0 if in_gap else og))
            in_gap = True
        else:
            sc += int(sub[qc, sc_])
            in_gap = False
    if sc != best:
        raise RuntimeError(
            f"linear-space traceback scored {sc}, expected {best}")
    return _build_alignment(qa, sa, sub, best, i0, bi, j0, bj)


def align_hits(db, query, result, submat, open_gap: int, extend_gap: int):
    """Traceback for every hit in a SearchResult: returns [Alignment].

    db: the PackedDB searched (sequences recovered via db.sequence_of);
    result: engine SearchResult (seq_ids are sorted-order ids).
    Each alignment's score must equal the device score — callers may
    assert this (tests do); a mismatch means packing/scoring corruption.
    """
    out = []
    for sid in np.asarray(result.seq_ids):
        subj = db.sequence_of(int(sid))
        out.append(sw_align(query, subj, submat, open_gap, extend_gap))
    return out


def gap_opens(aln: Alignment) -> int:
    """Number of gap RUNS in the alignment (BLAST outfmt-6 'gapopen')."""
    runs = 0
    prev = False
    for qc, sc in zip(aln.q_aln, aln.s_aln):
        g = qc == "-" or sc == "-"
        if g and not prev:
            runs += 1
        prev = g
    return runs


def format_tabular(query_title: str, subject_title: str, aln: Alignment,
                   evalue: float | None, bits: float | None) -> str:
    """One BLAST outfmt-6 line: qseqid sseqid pident length mismatch
    gapopen qstart qend sstart send evalue bitscore (tab-separated;
    subject id = first whitespace token of the title, like BLAST)."""
    L = max(aln.length, 1)
    mism = L - aln.identities - aln.gaps if aln.length else 0
    pid = 100.0 * aln.identities / L
    ev = f"{evalue:.2g}" if evalue is not None else "n/a"
    bs = f"{bits:.1f}" if bits is not None else "n/a"
    return "\t".join([
        query_title.split()[0] if query_title else "query",
        subject_title.split()[0] if subject_title else "subject",
        f"{pid:.3f}", str(aln.length), str(mism), str(gap_opens(aln)),
        str(aln.q_start), str(aln.q_end), str(aln.s_start),
        str(aln.s_end), ev, bs])


def format_alignment(aln: Alignment, width: int = 60) -> str:
    """BLAST-style block rendering of one alignment."""
    if aln.length == 0:
        return " (no alignment: score 0)\n"
    lines = []
    L = aln.length
    pct = 100.0 * aln.identities / L
    ppos = 100.0 * aln.positives / L
    lines.append(f" Identities: {aln.identities}/{L} ({pct:.0f}%), "
                 f"Positives: {aln.positives}/{L} ({ppos:.0f}%), "
                 f"Gaps: {aln.gaps}/{L}")
    qp, sp = aln.q_start, aln.s_start
    for o in range(0, L, width):
        qs = aln.q_aln[o:o + width]
        ms = aln.midline[o:o + width]
        ss = aln.s_aln[o:o + width]
        qn = sum(1 for c in qs if c != "-")
        sn = sum(1 for c in ss if c != "-")
        # an all-gap row consumes nothing: label both ends with the last
        # consumed coordinate instead of an inverted start > end range
        q0, q1 = (qp, qp + qn - 1) if qn else (qp - 1, qp - 1)
        s0, s1 = (sp, sp + sn - 1) if sn else (sp - 1, sp - 1)
        lines.append(f" Query {q0:>5} {qs} {q1}")
        lines.append(f"       {'':>5} {ms}")
        lines.append(f" Sbjct {s0:>5} {ss} {s1}")
        qp += qn
        sp += sn
    return "\n".join(lines) + "\n"
