"""The check of the alignments that a deployment returns with its hits
(a configuration with `"align": true`): plain numpy, nothing of the port.

Each hit's alignment is the ten fields of the port's JSON form
(`FIELDS`: 1-based inclusive coordinates, the two gapped rows, the
midline and three counts).  It passes when

- `q_aln` and `s_aln` are of one length, over the alphabet and `-`, with
  no column that is a gap in both;
- `q_aln` without its gaps is the query's residues `q_start..q_end`, and
  `s_aln` without its gaps the subject's `s_start..s_end`, each range
  within its sequence;
- the score of the two rows is the hit's score: the matrix summed over
  the aligned columns, less open + k x extend for each maximal run of k
  gaps in either row (the recurrence the port states, in which a gap in
  the query and one in the subject are separate states);
- `identities` (columns of one letter), `positives` (those, and columns
  whose matrix entry is > 0), `gaps` (columns with `-`) and the midline
  (`|`, `+` and space for the three kinds) are what the rows give;
- a hit of score 0 has the empty alignment.

The hit's score is held to the reference's Smith-Waterman score by
`hit_score_mismatch`, so an alignment that passes here is optimal.  Any
optimal alignment passes: which of equally scoring paths is reported is
the implementation's choice, as in BLAST.
"""

import numpy as np

from perfkit.synth import ALPHABET, decode

FIELDS = ("q_start", "q_end", "s_start", "s_end", "q_aln", "s_aln",
          "midline", "identities", "positives", "gaps")

GAP = len(ALPHABET)                  # the code of '-' in a row
_BAD = 255
_LUT = np.full(256, _BAD, np.uint8)
_LUT[np.frombuffer(ALPHABET.encode(), np.uint8)] = np.arange(len(ALPHABET))
_LUT[ord("-")] = GAP
_MID = np.frombuffer(b" +|", np.uint8)


def _codes(row: str):
    """uint8 codes of a gapped row (GAP for '-'), or None for a letter
    outside the alphabet."""
    try:
        raw = np.frombuffer(row.encode("ascii"), np.uint8)
    except (AttributeError, UnicodeEncodeError):
        return None
    codes = _LUT[raw]
    return None if np.any(codes == _BAD) else codes


def _gap_cost(gap: np.ndarray, open_gap: int, extend: int) -> int:
    """open x (maximal runs of gaps) + extend x (gap columns) of one row."""
    starts = gap & ~np.concatenate([[False], gap[:-1]])
    return open_gap * int(starts.sum()) + extend * int(gap.sum())


class Judge:
    """Holds alignments to the query, the subject of the hit's id, the
    hit's score and the configuration's matrix and gaps."""

    def __init__(self, matrix, open_gap: int, extend: int, subject):
        """matrix: int[>= 23, >= 23] in the alphabet's code order;
        subject(id) -> the residue string of that (length-sorted) id, or
        None for an id outside the database."""
        n = len(ALPHABET)
        self.matrix = np.asarray(matrix, np.int64)[:n, :n]
        self.open_gap, self.extend = int(open_gap), int(extend)
        self.subject = subject

    def holds(self, aln, query: str, subject: str, score: int) -> bool:
        """Whether one hit's alignment passes every rule above."""
        if not isinstance(aln, dict) or any(f not in aln for f in FIELDS):
            return False
        try:
            q0, q1, s0, s1, ident, pos, gaps = (
                int(aln[f]) for f in ("q_start", "q_end", "s_start",
                                      "s_end", "identities", "positives",
                                      "gaps"))
        except (TypeError, ValueError):
            return False
        q, s, mid = _codes(aln["q_aln"]), _codes(aln["s_aln"]), \
            aln["midline"]
        if q is None or s is None or not isinstance(mid, str):
            return False
        if score == 0:
            return q.size == s.size == len(mid) == 0 and \
                ident == pos == gaps == 0 and q1 == q0 - 1 and s1 == s0 - 1
        if q.size == 0 or q.size != s.size or len(mid) != q.size:
            return False
        qg, sg = q == GAP, s == GAP
        if np.any(qg & sg):
            return False
        if not (1 <= q0 <= q1 <= len(query) and
                1 <= s0 <= s1 <= len(subject)):
            return False
        if aln["q_aln"].replace("-", "") != query[q0 - 1:q1] or \
                aln["s_aln"].replace("-", "") != subject[s0 - 1:s1]:
            return False
        pair = ~(qg | sg)
        sub = self.matrix[q[pair], s[pair]]
        got = int(sub.sum()) - _gap_cost(qg, self.open_gap, self.extend) - \
            _gap_cost(sg, self.open_gap, self.extend)
        if got != score:
            return False
        same = pair & (q == s)
        plus = pair.copy()
        plus[pair] = sub > 0
        plus |= same
        kind = same.astype(np.int64) + plus        # 0 ' ', 1 '+', 2 '|'
        return _MID[kind].tobytes().decode() == mid and \
            ident == int(same.sum()) and pos == int(plus.sum()) and \
            gaps == int((qg | sg).sum())

    def mismatches(self, answers) -> int:
        """The hits of every answered query whose alignment is missing or
        fails."""
        bad = 0
        subjects = {}
        for a in answers:
            if not a.answered:
                continue
            query = decode(a.query)
            alns = a.alignments or []
            for h, (sid, score) in enumerate(zip(a.ids, a.scores)):
                sid = int(sid)
                if sid not in subjects:
                    subjects[sid] = self.subject(sid)
                aln = alns[h] if h < len(alns) else None
                bad += subjects[sid] is None or \
                    not self.holds(aln, query, subjects[sid], int(score))
        return bad


def corpus_subjects(order, flat, offsets):
    """subject(id) -> the residue string of a corpus's sequence (record
    order: `flat`, `offsets`) by the id the port reports, whose record
    `order` gives (`reference.Reference.order`); None outside it."""
    def subject(i):
        if not 0 <= i < len(order):
            return None
        r = int(order[i])
        return decode(flat[offsets[r]:offsets[r + 1]])
    return subject
