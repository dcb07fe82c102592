"""The judge of alignments (`perfkit/alignment.py`) alone: it takes any
optimal alignment, the port's own among them, and refuses one a point
short of its score, a shifted coordinate, a wrong residue and a count off
by one."""

import os

import numpy as np
import pytest

from conftest import BENCH
from perfkit import alignment, reference, synth
from perfkit.compare import Answer

OPEN, EXTEND = 11, 1


def _matrix():
    return reference.load_matrix(os.path.join(BENCH, "matrices", "BLOSUM62"))


def _aln(q_aln, s_aln, q_start=1, s_start=1):
    """The ten fields of an alignment, its midline and counts worked out
    here by the rules the judge states."""
    m = _matrix()
    code = {c: i for i, c in enumerate(synth.ALPHABET)}
    mid = "".join(" " if "-" in (a, b) else "|" if a == b else
                  "+" if m[code[a], code[b]] > 0 else " "
                  for a, b in zip(q_aln, s_aln))
    nq = len(q_aln.replace("-", ""))
    ns = len(s_aln.replace("-", ""))
    return {"q_start": q_start, "q_end": q_start + nq - 1,
            "s_start": s_start, "s_end": s_start + ns - 1,
            "q_aln": q_aln, "s_aln": s_aln, "midline": mid,
            "identities": mid.count("|"),
            "positives": mid.count("|") + mid.count("+"),
            "gaps": sum("-" in (a, b) for a, b in zip(q_aln, s_aln))}


# three A in the query against two in the subject: the gap may stand at
# any of three places, at one score (10 W-W pairs 110, two A-A 8, one gap
# of one -12)
QUERY = "WWWWWAAAWWWWW"
SUBJECT = "WWWWWAAWWWWW"
TIES = ["WWWWW-AAWWWWW", "WWWWWA-AWWWWW", "WWWWWAA-WWWWW"]
SCORE = 106


def _judge(subject=SUBJECT):
    return alignment.Judge(_matrix(), OPEN, EXTEND,
                           lambda i: subject if i == 0 else None)


@pytest.mark.parametrize("s_aln", TIES)
def test_every_optimal_alignment_holds(s_aln):
    assert _judge().holds(_aln(QUERY, s_aln), QUERY, SUBJECT, SCORE)


def test_one_point_short_fails():
    a = _aln(QUERY, TIES[0])
    assert not _judge().holds(a, QUERY, SUBJECT, SCORE + 1)
    assert not _judge().holds(a, QUERY, SUBJECT, SCORE - 1)


def test_gap_runs_cost_open_once_a_run():
    # two gaps of one: -24 against one of two: -13
    q, s = "WWWWWAAAAWWWWW", "WWWWWAAWWWWW"
    j = _judge(s)
    assert j.holds(_aln(q, "WWWWW--AAWWWWW"), q, s, 110 + 8 - 13)
    assert j.holds(_aln(q, "WWWWWA-A-WWWWW"), q, s, 110 + 8 - 24)
    assert not j.holds(_aln(q, "WWWWWA-A-WWWWW"), q, s, 110 + 8 - 13)


@pytest.mark.parametrize("edit", [
    dict(s_start=2), dict(q_start=2), dict(q_end=12), dict(s_end=11),
    dict(identities=11), dict(positives=13), dict(gaps=0),
    dict(midline="|" * 13), dict(s_aln="WWWWW-AAWWWWC"),
    dict(s_aln="WWWWW-AAWWWW"), dict(q_aln="WWWWWAAA-WWWW"),
    dict(q_aln="WWWWWAAAWWWW?"), dict(identities="x"),
])
def test_a_wrong_field_fails(edit):
    a = dict(_aln(QUERY, TIES[0]), **edit)
    assert not _judge().holds(a, QUERY, SUBJECT, SCORE)


def test_gap_in_both_rows_fails():
    a = _aln(QUERY[:5] + "-" + QUERY[5:], SUBJECT[:5] + "--" + SUBJECT[5:])
    assert not _judge().holds(a, QUERY, SUBJECT, SCORE)


def test_score_zero_is_the_empty_alignment():
    empty = {"q_start": 0, "q_end": -1, "s_start": 0, "s_end": -1,
             "q_aln": "", "s_aln": "", "midline": "", "identities": 0,
             "positives": 0, "gaps": 0}
    assert _judge().holds(empty, "CC", "WW", 0)
    assert not _judge().holds(empty, QUERY, SUBJECT, SCORE)
    assert not _judge().holds(_aln(QUERY, TIES[0]), QUERY, SUBJECT, 0)


def _answer(q, ids, scores, alns):
    return Answer(synth.encode(q), "t", answered=True, ids=np.asarray(ids),
                  scores=np.asarray(scores), alignments=alns)


def test_mismatches_counts_missing_and_foreign_hits():
    j = _judge()
    good = _aln(QUERY, TIES[1])
    assert j.mismatches([_answer(QUERY, [0], [SCORE], [good])]) == 0
    assert j.mismatches([_answer(QUERY, [0, 0], [SCORE, SCORE],
                                 [good])]) == 1             # one left out
    assert j.mismatches([_answer(QUERY, [0], [SCORE], None)]) == 1
    assert j.mismatches([_answer(QUERY, [5], [SCORE], [good])]) == 1
    unanswered = Answer(synth.encode(QUERY), "t")
    assert j.mismatches([unanswered]) == 0


def test_corpus_subjects_by_length_sorted_id():
    """The ids the reference's order gives: the stable ascending sort by
    length."""
    import torch
    lengths = np.asarray([3, 1, 2, 1])
    flat = synth.encode("ACDEFGH")
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    ref = reference.Reference(lengths, torch.as_tensor(flat),
                              ["a", "b", "c", "d"], _matrix(), OPEN, EXTEND,
                              2)
    subject = alignment.corpus_subjects(ref.order, flat, offsets)
    assert [subject(i) for i in range(4)] == ["E", "H", "FG", "ACD"]
    assert subject(4) is None and subject(-1) is None


def test_the_ports_alignments_hold_and_their_faults_fail():
    """The port's host traceback on random pairs, some of them homologs:
    every alignment holds; each planted fault fails."""
    from oswald_tpu_torch.engine.align import sw_align
    rng = np.random.default_rng(3)
    m = _matrix()[:24, :24]
    held = 0
    for n in range(40):
        q = synth.realistic_residues(rng, int(rng.integers(5, 80)))
        s = synth.mutate(q, rng, 0.7, 0.05) if n % 2 else \
            synth.realistic_residues(rng, int(rng.integers(5, 120)))
        a = sw_align(q, s, m, OPEN, EXTEND)
        qs, ss = synth.decode(q), synth.decode(s)
        j = _judge(ss)
        aln = {f: getattr(a, f) for f in alignment.FIELDS}
        assert j.holds(aln, qs, ss, a.score)
        if not a.length:
            continue
        held += 1
        c = "W" if a.s_aln[0] != "W" else "C"
        for bad in (dict(s_aln=c + a.s_aln[1:]), dict(s_start=a.s_start + 1),
                    dict(identities=a.identities + 1),
                    dict(q_end=a.q_end + 1)):
            assert not j.holds(dict(aln, **bad), qs, ss, a.score)
        assert not j.holds(aln, qs, ss, a.score + 1)
        assert not j.holds(None, qs, ss, a.score)
    assert held >= 30
