"""The plain reference against a scalar Smith-Waterman loop written here,
its layout across rows, its top-k order, and its control."""

import numpy as np
import pytest
import torch

from conftest import ROOT
from perfkit import compare, reference, synth


def sw_scalar(a, b, m, open_gap, extend):
    """Gotoh's local alignment, one cell at a time."""
    oe = open_gap + extend
    n = len(b)
    H = [0] * (n + 1)
    F = [0] * (n + 1)
    best = 0
    for i in range(len(a)):
        diag = h_left = e = 0
        for j in range(n):
            e = max(h_left - oe, e - extend)
            F[j] = max(H[j] - oe, F[j] - extend)
            h = max(0, diag + int(m[a[i], b[j]]), e, F[j])
            best = max(best, h)
            diag, H[j], h_left = H[j], h, h
    return best


def _db(rng, n, lo=1, hi=70):
    lengths = rng.integers(lo, hi, size=n)
    flat = synth.realistic_residues(rng, int(lengths.sum()))
    return lengths, flat, np.concatenate([[0], np.cumsum(lengths)])


@pytest.mark.parametrize("name, og, eg", [("BLOSUM62", 10, 2),
                                          ("PAM30", 9, 1), ("BLOSUM62", 0, 0)])
@pytest.mark.parametrize("width", [8192, 128])
def test_scores_equal_the_scalar_loop(monkeypatch, name, og, eg, width):
    # width 128 spreads the subjects over many rows of the layout
    monkeypatch.setattr(reference, "WIDTH", width)
    rng = np.random.default_rng(11)
    m = reference.load_matrix(reference.matrix_path(ROOT, name))
    lengths, flat, offs = _db(rng, 60)
    # one subject longer than the narrow width: its row widens to hold it
    lengths[9] = 150
    flat = synth.realistic_residues(rng, int(lengths.sum()))
    offs = np.concatenate([[0], np.cumsum(lengths)])
    ref = reference.Reference(lengths, torch.as_tensor(flat),
                              [f"t{i}" for i in range(60)], m, og, eg, 10)
    assert ref.layout.rows > (1 if width == 128 else 0)
    assert ref.layout.width == max(width, 151)
    for qlen in (1, 17, 64):
        q = synth.realistic_residues(rng, qlen)
        got = ref.scores(q).numpy()
        want = [sw_scalar(q, flat[offs[o]:offs[o + 1]], m, og, eg)
                for o in ref.order]
        assert got.tolist() == want
    qs = [synth.realistic_residues(rng, int(x)) for x in (5, 40, 23)]
    ids = [7, 0, 59]
    want = [sw_scalar(q, flat[offs[ref.order[i]]:offs[ref.order[i] + 1]],
                      m, og, eg) for q, i in zip(qs, ids)]
    assert ref.pair_scores(qs, ids).tolist() == want


def test_sorted_ids_titles_and_tie_order():
    rng = np.random.default_rng(3)
    lengths = np.asarray([30, 10, 30, 10, 20])
    flat = synth.realistic_residues(rng, int(lengths.sum()))
    m = reference.load_matrix(reference.matrix_path(ROOT, "BLOSUM62"))
    ref = reference.Reference(lengths, torch.as_tensor(flat),
                              ["a", "b", "c", "d", "e"], m, 10, 2, 3)
    # stable, ascending by length
    assert ref.order.tolist() == [1, 3, 4, 0, 2]
    assert ref.titles == ["b", "d", "e", "a", "c"]
    s, i = ref.topk(torch.tensor([5, 9, 9, 1, 9], dtype=torch.int32))
    assert s.tolist() == [9, 9, 9] and i.tolist() == [1, 2, 4]


def test_control_reads_far_from_the_reference():
    """The control (16-bit saturating scores, moments to bfloat16) moves
    the E-values of a database big enough for the tail fit."""
    rng = np.random.default_rng(5)
    lengths, flat, offs = _db(rng, 2600, 20, 120)
    m = reference.load_matrix(reference.matrix_path(ROOT, "BLOSUM62"))
    ref = reference.Reference(lengths, torch.as_tensor(flat),
                              [str(i) for i in range(2600)], m, 10, 2, 10)
    qs = [synth.realistic_residues(rng, 40) for _ in range(2)]
    r = ref.search(qs[0])
    assert r.evalues is not None
    answers = compare.control_answers(ref, qs)
    checks = compare.check(ref, answers, range(len(qs)),
                           {"evalue_log_gap": 0.01})
    assert checks["evalue_log_gap"][0] > 0.05
    assert compare.passed(checks) is False


def test_thresholds_near_a_whole_number_admit_both_roundings(monkeypatch):
    rng = np.random.default_rng(8)
    lengths, flat, _ = _db(rng, 300, 20, 120)
    m = reference.load_matrix(reference.matrix_path(ROOT, "BLOSUM62"))
    ref = reference.Reference(lengths, torch.as_tensor(flat),
                              [str(i) for i in range(300)], m, 10, 2, 10)
    q = synth.realistic_residues(rng, 30)
    s = ref.scores(q)
    top, _ = ref.topk(s)
    assert len(ref.moments(s, top)) == 1
    monkeypatch.setattr(reference, "THRESHOLD_TOL", 0.6)
    moms = ref.moments(s, top)
    assert len(moms) == 4
    assert len({(m[3], m[6]) for m in moms}) == 4
    # an answer is judged against the nearest admissible vector
    a, b = np.asarray([1.0, 2.0]), np.asarray([1.5, 2.0])
    assert compare.evalue_gap(a, [b, a]) == 0.0
    assert compare.evalue_gap(a, [b]) == pytest.approx(np.log(1.5))
    assert compare.evalue_gap(None, [None]) == 0.0
    assert compare.evalue_gap(a, [None]) == float("inf")
