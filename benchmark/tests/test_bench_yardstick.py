"""The frozen parts of the yardstick, pinned to golden values (not to the
port's live modules): the SwissProt-shaped generator, gcups, the bound's
constants, the matrices; and the generator's determinism by seed."""

import json
import os

import numpy as np
import pytest

from conftest import BENCH, ROOT
from perfkit import accounting, bound, data, reference, synth


def test_lengths_residues_mutate_golden():
    rng = np.random.default_rng(42)
    lengths = synth.realistic_lengths(rng, 1000)
    assert lengths[:12].tolist() == [192, 482, 41, 248, 273, 971, 407, 167,
                                     163, 532, 231, 23]
    assert int(lengths.sum()) == 330359
    res = synth.realistic_residues(rng, 50)
    assert res[:20].tolist() == [6, 16, 10, 18, 13, 10, 15, 10, 18, 4, 21,
                                 16, 17, 10, 17, 6, 16, 3, 6, 9]
    mut = synth.mutate(res, rng)
    assert mut.tolist() == [
        6, 16, 10, 18, 13, 10, 4, 10, 18, 14, 5, 9, 17, 10, 17, 12, 8, 3,
        6, 7, 16, 8, 6, 12, 6, 0, 16, 4, 9, 15, 18, 16, 8, 10, 13, 6, 16, 7,
        2, 2, 0, 9, 17, 17, 18, 9, 6, 3, 10, 5]


def test_device_residues_golden_on_cpu():
    assert synth.device_residues(7, 20, "cpu").tolist() == [
        10, 4, 13, 13, 5, 9, 4, 13, 8, 17, 17, 11, 6, 4, 9, 8, 15, 0, 21, 3]
    many = synth.device_residues(7, 200_000, "cpu").numpy()
    codes, probs = synth.residue_distribution()
    freq = np.bincount(many, minlength=24)[codes] / many.size
    assert np.abs(freq - probs).max() < 0.003
    assert many.max() < synth.DUMMY


def test_encode_decode_round_trip():
    text = "MKTAYIAKQRQISFVKSHFSRQBZX"
    assert synth.decode(synth.encode(text)) == text


def test_gcups_and_bound_golden():
    assert accounting.gcups(512, 191_722_906, 0.04) == pytest.approx(
        2454.0531968)
    assert accounting.gcups(1, 1, 0.0) == float("inf")
    assert bound.INSTR_PER_CELL == 5.5
    assert bound.INSTR_PER_S == 33.5e12
    # the whole database at m = 512 over true residues
    assert bound.bound_seconds(512, 191_722_906) == pytest.approx(
        0.01611617, rel=1e-6)


def test_percentile_nearest_rank():
    v = list(range(1, 101))
    assert accounting.percentile(v, 95) == 95
    assert accounting.percentile(v, 50) == 50
    assert accounting.percentile([3.0, float("inf")], 95) == float("inf")


@pytest.mark.parametrize("name, golden", [
    ("BLOSUM62", {("W", "W"): 11, ("A", "A"): 4, ("C", "C"): 9,
                  ("W", "C"): -2, ("E", "Q"): 2, ("X", "X"): -1}),
    ("PAM30", {("W", "W"): 13, ("A", "A"): 6, ("C", "C"): 10,
               ("W", "C"): -15, ("E", "Q"): 1, ("X", "X"): -5}),
])
def test_matrices_golden(name, golden):
    m = reference.load_matrix(reference.matrix_path(ROOT, name))
    code = {c: i for i, c in enumerate(synth.ALPHABET)}
    for (a, b), v in golden.items():
        assert m[code[a], code[b]] == v == m[code[b], code[a]]
    assert (m[:, synth.DUMMY] == 0).all() and (m[synth.DUMMY, :24] == 0).all()
    assert (m[:, reference.SENT] == reference.NEG).all()
    assert (m[:24, :24] == m[:24, :24].T).all()


GOLDEN_RELEASE_HEAD = [195, 413, 152, 487, 114, 252, 730, 32]
GOLDEN_OVER_TITIN_QUERY = 590
CONFIG = {"n_seqs": 400, "residues": 80_000, "longest": 900,
          "length_seed": 5}


def test_release_lengths_hold_the_release_statistics():
    """The configurations' databases: the release's count, total residues
    and longest sequence exactly, the longest once, no pile-up below it;
    pinned to golden values."""
    for cfg in ("swissprot-blosum62", "swissprot-pam30-short"):
        c = json.load(open(os.path.join(BENCH, "configs", cfg + ".json")))
        lengths = data.release_lengths(c)
        assert lengths.size == c["n_seqs"] == 541_561
        assert int(lengths.sum()) == c["residues"] == 192_480_382
        assert int(lengths.max()) == c["longest"] == 35_213
        assert int(np.sum(lengths == 35_213)) == 1
        assert int(np.sum(lengths >= 35_000)) < 4
    assert lengths[:8].tolist() == GOLDEN_RELEASE_HEAD
    assert int(np.sum(lengths > 5478)) == GOLDEN_OVER_TITIN_QUERY
    small = data.release_lengths(CONFIG)
    assert small.size == 400 and int(small.sum()) == 80_000
    assert int(small.max()) == 900 and int(small.min()) >= 1


def test_corpus_is_determined_by_the_seed():
    a = data.make_corpus(CONFIG, 2**31 + 17, "cpu")
    b = data.make_corpus(CONFIG, 2**31 + 17, "cpu")
    c = data.make_corpus(CONFIG, 2**31 + 18, "cpu")
    assert np.array_equal(a.lengths, b.lengths)
    assert np.array_equal(a.flat, b.flat)
    assert a.titles == b.titles
    # another seed: the same length spectrum in another order, other
    # residues
    assert np.array_equal(np.sort(a.lengths), np.sort(c.lengths))
    assert not np.array_equal(a.lengths, c.lengths)
    assert not np.array_equal(a.flat[:1000], c.flat[:1000])


@pytest.mark.parametrize("spec", [
    {"mode": "batch", "batch": 4, "lengths": {"kind": "fixed",
                                               "values": [30, 10, 50, 70]},
     "residues": {"kind": "random", "homolog_share": 0.5},
     "warm_lengths": [5]},
    {"mode": "batch", "batch": 6, "base_seed": 3,
     "lengths": {"kind": "uniform", "lo": 10, "hi": 30},
     "residues": {"kind": "db_substring", "substitution_share": 0.5,
                  "max_substitutions": 2}, "warm_lengths": [5]},
])
def test_batch_traffic_is_determined_by_the_seed(spec):
    corpus = data.make_corpus(CONFIG, 9, "cpu")
    t1 = data.Traffic(spec, corpus, 123, 5)
    t2 = data.Traffic(spec, corpus, 123, 5)
    t3 = data.Traffic(spec, corpus, 124, 5)
    for b in range(3):
        q1, q2, q3 = t1.batch(b), t2.batch(b), t3.batch(b)
        assert all(np.array_equal(x, y) for x, y in zip(q1, q2))
        # every seed and batch: the same multiset of lengths
        assert sorted(x.size for x in q1) == sorted(x.size for x in q3)
    assert any(not np.array_equal(x, y)
               for x, y in zip(t1.batch(0), t3.batch(0)))


def test_serve_traffic_same_arrivals_and_sizes_for_every_seed():
    corpus = data.make_corpus(CONFIG, 9, "cpu")
    spec = {"mode": "serve", "rate": 40.0, "base_seed": 1,
            "lengths": {"kind": "swissprot", "cap": 900},
            "residues": {"kind": "random"}, "warm_lengths": [20, 30]}
    s1 = data.Traffic(spec, corpus, 7, 10).schedule()
    s2 = data.Traffic(spec, corpus, 7, 10).schedule()
    s3 = data.Traffic(spec, corpus, 8, 10).schedule()
    assert len(s1) > 300 and s1[-1][0] <= 10.0
    assert [t for t, _ in s1] == [t for t, _ in s2] == [t for t, _ in s3]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(s1, s2))
    assert [q.size for _, q in s1] == [q.size for _, q in s3]
    assert not all(np.array_equal(a, b) for (_, a), (_, b) in zip(s1, s3))
    gaps = np.diff([0.0] + [t for t, _ in s1])
    assert 1 / 40 * 0.8 < gaps.mean() < 1 / 40 * 1.2


def test_db_substring_peptides_come_from_the_database():
    corpus = data.make_corpus(CONFIG, 9, "cpu")
    spec = {"mode": "batch", "batch": 40, "base_seed": 3,
            "lengths": {"kind": "uniform", "lo": 10, "hi": 30},
            "residues": {"kind": "db_substring", "substitution_share": 0.0},
            "warm_lengths": [5]}
    text = synth.decode(corpus.flat)
    for q in data.Traffic(spec, corpus, 1, 5).batch(0):
        assert synth.decode(q) in text
