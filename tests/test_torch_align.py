"""oswald_tpu_torch.engine.align against oswald_tpu.engine.align.

The port keeps its own copy of the traceback module (numpy only).  Every
function must give the reference's result on the same inputs, drawn from a
seed as tests/test_align.py draws them: equal Alignment objects (score,
coordinates, aligned rows, counts) and equal formatted text.
`SearchEngine.align` on the CPU must equal the JAX engine's on a shared
database carried across by `from_reference`, and every alignment, rescored
from its rows, must equal its hit's score.
"""

import dataclasses

import numpy as np
import pytest
import torch

from oswald_tpu.alphabet import encode, DUMMY
from oswald_tpu.engine import SearchConfig as JaxConfig
from oswald_tpu.engine import SearchEngine as JaxEngine
from oswald_tpu.engine import align as jax_align
from oswald_tpu.io import pack_sequences
from oswald_tpu.submat import get_submat
from oswald_tpu_torch.engine import SearchConfig, SearchEngine
from oswald_tpu_torch.engine import align
from oswald_tpu_torch.io import from_reference

from conftest import random_protein

CASES = [("blosum62", 10, 2), ("pam30", 9, 1), ("blosum50", 5, 5),
         ("blosum62", 0, 1)]


def _same(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def _rescore(aln, submat, og, eg):
    """The alignment's score recomputed from its aligned rows."""
    score, in_gap = 0, False
    qa = encode(aln.q_aln.replace("-", "*"))
    sa = encode(aln.s_aln.replace("-", "*"))
    for qc, sc, qg, sg in zip(qa, sa, aln.q_aln, aln.s_aln):
        if qg == "-" or sg == "-":
            score -= eg + (0 if in_gap else og)
            in_gap = True
        else:
            score += int(submat[qc, sc])
            in_gap = False
    return score


@pytest.mark.parametrize("matrix,og,eg", CASES)
def test_sw_align_equals_jax(rng, matrix, og, eg):
    sub = get_submat(matrix)
    for _ in range(20):
        a = random_protein(rng, int(rng.integers(1, 120)))
        b = random_protein(rng, int(rng.integers(1, 150)))
        got = align.sw_align(a, b, sub, og, eg)
        _same(got, jax_align.sw_align(a, b, sub, og, eg))
        if got.score > 0:
            assert _rescore(got, sub, og, eg) == got.score


@pytest.mark.parametrize("matrix,og,eg", CASES)
def test_sw_align_linear_equals_jax(rng, matrix, og, eg):
    sub = get_submat(matrix)
    for _ in range(15):
        a = random_protein(rng, int(rng.integers(1, 120)))
        b = random_protein(rng, int(rng.integers(1, 150)))
        _same(align.sw_align_linear(a, b, sub, og, eg),
              jax_align.sw_align_linear(a, b, sub, og, eg))
        # max_cells routes sw_align to the linear path on both sides
        _same(align.sw_align(a, b, sub, og, eg, max_cells=16),
              jax_align.sw_align(a, b, sub, og, eg, max_cells=16))


def test_edge_cases_equal_jax():
    sub = get_submat("blosum62")
    q = encode("MKVLATGHWCEDYFRNQPIS")
    s = np.concatenate([q[:8], q[12:]])          # a 4-residue deletion
    dummy = np.full(5, DUMMY, np.int8)
    empty = np.zeros(0, np.int8)
    for a, b in ((q, q), (q, s), (s, q), (dummy, q), (q, empty),
                 (empty, q)):
        for fn in ("sw_align", "sw_align_linear"):
            _same(getattr(align, fn)(a, b, sub, 10, 2),
                  getattr(jax_align, fn)(a, b, sub, 10, 2))
    gapped = align.sw_align(q, s, sub, 10, 2)
    assert "----" in gapped.s_aln and align.gap_opens(gapped) == 1


def test_formatting_equals_jax(rng):
    sub = get_submat("blosum62")
    alns = [align.sw_align(random_protein(rng, 150),
                           random_protein(rng, 200), sub, 5, 1)
            for _ in range(6)]
    q = encode("MKVLATGHWCEDYFRNQPIS")
    alns += [align.sw_align(q, np.concatenate([q[:8], q[12:]]), sub, 10, 2),
             align.sw_align(np.full(5, DUMMY, np.int8), q, sub, 10, 2)]
    for a in alns:
        ref = jax_align.Alignment(**dataclasses.asdict(a))
        assert align.gap_opens(a) == jax_align.gap_opens(ref)
        for width in (60, 17):
            assert align.format_alignment(a, width) == \
                jax_align.format_alignment(ref, width)
        for ev, bits in ((1.5e-7, 42.25), (None, None), (3.0, None)):
            assert align.format_tabular("q1 desc", "s9 other", a, ev, bits) \
                == jax_align.format_tabular("q1 desc", "s9 other", ref, ev,
                                            bits)
        assert align.format_tabular("", "", a, None, 1.0) == \
            jax_align.format_tabular("", "", ref, None, 1.0)


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(5)
    lengths = rng.integers(10, 200, size=400)
    seqs = [random_protein(rng, int(n)) for n in lengths]
    db = pack_sequences(np.concatenate(seqs), lengths,
                        [f"t{i}" for i in range(400)])
    cfg = dict(top=8, matrix="pam30", open_gap=9, extend_gap=1)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield (seqs, JaxEngine(db, JaxConfig(**cfg)),
           SearchEngine(from_reference(db), SearchConfig(**cfg),
                        device="cpu"))
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["precompute", "host_stream"])
def test_engine_align_equals_jax(engines, mode):
    """SearchEngine.align gives the JAX engine's alignments of the same
    hits, in every mode, and each rescores to its hit's score."""
    seqs, jax_eng, eng = engines
    if mode == "host_stream":
        eng = SearchEngine(eng.db, dataclasses.replace(
            eng.config, profile_mode="host_stream"), device="cpu")
    rng = np.random.default_rng(6)
    for q in (seqs[17][10:90], random_protein(rng, 64)):
        want_res, res = jax_eng.search(q), eng.search(q)
        np.testing.assert_array_equal(res.seq_ids, want_res.seq_ids)
        got, want = eng.align(q, res), jax_eng.align(q, want_res)
        assert len(got) == len(res.scores) == 8
        for a, b, score in zip(got, want, res.scores):
            _same(a, b)
            assert a.score == int(score)
            assert _rescore(a, eng.submat, 9, 1) == a.score
