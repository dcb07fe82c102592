"""oswald_tpu_torch's batched and streamed search against oswald_tpu's.

`mixed_pack_plan` is held to the JAX function value for value.
`search_many(batch=True)` runs packed batches (one padded length, mixed
lengths) and a batch with a query over the pack budget on one database,
packed once by the JAX package and carried across by `from_reference`; the
port runs on the CPU (plain PyTorch scorers), the reference with its Pallas
kernel in interpret mode.  Scores, ids and titles must be equal; the
tolerance on E-values and bit scores is stated at BATCH_RTOL below.
Unbatched lists and `search_stream` at several readback windows must give
the results of per-query `search`.
"""

import numpy as np
import pytest
import torch

from oswald_tpu.engine import SearchConfig as JaxConfig
from oswald_tpu.engine import SearchEngine as JaxEngine
from oswald_tpu.engine.search import mixed_pack_plan as jax_mixed_pack_plan
from oswald_tpu.io import pack_sequences
from oswald_tpu_torch.engine import SearchConfig, SearchEngine
from oswald_tpu_torch.engine.search import (MIXED_PACK_SEGS,
                                            mixed_pack_plan, plan_segments)
from oswald_tpu_torch.io import from_reference
from oswald_tpu_torch.kernels import sw_lanes

from conftest import random_protein

TOP = 12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain scorer's tensors are small: one thread is fastest, and the
    test workers do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_db(rng, n, lmax):
    lengths = rng.integers(1, lmax, size=n)
    seqs = [random_protein(rng, int(l)) for l in lengths]
    return pack_sequences(np.concatenate(seqs), lengths,
                          [f"seq{i}" for i in range(n)], bin_cost=1)


def _assert_same_hits(a, b):
    np.testing.assert_array_equal(a.scores, b.scores)
    np.testing.assert_array_equal(np.asarray(a.seq_ids),
                                  np.asarray(b.seq_ids))
    assert a.titles == b.titles
    assert a.query_length == b.query_length


def _assert_same_stats(a, b, rtol=1e-5):
    assert (a.evalues is None) == (b.evalues is None)
    if a.evalues is not None:
        np.testing.assert_allclose(b.evalues, a.evalues, rtol=rtol)
        np.testing.assert_allclose(b.bit_scores, a.bit_scores, rtol=rtol)


def _same_plan(ours, theirs):
    (bins, rest), (jbins, jrest) = ours, theirs
    assert rest == jrest and len(bins) == len(jbins)
    for (idxs, qp, sm, used), (jidxs, jqp, jsm, jused) in zip(bins, jbins):
        assert idxs == jidxs and used == jused
        assert qp.dtype == jqp.dtype and sm.dtype == jsm.dtype
        np.testing.assert_array_equal(qp, jqp)
        np.testing.assert_array_equal(sm, jsm)


@pytest.mark.parametrize("pack_rows,u_rows,max_segs", [
    (1024, 8, MIXED_PACK_SEGS), (1000, 8, MIXED_PACK_SEGS), (256, 16, 4),
    (0, 8, MIXED_PACK_SEGS), (8, 8, MIXED_PACK_SEGS)])
def test_mixed_pack_plan_equals_jax(rng, pack_rows, u_rows, max_segs):
    """The inputs of the JAX package's test_mixed_pack_plan_invariants: 50
    random lengths plus two queries over the pack budget."""
    qlens = list(rng.integers(1, 900, size=50)) + [3000, 1025, 0]
    queries = [rng.integers(0, 23, int(n)).astype(np.int32) for n in qlens]
    ours = mixed_pack_plan(pack_rows, u_rows, queries, max_segs)
    _same_plan(ours, jax_mixed_pack_plan(pack_rows, u_rows, queries,
                                         max_segs))
    bins, rest = ours
    if pack_rows >= 256:
        assert bins and rest
    else:
        assert not bins and rest == list(range(len(queries)))
    for idxs, qp, sm, used in bins:
        segs = plan_segments(idxs, sm, used, u_rows, queries)
        for (r0, n), i in zip(segs.tolist(), idxs):
            assert n == max(queries[i].size, 1) and r0 % u_rows == 0
            np.testing.assert_array_equal(qp[r0:r0 + queries[i].size],
                                          queries[i])
        assert (np.diff(segs[:, 0]) > 0).all()


def test_mixed_pack_plan_small_batches_and_bad_codes(rng):
    one = [rng.integers(0, 23, 40).astype(np.int32)]
    _same_plan(mixed_pack_plan(1024, 8, one),
               jax_mixed_pack_plan(1024, 8, one))
    assert mixed_pack_plan(1024, 8, one) == ([], [0])
    with pytest.raises(ValueError, match="encode"):
        mixed_pack_plan(1024, 8, [np.frombuffer(b"MKT", np.uint8), one[0]])


BATCH_N_SEQS = 1100
# Port against JAX on this database, whose subject lengths spread wider
# (two bins, 128 and 224) than that of tests/test_torch_engine.py: the
# E-values rest on float32 score moments, and the one float32
# ulp by which the two sides' sum(S * lnL) can differ moves an E-value by
# up to 4.1e-5 relative here (measured; single searches differ by the same
# amounts as batches, and inside either package batch and single agree
# exactly).  1e-4 is also what the JAX package's own tests allow between
# its batched paths (tests/test_batch.py).  Inside the port the module's
# 1e-5 of tests/test_torch_engine.py stays.
BATCH_RTOL = 1e-4


@pytest.fixture(scope="module")
def batch_db():
    db = _make_db(np.random.default_rng(31), n=BATCH_N_SEQS, lmax=200)
    assert len(db.bin_lengths) >= 2
    return db, from_reference(db)


def _query_set(name):
    rng = np.random.default_rng(len(name))
    if name == "short_uniform":      # one padded length, several packed bins
        return 256, [random_protein(rng, int(n))
                     for n in rng.integers(10, 64, size=10)]
    if name == "mixed_lengths":      # unequal segments, two bins of 1024
        return 1024, [random_protein(rng, n)
                      for n in (100, 173, 254, 399, 311, 47, 128, 222)]
    if name == "with_leftover":      # 300 rows are over the 256-row budget
        return 256, [random_protein(rng, n) for n in (30, 40, 300, 0)]
    raise KeyError(name)


@pytest.mark.parametrize("name", ["short_uniform", "mixed_lengths",
                                  "with_leftover"])
def test_search_many_batched_matches_jax(batch_db, name):
    """Packed batches against the JAX engine's: scores, ids and titles
    exact, statistics at BATCH_RTOL, one shared wall time."""
    jdb, tdb = batch_db
    pack_rows, queries = _query_set(name)
    titles = [f"{name}{i}" for i in range(len(queries))]
    ref = JaxEngine(jdb, JaxConfig(top=TOP,
                                   batch_query_pack_rows=pack_rows))
    eng = SearchEngine(tdb, SearchConfig(top=TOP,
                                         batch_query_pack_rows=pack_rows),
                       device="cpu")
    bins, rest = mixed_pack_plan(pack_rows, 8, queries)
    assert bins and bool(rest) == (name == "with_leftover")
    want = ref.search_many(queries, titles, batch=True)
    got = eng.search_many(queries, titles, batch=True)
    assert eng.metrics.count("search_batch") == 1
    assert eng.metrics.count("search") == 0
    for a, b in zip(want, got):
        _assert_same_hits(a, b)
        _assert_same_stats(a, b, BATCH_RTOL)
        assert b.query_title == a.query_title
        assert b.batch_n == a.batch_n == len(queries)
        assert b.elapsed == got[0].elapsed > 0
    # unbatched list and stream give the reference's hits too
    for run in (eng.search_many(queries, titles, batch=False),
                eng.search_stream(queries, titles)):
        for a, b in zip(want, run):
            _assert_same_hits(a, b)
            _assert_same_stats(a, b, BATCH_RTOL)
            assert b.batch_n == 1
    # without packing, every query runs unpacked: same results
    plain = SearchEngine(tdb, SearchConfig(top=TOP, batch_query_pack_rows=0),
                         device="cpu").search_many(queries, titles)
    singles = [eng.search(q, t) for q, t in zip(queries, titles)]
    for a, b, c in zip(got, plain, singles):
        _assert_same_hits(a, b)
        _assert_same_hits(a, c)
        _assert_same_stats(a, b)
        _assert_same_stats(a, c)


@pytest.mark.parametrize("window", [1, 3, 4])
def test_search_stream_windows_equal_search(batch_db, window):
    _, tdb = batch_db
    eng = SearchEngine(tdb, SearchConfig(top=TOP,
                                         stream_readback_window=window),
                       device="cpu")
    rng = np.random.default_rng(window)
    queries = [random_protein(rng, int(n))
               for n in rng.integers(5, 90, size=7)]
    titles = [f"s{i}" for i in range(7)]
    singles = [eng.search(q, t) for q, t in zip(queries, titles)]
    before = eng.metrics.count("search")
    stream = eng.search_stream(queries, titles)
    assert eng.metrics.count("search") == before + 7
    assert [r.query_title for r in stream] == titles
    for a, b in zip(singles, stream):
        _assert_same_hits(a, b)
        np.testing.assert_array_equal(a.evalues, b.evalues)
        np.testing.assert_array_equal(a.bit_scores, b.bit_scores)
        assert b.elapsed > 0 and b.batch_n == 1
    assert eng.search_stream([]) == []


def test_cpu_batch_launches_no_kernel(batch_db):
    _, tdb = batch_db
    eng = SearchEngine(tdb, SearchConfig(top=3), device="cpu")
    before = (sw_lanes.launches, sw_lanes.launches_packed)
    rng = np.random.default_rng(0)
    eng.search_many([random_protein(rng, 20), random_protein(rng, 31)])
    assert (sw_lanes.launches, sw_lanes.launches_packed) == before
