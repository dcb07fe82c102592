"""oswald_tpu_torch's SearchEngine against oswald_tpu's on one database.

Both engines search the same `pack_sequences` database (bin_cost=1, so
each of its two groups is its own bin), packed once by the JAX package and
carried to the port by `from_reference`; the port runs on the CPU (plain
PyTorch scorer), the reference with its Pallas kernel in interpret mode.
Batches and streams are in tests/test_torch_batch.py.  Scores,
ids and titles must be equal.  E-values and bit scores are held at rtol
1e-5: they come from float32 score moments whose sum(S * lnL) term each
side reduces in its own order (test_moments_match_jax bounds the
difference), and every other moment is an exact float32 integer at this
size, equal bit for bit.  The length regression amplifies one float32 ulp
of sum(S * lnL) to about 1e-5 in an E-value, so that is the tightest
tolerance the reference's own float32 moments support.
"""

import numpy as np
import pytest
import torch

from oswald_tpu.alphabet import DUMMY
from oswald_tpu.engine import SearchConfig as JaxConfig
from oswald_tpu.engine import SearchEngine as JaxEngine
from oswald_tpu.engine.search import _topk as jax_topk
from oswald_tpu.io import pack_sequences
from oswald_tpu_torch.engine import SearchConfig, SearchEngine
from oswald_tpu_torch.engine.search import _topk, _unpack_topk
from oswald_tpu_torch.io import from_reference, to_device
from oswald_tpu_torch.kernels import sw_lanes

from conftest import random_protein

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain scorer's tensors are small: one thread is fastest, and the
    test workers do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_SEQS = 1500
TOP = 12
# query lengths below 64 share the reference's one padded program per bin
QLENS = (40, 61, 23)


def _make_db(rng, n=N_SEQS, lmax=150, planted=()):
    lengths = rng.integers(1, lmax, size=n)
    seqs = [random_protein(rng, int(l)) for l in lengths]
    for i, s in planted:
        seqs[i] = s
    lengths = np.asarray([len(s) for s in seqs])
    return pack_sequences(np.concatenate(seqs), lengths,
                          [f"seq{i}" for i in range(n)], bin_cost=1)


@pytest.fixture(scope="module")
def engines():
    db = _make_db(np.random.default_rng(1))
    assert len(db.bin_lengths) >= 2
    return (db, JaxEngine(db, JaxConfig(top=TOP)),
            SearchEngine(from_reference(db), SearchConfig(top=TOP),
                         device="cpu"))


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


@pytest.mark.parametrize("matrix,og,eg", [("blosum62", 10, 2),
                                          ("pam30", 7, 1)])
def test_score_all_matches_jax(matrix, og, eg):
    db = _make_db(np.random.default_rng(2), n=1100, lmax=120)
    ref = JaxEngine(db, JaxConfig(matrix=matrix, open_gap=og,
                                  extend_gap=eg))
    eng = SearchEngine(from_reference(db),
                       SearchConfig(matrix=matrix, open_gap=og,
                                    extend_gap=eg), device="cpu")
    q = random_protein(np.random.default_rng(3), 45)
    want = np.asarray(ref.score_all(q))[np.asarray(ref.valid)]
    got = eng.score_all(q).numpy()[eng.valid.numpy()]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("qlen", QLENS)
def test_search_matches_jax(engines, qlen):
    db, ref, eng = engines
    q = random_protein(np.random.default_rng(qlen), qlen)
    a, b = ref.search(q, "q"), eng.search(q, "q")
    _assert_same_hits(a, b)
    assert b.query_title == "q" and b.elapsed > 0 and b.batch_n == 1
    _assert_same_stats(a, b)


@pytest.mark.parametrize("qlen", QLENS)
def test_moments_match_jax(engines, qlen):
    """The packed readback: top-k and every moment bit-equal except
    sum(S * lnL), which is within a few float32 ulps."""
    db, ref, eng = engines
    q = random_protein(np.random.default_rng(qlen), qlen)
    k = min(TOP, db.n_seqs)
    want = np.asarray(jax_topk(ref.score_all(q), ref.valid, ref.lnl, k))
    got = _topk(eng.score_all(q), eng.valid, eng.lnl, k).numpy()
    ws, wslot, wm = _unpack_topk(want)
    gs, gslot, gm = _unpack_topk(got)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(eng.ids_flat[gslot], ref.ids_flat[wslot])
    for i, (x, y) in enumerate(zip(gm, wm)):
        if i == 2:
            np.testing.assert_allclose(x, y, rtol=1e-6)
        else:
            assert x == y, (i, x, y)


def test_tie_break_on_planted_duplicates():
    """Copies of the query (and of another sequence) planted in both
    groups: equal scores rank by lowest sorted id on both engines.  A
    DUMMY tail (score 0 against everything) keeps a copy's score while
    moving it to the longer group."""
    rng = np.random.default_rng(4)
    q = random_protein(rng, 50)
    other = random_protein(rng, 40)

    def tail(s, n):
        return np.concatenate([s, np.full(n, DUMMY, np.int8)])

    planted = [(5, q), (700, q), (1100, tail(q, 80)), (1400, tail(q, 90)),
               (6, other), (900, tail(other, 95)), (1300, tail(other, 100))]
    db = _make_db(rng, planted=planted)
    ref = JaxEngine(db, JaxConfig(top=TOP))
    eng = SearchEngine(from_reference(db), SearchConfig(top=TOP),
                       device="cpu")
    for query in (q, other):
        a, b = ref.search(query), eng.search(query)
        _assert_same_hits(a, b)
        tied = np.asarray(b.seq_ids)[b.scores == b.scores[0]]
        assert len(tied) >= 3
        assert tied.min() < 1024 <= tied.max()       # both groups
        assert (np.diff(tied) > 0).all()


def test_empty_query(engines):
    db, ref, eng = engines
    a, b = ref.search(np.zeros(0, np.int8)), eng.search(np.zeros(0, np.int8))
    assert (b.scores == 0).all() and b.query_length == 0
    _assert_same_hits(a, b)
    np.testing.assert_array_equal(np.asarray(b.seq_ids), np.arange(TOP))


@pytest.mark.parametrize("query", [
    np.frombuffer(b"MKVLAT", np.uint8),      # raw ASCII, not encoded
    "MKVLAT",
    np.array([0, 5, 24], np.int32),
    np.array([-1, 5], np.int32),
    np.zeros(5479, np.int8),                 # over max_query_len
])
def test_bad_queries_raise(engines, query):
    _, _, eng = engines
    with pytest.raises(ValueError):
        eng.search(query)


def test_search_many_checks_lengths_first(engines):
    _, _, eng = engines
    before = eng.metrics.count("search")
    with pytest.raises(ValueError, match="max_query_len"):
        eng.search_many([np.zeros(10, np.int8), np.zeros(6000, np.int8)])
    assert eng.metrics.count("search") == before


def test_search_many_and_stream_equal_search(engines):
    _, _, eng = engines
    rng = np.random.default_rng(9)
    qs = [random_protein(rng, l) for l in (30, 12)]
    singles = [eng.search(q, f"query{i}") for i, q in enumerate(qs)]
    for batch in (eng.search_many(qs), eng.search_many(qs, batch=False),
                  eng.search_stream(qs)):
        for a, b in zip(singles, batch):
            _assert_same_hits(a, b)
            assert a.query_title == b.query_title
            np.testing.assert_array_equal(a.evalues, b.evalues)


def test_to_device_slot_order_matches_jax(engines):
    db, ref, eng = engines
    state = to_device(from_reference(db), "cpu")
    np.testing.assert_array_equal(state.ids_flat[state.ids_flat >= 0],
                                  ref.ids_flat[ref.ids_flat >= 0])
    np.testing.assert_array_equal(state.valid.numpy(), state.ids_flat >= 0)
    assert state.residues.dtype == torch.int8
    assert state.groups.dtype == torch.int32
    # groups back to back, each [L, 8, 128] as packed
    cols = 0
    for (c0, L), seq in zip(state.groups.tolist(),
                            [g for L in db.bin_lengths
                             for g in db.bins[L]["seq"]]):
        assert c0 == cols and L == seq.shape[0]
        np.testing.assert_array_equal(state.residues[c0:c0 + L].numpy(),
                                      seq)
        cols += L
    assert cols == state.residues.shape[0]
    lnl = state.lnl.numpy()
    assert (lnl[~state.valid.numpy()] == 0).all()
    np.testing.assert_allclose(
        lnl[state.valid.numpy()],
        np.log(db.lengths[state.ids_flat[state.ids_flat >= 0]]), rtol=1e-6)


def test_cpu_search_launches_no_kernel(engines):
    _, _, eng = engines
    before = sw_lanes.launches
    eng.search(random_protein(np.random.default_rng(0), 20))
    assert sw_lanes.launches == before


def test_cuda_engine_needs_cuda(engines, monkeypatch):
    db, _, _ = engines
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SearchEngine(db)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SearchEngine(db, device="cuda")


@pytest.mark.parametrize("kw", [
    {"u_rows": 12}, {"group_block": 0}, {"top": 0}, {"open_gap": -1},
    {"open_gap": 256}, {"extend_gap": 128}, {"acc_dtype": "int64"},
    {"profile_mode": "bogus"}, {"col_unroll": 3}, {"max_query_len": 0},
])
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        JaxConfig(**kw)
    with pytest.raises(ValueError):
        SearchConfig(**kw)


def test_config_defaults_match_jax():
    import dataclasses
    ours = {f.name: f.default for f in dataclasses.fields(SearchConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert ours == theirs


def test_batched_topk_equals_per_query_topk(engines):
    """_topk with a leading batch dimension gives each row the packed
    array of the one-dimensional call."""
    _, _, eng = engines
    rng = np.random.default_rng(12)
    scores = torch.stack([eng.score_all(random_protein(rng, n))
                          for n in (20, 45, 8)])
    k = 7
    batched = _topk(scores, eng.valid, eng.lnl, k)
    assert tuple(batched.shape) == (3, 2, k + 4)
    for row in range(3):
        alone = _topk(scores[row], eng.valid, eng.lnl, k)
        bs, bslot, bm = _unpack_topk(batched[row].numpy())
        s, slot, m = _unpack_topk(alone.numpy())
        np.testing.assert_array_equal(bs, s)
        np.testing.assert_array_equal(bslot, slot)
        np.testing.assert_allclose(bm, m, rtol=1e-6)


def test_warmup_on_cpu(engines):
    """warmup on the CPU loads no kernel library, runs the plain versions
    once (a search and a packed batch), logs each step, adds its seconds to
    the metrics and leaves search results unchanged."""
    _, _, eng = engines
    q = random_protein(np.random.default_rng(13), 40)
    before = eng.search(q)
    lines = []
    n_batch = eng.metrics.count("search_batch")
    assert eng.warmup(48, log=lines.append, jobs=4) == []
    assert [line.split("] ", 1)[1] for line in lines] == [
        "one search of 48 residues",
        "one batch of two queries of 48 residues", "done"]
    assert all(line.startswith("warmup [") for line in lines)
    assert eng.metrics.count("warmup") == 1
    assert eng.metrics.total("warmup") > 0
    assert eng.metrics.count("search_batch") == n_batch + 1
    after = eng.search(q)
    _assert_same_hits(before, after)
    np.testing.assert_array_equal(before.evalues, after.evalues)
    # never past the engine's cap; no batch when asked for none
    lines.clear()
    small = SearchEngine(eng.db, SearchConfig(top=TOP, max_query_len=20),
                         device="cpu")
    assert small.warmup(512, batch=False, log=lines.append) == []
    assert [line.split("] ", 1)[1] for line in lines] == [
        "one search of 20 residues", "done"]
