"""The larger-than-device-memory path of the port against oswald_tpu's.

The port's `host_stream` engine (database on the host, streamed through the
device slice by slice; here on the CPU, so the slices are scored by the
plain PyTorch versions) is held to the JAX package's `host_stream` engine on
the same database, and to the port's own resident engine on the full score
surface.  Scores, ids and titles must be equal.  E-values: both packages
take the host_stream moments on the host in float64 from equal int32
scores, so they are held at rtol 1e-9 between the two host_stream engines;
against a resident engine, whose moments are float32, at the rtol 1e-4 of
tests/test_torch_batch.py.  The host reductions (`_host_topk`,
`_host_moments`), the planner and the mode resolution are held to their
JAX counterparts where those have one; the planner's arithmetic is the
port's own.
"""

import numpy as np
import pytest
import torch

from oswald_tpu.engine import SearchConfig as JaxConfig
from oswald_tpu.engine import SearchEngine as JaxEngine
from oswald_tpu.engine.search import _host_moments as jax_host_moments
from oswald_tpu.engine.search import _host_topk as jax_host_topk
from oswald_tpu.io import pack_sequences
from oswald_tpu.io.db import save_db
from oswald_tpu_torch.engine import SearchConfig, SearchEngine, planner
from oswald_tpu_torch.engine.planner import (SAFETY_FRACTION,
                                             db_padded_bytes,
                                             plan_profile_mode)
from oswald_tpu_torch.engine.search import (MIXED_PACK_SEGS, _host_moments,
                                            _host_topk, _topk, _unpack_topk)
from oswald_tpu_torch.io import from_reference, load_db
from oswald_tpu_torch.io.device_db import (fill_slice, slice_budget_bytes,
                                           to_device, to_host_stream)
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


def _make_db(rng, n, lmax, bin_cost=None):
    lengths = rng.integers(1, lmax, size=n)
    seqs = [random_protein(rng, int(l)) for l in lengths]
    return pack_sequences(np.concatenate(seqs), lengths,
                          [f"s{i}" for i in range(n)],
                          **({"bin_cost": bin_cost} if bin_cost else {}))


def _same_hits(a, b):
    np.testing.assert_array_equal(a.scores, b.scores)
    np.testing.assert_array_equal(np.asarray(a.seq_ids),
                                  np.asarray(b.seq_ids))
    assert a.titles == b.titles


def _same_stats(a, b, rtol):
    assert (a.evalues is None) == (b.evalues is None)
    if a.evalues is not None:
        np.testing.assert_allclose(b.evalues, a.evalues, rtol=rtol)
        np.testing.assert_allclose(b.bit_scores, a.bit_scores, rtol=rtol)


@pytest.fixture(scope="module")
def sliced():
    """A database of several thin bins whose 1 MiB slices split it into
    several transfers and coalesce spans across bin boundaries, with the
    JAX host_stream engine and the port's host_stream and resident ones."""
    db = _make_db(np.random.default_rng(11), 9000, 200)
    tdb = from_reference(db)
    ref = JaxEngine(db, JaxConfig(top=20, profile_mode="host_stream",
                                  host_stream_slice_mb=1, group_block=1))
    hs = SearchEngine(tdb, SearchConfig(top=20, profile_mode="host_stream",
                                        host_stream_slice_mb=1),
                      device="cpu")
    res = SearchEngine(tdb, SearchConfig(top=20, profile_mode="precompute"),
                       device="cpu")
    return db, tdb, ref, hs, res


def test_host_stream_matches_jax_host_stream(sliced):
    db, _, ref, hs, res = sliced
    assert hs.mode == "host_stream" and hs.state is None
    assert len(hs._hs_slices) > 1, \
        "test should exercise multiple slices"
    assert any(len(s.spans) > 1 for s in hs._hs_slices), \
        "test should exercise a multi-span (cross-bin) slice"
    # the same cut as the reference's, span for span (its group_block=1
    # spans are (L, Gs, byte offset, lo, take))
    assert [[(L, lo, take) for L, _, _, lo, take in spans]
            for _, spans in ref._hs_slices] == \
        [s.spans for s in hs._hs_slices]
    np.testing.assert_array_equal(hs.ids_flat, ref.ids_flat)
    assert hs.n_slots == ref.n_slots == res.n_slots
    for qlen in (77, 23):
        q = random_protein(np.random.default_rng(qlen), qlen)
        a, b, c = ref.search(q, "q"), hs.search(q, "q"), res.search(q, "q")
        _same_hits(a, b)
        _same_hits(c, b)
        assert b.query_title == "q" and b.elapsed > 0 and b.batch_n == 1
        _same_stats(a, b, 1e-9)
        _same_stats(c, b, 1e-4)
        # the full score surface, not only the top-k
        s_ref = np.asarray(ref.score_all(q))
        s_hs, s_res = hs.score_all(q), res.score_all(q)
        assert s_hs.dtype == torch.int32
        np.testing.assert_array_equal(s_hs.numpy(), s_ref)
        np.testing.assert_array_equal(s_hs.numpy(), s_res.numpy())


def test_slices_tile_the_database(sliced):
    """Slices are whole groups in slot order; their group tables start at
    column 0 of each slice; the bytes they fill are the resident state's."""
    _, tdb, _, hs, res = sliced
    slot, chunks = 0, []
    for sl in hs._hs_slices:
        assert sl.slot0 == slot
        slot += sl.n_slots
        table = sl.groups.numpy()
        want, col = [], 0
        for L, lo, take in sl.spans:
            want += [(col + g * L, L) for g in range(take)]
            col += take * L
        assert col == sl.n_cols and sl.n_bytes == col * 1024
        np.testing.assert_array_equal(table, np.array(want, np.int32))
        buf = np.empty(sl.n_bytes, np.int8)
        fill_slice(tdb, sl, buf)
        chunks.append(buf)
    assert slot == hs.n_slots
    np.testing.assert_array_equal(np.concatenate(chunks),
                                  res.state.residues.numpy().reshape(-1))
    np.testing.assert_array_equal(hs.ids_flat, res.ids_flat)
    np.testing.assert_array_equal(hs.lnl_flat, res.lnl.numpy())


def test_host_stream_from_mmap_artifact(tmp_path):
    """host_stream over a memory-mapped .oswt written by the JAX package:
    the bins stay read-only maps, and the hits are the resident engine's
    and the JAX host_stream engine's."""
    rng = np.random.default_rng(12)
    db = _make_db(rng, 1200, 150)
    save_db(db, str(tmp_path / "d"))
    mdb = load_db(str(tmp_path / "d"))
    assert all(isinstance(b["seq"], np.memmap) for b in mdb.bins.values())
    q = random_protein(rng, 40)
    ref = JaxEngine(db, JaxConfig(top=8, profile_mode="host_stream",
                                  host_stream_slice_mb=1))
    res = SearchEngine(from_reference(db), SearchConfig(top=8), device="cpu")
    hs = SearchEngine(mdb, SearchConfig(top=8, profile_mode="host_stream",
                                        host_stream_slice_mb=1),
                      device="cpu")
    assert all(isinstance(b["seq"], np.memmap) for b in mdb.bins.values())
    a, b, c = ref.search(q), hs.search(q), res.search(q)
    _same_hits(a, b)
    _same_hits(c, b)
    _same_stats(a, b, 1e-9)


def test_host_stream_batch():
    """A batch under host_stream: the launches of its packing plan (packed
    bins and a leftover over the pack budget) all in one sweep; results
    equal the JAX host_stream batch, the resident batch and the same
    queries one by one."""
    rng = np.random.default_rng(13)
    db = _make_db(rng, 3000, 600)
    tdb = from_reference(db)
    queries = [random_protein(rng, int(l)) for l in (30, 33, 90, 5, 0, 140)]
    cfg = dict(top=7, batch_query_pack_rows=128)
    ref = JaxEngine(db, JaxConfig(profile_mode="host_stream",
                                  host_stream_slice_mb=1, **cfg))
    res = SearchEngine(tdb, SearchConfig(**cfg), device="cpu")
    hs = SearchEngine(tdb, SearchConfig(profile_mode="host_stream",
                                        host_stream_slice_mb=1, **cfg),
                      device="cpu")
    assert len(hs._hs_slices) > 1
    r_ref = ref.search_many(queries, batch=True)
    r_res = res.search_many(queries, batch=True)
    r_hs = hs.search_many(queries, batch=True)
    assert hs.metrics.count("search_batch") == 1
    singles = [hs.search(q, f"query{i}") for i, q in enumerate(queries)]
    streamed = hs.search_stream(queries)
    for a, b, c, d, e in zip(r_ref, r_hs, r_res, singles, streamed):
        _same_hits(a, b)
        _same_hits(c, b)
        _same_hits(d, b)
        _same_hits(e, b)
        _same_stats(a, b, 1e-9)
        _same_stats(c, b, 1e-4)
        _same_stats(d, b, 1e-12)
        assert b.batch_n == len(queries) and d.batch_n == 1
        assert b.query_title == d.query_title
    assert len({r.elapsed for r in r_hs}) == 1


def test_host_stream_batch_is_one_sweep(monkeypatch):
    """Every launch of a batch's plan scores each slice once: the sweep
    fills each slice exactly once per search_many call."""
    from oswald_tpu_torch.engine import search as search_mod
    rng = np.random.default_rng(14)
    db = from_reference(_make_db(rng, 2500, 120))
    hs = SearchEngine(db, SearchConfig(top=5, profile_mode="host_stream",
                                       host_stream_slice_mb=1,
                                       batch_query_pack_rows=64),
                      device="cpu")
    filled = []
    real = search_mod.fill_slice
    monkeypatch.setattr(search_mod, "fill_slice",
                        lambda db_, sl, out: (filled.append(sl.slot0),
                                              real(db_, sl, out))[1])
    queries = [random_protein(rng, n) for n in (20, 30, 25, 100)]
    hs.search_many(queries)
    assert filled == [s.slot0 for s in hs._hs_slices]


def test_host_stream_serial_matches_overlap():
    """host_stream_overlap=False is a schedule, not a result: identical
    hits and statistics."""
    rng = np.random.default_rng(15)
    db = from_reference(_make_db(rng, 9000, 300))
    q = random_protein(rng, 61)
    ov = SearchEngine(db, SearchConfig(top=15, profile_mode="host_stream",
                                       host_stream_slice_mb=1),
                      device="cpu")
    ser = SearchEngine(db, SearchConfig(top=15, profile_mode="host_stream",
                                        host_stream_slice_mb=1,
                                        host_stream_overlap=False),
                       device="cpu")
    assert len(ov._hs_slices) >= 2
    a, b = ov.search(q), ser.search(q)
    _same_hits(a, b)
    np.testing.assert_array_equal(a.evalues, b.evalues)
    np.testing.assert_array_equal(ov.score_all(q).numpy(),
                                  ser.score_all(q).numpy())


def test_host_stream_adaptive_slice_budget():
    """A database smaller than the configured slice size still cuts into
    several slices (about eight, at least 16 MiB each); a smaller
    configured size is honoured.  The rule is the reference's."""
    mib = 1 << 20
    assert slice_budget_bytes(400 * mib, 256) == 50 * mib
    assert slice_budget_bytes(40 * mib, 256) == 16 * mib
    assert slice_budget_bytes(40 * mib, 1) == mib
    assert slice_budget_bytes(8000 * mib, 256) == 256 * mib
    assert slice_budget_bytes(0, 256) == 16 * mib
    rng = np.random.default_rng(16)
    db = _make_db(rng, 40000, 1500)         # ~30+ MB packed
    tdb = from_reference(db)
    ref = JaxEngine(db, JaxConfig(profile_mode="host_stream",
                                  host_stream_slice_mb=256, group_block=1))
    big = to_host_stream(tdb, "cpu", 256)
    assert len(big.slices) >= 2
    assert [s.spans for s in big.slices] == \
        [[(L, lo, take) for L, _, _, lo, take in spans]
         for _, spans in ref._hs_slices]
    tiny = to_host_stream(tdb, "cpu", 1)
    assert len(tiny.slices) > len(big.slices)
    # a group larger than the budget is a one-span slice of its own
    assert any(s.n_bytes > tiny.budget_bytes and len(s.spans) == 1 and
               s.spans[0][2] == 1 for s in tiny.slices)
    assert max(s.n_bytes for s in big.slices) <= big.budget_bytes


@pytest.mark.parametrize("n,k,qrows", [(5000, 10, None), (3000, 25, 3),
                                       (40, 40, None)])
def test_host_topk_and_moments_equal_jax(n, k, qrows):
    """Tie-heavy scores with padding slots: the order of the reference's
    lexsort, slot for slot, and its float64 moments."""
    rng = np.random.default_rng(n + k)
    ids = np.where(rng.random(n) < 0.1, -1,
                   np.arange(n)).astype(np.int32)
    if k == n:
        ids = np.arange(n, dtype=np.int32)
    lnl = np.where(ids >= 0, rng.random(n) * 6, 0).astype(np.float32)
    shape = (n,) if qrows is None else (qrows, n)
    scores = rng.integers(0, 12, size=shape).astype(np.int32)
    rows = scores[None] if qrows is None else scores
    tops = []
    for row in rows:
        ws, wslot = jax_host_topk(row, ids, k)
        gs, gslot = _host_topk(row, ids, k)
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gslot, wslot)
        assert gs.dtype == np.int32
        tops.append(gs)
        # and the device top-k of the resident path gives the same order
        packed = _topk(torch.from_numpy(row), torch.from_numpy(ids >= 0),
                       torch.from_numpy(lnl), k).numpy()
        ds, dslot, _ = _unpack_topk(packed)
        np.testing.assert_array_equal(ds, gs)
        np.testing.assert_array_equal(dslot, gslot)
    top = tops[0] if qrows is None else np.stack(tops)
    want = jax_host_moments(scores, ids >= 0, lnl, top)
    got = _host_moments(scores, ids >= 0, lnl, top)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12)
        assert np.shape(g) == np.shape(w)


@pytest.mark.parametrize("mode", ["stream", "precompute"])
def test_resident_modes_match_jax(mode):
    """`stream` and `precompute` are one resident path here; each equals
    the JAX engine of the same mode."""
    rng = np.random.default_rng(17)
    db = _make_db(rng, 1500, 150, bin_cost=1)
    ref = JaxEngine(db, JaxConfig(top=12, profile_mode=mode))
    eng = SearchEngine(from_reference(db),
                       SearchConfig(top=12, profile_mode=mode), device="cpu")
    assert eng.mode == mode and eng._hs_slices == []
    assert eng.state is not None
    for qlen in (40, 9):
        q = random_protein(rng, qlen)
        a, b = ref.search(q), eng.search(q)
        _same_hits(a, b)
        # float32 moments on both sides, each summed in its own order: one
        # ulp of sum(S * lnL) moved an E-value by 1.1e-5 here
        _same_stats(a, b, 1e-4)
    qs = [random_protein(rng, n) for n in (30, 12, 50)]
    for a, b in zip(ref.search_many(qs), eng.search_many(qs)):
        _same_hits(a, b)


def test_auto_mode_resolves_and_searches(capsys):
    rng = np.random.default_rng(18)
    db = _make_db(rng, 600, 80)
    tdb = from_reference(db)
    eng = SearchEngine(tdb, SearchConfig(
        top=5, profile_mode="auto",
        hbm_budget_bytes=db_padded_bytes(tdb) // 4, host_stream_slice_mb=1),
        device="cpu")
    assert eng.mode == "host_stream"
    cap = capsys.readouterr()
    assert cap.out == ""                         # stdout stays clean
    assert cap.err.startswith("oswald-tpu-torch engine: "
                              "profile_mode=host_stream")
    assert "degraded from precompute" in cap.err
    q = random_protein(rng, 25)
    ref = JaxEngine(db, JaxConfig(top=5, profile_mode="precompute"))
    _same_hits(ref.search(q), eng.search(q))
    # no budget and a device that reports no memory: resident
    eng = SearchEngine(tdb, SearchConfig(top=5), device="cpu")
    assert eng.mode == "precompute"
    assert "profile_mode=precompute" in capsys.readouterr().err
    assert "no limit" in plan_profile_mode(tdb).describe()
    # an explicit mode asks no planner and announces nothing
    SearchEngine(tdb, SearchConfig(profile_mode="stream"), device="cpu")
    assert capsys.readouterr().err == ""


def test_planner_mode_selection():
    rng = np.random.default_rng(19)
    db = from_reference(_make_db(rng, 1100, 100))
    assert db_padded_bytes(db) > 0
    est = plan_profile_mode(db, hbm_bytes=1)     # fields only
    assert est.mode == "host_stream"
    assert est.profile_bytes == 0
    assert est.db_bytes == db_padded_bytes(db)
    slots = to_device(db, "cpu").ids_flat.size
    assert planner.db_slots(db) == slots
    # the port's own arithmetic: 8 B of scratch per padded residue, the
    # per-slot vectors, and the rows of the widest packed batch
    assert planner.BATCH_SEGS == MIXED_PACK_SEGS
    assert est.state_bytes == 8 * est.db_bytes + slots * (
        planner.SLOT_BYTES + MIXED_PACK_SEGS * planner.BATCH_SLOT_BYTES)
    assert est.resident_bytes == est.db_bytes + est.state_bytes

    def hbm_for(resident):
        # smallest budget whose SAFETY_FRACTION share covers `resident`
        return int(resident / SAFETY_FRACTION) + 1024

    assert plan_profile_mode(
        db, hbm_bytes=hbm_for(est.resident_bytes)).mode == "precompute"
    # the residues alone fit, with their scratch they do not
    assert plan_profile_mode(
        db, hbm_bytes=hbm_for(est.db_bytes)).mode == "host_stream"
    assert plan_profile_mode(
        db, hbm_bytes=hbm_for(est.resident_bytes) // 2).mode == "host_stream"
    # sharding over devices shrinks the per-device share
    assert plan_profile_mode(
        db, hbm_bytes=hbm_for(est.resident_bytes) // 2,
        n_devices=4).mode == "precompute"
    # the scratch does not grow with the query: max_query_len moves nothing
    short = plan_profile_mode(db, hbm_bytes=1 << 30, max_query_len=64)
    long = plan_profile_mode(db, hbm_bytes=1 << 30, max_query_len=5478)
    assert (short.state_bytes, short.mode) == (long.state_bytes, long.mode)
    assert (short.max_query_len, long.max_query_len) == (64, 5478)
    # a config that packs nothing needs one query's rows only
    lone = plan_profile_mode(db, hbm_bytes=1,
                             config=SearchConfig(batch_query_pack_rows=0))
    assert lone.state_bytes < est.state_bytes
    assert planner.device_hbm_bytes("cpu") is None
    assert not hasattr(planner, "DEFAULT_HBM_BYTES")
    assert planner.host_stream_bytes(1 << 20, 4096) == \
        10 * (1 << 20) + 2 * 32 * 4 * 4096


def test_cpu_host_stream_launches_no_kernel(sliced):
    _, _, _, hs, _ = sliced
    before = (sw_lanes.launches, sw_lanes.launches_packed)
    rng = np.random.default_rng(20)
    hs.search_many([random_protein(rng, 10), random_protein(rng, 12)])
    assert (sw_lanes.launches, sw_lanes.launches_packed) == before


def test_host_stream_rejects_bad_queries_first(sliced):
    _, _, _, hs, _ = sliced
    with pytest.raises(ValueError, match="max_query_len"):
        hs.search(np.zeros(6000, np.int8))
    with pytest.raises(ValueError, match="max_query_len"):
        hs.search_many([np.zeros(10, np.int8), np.zeros(6000, np.int8)])
    with pytest.raises(ValueError, match="codes outside"):
        hs.search_many([np.full(10, 30, np.int8), np.zeros(9, np.int8)])
    empty = hs.search(np.zeros(0, np.int8))
    assert (empty.scores == 0).all() and empty.query_length == 0
