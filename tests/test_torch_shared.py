"""The port's own copies of the device-free modules against the JAX
package's: alphabet, substitution matrices, statistics, FASTA parsing, the
packed database and its `.oswt` artifact, the synthetic corpus, metrics.

They are the same numpy code on the same seeded inputs, so arrays must be
equal and floats equal to rtol 1e-12.  `.oswt` databases written by one
package must load in the other.
"""

import dataclasses

import numpy as np
import pytest

import oswald_tpu_torch
from oswald_tpu import alphabet as jax_alphabet
from oswald_tpu import stats as jax_stats
from oswald_tpu import submat as jax_submat
from oswald_tpu.engine.search import _db_len_stats as jax_db_len_stats
from oswald_tpu.io import db as jax_db
from oswald_tpu.io import fasta as jax_fasta
from oswald_tpu.io import synth as jax_synth
from oswald_tpu.utils import metrics as jax_metrics
from oswald_tpu_torch import alphabet, stats, submat
from oswald_tpu_torch.io import db, fasta, synth
from oswald_tpu_torch.utils import hostmem, metrics

from conftest import random_protein


def test_alphabet_equals_jax():
    assert alphabet.ALPHABET == jax_alphabet.ALPHABET
    assert (alphabet.DUMMY, alphabet.ALPHA_SIZE) == \
        (jax_alphabet.DUMMY, jax_alphabet.ALPHA_SIZE)
    np.testing.assert_array_equal(alphabet._LUT, jax_alphabet._LUT)
    assert oswald_tpu_torch.encode is alphabet.encode
    text = "MKVLAtghwXBZJOU*-acdefgh"
    for seq in (text, text.encode(), bytearray(text.encode()),
                np.frombuffer(text.encode(), np.uint8)):
        np.testing.assert_array_equal(alphabet.encode(seq),
                                      jax_alphabet.encode(seq))
    codes = np.random.default_rng(0).integers(-3, 30, size=200)
    assert alphabet.decode(codes) == jax_alphabet.decode(codes)
    assert alphabet.decode(alphabet.encode("MKVLATGHW")) == "MKVLATGHW"


@pytest.mark.parametrize("name", jax_submat.MATRIX_NAMES)
def test_submat_equals_jax(name):
    assert submat.MATRIX_NAMES == jax_submat.MATRIX_NAMES
    ours, theirs = submat.get_submat(name), jax_submat.get_submat(name)
    assert ours.dtype == theirs.dtype and ours.shape == (24, 24)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(submat.get_submat(name.upper()), theirs)


def test_submat_unknown_name_raises():
    with pytest.raises(ValueError, match="unknown substitution matrix"):
        submat.get_submat("blosum63")


def _moments(rng, n, hits):
    """Score moments of a synthetic search, as the device would send."""
    lengths = rng.integers(20, 900, size=n)
    lnl = np.log(lengths.astype(np.float64))
    scores = np.round(20 + 6 * lnl + rng.gumbel(0, 4, n)).astype(np.int64)
    top = np.argsort(-scores)[:hits]
    mean, sd = scores.mean(), scores.std()
    t0, t1 = np.ceil(mean + 1.2 * sd), np.ceil(mean + 2.5 * sd)
    return dict(
        n=n, s1=float(scores.sum()), s2=float((scores ** 2).sum()),
        slnl=float((scores * lnl).sum()), lnl1=float(lnl.sum()),
        lnl2=float((lnl ** 2).sum()), top=scores[top], top_lnl=lnl[top],
        hist=np.unique(lengths, return_counts=True), t0=t0, t1=t1,
        c0=float((scores >= t0).sum()), c1=float((scores >= t1).sum()),
        mean_len=float(lengths.mean()), scores=scores)


def _same_stats(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_allclose(
            list(dataclasses.astuple(a)), list(dataclasses.astuple(b)),
            rtol=1e-12)


@pytest.mark.parametrize("n,hits", [(40, 5), (800, 10), (5000, 10),
                                    (5000, 0)])
def test_stats_equal_jax(n, hits):
    m = _moments(np.random.default_rng(n + hits), n, hits)
    fits = []
    for mod in (stats, jax_stats):
        st = mod.fit_score_model(m["n"], m["s1"], m["s2"], m["slnl"],
                                 m["lnl1"], m["lnl2"],
                                 exclude_scores=m["top"],
                                 exclude_lnl=m["top_lnl"])
        cal = mod.tail_calibrate(st, m["n"], m["hist"], m["t0"], m["t1"],
                                 m["c0"], m["c1"], exclude_scores=m["top"])
        pooled = mod.fit_gumbel(m["n"], m["s1"], m["s2"],
                                exclude_scores=m["top"])
        fits.append((st, cal, pooled))
    for a, b in zip(*fits):
        _same_stats(a, b)
    st, cal, _ = fits[0]
    assert (st is None) == (n < 50 + hits)
    if cal is None:
        return
    if n >= 2000 + hits:
        assert cal.lam != st.lam             # the tail moved the rate
    probe = np.concatenate([m["top"], [int(m["t1"]), 500]])
    jcal = fits[1][1]
    for hist in (m["hist"], None):
        np.testing.assert_allclose(cal.evalues(probe, n, hist),
                                   jcal.evalues(probe, n, hist), rtol=1e-12)
    np.testing.assert_allclose(cal.bit_scores(probe, 77, m["mean_len"]),
                               jcal.bit_scores(probe, 77, m["mean_len"]),
                               rtol=1e-12)
    np.testing.assert_allclose(cal.tail_p(probe, 5.5),
                               jcal.tail_p(probe, 5.5), rtol=1e-12)
    assert stats.histogram_report(m["scores"], cal, m["hist"]) == \
        jax_stats.histogram_report(m["scores"], jcal, m["hist"])


@pytest.mark.parametrize("e", [float("nan"), 123.4, 10.0, 3.14159, 0.1,
                               0.0999, 1e-5, 6.56e-143, 0.0])
def test_format_evalue_equals_jax(e):
    assert stats.format_evalue(e) == jax_stats.format_evalue(e)


def test_metrics_equal_jax():
    for args in ((512, 191722906, 0.1423), (65, 10, 0.0), (0, 5, 1.0)):
        assert metrics.gcups(*args) == jax_metrics.gcups(*args)
    ours, theirs = metrics.Metrics(), jax_metrics.Metrics()
    for m in (ours, theirs):
        m.add("search", 0.25)
        m.add("search", 0.5)
        m.add("engine_setup", 1.0)
        with m.phase("idle"):
            pass
    assert ours.count("search") == 2 and ours.total("search") == 0.75
    assert set(ours.as_dict()) == set(theirs.as_dict())
    assert ours.as_dict()["search"] == theirs.as_dict()["search"]
    assert ours.report().splitlines()[0] == theirs.report().splitlines()[0]


_FASTA = (">plain record 1\nMKVLATGHWMKVLATGHW\nACDEFG\n"
          ">crlf record\r\nMKVLAT\r\nGHWAC\r\n"
          ">lower record\nmkvlatghw\n"
          "\n>stops record\nMKV*LAT*\n"
          ">multiline record\nMKVLA\n \t\nTGHW \nACD\n"
          ">dup record\nWWWW\n>dup record\nWWWW\n"
          ">empty record\n"
          ">last record without newline\nACDEFGHIKLMNPQRSTVWY")


@pytest.fixture(scope="module")
def fasta_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("shared") / "adversarial.fasta"
    path.write_bytes(_FASTA.encode())
    return str(path)


def test_parse_fasta_equals_jax(fasta_file):
    titles, seqs, lengths = fasta.parse_fasta(fasta_file)
    jt, js, jl = jax_fasta.parse_fasta(fasta_file, use_native=False)
    assert titles == jt and len(titles) == 9
    np.testing.assert_array_equal(seqs, js)
    np.testing.assert_array_equal(lengths, jl)
    assert seqs.dtype == np.int8 and lengths.dtype == np.int64
    assert lengths.tolist() == [24, 11, 9, 8, 12, 4, 4, 0, 20]
    data = _FASTA.encode()
    for mode in ("bytes", None):
        ours = fasta.parse_fasta_bytes(data, titles=mode)
        theirs = jax_fasta.parse_fasta_bytes(data, titles=mode)
        if mode == "bytes":
            assert ours[0][0] == theirs[0][0]
            np.testing.assert_array_equal(ours[0][1], theirs[0][1])
        else:
            assert ours[0] is None and theirs[0] is None
        np.testing.assert_array_equal(ours[1], theirs[1])
    with pytest.raises(ValueError, match="not a FASTA"):
        fasta.parse_fasta_bytes(b"MKVLAT\n")
    with pytest.raises(ValueError, match="before first"):
        fasta.parse_fasta_bytes(b"MKV\n>a\nMKV\n")


def test_parse_fasta_reads_compressed(tmp_path, fasta_file):
    import gzip
    gz = tmp_path / "adversarial.fasta.gz"
    with gzip.open(gz, "wb") as f:
        f.write(_FASTA.encode())
    want = fasta.parse_fasta(fasta_file)
    got = fasta.parse_fasta(str(gz))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


def test_load_queries_and_write_fasta_equal_jax(fasta_file, tmp_path):
    titles, seqs = db.load_queries(fasta_file)
    jt, js = jax_db.load_queries(fasta_file)
    assert titles == jt
    assert [len(s) for s in seqs] == sorted(len(s) for s in seqs)
    for a, b in zip(seqs, js):
        np.testing.assert_array_equal(a, b)
    fasta.write_fasta(str(tmp_path / "ours.fasta"), titles, seqs, width=7)
    jax_fasta.write_fasta(str(tmp_path / "theirs.fasta"), titles, seqs,
                          width=7)
    assert (tmp_path / "ours.fasta").read_text() == \
        (tmp_path / "theirs.fasta").read_text()


def _corpus(seed, n=2300, lmax=300):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, lmax, size=n)
    flat = np.concatenate([random_protein(rng, int(l)) for l in lengths])
    return flat, lengths, [f"seq{i} é title {i}" for i in range(n)]


def _assert_same_db(a, b):
    assert a.bin_lengths == b.bin_lengths
    assert (a.n_seqs, a.n_residues) == (b.n_seqs, b.n_residues)
    assert list(a.titles) == list(b.titles)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    for L in a.bin_lengths:
        for k in ("seq", "len", "id"):
            x, y = np.asarray(a.bins[L][k]), np.asarray(b.bins[L][k])
            assert x.dtype == y.dtype and x.shape == y.shape, (L, k)
            assert x.tobytes() == y.tobytes(), (L, k)


@pytest.mark.parametrize("bin_cost", [None, 1])
def test_pack_sequences_equals_jax(bin_cost, monkeypatch):
    monkeypatch.setenv("OSWALD_NO_NATIVE", "1")
    flat, lengths, titles = _corpus(5)
    kw = {} if bin_cost is None else {"bin_cost": bin_cost}
    ours = db.pack_sequences(flat, lengths, titles, **kw)
    theirs = jax_db.pack_sequences(flat, lengths, titles, **kw)
    _assert_same_db(ours, theirs)
    assert len(ours.bin_lengths) >= (3 if bin_cost else 1)
    for i in (0, 1023, 1024, ours.n_seqs - 1):
        np.testing.assert_array_equal(ours.sequence_of(i),
                                      theirs.sequence_of(i))
        assert ours.title_of(i) == theirs.title_of(i)
    L = ours.bin_lengths[0]
    for (i, n, s), (ji, jn, js) in zip(db.unpack_group(ours, L, 0)[:50],
                                       jax_db.unpack_group(theirs, L, 0)):
        assert (i, n) == (ji, jn)
        np.testing.assert_array_equal(s, js)


def test_pack_sequences_default_titles_and_bad_codes():
    flat, lengths, _ = _corpus(6, n=30, lmax=40)
    assert db.pack_sequences(flat, lengths).titles == \
        jax_db.pack_sequences(flat, lengths).titles
    with pytest.raises(ValueError, match="encode"):
        db.pack_sequences(np.frombuffer(b"MKVLAT", np.uint8).astype(np.int8),
                          [6])
    empty = db.pack_sequences(np.zeros(0, np.int8), [])
    assert empty.n_seqs == 0 and empty.bins == {}


@pytest.fixture(scope="module")
def packed_pair():
    flat, lengths, titles = _corpus(7, n=1500, lmax=200)
    return (db.pack_sequences(flat, lengths, titles, bin_cost=1),
            jax_db.pack_sequences(flat, lengths, titles, bin_cost=1))


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax"),
                                           ("torch", "torch")])
@pytest.mark.parametrize("mmap,lazy", [(True, None), (False, True)])
def test_save_load_across_packages(packed_pair, tmp_path, writer, reader,
                                   mmap, lazy):
    ours, theirs = packed_pair
    mods = {"jax": jax_db, "torch": db}
    src = {"jax": theirs, "torch": ours}[writer]
    mods[writer].save_db(src, str(tmp_path / "db"))
    back = mods[reader].load_db(str(tmp_path / "db"), mmap=mmap,
                                lazy_titles=lazy)
    _assert_same_db(back, ours)
    if lazy:
        assert not isinstance(back.titles, list)
        assert back.title_of(3) == ours.title_of(3)
    # the path may also name the directory itself
    again = mods[reader].load_db(str(tmp_path / "db.oswt"))
    assert again.n_seqs == ours.n_seqs


def test_load_db_rejects_unknown_version(packed_pair, tmp_path):
    import json
    db.save_db(packed_pair[0], str(tmp_path / "db"))
    meta = tmp_path / "db.oswt" / "meta.json"
    doc = json.loads(meta.read_text())
    doc["version"] = 99
    meta.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="unsupported db format"):
        db.load_db(str(tmp_path / "db"))


def test_from_reference_round_trip(packed_pair):
    ours, theirs = packed_pair
    carried = db.from_reference(theirs)
    assert type(carried) is db.PackedDB
    assert type(carried) is not type(theirs)
    _assert_same_db(carried, ours)
    # the arrays are shared, not copied
    L = carried.bin_lengths[0]
    assert carried.bins[L]["seq"] is theirs.bins[L]["seq"]
    np.testing.assert_array_equal(carried.sequence_of(77),
                                  theirs.sequence_of(77))
    for a, b in zip(db.db_len_stats(carried),
                    jax_db_len_stats(theirs)):
        for x, y in zip(a, b) if isinstance(a, tuple) else [(a, b)]:
            np.testing.assert_array_equal(x, y)


def test_preprocess_db_equals_jax(fasta_file, tmp_path, monkeypatch):
    monkeypatch.setenv("OSWALD_NO_NATIVE", "1")
    ours = db.preprocess_db(fasta_file, str(tmp_path / "ours"),
                            verbose=False)
    theirs = jax_db.preprocess_db(fasta_file, str(tmp_path / "theirs"),
                                  verbose=False)
    _assert_same_db(ours, theirs)
    _assert_same_db(jax_db.load_db(str(tmp_path / "ours")),
                    db.load_db(str(tmp_path / "theirs")))


@pytest.mark.parametrize("seed", [0, 3])
def test_synth_corpus_equals_jax(seed):
    out = []
    for mod in (synth, jax_synth):
        rng = np.random.default_rng(seed)
        q = mod.realistic_residues(rng, 120)
        flat, lengths, titles = mod.make_realistic_corpus(
            rng, 3000, planted=[mod.mutate(q, rng), mod.mutate(q, rng, 0.9)])
        out.append((q, flat, lengths, titles))
    for a, b in zip(*out):
        if isinstance(a, list):
            assert a == b
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    q, flat, lengths, titles = out[0]
    assert titles[-2:] == ["planted_0", "planted_1"]
    assert lengths.max() == 5478 and flat.size == lengths.sum()
    for a, b in zip(synth.residue_distribution(),
                    jax_synth.residue_distribution()):
        np.testing.assert_array_equal(a, b)


def test_synth_write_fasta_equals_jax(tmp_path):
    rng = np.random.default_rng(1)
    flat, lengths, titles = synth.make_realistic_corpus(rng, 20, max_len=300)
    synth.write_fasta(str(tmp_path / "a.fasta"), flat, lengths, titles)
    jax_synth.write_fasta(str(tmp_path / "b.fasta"), flat, lengths, titles)
    assert (tmp_path / "a.fasta").read_text() == \
        (tmp_path / "b.fasta").read_text()
    back = fasta.parse_fasta(str(tmp_path / "a.fasta"))
    np.testing.assert_array_equal(back[1], flat)
    np.testing.assert_array_equal(back[2], lengths)


def test_hostmem_helpers():
    buf = hostmem.alloc_nohuge(1000, np.int32)
    assert buf.shape == (1000,) and buf.dtype == np.int32
    buf[:] = 7
    assert int(buf.sum()) == 7000
    with hostmem.numpy_nohuge():
        big = np.ones(2 << 20, np.int8)
    assert int(big.sum()) == 2 << 20


def test_planner_shared_parts_equal_jax(packed_pair):
    """What the port's planner shares with the reference's: the safety
    fraction, the longest default query, and the padded residue bytes of a
    database.  (Its ladder and its byte counts are its own: no profile, no
    scan state that grows with the query, no default device-memory size.)"""
    from oswald_tpu.engine import planner as jax_planner
    from oswald_tpu_torch.engine import planner
    db, ref_db = packed_pair
    assert planner.SAFETY_FRACTION == jax_planner.SAFETY_FRACTION
    assert planner.MAX_QUERY_LEN_DEFAULT == jax_planner.MAX_QUERY_LEN_DEFAULT
    assert planner.GROUP_LANES == jax_planner.GROUP_LANES
    assert planner.db_padded_bytes(db) == jax_planner.db_padded_bytes(ref_db)
    assert {f.name for f in dataclasses.fields(planner.Plan)} == \
        {f.name for f in dataclasses.fields(jax_planner.Plan)}
    both = jax_planner.plan_profile_mode(ref_db, hbm_bytes=1 << 40)
    ours = planner.plan_profile_mode(db, hbm_bytes=1 << 40)
    assert (ours.mode, ours.db_bytes, ours.budget_bytes) == \
        (both.mode, both.db_bytes, both.budget_bytes)


def _round_up(x, q):
    return -(-x // q) * q


def _brute_best(group_Ls, quanta, bin_cost):
    """Exhaustive partition DP over a tiny input: mesh_bin_plan's oracle."""
    best = [0.0] + [float("inf")] * len(group_Ls)
    for j in range(1, len(group_Ls) + 1):
        for i in range(j):
            best[j] = min(best[j], best[i] + bin_cost + _round_up(
                j - i, quanta) * group_Ls[j - 1] * 1024)
    return best[-1]


def test_mesh_bin_plan_equals_jax_and_brute_force(rng):
    from oswald_tpu.dist import repack as jax_repack
    from oswald_tpu_torch.dist import repack
    for _ in range(20):
        G = int(rng.integers(1, 40))
        Ls = np.sort(rng.choice(np.arange(1, 40) * 32, size=G))
        quanta = int(rng.choice([1, 2, 8, 16, 64]))
        plan = repack.mesh_bin_plan(Ls, quanta)
        assert plan == jax_repack.mesh_bin_plan(Ls, quanta)
        cells = repack.plan_sharded_cells(Ls, quanta, plan)
        assert cells == jax_repack.plan_sharded_cells(Ls, quanta, plan)
        assert abs(cells + 262_144 * len(plan) -
                   _brute_best(list(Ls), quanta, 262_144)) < 1e-6


@pytest.mark.parametrize("quanta", [1, 2, 16])
def test_repack_for_mesh_equals_jax(quanta):
    """The re-cut of a database (bins, and every array of every bin) and
    the per-group geometry equal the JAX package's."""
    from oswald_tpu.dist import repack as jax_repack
    from oswald_tpu.io import pack_sequences as jax_pack
    from oswald_tpu_torch.dist import repack
    rng = np.random.default_rng(2)
    lengths = rng.integers(1, 700, size=30_000)
    flat = rng.integers(0, 23, size=int(lengths.sum())).astype(np.int8)
    ref = jax_pack(flat, lengths, None)
    ours = db.pack_sequences(flat, lengths, None)
    np.testing.assert_array_equal(repack.group_geometry(ours),
                                  jax_repack.group_geometry(ref))
    a, b = repack.repack_for_mesh(ours, quanta), \
        jax_repack.repack_for_mesh(ref, quanta)
    assert a.bin_lengths == b.bin_lengths
    assert (a is ours) == (b is ref)
    for L in a.bin_lengths:
        for k in ("seq", "len", "id"):
            np.testing.assert_array_equal(np.asarray(a.bins[L][k]),
                                          np.asarray(b.bins[L][k]))


def _duplicate_plan(group_Ls, quanta, bin_cost=0):
    """A plan that ends two bins inside one equal-length run."""
    return [(0, 1), (1, len(group_Ls))]


def test_repack_for_mesh_raises_on_duplicate_bin_length(monkeypatch):
    from oswald_tpu_torch.dist import repack
    lengths = np.full(3000, 40)
    ours = db.pack_sequences(np.zeros(120_000, np.int8), lengths, None)
    monkeypatch.setattr(repack, "mesh_bin_plan", _duplicate_plan)
    with pytest.raises(ValueError, match="two bins one length"):
        repack.repack_for_mesh(ours, 2)


def test_repack_for_mesh_raises_under_python_O():
    """The duplicate-length check survives python -O (the JAX package
    asserts it)."""
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    code = (
        "import numpy as np\n"
        "from oswald_tpu_torch.dist import repack\n"
        "from oswald_tpu_torch.io import pack_sequences\n"
        "d = pack_sequences(np.zeros(120000, np.int8), np.full(3000, 40))\n"
        "repack.mesh_bin_plan = lambda g, q, b=0: [(0, 1), (1, len(g))]\n"
        "try:\n    repack.repack_for_mesh(d, 2)\n"
        "except ValueError:\n    print('raised')\n")
    out = subprocess.run([sys.executable, "-O", "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "raised", out.stderr


def test_scaling_projection_equals_jax():
    from oswald_tpu.dist import model as jax_model
    from oswald_tpu.io import pack_sequences as jax_pack
    from oswald_tpu_torch.dist import model
    rng = np.random.default_rng(4)
    lengths = rng.integers(1, 900, size=20_000)
    flat = rng.integers(0, 23, size=int(lengths.sum())).astype(np.int8)
    args = dict(k=10, qlen=300, t_single_s=0.04, t_mesh1_s=0.05,
                n_list=(1, 2, 8, 64), t_batch_s=0.4, batch_n=10)
    a = model.scaling_projection(db.pack_sequences(flat, lengths, None),
                                 **args)
    b = jax_model.scaling_projection(jax_pack(flat, lengths, None), **args)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.rows() == b.rows()
    from oswald_tpu.engine.search import MOM_COLS
    from oswald_tpu_torch.engine.search import MOM_COLS as engine_cols
    assert model.MOM_COLS == engine_cols == MOM_COLS


def test_import_export_reference_format_equal_jax(tmp_path):
    """export_reference_db writes the bytes the JAX package writes, and
    import_reference_db reads them back to the same database."""
    from oswald_tpu.io import db as jax_db_mod
    rng = np.random.default_rng(8)
    lengths = rng.integers(3, 200, size=500)
    flat = rng.integers(0, 23, size=int(lengths.sum())).astype(np.int8)
    titles = [f"seq{i} desc" for i in range(500)]
    ours = db.pack_sequences(flat, lengths, titles)
    db.export_reference_db(ours, str(tmp_path / "p"), verbose=False)
    jax_db_mod.export_reference_db(
        jax_db_mod.pack_sequences(flat, lengths, titles),
        str(tmp_path / "j"), verbose=False)
    for ext in (".desc", ".info", ".seq"):
        assert (tmp_path / f"p{ext}").read_bytes() == \
            (tmp_path / f"j{ext}").read_bytes()
    back = db.import_reference_db(str(tmp_path / "p"), verbose=False)
    ref = jax_db_mod.import_reference_db(str(tmp_path / "j"), verbose=False)
    assert back.bin_lengths == ref.bin_lengths == ours.bin_lengths
    assert list(back.titles) == list(ref.titles)
    for L in back.bin_lengths:
        for k in ("seq", "len", "id"):
            np.testing.assert_array_equal(back.bins[L][k], ref.bins[L][k])
            np.testing.assert_array_equal(back.bins[L][k], ours.bins[L][k])
    with open(tmp_path / "p.info", "w") as f:
        f.write(f"500 {int(lengths.sum()) + 7} 40")
    with pytest.raises(ValueError, match="inconsistent"):
        db.import_reference_db(str(tmp_path / "p"), verbose=False)
    big = db.pack_sequences(np.zeros(70000, np.int8), [70000], ["giant"])
    with pytest.raises(ValueError, match="uint16"):
        db.export_reference_db(big, str(tmp_path / "big"), verbose=False)
