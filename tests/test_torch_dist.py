"""The port's distributed engine (oswald_tpu_torch.dist) on the CPU.

World size 1 runs in this process over a gloo group on a file:// store
under tmp_path, and must be the port's SearchEngine bit for bit (the same
launches on the database as packed, the same float32 sums, thresholds and
counts).  Two ranks run as two processes (tests/torch_dist_worker.py, each
with its own timeout): their scores and ids must equal the port's single
engine and oswald_tpu's DistributedSearchEngine on a two-device slice of
the virtual CPU mesh, exactly; their E-values the port's single engine at
rtol 1e-4 (the ranks' sums are exact, taken in int64 and added, and the
single engine's are float32 sums of one vector: the tolerance of the
port's batch tests).  The pod test serves the
same database from two ranks and holds rank 0's answers to the single
engine.
"""

import gc
import json
import os
import select
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from oswald_tpu.dist import DistributedSearchEngine as JaxDist
from oswald_tpu.dist import make_device_mesh
from oswald_tpu.engine import SearchConfig as JaxConfig
from oswald_tpu.io import pack_sequences as jax_pack
from oswald_tpu_torch import decode
from oswald_tpu_torch.dist import (DistributedSearchEngine, bootstrap,
                                   process_group_slice, shard_bounds,
                                   shard_cells, shutdown, world)
from oswald_tpu_torch.engine import SearchConfig, SearchEngine
from oswald_tpu_torch.engine.search import batch_plan
from oswald_tpu_torch.io import pack_sequences

import torch_dist_worker as worker

WORKER = Path(__file__).resolve().parent / "torch_dist_worker.py"
REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def world1(tmp_path):
    """A gloo group of one rank in this process, torn down after."""
    assert bootstrap(f"file://{tmp_path}/store", 1, 0) == (0, 1)
    assert bootstrap() == (0, 1)             # idempotent
    yield
    shutdown()
    assert world() == (0, 1)


def _db(rng, n, lmax):
    lengths = rng.integers(1, lmax, size=n)
    flat = rng.integers(0, 23, size=int(lengths.sum())).astype(np.int8)
    return pack_sequences(flat, lengths, [f"s{i}" for i in range(n)])


def _same(a, b):
    """Hits and E-values bit for bit."""
    np.testing.assert_array_equal(a.scores, b.scores)
    np.testing.assert_array_equal(a.seq_ids, b.seq_ids)
    assert a.titles == b.titles
    np.testing.assert_array_equal(a.evalues, b.evalues)


@pytest.mark.parametrize("mode", ["precompute", "stream", "host_stream"])
def test_world1_equals_single_engine(world1, mode):
    """Every method at world size 1 equals the single engine bit for bit,
    E-values included (tail-calibrated on every path)."""
    rng = np.random.default_rng(11)
    db = _db(rng, 2600, 160)
    cfg = SearchConfig(top=8, profile_mode=mode, host_stream_slice_mb=1,
                       batch_query_pack_rows=128, stream_readback_window=2)
    one = SearchEngine(db, cfg, device="cpu")
    dist = DistributedSearchEngine(db, cfg, device="cpu")
    assert dist.world_size == 1 and dist.mode == one.mode
    qs = [rng.integers(0, 23, size=m).astype(np.int8)
          for m in (19, 64, 140, 40, 0)]
    _same(one.search(qs[1], "x"), dist.search(qs[1], "x"))
    for a, b in zip(one.search_stream(qs), dist.search_stream(qs)):
        _same(a, b)
    many = dist.search_many(qs)
    for a, b in zip(one.search_many(qs), many):
        _same(a, b)
        assert b.batch_n == len(qs)
    assert many[1].stats is not None       # tail-calibrated fit
    assert dist.metrics.count("search_batch") == 1
    np.testing.assert_array_equal(dist.ids_flat, one.ids_flat)
    if mode == "host_stream":
        with pytest.raises(ValueError, match="host_stream"):
            dist.score_all(qs[0])
    else:
        assert torch.equal(dist.score_all(qs[0]), one.score_all(qs[0]))
    assert dist.warmup(32, log=lambda s: None) == []
    aln = dist.align(qs[1], many[1])
    assert [a.score for a in aln] == many[1].scores.tolist()


def _score_rows_alive(n_slots):
    """Rows of the int32 [rows, n_slots] tensors alive in the process."""
    return sum(o.shape[0] for o in gc.get_objects()
               if type(o) is torch.Tensor and o.dtype == torch.int32
               and o.dim() == 2 and o.shape[1] == n_slots)


@pytest.mark.parametrize("which", ["single", "dist"])
def test_batch_holds_one_groups_scores_at_a_time(world1, which,
                                                 monkeypatch):
    """A batch of many plan groups keeps one group's scores alive at a
    time, in both engines: when a launch starts, the only score rows alive
    are those its own group launched before it, so a batch's memory does
    not grow with its query count.  The results stay search_stream's."""
    rng = np.random.default_rng(5)
    db = _db(rng, 600, 60)
    cfg = SearchConfig(top=5, batch_query_pack_rows=64)
    one = SearchEngine(db, cfg, device="cpu")
    eng = one if which == "single" else \
        DistributedSearchEngine(db, cfg, device="cpu")
    inner = one if which == "single" else eng.engine
    qs = [rng.integers(0, 23, size=m).astype(np.int8)
          for m in [*rng.integers(10, 60, size=30), 100, 120, 90]]
    plan = batch_plan(cfg, qs)
    assert len(plan) > 8 and len(plan[-1][1]) == 3      # 3 unpacked
    # rows of the group launched before each launch
    before = [sum(1 if segs is None else len(segs)
                  for _, segs in launches[:j])
              for _, launches in plan for j in range(len(launches))]
    alive = []
    launch = inner._launch

    def counted(rows, segs=None):
        alive.append(_score_rows_alive(inner.n_slots))
        return launch(rows, segs)

    monkeypatch.setattr(inner, "_launch", counted)
    got = eng.search_many(qs)
    monkeypatch.setattr(inner, "_launch", launch)
    assert alive == before
    for a, b in zip(one.search_stream(qs), got):
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.seq_ids, b.seq_ids)
        np.testing.assert_allclose(a.evalues, b.evalues, rtol=1e-4)


def test_world1_without_a_process_group_runs_in_process():
    rng = np.random.default_rng(3)
    db = _db(rng, 700, 90)
    q = rng.integers(0, 23, size=30).astype(np.int8)
    dist = DistributedSearchEngine(db, SearchConfig(top=5), device="cpu")
    _same(SearchEngine(db, SearchConfig(top=5), device="cpu").search(q),
          dist.search(q))


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db = _db(np.random.default_rng(0), 50, 20)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DistributedSearchEngine(db)


def test_bad_queries_fail_before_any_search(world1):
    db = _db(np.random.default_rng(0), 300, 40)
    dist = DistributedSearchEngine(db, SearchConfig(max_query_len=50),
                                   device="cpu")
    with pytest.raises(ValueError, match="max_query_len"):
        dist.search_many([np.zeros(60, np.int8), np.zeros(5, np.int8)])
    with pytest.raises(ValueError, match="codes outside"):
        dist.search(np.full(5, 30, np.int8))


@pytest.mark.parametrize("n_groups,world_size,extra,want", [
    (7, 2, None, [(0, 4), (4, 7)]),
    (7, 2, [1], [(0, 3), (3, 7)]),
    (6, 3, None, [(0, 2), (2, 4), (4, 6)]),
    (1, 2, [1], [(0, 0), (0, 1)]),
    (0, 4, None, [(0, 0)] * 4),
])
def test_process_group_slice(n_groups, world_size, extra, want):
    got = [process_group_slice(n_groups, world_size, r, extra)
           for r in range(world_size)]
    assert got == want


@pytest.mark.parametrize("args,msg", [
    ((5, 2, 2), "not in a world"),
    ((5, 0, 0), "world size"),
    ((-1, 2, 0), "group count"),
    ((5, 2, 0, [0, 1]), "extra groups"),
    ((5, 2, 0, [3]), "extra groups"),
])
def test_process_group_slice_raises(args, msg):
    with pytest.raises(ValueError, match=msg):
        process_group_slice(*args)


def test_process_group_slice_raises_under_python_O():
    """The check survives python -O (the reference asserts)."""
    code = ("from oswald_tpu_torch.dist import process_group_slice\n"
            "try:\n    process_group_slice(5, 2, 0, [0, 1])\n"
            "except ValueError:\n    print('raised')\n")
    out = subprocess.run([sys.executable, "-O", "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=TIMEOUT_S,
                         env=_env())
    assert out.stdout.strip() == "raised", out.stderr


def test_shard_bounds_balance_cells():
    """Every bin splits within one group between ranks, contiguously and
    in rank order; leftovers go to the least loaded ranks."""
    db = _db(np.random.default_rng(5), 40000, 400)
    for w in (2, 3, 4):
        bounds = shard_bounds(db, w)
        for L, b in bounds.items():
            G = db.bins[L]["seq"].shape[0]
            assert b[0][0] == 0 and b[-1][1] == G
            assert all(b[r][1] == b[r + 1][0] for r in range(w - 1))
            sizes = [hi - lo for lo, hi in b]
            assert max(sizes) - min(sizes) <= 1
        cells = shard_cells(bounds)
        assert sum(cells) == sum(db.bins[L]["seq"].shape[0] * L * 1024
                                 for L in db.bin_lengths)
        assert max(cells) - min(cells) <= max(db.bin_lengths) * 1024


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def _ranks(mode, tmp_path, world_size=2, **popen):
    init = f"file://{tmp_path}/store-{mode}"
    return [subprocess.Popen(
        [sys.executable, str(WORKER), mode, init, str(world_size), str(r),
         str(tmp_path / f"{mode}{r}.json")], env=_env(), cwd=REPO, **popen)
        for r in range(world_size)]


def _wait(procs, timeout=TIMEOUT_S):
    """Each rank's (exit code, output) within the timeout; a hang kills
    them all and fails."""
    outs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1))
            outs.append((p.returncode, out))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"ranks did not finish within {timeout} s")
    return outs


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results of torch_dist_worker's `search` mode."""
    tmp = tmp_path_factory.mktemp("dist2")
    procs = _ranks("search", tmp, stdout=subprocess.PIPE,
                   stderr=subprocess.STDOUT, text=True)
    for code, out in _wait(procs):
        assert code == 0, out[-3000:]
    return [json.loads((tmp / f"search{r}.json").read_text())
            for r in range(2)]


def _port_single(name):
    db, qs = worker.make_db(name)
    eng = SearchEngine(db, SearchConfig(**worker.CONFIGS[name]),
                       device="cpu")
    return eng, qs


def _check(got, want_results):
    assert len(got) == len(want_results)
    for g, w in zip(got, want_results):
        assert g["scores"] == w.scores.tolist()
        assert g["ids"] == w.seq_ids.tolist()
        np.testing.assert_allclose(g["evalues"], w.evalues, rtol=1e-4)


@pytest.mark.parametrize("name", list(worker.DBS))
def test_two_ranks_equal_the_single_engine(two_ranks, name):
    """Both ranks return the same results, and they equal the port's
    single engine: search, search_many (the packing plan on every rank,
    a leftover query), search_stream and score_all."""
    r0, r1 = two_ranks[0][name], two_ranks[1][name]
    for key in ("search", "many", "stream", "score_all"):
        assert r0.get(key) == r1.get(key), key
    eng, qs = _port_single(name)
    _check(r0["search"], [eng.search(qs[0])])
    _check(r0["many"], eng.search_many(qs))
    _check(r0["stream"], eng.search_stream(qs))
    if "score_all" in r0:
        assert r0["score_all"] == eng.score_all(qs[1]).tolist()
    assert r0["slots"] + r1["slots"] == eng.n_slots


def test_two_ranks_stream_several_slices_per_bin(two_ranks):
    """The host_stream database has one bin, and each rank streams its
    share of it in more than one slice."""
    for r in two_ranks:
        rec = r["slices"]
        assert rec["mode"] == "host_stream"
        assert rec["bins"] == 1 and rec["slices"] >= 2


def test_top_larger_than_a_ranks_slots(two_ranks):
    """One group: rank 1 owns no slot, top 50 > nothing; the merge still
    gives the exact global top-k."""
    assert two_ranks[1]["one_group"]["slots"] == 0
    assert len(two_ranks[0]["one_group"]["search"][0]["scores"]) == 50


@pytest.mark.parametrize("name", ["mixed", "one_group"])
def test_two_ranks_equal_the_reference_mesh(two_ranks, name):
    """Scores and ids equal oswald_tpu's DistributedSearchEngine on a
    two-device slice of the virtual CPU mesh (Pallas in interpret mode)."""
    seed, n, lo, hi = worker.DBS[name]
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi, size=n)
    flat = rng.integers(0, 20, size=int(lengths.sum())).astype(np.int8)
    jdb = jax_pack(flat, lengths, [f"{name}{i}" for i in range(n)])
    qs = [rng.integers(0, 20, size=m).astype(np.int8)
          for m in worker.QUERY_LENGTHS[name]]
    cfg = dict(worker.CONFIGS[name])
    ref = JaxDist(jdb, JaxConfig(**cfg), mesh=make_device_mesh(2))
    got = two_ranks[0][name]
    for g, w in zip(got["many"], ref.search_many(qs)):
        assert g["scores"] == np.asarray(w.scores).tolist()
        assert g["ids"] == np.asarray(w.seq_ids).tolist()
    w = ref.search(qs[0])
    assert got["search"][0]["scores"] == np.asarray(w.scores).tolist()
    assert got["search"][0]["ids"] == np.asarray(w.seq_ids).tolist()


def _read_until(proc, marker, timeout):
    """Lines of proc's stdout up to the one holding `marker`."""
    deadline = time.monotonic() + timeout
    lines = []
    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 0.5)
        if ready:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if marker in line:
                return lines
        elif proc.poll() is not None:
            break
    raise AssertionError(f"no {marker!r} within {timeout} s: "
                         f"{''.join(lines)[-2000:]}")


def test_pod_serving_two_ranks(tmp_path):
    """Rank 0 serves HTTP, rank 1 mirrors every dispatch; /search equals
    the single engine, and an interrupt of rank 0 drains, releases rank 1
    and both exit 0."""
    procs = _ranks("pod", tmp_path, stdout=subprocess.PIPE,
                   stderr=subprocess.STDOUT, text=True)
    try:
        lines = _read_until(procs[0], "[pod: 2 ranks]", TIMEOUT_S)
        base = lines[-1].split(" at ")[1].split()[0]
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.load(r)["status"] == "ok"
        eng, qs = _port_single("mixed")
        body = json.dumps({"queries": [decode(q) for q in qs[:2]]}).encode()
        req = urllib.request.Request(base + "/search", data=body, headers={
            "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.load(r)["results"]
        for g, w in zip(got, eng.search_many(qs[:2])):
            assert [h["score"] for h in g["hits"]] == w.scores.tolist()
            assert [h["id"] for h in g["hits"]] == w.seq_ids.tolist()
        procs[0].send_signal(signal.SIGINT)
        outs = _wait(procs, 60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [code for code, _ in outs] == [0, 0], outs
    assert "exiting after 2 queries" in outs[1][1]
