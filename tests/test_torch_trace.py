"""The port's spans and counters on the CPU: the engine's phases inside
search_many (ENGINE_PHASES), the service's queue waits and dispatch spans,
the process-wide totals, and the ranges they leave in a profiler trace.

The spans must cover search_many's time (at least 95% of it), be recorded
once a call, a group or a readback window, cost no record_function while
no profiler records, and under `profile_trace` appear as ranges of the
same names, in order, each engine range inside its dispatch or call, with
the serve.dispatch ranges carrying the requests' ids and queue waits.
"""

import gc
import glob
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from oswald_tpu_torch.engine import SearchConfig, SearchEngine
from oswald_tpu_torch.engine.search import ENGINE_PHASES, batch_plan
from oswald_tpu_torch.io import pack_sequences
from oswald_tpu_torch.serve import SearchService
from oswald_tpu_torch.utils.metrics import (Metrics, process_metrics,
                                            profile_trace)

from conftest import random_protein

# query lengths of one call: with 64-row bins, 40, 9 and 7 pack into one
# launch, 30 into another, and 100 runs unpacked: three groups
LENGTHS = (9, 30, 100, 40, 7)
HOLD_S = 0.3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def db():
    rng = np.random.default_rng(11)
    lengths = rng.integers(5, 120, size=240)
    return pack_sequences(
        np.concatenate([random_protein(rng, int(n)) for n in lengths]),
        lengths, [f"t{i}" for i in range(240)])


def _config(**kw):
    return SearchConfig(top=4, batch_query_pack_rows=64,
                        stream_readback_window=2, **kw)


@pytest.fixture(scope="module")
def engine(db):
    return SearchEngine(db, _config(), device="cpu")


def _queries(seed=3, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    return [random_protein(rng, n) for n in lengths]


def _counts(m):
    return {n: m.count(n) for n in ENGINE_PHASES}


def _totals(m):
    return {n: m.total(n) for n in ENGINE_PHASES}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("path", ["batched", "stream", "host_stream"])
def test_engine_spans_per_call_cover_the_call(db, engine, path):
    """Spans a call: engine.plan once, and once a group (batched) or a
    readback window (stream) each of launch, readback and results; under
    host_stream one launch (the sweep) and no readback.  Together they
    cover at least 95% of search_batch (batched) or of the call."""
    if path == "host_stream":
        engine = SearchEngine(db, _config(profile_mode="host_stream",
                                          host_stream_slice_mb=1),
                              device="cpu")
    qs = _queries()
    n_groups = len(batch_plan(engine.config, qs))
    m = engine.metrics
    c0, t0, b0 = _counts(m), _totals(m), m.total("search_batch")
    gc.disable()            # a collection between spans is not the code's
    try:
        w0 = time.perf_counter()
        engine.search_many(qs, batch=path != "stream")
        wall = time.perf_counter() - w0
    finally:
        gc.enable()
    counts, spent = _delta(_counts(m), c0), _delta(_totals(m), t0)
    if path == "batched":
        assert n_groups == 3 and counts == {
            "engine.plan": 1, "engine.launch": n_groups,
            "engine.readback": n_groups, "engine.results": n_groups}
    elif path == "stream":
        windows = -(-len(qs) // 2)
        assert counts == {"engine.plan": 1, "engine.launch": windows,
                          "engine.readback": windows,
                          "engine.results": windows}
    else:
        assert counts == {"engine.plan": 1, "engine.launch": 1,
                          "engine.readback": 0, "engine.results": n_groups}
    whole = wall if path == "stream" else m.total("search_batch") - b0
    assert whole <= wall
    assert 0.95 * whole <= sum(spent.values()) <= whole


def test_process_totals_outlive_the_engine(db):
    p = process_metrics()
    before = _counts(p)
    eng = SearchEngine(db, _config(), device="cpu")
    eng.search_many(_queries())
    mine = _counts(eng.metrics)
    del eng
    gc.collect()
    got = _delta(_counts(p), before)
    assert got == mine and got["engine.launch"] == 3


def test_no_record_function_without_a_profiler(db, engine, monkeypatch):
    """With no profiler recording, no span enters record_function: the
    engine's, on both paths, and the service's.  Under a profiler the same
    calls reach it."""
    def refuse(*a, **k):
        raise RuntimeError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    qs = _queries()
    engine.search_many(qs)
    engine.search_many(qs, batch=False)
    service = SearchService(db, engine)
    try:
        out = service.search({"queries": ["MKVLATGHWA", "PEPTIDEK"]})
        assert len(out["results"]) == 2
    finally:
        service.close()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="record_function entered"):
            engine.search_many(qs)


def _ranges(trace_dir):
    (path,) = glob.glob(f"{trace_dir}/trace.*.json")
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e["name"].split(".")[0] in ("engine", "serve")),
                  key=lambda e: e["ts"])


def _inside(e, outer):
    return outer["ts"] <= e["ts"] and \
        e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


def test_profile_trace_holds_engine_ranges_in_order(engine, tmp_path):
    qs = _queries()
    with profile_trace(str(tmp_path)):
        engine.search_many(qs)
    got = _ranges(tmp_path)
    n = len(batch_plan(engine.config, qs))
    assert [e["name"] for e in got] == \
        ["engine.plan"] + ["engine.launch"] * n + \
        ["engine.readback", "engine.results"] * n
    launches = [e["args"] for e in got if e["name"] == "engine.launch"]
    assert sum(a["queries"] for a in launches) == len(qs)
    assert sum(a["residues"] for a in launches) == sum(LENGTHS)


def test_engine_launch_args_name_the_split(db, engine, tmp_path):
    """Each engine.launch range says whether its launches split slabs
    over clusters: the cluster size of the engine's work table and its
    split slabs, resident and across a host_stream sweep's slices."""
    hs = SearchEngine(db, _config(profile_mode="host_stream",
                                  host_stream_slice_mb=1), device="cpu")
    for eng, tables in ((engine, [engine.state.work]),
                        (hs, [sl.work for sl in hs._hs_slices])):
        with profile_trace(str(tmp_path / eng.mode)):
            eng.search_many(_queries())
        got = [e["args"] for e in _ranges(tmp_path / eng.mode)
               if e["name"] == "engine.launch"]
        assert got and all(
            a["cluster"] == max(t.cluster for t in tables) and
            a["split_slabs"] == sum(t.split_slabs for t in tables)
            for a in got)


def test_profile_trace_holds_serve_dispatch_ranges(db, engine, tmp_path):
    """Each serve.dispatch range carries its request's id and queue wait,
    and holds the engine's four ranges in order; serve.wait ranges lie
    between dispatches."""
    class Traced(SearchService):
        """The dispatcher under profile_trace from its start to its close:
        the profiler records the thread that starts it."""

        def _drain_loop(self):
            with profile_trace(str(tmp_path)):
                super()._drain_loop()

    service = Traced(db, engine)
    try:
        for q in ("MKVLATGHWA", "PEPTIDEKR", "WWYYHHKKLL"):
            service.search({"query": q})
    finally:
        service.close()
    got = _ranges(tmp_path)
    dispatches = [e for e in got if e["name"] == "serve.dispatch"]
    assert [d["args"]["ids"] for d in dispatches] == [[0], [1], [2]]
    for d in dispatches:
        (wait_ms,) = d["args"]["wait_ms"]
        assert 0 <= wait_ms < 60e3
        inner = [e["name"] for e in got
                 if e is not d and _inside(e, d)]
        assert inner == list(ENGINE_PHASES)
    waits = [e for e in got if e["name"] == "serve.wait"]
    assert waits and not any(_inside(w, d) for w in waits
                             for d in dispatches)


def _gate(engine, fail_coalesced):
    """search_many held at its first call until `release` is set; with
    fail_coalesced, every call of more than one query raises."""
    calls, release = [], threading.Event()
    real = engine.search_many

    def gated(queries, titles=None, batch=True):
        calls.append(len(queries))
        if len(calls) == 1:
            assert release.wait(timeout=60)
        if fail_coalesced and len(queries) > 1:
            raise RuntimeError("coalesced batch refused")
        return real(queries, titles, batch)
    return gated, calls, release


@pytest.mark.parametrize("fail_coalesced", [False, True])
def test_queue_wait_of_gated_requests(db, engine, fail_coalesced):
    """Three requests queued behind a dispatch held for HOLD_S each wait at
    least that long; every dispatched request counts once in `waited`,
    also when its coalesced batch fails and it is retried alone."""
    service = SearchService(db, engine)
    real = engine.search_many
    engine.search_many, calls, release = _gate(engine, fail_coalesced)
    h0 = service.health()
    try:
        threads = [threading.Thread(target=service.search,
                                    args=({"query": "MKVLATGHWA"},))]
        threads[0].start()
        for _ in range(600):
            if calls:
                break
            time.sleep(0.01)
        assert calls, "the dispatcher never took the first request"
        for q in ("PEPTIDEKR", "WWYYHHKKLL", "ACDEFGHIK"):
            threads.append(threading.Thread(target=service.search,
                                            args=({"query": q},)))
            threads[-1].start()
        for _ in range(600):
            with service._cv:
                if len(service._queue) == 3:
                    break
            time.sleep(0.01)
        time.sleep(HOLD_S)
        release.set()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        release.set()
        engine.search_many = real
        h1 = service.health()
        service.close()
    assert calls == ([1, 3, 1, 1, 1] if fail_coalesced else [1, 3])
    assert h1["waited"] - h0["waited"] == 4
    assert h1["queue_wait_s"] - h0["queue_wait_s"] >= 3 * HOLD_S
    assert service.metrics.count("serve.dispatch") == len(calls)
    assert set(h1["phases"]) == set(ENGINE_PHASES)
    assert h1["phases"]["engine.launch"] > h0["phases"]["engine.launch"]


def test_metrics_lose_no_update_across_threads():
    """Adds from more threads than cores, switching every microsecond:
    every add lands in the totals and in the process-wide totals."""
    m, p = Metrics(), process_metrics()
    before = p.count("trace.test_add")
    n_threads, n_adds = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            m.add("trace.test_add", 1.0) for _ in range(n_adds)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert m.count("trace.test_add") == n_threads * n_adds
    assert m.total("trace.test_add") == float(n_threads * n_adds)
    assert p.count("trace.test_add") - before == n_threads * n_adds
