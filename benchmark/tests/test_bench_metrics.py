"""Each metric's arithmetic on a synthetic trace and synthetic counters,
the union of device intervals included."""

import json

import pytest

from conftest import ROOT
from perfkit import bound, trace
from perfkit.harness import Context
from perfkit.spec import Spec


def test_union_and_gaps():
    merged = trace.union([(5, 7), (0, 2), (1, 3), (6, 9), (9, 10)])
    assert merged == [(0, 3), (5, 10)]
    assert trace.gaps(merged, -1, 12) == [(-1, 0), (3, 5), (10, 12)]
    assert trace.clip(merged, 2, 6) == [(2, 3), (5, 6)]


def _events():
    k = lambda ts, dur, name="sw_groups_kernel": {  # noqa: E731
        "ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}
    return [
        k(100, 300), k(200, 300, "topk"),       # overlap: busy 100..500
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 600,
         "dur": 100},                          # 600..700
        k(900, 200),                           # 900..1100, clipped at 1000
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0,
         "dur": 5000},                         # host work: never busy
    ]


def test_reduce_trace_busy_and_named_gaps():
    spans = [("search_many", 60, 800), ("search_many", 850, 1000)]
    s = trace.reduce_trace(_events(), 0, 1000, spans)
    assert s["window_s"] == pytest.approx(1000e-6)
    # union: 100..500, 600..700, 900..1000
    assert s["busy_s"] == pytest.approx(600e-6)
    ops = dict(s["device_ops"])
    assert ops["sw_groups_kernel"] == pytest.approx(400e-6)
    assert ops["topk"] == pytest.approx(300e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps["outside any call after window start"] == pytest.approx(
        100e-6)                                # 0..100
    assert gaps["search_many after topk"] == pytest.approx(100e-6)
    assert gaps["search_many after Memcpy DtoH"] == pytest.approx(200e-6)
    assert sum(gaps.values()) == pytest.approx(400e-6)


def test_tracer_counts_query_residues_of_searches_alone(tmp_path):
    """An align span inside the traced window names the idle gap it holds
    and adds nothing to the query residues the rooflines read."""
    spans = trace.Spans()
    tr = trace.Tracer(str(tmp_path), spans)
    tr._c_start = 1_000_000.0                  # ns: 1000 us on the trace
    clock = {"ph": "X", "cat": "user_annotation", "name": "bench.clock",
             "dur": 1}

    class Profile:
        def export_chrome_trace(self, path):
            with open(path, "w") as fh:
                json.dump({"traceEvents": [
                    dict(clock, ts=1000), dict(clock, ts=2000),
                    {"ph": "X", "cat": "kernel", "name": "sw_groups_kernel",
                     "ts": 1100, "dur": 400}]}, fh)
    tr._prof = Profile()
    spans.add("search_many", 1_050_000, 1_550_000, 700)
    spans.add("align", 1_560_000, 1_990_000, 5)
    s = tr.finish()
    assert s["query_residues"] == 700
    assert s["busy_s"] == pytest.approx(400e-6)
    assert dict(s["idle_gaps"])["align after sw_groups_kernel"] == \
        pytest.approx(500e-6)


def _readers():
    spec = Spec(ROOT)
    return {m["name"]: spec.reader(m["name"])
            for m in spec.doc["end_to_end"] + spec.doc["per_layer"]}


def test_every_metric_has_a_reader():
    doc = Spec(ROOT).doc
    readers = _readers()
    assert len(readers) == len(doc["end_to_end"]) + len(doc["per_layer"])
    assert all(callable(r) for r in readers.values())


def test_a_split_metric_reads_its_own_file_first(tmp_path):
    bench = tmp_path / "benchmark"
    (bench / "metrics").mkdir(parents=True)
    (tmp_path / "BENCHMARK.json").write_text('{"paths": ["benchmark"]}')
    (bench / "metrics" / "q.py").write_text("def read(ctx):\n    return 1\n")
    (bench / "metrics" / "q.own.py").write_text(
        "def read(ctx):\n    return 2\n")
    spec = Spec(str(tmp_path))
    assert spec.reader("q.other")(None) == 1
    assert spec.reader("q.own")(None) == 2
    with pytest.raises(FileNotFoundError):
        spec.reader("nothing.here")


def test_metric_arithmetic():
    r = _readers()
    db = 191_722_906
    tr = {"window_s": 2.0, "busy_s": 1.5, "query_residues": 20_000}
    batch = Context("batch", setup_s=12.5, window_s=4.0,
                    query_residues=41_752, db_residues=db, trace=tr)
    assert r["gcups"](batch) == pytest.approx(41_752 * db / 4.0 / 1e9)
    assert r["setup_s"](batch) == 12.5
    cells_s = bound.bound_seconds(20_000, db)
    assert r["sw_kernels_roofline.batch"](batch) == pytest.approx(
        100 * cells_s / 1.5)
    assert r["step_mfu.batch"](batch) == pytest.approx(100 * cells_s / 2.0)
    assert r["device.idle_pct.batch"](batch) == pytest.approx(25.0)
    for kind in ("batch", "peptides"):
        assert r[f"sw_kernels_roofline.{kind}"](batch) == pytest.approx(
            100 * cells_s / 1.5)
    assert r["gcups.peptides"](batch) == r["gcups"](batch)
    for name in ("latency_p95_ms", "serve.queries_per_dispatch"):
        assert r[name](batch) is None
    # a split reads with its quantity's reader; its cells are its workloads
    for q in ("sw_kernels_roofline", "step_mfu", "device.idle_pct"):
        assert r[f"{q}.serve"](batch) == r[f"{q}.peptides"](batch) == \
            r[f"{q}.batch"](batch)
    lat = [float(i) for i in range(1, 101)]
    serve = Context("serve", setup_s=1.0, window_s=30.0, query_residues=5,
                    db_residues=db, latencies_ms=lat, trace=tr,
                    health=({"queries": 10, "dispatches": 4, "busy_s": 1.0},
                            {"queries": 110, "dispatches": 24,
                             "busy_s": 16.0}, 30.0))
    assert r["latency_p95_ms"](serve) == 95.0
    assert r["latency_p50_ms"](serve) == 50.0
    assert r["serve.queries_per_dispatch"](serve) == 5.0
    assert r["engine.busy_pct.serve"](serve) == pytest.approx(50.0)
    assert r["device.idle_pct.serve"](serve) == pytest.approx(25.0)
    assert r["gcups"](serve) is None
    # nothing to read: no metric, never 0
    empty = Context("batch", 1.0, 1.0, 0, db,
                    trace={"window_s": 1.0, "busy_s": 0.0,
                           "query_residues": 0})
    assert r["sw_kernels_roofline.batch"](empty) is None
    assert r["step_mfu.batch"](empty) is None
