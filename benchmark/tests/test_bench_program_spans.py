"""The readers of the program's own spans and counters: the service's
queue wait and the engine's host share, on hand-made /healthz pairs and
process-wide totals, on a program that keeps none of them (they read
nothing and raise nothing), and end to end through run_cell at the tiny
size on the CPU."""

import pytest

from conftest import ROOT
from perfkit import harness
from perfkit.harness import Context
from perfkit.spec import Spec

PHASES = ("engine.plan", "engine.launch", "engine.readback",
          "engine.results")
NEW = ("serve.queue_wait_ms", "engine.host_pct.serve",
       "engine.host_pct.peptides")


def _reader(name):
    return Spec(ROOT).reader(name)


def _phases(plan, launch, readback, results):
    return dict(zip(PHASES, (plan, launch, readback, results)))


def _serve(h0, h1):
    return Context("serve", setup_s=1.0, window_s=30.0, query_residues=5,
                   db_residues=1000, latencies_ms=[1.0],
                   health=(h0, h1, 30.0))


def test_every_metric_resolves_to_a_reader():
    spec = Spec(ROOT)
    names = [m["name"] for m in spec.doc["end_to_end"] +
             spec.doc["per_layer"]]
    assert set(NEW) <= set(names)
    for name in names:
        assert callable(spec.reader(name))


def test_queue_wait_reader():
    read = _reader("serve.queue_wait_ms")
    h0 = {"queue_wait_s": 1.5, "waited": 10}
    h1 = {"queue_wait_s": 4.5, "waited": 110}
    assert read(_serve(h0, h1)) == pytest.approx(30.0)
    # nothing dispatched in the window, or counters the service lacks
    assert read(_serve(h1, h1)) is None
    assert read(_serve({"waited": 1}, {"waited": 2})) is None
    assert read(Context("batch", 1.0, 1.0, 1, 1)) is None


def test_host_share_reader_of_the_serve_cell():
    read = _reader("engine.host_pct.serve")
    h0 = {"phases": _phases(1.0, 2.0, 3.0, 4.0)}
    h1 = {"phases": _phases(1.5, 6.0, 8.0, 5.5)}
    # plan 0.5 + results 1.5 of 0.5 + 4 + 5 + 1.5
    assert read(_serve(h0, h1)) == pytest.approx(100 * 2.0 / 11.0)
    assert read(_serve(h1, h1)) is None
    assert read(_serve({"busy_s": 0.0}, {"busy_s": 1.0})) is None
    assert read(Context("batch", 1.0, 1.0, 1, 1)) is None


def test_host_share_reader_of_a_batch_cell(monkeypatch):
    from oswald_tpu_torch.utils import metrics
    read = _reader("engine.host_pct.peptides")
    m = metrics.Metrics()
    for name, s in _phases(0.25, 3.0, 0.5, 1.25).items():
        m.add(name, s)
    monkeypatch.setattr(metrics, "process_metrics", lambda: m)
    batch = Context("batch", 1.0, 1.0, 1, 1)
    assert read(batch) == pytest.approx(100 * 1.5 / 5.0)
    assert read(_serve({}, {})) is None
    monkeypatch.setattr(metrics, "process_metrics", metrics.Metrics)
    assert read(batch) is None
    # a program without process-wide totals
    monkeypatch.delattr(metrics, "process_metrics")
    assert read(batch) is None


@pytest.mark.parametrize("workload, names", [
    ("swissprot-pam30-short.batch-peptides", {"engine.host_pct.peptides"}),
    ("swissprot-blosum62.serve-poisson", {"serve.queue_wait_ms",
                                          "engine.host_pct.serve"}),
])
def test_traced_run_reports_the_program_metrics(tiny_root, workload, names):
    out = harness.run_cell(tiny_root, workload, 2**31 + 9, 1.0, 1, "cpu")
    assert out["correct"] is True, out["checks"]
    got = out["metrics"]
    assert names <= set(got)
    for name in names:
        assert got[name]["value"] >= 0
        assert got[name]["unit"] == ("ms" if name.endswith("_ms") else "%")
    for name in names - {"serve.queue_wait_ms"}:
        assert got[name]["value"] <= 100
