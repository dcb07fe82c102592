"""A run with the timed path broken underneath must come out not correct:
the harness's look for a card is skipped and the rest of a run is driven
on the CPU at a tiny size, once for each fault a cell can have (one card:
there is no exchange between cards to leave out)."""

import pytest
import torch

import control
from oswald_tpu_torch.engine import search as engine_search
from oswald_tpu_torch import serve as port_serve
from perfkit import harness

BATCH = "swissprot-blosum62.batch20"
SERVE = "swissprot-blosum62.serve-poisson"


def _stale(monkeypatch):
    """A step that returns its state unchanged: every call answers with
    the call before's results."""
    real = engine_search.SearchEngine.search_many
    last = {}

    def search_many(self, queries, titles=None, batch=True):
        out = last.get("res")
        last["res"] = real(self, queries, titles, batch)
        return out if out is not None else last["res"]
    monkeypatch.setattr(engine_search.SearchEngine, "search_many",
                        search_many)


def _half_batch(monkeypatch):
    """Half of the batch left out: the second half gets the first half's
    answers."""
    real = engine_search.SearchEngine.search_many

    def search_many(self, queries, titles=None, batch=True):
        h = max(1, len(queries) // 2)
        res = real(self, queries[:h], (titles or [])[:h] or None, batch)
        return (res * 2)[:len(queries)]
    monkeypatch.setattr(engine_search.SearchEngine, "search_many",
                        search_many)


def _half_mean(monkeypatch):
    """The moments (and so the E-values) taken over half of the database."""
    real = engine_search._score_sums

    def score_sums(scores, valid, lnl):
        live = torch.nonzero(valid).reshape(-1)
        half = valid.clone()
        half[live[live.numel() // 2:]] = False
        return real(scores, half, lnl)
    monkeypatch.setattr(engine_search, "_score_sums", score_sums)


def _altered_score(monkeypatch):
    """An answer altered where it is produced: the kernels' first score
    row comes out one higher."""
    for name in ("sw_groups", "sw_groups_packed"):
        real = getattr(engine_search, name)

        def plus_one(*a, _real=real, **k):
            out = _real(*a, **k)
            flat = out.reshape(-1, out.shape[-1]) if out.dim() > 1 else \
                out.reshape(1, -1)
            flat[0] += 1
            return out
        monkeypatch.setattr(engine_search, name, plus_one)


def _sliced_wrong(monkeypatch):
    """A coalesced dispatch sliced back to the wrong requests."""
    real = port_serve.SearchService._drain_loop

    def drain(self):
        inner = self.engine.search_many

        def reversed_many(queries, titles=None, batch=True):
            return inner(queries, titles, batch)[::-1]
        self.engine = type("E", (), {"__getattr__": lambda s, n: getattr(
            inner.__self__, n), "search_many": staticmethod(
                reversed_many)})()
        return real(self)
    monkeypatch.setattr(port_serve.SearchService, "_drain_loop", drain)


@pytest.mark.parametrize("workload, fault", [
    (BATCH, _stale), (BATCH, _half_batch), (BATCH, _half_mean),
    (BATCH, _altered_score), (SERVE, _stale), (SERVE, _sliced_wrong),
])
def test_fault_is_not_correct(tiny_root, monkeypatch, workload, fault):
    fault(monkeypatch)
    out = harness.run_cell(tiny_root, workload, 11, 1.0, 0, "cpu")
    assert out["correct"] is False
    bad = [k for k, c in out["checks"].items() if c["value"] > c["limit"]]
    assert bad, out["checks"]


@pytest.mark.parametrize("workload", [
    BATCH, SERVE, "swissprot-pam30-short.batch-peptides"])
def test_control_is_not_correct(tiny_root, workload):
    """The control in the program's place, judged by the run's comparison
    with the mix's limits, comes out not correct at the tiny size."""
    out = control.readings(tiny_root, workload, 2**31 + 3, 1.0, 1, "cpu")
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["evalue_log_gap"]["value"] > \
        out["checks"]["evalue_log_gap"]["limit"]


def test_sound_run_is_correct(tiny_root):
    out = harness.run_cell(tiny_root, BATCH, 11, 1.0, 0, "cpu")
    assert out["correct"] is True, out["checks"]
