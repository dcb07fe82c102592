"""A run with the timed path broken underneath must come out not correct:
the harness's look for a card is skipped and the rest of a run is driven
on the CPU at a tiny size, once for each fault a cell can have (one card:
there is no exchange between cards to leave out); for a configuration
that returns alignments, once for each way an alignment can be wrong, and
once with a traceback too slow for the window."""

import dataclasses
import time

import pytest
import torch

import control
from conftest import add_align_cell, make_tiny_root
from oswald_tpu_torch.engine import search as engine_search
from oswald_tpu_torch import serve as port_serve
from perfkit import harness
from perfkit import system as sut

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


# --- alignments ---------------------------------------------------------
def _first_aligned(edit):
    """A fault that edits, in every align call, the first alignment that
    has a column (every other hit's alignment is the port's own)."""
    def fault(monkeypatch):
        real = engine_search.SearchEngine.align

        def align(self, query, result):
            alns = real(self, query, result)
            for h, a in enumerate(alns):
                if a.length:
                    alns[h] = edit(a)
                    break
            return alns
        monkeypatch.setattr(engine_search.SearchEngine, "align", align)
    fault.__name__ = edit.__name__
    return fault


@_first_aligned
def _residue_changed(a):
    """One residue of s_aln changed (its first column is never a gap)."""
    c = "W" if a.s_aln[0] != "W" else "C"
    return dataclasses.replace(a, s_aln=c + a.s_aln[1:])


@_first_aligned
def _last_column_trimmed(a):
    """The last column (an aligned pair in a local alignment) taken off,
    the coordinates and counts kept true to the rest: only the score, now
    lower, gives it away."""
    mid = a.midline[-1]
    return dataclasses.replace(
        a, q_aln=a.q_aln[:-1], s_aln=a.s_aln[:-1], midline=a.midline[:-1],
        q_end=a.q_end - 1, s_end=a.s_end - 1,
        identities=a.identities - (mid == "|"),
        positives=a.positives - (mid in "|+"))


@_first_aligned
def _subject_shifted(a):
    return dataclasses.replace(a, s_start=a.s_start + 1)


@_first_aligned
def _identities_plus_one(a):
    return dataclasses.replace(a, identities=a.identities + 1)


def _alignment_left_out(monkeypatch):
    """One hit's alignment left out: the last hit of each query has
    none."""
    real = engine_search.SearchEngine.align

    def align(self, query, result):
        return real(self, query, result)[:-1]
    monkeypatch.setattr(engine_search.SearchEngine, "align", align)


@pytest.mark.parametrize("traffic", ["batch20", "serve-poisson"])
@pytest.mark.parametrize("fault", [
    _residue_changed, _last_column_trimmed, _subject_shifted,
    _identities_plus_one, _alignment_left_out])
def test_alignment_fault_is_not_correct(tmp_path, monkeypatch, traffic,
                                        fault):
    root = make_tiny_root(tmp_path)
    cell = add_align_cell(root, traffic)
    fault(monkeypatch)
    out = harness.run_cell(root, cell, 13, 1.0, 0, "cpu")
    assert out["correct"] is False
    checks = {k: c["value"] for k, c in out["checks"].items()}
    assert checks.pop("alignment_mismatch") > 0
    assert checks.pop("evalue_log_gap") <= \
        out["checks"]["evalue_log_gap"]["limit"]
    assert set(checks.values()) == {0}, out["checks"]


@pytest.mark.parametrize("traffic", ["batch20", "serve-poisson"])
def test_sound_alignments_are_correct(tmp_path, traffic):
    """The port's own host alignments, unchanged, pass, in a traced run
    too (the alignment calls inside the traced part of the window)."""
    root = make_tiny_root(tmp_path)
    cell = add_align_cell(root, traffic)
    out = harness.run_cell(root, cell, 13, 1.0, 1, "cpu")
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["alignment_mismatch"]["value"] == 0
    assert "busy_s" in out["device"]


def test_slow_alignments_end_the_batch_run(tmp_path, monkeypatch):
    """A traceback far too slow for the window: once the window's seconds
    and the wait after it have passed, the batch's remaining queries get
    no alignment request and count as unanswered."""
    root = make_tiny_root(tmp_path)
    cell = add_align_cell(root, "batch20")
    seconds, wait, slow = 0.5, 0.3, 1.0
    monkeypatch.setattr(sut, "WAIT_AFTER_S", wait)
    real_align = engine_search.SearchEngine.align
    real_search = engine_search.SearchEngine.search_many
    searching, aligned = [], []

    def align(self, query, result):
        aligned.append(time.perf_counter())
        time.sleep(slow)
        return real_align(self, query, result)

    def search_many(self, *a, **k):
        t = time.perf_counter()
        try:
            return real_search(self, *a, **k)
        finally:
            searching.append(time.perf_counter() - t)
    monkeypatch.setattr(engine_search.SearchEngine, "align", align)
    monkeypatch.setattr(engine_search.SearchEngine, "search_many",
                        search_many)
    real_window = sut.batch_window
    window = []

    def batch_window(*a, **k):
        window.append(time.perf_counter())
        n = len(searching)
        try:
            return real_window(*a, **k)
        finally:
            window.append(time.perf_counter())
            window.append(sum(searching[n:]))
    monkeypatch.setattr(sut, "batch_window", batch_window)
    out = harness.run_cell(root, cell, 17, seconds, 0, "cpu")
    start, end, window_search = window
    assert end - start <= seconds + wait + slow + window_search + 0.2
    assert out["failed"] > 0
    assert out["checks"]["unanswered"]["value"] == out["failed"]
    # one alignment asked for each answered query, none after the wait
    assert sum(t >= start for t in aligned) == \
        out["attempted"] - out["failed"]
    assert out["correct"] is False
