"""The port's hardware parity gate (oswald_tpu_torch.utils.parity) on the
CPU: at the reference's test size it passes all 24 checks, it draws the
reference's inputs in the reference's order (replayed here from the
reference's numpy rng sequence, oswald_tpu/utils/parity.py:55-105), and a
seeded fault in the engine fails it: a score one off in one slot, and two
ids swapped in a packed batch.  Its entry exits 0 when the gate passes and
1 when it fails, and with no device named it needs CUDA."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from oswald_tpu.core import sw_score_diag_batch as jax_diag_batch
from oswald_tpu.utils.parity import _oracle_layout as jax_layout
import oswald_tpu_torch.core
from oswald_tpu_torch.engine import SearchEngine
from oswald_tpu_torch.submat import get_submat
from oswald_tpu_torch.utils import parity

REPO = Path(__file__).resolve().parents[1]
# the reference's count at these arguments is 24 checks; SEED is
# run_parity's default, which the entry uses
N, LMAX, SEED, TITIN = 64, 120, 7, 2
# the smallest run, for the seeded faults
SMALL = dict(n=8, lmax=12, titin_sample=1, device="cpu")
QLENS = (64, 65, 512, 5478)
PACKED_QLENS = (40, 64, 55, 128, 100, 61, 200, 90)
GAPS = (("blosum62", 10, 2), ("pam30", 7, 1))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def recorded():
    """One run of the entry at the test size, with the oracle and
    search_many wrapped to record what they receive: (exit code, stdout
    lines, oracle calls, packed batches)."""
    import contextlib
    import io
    calls, batches = [], []
    oracle = oswald_tpu_torch.core.sw_score_diag_batch
    many = SearchEngine.search_many

    def oracle_rec(q, bs, n_bs, sm, og, eg):
        out = oracle(q, bs, n_bs, sm, og, eg)
        calls.append((np.asarray(q).copy(), bs.cpu().numpy(),
                      n_bs.cpu().numpy(), np.asarray(sm), og, eg,
                      out.cpu().numpy()))
        return out

    def many_rec(self, queries, *args, **kwargs):
        batches.append([np.asarray(q).copy() for q in queries])
        return many(self, queries, *args, **kwargs)

    stdout = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(stdout):
        mp.setattr(oswald_tpu_torch.core, "sw_score_diag_batch", oracle_rec)
        mp.setattr(SearchEngine, "search_many", many_rec)
        rc = parity.main(["--device", "cpu", "--n", str(N), "--lmax",
                          str(LMAX), "--titin-sample", str(TITIN)])
    return rc, stdout.getvalue().splitlines(), calls, batches


def _replay(n, lmax, seed, titin_sample):
    """The reference's draws, in its order: the database, then per matrix
    each query (and, for the titin length, its sample), then the 8 packed
    queries.  Returns (seqs, lengths, [(query, sample)], [packed batch])."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, lmax, size=n)
    seqs = [rng.integers(0, 23, int(l)).astype(np.int8) for l in lengths]
    checks, batches = [], []
    for _ in GAPS:
        for qlen in QLENS:
            q = rng.integers(0, 23, size=qlen).astype(np.int8)
            sample = (rng.choice(n, size=titin_sample, replace=False)
                      if qlen > 2048 else np.arange(n))
            checks.append((q, sample))
        batches.append([rng.integers(0, 23, size=int(l)).astype(np.int8)
                        for l in PACKED_QLENS])
    return seqs, lengths, checks, batches


def test_run_parity_passes_on_the_cpu(recorded):
    """The entry exits 0; its result is the reference's: 24 checks, ok."""
    rc, lines, calls, _ = recorded
    assert rc == 0
    assert lines[-1] == "ALL PARITY CHECKS PASSED on cpu"
    out = json.loads(lines[-2])
    assert out["parity"] == "ok" and "failures" not in out
    assert out["checks"] == 24
    assert out["backend"] == "cpu"
    assert sum("EXACT" in l for l in lines) == 10
    assert len(calls) == 2 * len(QLENS)


def test_draws_are_the_references(recorded):
    """Every query, sample and packed batch the gate used is the one the
    reference's rng sequence gives at the same seed."""
    _, _, calls, batches = recorded
    seqs, lengths, checks, want_batches = _replay(N, LMAX, SEED, TITIN)
    bs, ns = jax_layout(seqs, lengths)
    gaps = [g for g in GAPS for _ in QLENS]
    for (q, got_bs, got_ns, sm, og, eg, _), (wq, sample), (mat, wog, weg) \
            in zip(calls, checks, gaps):
        np.testing.assert_array_equal(q, wq.astype(np.int32))
        np.testing.assert_array_equal(got_bs, bs[sample])
        np.testing.assert_array_equal(got_ns, ns[sample])
        np.testing.assert_array_equal(sm, get_submat(mat))
        assert (og, eg) == (wog, weg)
    assert len(batches) == len(want_batches)
    for got, want in zip(batches, want_batches):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_oracle_on_a_drawn_query_equals_jax(recorded):
    """The port's CPU oracle scores on the pam30 65-residue check equal
    the JAX package's on the same inputs."""
    _, _, calls, _ = recorded
    q, bs, ns, sm, og, eg, got = calls[len(QLENS) + 1]
    assert (q.size, og, eg) == (65, 7, 1)
    want = np.asarray(jax_diag_batch(q, bs, ns, sm, og, eg))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# the module run as `python -m` (runpy, as -m runs it) with score_all one
# higher in one valid slot
_OFF_BY_ONE = """
import runpy, sys
from oswald_tpu_torch.engine import SearchEngine
score_all = SearchEngine.score_all

def off_by_one(self, query):
    scores = score_all(self, query).clone()
    scores[self.valid.nonzero()[SLOT, 0]] += 1
    return scores

SearchEngine.score_all = off_by_one
sys.argv = ["parity"] + sys.argv[1:]
runpy.run_module("oswald_tpu_torch.utils.parity", run_name="__main__")
"""


def test_a_score_off_by_one_fails_the_gate(tmp_path):
    """score_all one higher in one valid slot: the module's entry exits 1,
    and its result names that slot, with got = want + 1, in each check of
    the whole database."""
    slot = 5
    env = dict(os.environ, OMP_NUM_THREADS="1",
               XDG_CACHE_HOME=str(tmp_path / "xdg"))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run(
        [sys.executable, "-c", _OFF_BY_ONE.replace("SLOT", str(slot)),
         "--device", "cpu", "--n", str(SMALL["n"]), "--lmax",
         str(SMALL["lmax"]), "--titin-sample", str(SMALL["titin_sample"])],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr
    lines = proc.stdout.splitlines()
    assert not any("ALL PARITY CHECKS PASSED" in l for l in lines)
    out = json.loads(lines[-1])
    assert out["parity"] == "FAIL" and out["checks"] == 24
    scored = [f for f in out["failures"] if f["check"].split(":")[1]
              in ("64", "65", "512")]
    assert [f["check"] for f in scored] == [
        f"{m}:{q}" for m, _, _ in GAPS for q in (64, 65, 512)]
    for f in scored:
        assert f["slots"] == [slot]
        assert f["got"][0] == f["want"][0] + 1
    assert sum("MISMATCH" in l for l in lines) >= 6


def test_swapped_ids_in_a_packed_batch_fail_the_gate(monkeypatch):
    """search_many with the first query's two best ids swapped: the packed
    check of each matrix fails, and only it."""
    many = SearchEngine.search_many

    def swapped(self, *args, **kwargs):
        out = many(self, *args, **kwargs)
        ids = np.array(out[0].seq_ids)
        ids[[0, 1]] = ids[[1, 0]]
        out[0].seq_ids = ids
        return out

    monkeypatch.setattr(SearchEngine, "search_many", swapped)
    out = parity.run_parity(**SMALL)
    assert out["parity"] == "FAIL" and out["checks"] == 24
    assert [f["check"] for f in out["failures"]] == [
        f"{m}:packed" for m, _, _ in GAPS]


def test_no_device_needs_cuda(monkeypatch):
    """With no device named the engine runs on CUDA; without CUDA the gate
    raises instead of certifying the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parity.run_parity()
