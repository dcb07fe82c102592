"""The harness end to end on the CPU at a tiny size: the result line, the
discovery of cells, mixes and metrics by name, the isolation check, and a
run without a card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, add_align_cell, make_tiny_root
from perfkit import harness

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
# the numbers a cell that returns no alignments compares, in their order
CHECKS = ["unanswered", "echo_mismatch", "hit_order_mismatch",
          "hit_title_mismatch", "hit_score_mismatch", "topk_mismatch",
          "evalue_log_gap"]


@pytest.mark.parametrize("workload, trace", [
    ("swissprot-blosum62.batch20", 0),
    ("swissprot-blosum62.batch20", 1),
    ("swissprot-blosum62.serve-poisson", 0),
    ("swissprot-blosum62.serve-poisson", 1),
    ("swissprot-pam30-short.batch-peptides", 0),
])
def test_result_line(tiny_root, workload, trace):
    out = harness.run_cell(tiny_root, workload, 2**31 + 5, 1.0, trace, "cpu")
    assert list(out)[:5] == LINE_KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert list(out["checks"]) == CHECKS
    assert out["attempted"] > 0 and out["failed"] == 0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    spec = json.load(open(os.path.join(tiny_root, "BENCHMARK.json")))
    group = spec["per_layer" if trace else "end_to_end"]
    want = {m["name"] for m in group
            if workload in m.get("workloads", [workload])}
    got = set(out["metrics"])
    # no card: the device's numbers find nothing to read but the idle share
    # and the whole path's share, which a CPU trace gives as idle
    if trace:
        assert got <= want and "busy_s" in out["device"]
        assert {"device_ops", "idle_gaps"} == set(out["breakdown"])
    else:
        assert got == want
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    json.dumps(out)


def test_added_config_mix_and_metric_need_no_edit(tmp_path):
    root = make_tiny_root(tmp_path)
    bench = os.path.join(root, "benchmark")
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    cfg = json.load(open(os.path.join(bench, "configs",
                                      "swissprot-blosum62.json")))
    cfg.update(name="tiny-gaps11", open_gap=11, extend_gap=1)
    with open(os.path.join(bench, "configs", "tiny-gaps11.json"), "w") \
            as fh:
        json.dump(cfg, fh)
    mix = json.load(open(os.path.join(bench, "traffic", "batch20.json")))
    mix["lengths"]["values"] = [25, 35, 45, 55]
    with open(os.path.join(bench, "traffic", "batch-four.json"), "w") as fh:
        json.dump(mix, fh)
    with open(os.path.join(bench, "metrics", "queries_per_s.py"), "w") as fh:
        fh.write("def read(ctx):\n"
                 "    return ctx.query_residues / ctx.window_s\n")
    spec["configs"].append({"name": "tiny-gaps11", "source": "x",
                            "file": "benchmark/configs/tiny-gaps11.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "tiny-gaps11.batch-four",
                              "config": "tiny-gaps11",
                              "traffic": "batch-four", "chips": 1,
                              "why": "x"})
    spec["end_to_end"].append({"name": "queries_per_s", "unit": "res/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["tiny-gaps11.batch-four"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    out = harness.run_cell(root, "tiny-gaps11.batch-four", 3, 1.0, 0, "cpu")
    assert out["correct"] is True
    assert {"queries_per_s", "setup_s"} == set(out["metrics"])


@pytest.mark.parametrize("traffic", ["batch20", "serve-poisson"])
def test_added_align_config_needs_no_edit(tmp_path, traffic):
    """A configuration with `"align": true` and its cell, added as new
    files and entries, runs under a batch and a serve mix: every hit comes
    with an alignment, and each is judged."""
    root = make_tiny_root(tmp_path)
    cell = add_align_cell(root, traffic)
    out = harness.run_cell(root, cell, 2**31 + 9, 1.0, 0, "cpu")
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out["checks"]) == CHECKS[:5] + ["alignment_mismatch"] + \
        CHECKS[5:]
    assert out["checks"]["alignment_mismatch"] == {"value": 0, "limit": 0}


def test_isolation_check_by_whole_top_level_name(monkeypatch):
    for name in ("jax", "jaxlib", "flax", "oswald_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "oswald_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "oswald_tpu.engine", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax", "oswald_tpu"]


def _run(cwd, *args):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "swissprot-blosum62.batch20", "--seed", "1", "--seconds", "1",
         "--trace", "0", *args], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_fails_and_prints_no_result():
    p = _run(ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_benchmark_alone_fails_and_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.gpu
def test_tiny_run_on_the_card(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = make_tiny_root(tmp_path)
    out = harness.run_cell(root, "swissprot-blosum62.batch20", 7, 1.0, 1,
                           "cuda")
    assert out["correct"] is True, out["checks"]
    assert out["device"]["busy_s"] > 0
