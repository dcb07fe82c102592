"""CPU tests of the benchmark: `python -m pytest benchmark/tests -q` from the
root of the repository.  Tests that need a card are marked `gpu` and skip
without one.

`tiny_root` lays out a checkout of the benchmark at a size a CPU holds: a
BENCHMARK.json with the real cells' names, modes and metrics, whose
configurations and mixes are cut to a few hundred sequences and a few
queries; the metric readers and matrices are the real files.
"""

import copy
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skipped without one)")


def real_spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _tiny(spec):
    """The real BENCHMARK.json with its files cut to CPU size."""
    with open(os.path.join(BENCH, "traffic", spec["traffic"] + ".json")) \
            as fh:
        t = json.load(fh)
    t["warm_lengths"] = t["warm_lengths"][:3]
    t["warm_lengths"] = [min(x, 40) for x in t["warm_lengths"]]
    if t["lengths"]["kind"] == "fixed":
        t["lengths"]["values"] = [12, 30, 45, 60]
        t["batch"] = 4
    elif t["mode"] == "batch":
        t["batch"] = 6
    if t["lengths"]["kind"] == "swissprot":
        t["lengths"] = {"kind": "uniform", "lo": 20, "hi": 60}
    if t["mode"] == "serve":
        t["rate"] = 8.0
        t["trace_seconds"] = 0.5
    t["check"] = dict(t["check"], residues=80, min_queries=1)
    t["check"].pop("one_over", None)
    t["trace_batches"] = 1
    return t


def make_tiny_root(path, n_seqs=300):
    spec = copy.deepcopy(real_spec())
    os.makedirs(os.path.join(path, "benchmark", "configs"))
    os.makedirs(os.path.join(path, "benchmark", "traffic"))
    for sub in ("metrics", "matrices"):
        shutil.copytree(os.path.join(BENCH, sub),
                        os.path.join(path, "benchmark", sub))
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        cfg.update(n_seqs=n_seqs, residues=n_seqs * 50, longest=80,
                   max_query_len=200)
        with open(os.path.join(path, c["file"]), "w") as fh:
            json.dump(cfg, fh)
    for w in spec["workloads"]:
        with open(os.path.join(path, "benchmark", "traffic",
                               w["traffic"] + ".json"), "w") as fh:
            json.dump(_tiny(w), fh)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return str(path)


def add_align_cell(root, traffic):
    """A configuration that returns alignments, added to a tiny root as a
    new deployment is added (new files and new BENCHMARK.json entries): the
    tiny Swiss-Prot database under BLOSUM62 11/1, top 5, `"align": true`,
    and its cell under the root's mix `traffic`.  Returns the cell's
    name."""
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "swissprot-blosum62.json")) \
            as fh:
        cfg = json.load(fh)
    cfg.update(name="tiny-align", open_gap=11, extend_gap=1, top=5,
               align=True)
    with open(os.path.join(bench, "configs", "tiny-align.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    spec["configs"].append({"name": "tiny-align", "source": "x",
                            "file": "benchmark/configs/tiny-align.json",
                            "reduced": [], "why": "x"})
    name = f"tiny-align.{traffic}"
    spec["workloads"].append({"name": name, "config": "tiny-align",
                              "traffic": traffic, "chips": 1, "why": "x"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return name


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
