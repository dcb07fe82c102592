"""BENCHMARK.json and the files it names, found by name.

- a configuration: the `file` of its `configs` entry;
- a traffic mix: `<paths[0]>/traffic/<traffic>.json`;
- a metric: `<paths[0]>/metrics/<metric name>.py`, a small reader with
  `read(ctx)` that returns a number, or None where it finds nothing to
  read (the metric is then left out of the line).  A metric split by the
  end-to-end metric it moves (`step_mfu.batch`, `step_mfu.serve`) and with
  no file of its own reads with its quantity's reader, the file of its
  name without the last dotted part (`step_mfu.py`); its `workloads`
  choose the cells.

A cell reports, with `--trace 0`, the end-to-end metrics and, with
`--trace 1`, the per-layer metrics whose `workloads` list names it (or
that have no such list).  Adding a cell, a mix or a metric is adding files
and entries: nothing here names one.
"""

import dataclasses
import importlib.util
import json
import os


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    metrics: list          # [(entry of BENCHMARK.json, reader)]


class Spec:
    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.doc = json.load(fh)
        self.bench_dir = os.path.join(root, self.doc["paths"][0])

    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as fh:
                    return json.load(fh)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.bench_dir, "traffic",
                               f"{name}.json")) as fh:
            return json.load(fh)

    def reader(self, metric: str):
        path = os.path.join(self.bench_dir, "metrics", f"{metric}.py")
        if not os.path.exists(path) and "." in metric:
            path = os.path.join(self.bench_dir, "metrics",
                                metric.rsplit(".", 1)[0] + ".py")
        mod_spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod.read

    def cell(self, name: str, trace: bool) -> Cell:
        w = self.workload(name)
        group = self.doc["per_layer" if trace else "end_to_end"]
        metrics = [(m, self.reader(m["name"])) for m in group
                   if name in m.get("workloads", [name])]
        return Cell(name, self.config(w["config"]),
                    self.traffic(w["traffic"]), int(w["chips"]), metrics)
