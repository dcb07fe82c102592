"""Timing, GCUPS accounting and the profiler.

- `Metrics`: named phase wall-timers (engine_setup / search / search_batch
  / warmup / the engine's and the service's spans ...) with counts,
  totals, and a report.  A phase is also a span: while torch.profiler
  records on the calling thread it is a `record_function` range of the
  same name, so it lands in the profiler's trace beside the kernels,
  copies and memsets, on their clock, nested in the spans around it.
  Every `add` also feeds one process-wide `Metrics` (`process_metrics()`),
  whose totals outlive the engines and services that fed them.
- `gcups`: the throughput metric, Q * D / (t * 1e9) over true residues.
- `profile_trace`: a torch.profiler trace of the enclosed block, written as
  a Chrome trace (viewable in Perfetto or chrome://tracing), each span's
  args in its range.
"""

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque

import torch

# whether torch.profiler records on this thread: ~0.14 us a call, where an
# unguarded record_function costs ~9 us even with no profiler
_recording = torch.autograd._profiler_enabled

# (span name, args as JSON or None) of every span recorded while
# profile_trace runs, in the order they began; None outside profile_trace.
# The profiler keeps a range's name but not its args string, so
# profile_trace writes them into its trace from here.
_span_args = None


def gcups(query_residues: int, db_residues: int, seconds: float) -> float:
    """GCUPS = Q * D / (t * 1e9)."""
    if seconds <= 0:
        return float("inf")
    return query_residues * db_residues / (seconds * 1e9)


def _range(name: str, args):
    """The record_function range of one span; `args` (a callable that
    returns a JSON-able dict, or None) is called here, while recording."""
    a = None if args is None else json.dumps(args())
    log = _span_args
    if log is not None:
        log.append((name, a))
    return torch.profiler.record_function(name, a)


class Metrics:
    """Named wall-clock phase accumulator, safe to feed and read from
    several threads.

    >>> m = Metrics()
    >>> with m.phase("search"):
    ...     pass
    >>> m.total("search") >= 0
    True
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._totals = defaultdict(float)
        self._counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, args=None):
        """Time the enclosed block under `name`.  While torch.profiler
        records on this thread, the block is also a record_function range
        of that name, and `args` (a callable that returns a JSON-able dict)
        is called for the range's args; otherwise `args` is never called."""
        t0 = time.perf_counter()
        try:
            if _recording():
                with _range(name, args):
                    yield
            else:
                yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def _add(self, name: str, seconds: float):
        with self._lock:
            self._totals[name] += seconds
            self._counts[name] += 1

    def add(self, name: str, seconds: float):
        self._add(name, seconds)
        if self is not _PROCESS:
            _PROCESS._add(name, seconds)

    def total(self, name: str) -> float:
        with self._lock:
            return self._totals.get(name, 0.0)

    def count(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def report(self) -> str:
        lines = []
        with self._lock:
            items = [(k, self._totals[k], self._counts[k])
                     for k in sorted(self._totals)]
        for name, t, c in items:
            avg = f", avg {t / c * 1e3:.2f} ms" if c > 1 else ""
            lines.append(f"{name}:\t{t:.4f} s (x{c}{avg})")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        with self._lock:
            return {k: {"total_s": self._totals[k], "count": self._counts[k]}
                    for k in self._totals}


_PROCESS = Metrics()


def process_metrics() -> Metrics:
    """The process-wide totals: every `add` of every Metrics in this
    process since it started (the `kernels.sw_lanes` launch counters count
    the same way)."""
    return _PROCESS


_traces = itertools.count()


def _attach_args(path: str, logged):
    """Write the args of the spans in `logged` into their ranges of the
    Chrome trace at `path`.  The profiler records one thread, and no span
    nests in one of its own name, so the ranges of one name in the order
    they began are the spans of that name in the order they were logged."""
    if not any(a for _, a in logged):
        return
    queues = defaultdict(deque)
    for name, a in logged:
        queues[name].append(a)
    with open(path) as fh:
        doc = json.load(fh)
    ranges = sorted((e for e in doc["traceEvents"]
                     if e.get("cat") == "user_annotation"
                     and e.get("name") in queues), key=lambda e: e["ts"])
    for e in ranges:
        q = queues[e["name"]]
        a = q.popleft() if q else None
        if a:
            e.setdefault("args", {}).update(json.loads(a))
    with open(path, "w") as fh:
        json.dump(doc, fh)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the enclosed block with torch.profiler: the CPU activity,
    plus the CUDA activity (every kernel on the card, whoever launched it)
    where a card is present, and the spans (`Metrics.phase`) of the thread
    that enters it.  On exit the trace is written into log_dir (created)
    as trace.<pid>.<n>.json, each span's args in its range.  Yields the
    profiler, whose key_averages() sums time by kernel once the block has
    ended."""
    global _span_args
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _span_args = []
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        logged, _span_args = _span_args, None
    path = os.path.join(log_dir, f"trace.{os.getpid()}.{next(_traces)}.json")
    prof.export_chrome_trace(path)
    _attach_args(path, logged)
