"""Timing, GCUPS accounting and the profiler.

- `Metrics`: named phase wall-timers (engine_setup / search / search_batch
  / warmup ...) with counts, totals, and a report.
- `gcups`: the throughput metric, Q * D / (t * 1e9) over true residues.
- `profile_trace`: a torch.profiler trace of the enclosed block, written as
  a Chrome trace (viewable in Perfetto or chrome://tracing).
"""

import contextlib
import itertools
import os
import time
from collections import defaultdict


def gcups(query_residues: int, db_residues: int, seconds: float) -> float:
    """GCUPS = Q * D / (t * 1e9)."""
    if seconds <= 0:
        return float("inf")
    return query_residues * db_residues / (seconds * 1e9)


class Metrics:
    """Named wall-clock phase accumulator.

    >>> m = Metrics()
    >>> with m.phase("search"):
    ...     pass
    >>> m.total("search") >= 0
    True
    """

    def __init__(self):
        self._totals = defaultdict(float)
        self._counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        self._totals[name] += seconds
        self._counts[name] += 1

    def total(self, name: str) -> float:
        return self._totals[name]

    def count(self, name: str) -> int:
        return self._counts[name]

    def report(self) -> str:
        lines = []
        for name in sorted(self._totals):
            t, c = self._totals[name], self._counts[name]
            avg = f", avg {t / c * 1e3:.2f} ms" if c > 1 else ""
            lines.append(f"{name}:\t{t:.4f} s (x{c}{avg})")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {k: {"total_s": self._totals[k], "count": self._counts[k]}
                for k in self._totals}


_traces = itertools.count()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the enclosed block with torch.profiler: the CPU activity,
    plus the CUDA activity (every kernel on the card, whoever launched it)
    where a card is present.  On exit the trace is written into log_dir
    (created) as trace.<pid>.<n>.json.  Yields the profiler, whose
    key_averages() sums time by kernel once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace.{os.getpid()}.{next(_traces)}.json"))
