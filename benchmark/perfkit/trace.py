"""The device trace of a `--trace 1` run and its reduction.

`Tracer` runs torch.profiler (CPU and CUDA activity) over a part of the
window, exports the Chrome trace into the checkout's build directory,
reads it and deletes it.  The profiler records the CPU operations, and the
card's operations launched by them, of the thread that started it only:
the tracer is started and stopped on the thread that searches
(system.SpanEngine).  The benchmark keeps its own spans (`Spans`, on
time.monotonic_ns) and puts them on the trace's clock through two markers
that the tracing thread records at the start and at the end.

The reduction: device intervals are every kernel, copy and memset on the
card; `busy_s` is the length of their union inside the traced window;
each idle gap (a stretch of the window with nothing on the card) is named
by the innermost benchmark span around its middle and by the device
operation that ran last before it.
"""

import bisect
import json
import os
import threading
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Spans of the benchmark's own calls into the program, thread-safe:
    (name, start ns, end ns, count: a search's query residues, an
    alignment call's hits) on time.monotonic_ns."""

    def __init__(self):
        self._lock = threading.Lock()
        self.items = []

    def add(self, name, t0, t1, count=0):
        with self._lock:
            self.items.append((name, t0, t1, count))


def union(intervals):
    """Merged, sorted [(start, end)] of possibly overlapping intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def gaps(merged, lo, hi):
    """The stretches of [lo, hi] that no merged interval covers."""
    out, cur = [], lo
    for s, e in merged:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out


def _short(name: str, n: int = 96) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def reduce_trace(events, lo, hi, spans=()):
    """The summary of one traced window [lo, hi] (microseconds on the
    trace's clock): events are the Chrome trace's; spans [(name, start,
    end)] on the same clock.  Returns dict(window_s, busy_s, device_ops,
    idle_gaps), the last two as [[name, seconds], ...] sorted by seconds,
    at most 10 each."""
    dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
            e.get("name", "?")) for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    by_name = defaultdict(float)
    for s, e, name in dev:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            by_name[_short(name)] += (e - s) / 1e6
    merged = union(clip([(s, e) for s, e, _ in dev], lo, hi))
    busy = sum(e - s for s, e in merged)
    ends = sorted((e, name) for s, e, name in dev)
    named = defaultdict(float)
    end_keys = [e for e, _ in ends]
    for gs, ge in gaps(merged, lo, hi):
        mid = (gs + ge) / 2
        inner = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        where = min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner \
            else "outside any call"
        j = bisect.bisect_right(end_keys, gs + 1e-3) - 1
        after = _short(ends[j][1], 48) if j >= 0 else "window start"
        named[f"{where} after {after}"] += (ge - gs) / 1e6
    top = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                           key=lambda kv: -kv[1])[:10]
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6,
            "device_ops": top(by_name), "idle_gaps": top(named)}


def idle_pct(summary):
    """The share of the traced window with nothing on the card, as a
    percentage; None with nothing to read."""
    if summary is None or summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])


class Tracer:
    """torch.profiler over [start(), stop()], reduced by reduce_trace; one
    thread calls both."""

    def __init__(self, out_dir: str, spans: Spans):
        self.out_dir = out_dir
        self.spans = spans
        self.started = self.stopped = False
        self.summary = None

    def _mark(self, record_function):
        c0 = time.monotonic_ns()
        with record_function("bench.clock"):
            pass
        return (c0 + time.monotonic_ns()) / 2

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, \
            record_function
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._rf = record_function
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.started = True
        self._c_start = self._mark(record_function)

    def stop(self):
        """Stop recording (on the thread that started it)."""
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._mark(self._rf)
        self._prof.__exit__(None, None, None)
        self.stopped = True

    def finish(self):
        """Export, read and reduce the trace (any thread, after stop)."""
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "trace.json")
        self._prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        os.remove(path)
        marks = sorted(float(e["ts"]) for e in events
                       if e.get("name") == "bench.clock"
                       and e.get("ph") == "X")
        if len(marks) < 2:
            raise RuntimeError("the trace lacks its clock markers")
        lo, hi = marks[0], marks[-1]
        # one monotonic ns = 1e-3 us on the trace's clock; the offset
        # from the start marker
        off = lo - self._c_start / 1e3
        spans = [(n, t0 / 1e3 + off, t1 / 1e3 + off, res)
                 for n, t0, t1, res in list(self.spans.items)]
        self.summary = reduce_trace(events, lo, hi,
                                    [s[:3] for s in spans])
        # the query residues of the searches that ran wholly inside
        self.summary["query_residues"] = sum(
            r for n, a, b, r in spans
            if n == "search_many" and a >= lo and b <= hi)
        return self.summary
