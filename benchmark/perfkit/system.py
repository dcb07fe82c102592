"""The system under test and the two ways the window drives it.

Set-up hands the corpus to the port: `pack_sequences`, `SearchEngine` (the
database resident on the device), the kernel libraries from the
checkout's kernel directory, the engine's warmup and the mix's warm-up
queries; a serve mix also starts `make_server(SearchService(db, engine))`
on an ephemeral port.  The engine the service gets is `SpanEngine`, a thin
proxy that records a span around each search_many and each align (this is
the only program code the benchmark wraps; no program file changes).

- batch: a closed loop of search_many calls, batch after batch, until the
  window's seconds are over; the batch running then completes, so the
  window holds whole batches.
- serve: the open-loop client process posts each request at its due time;
  the window's numbers are read once every request due in it has its
  answer (or the wait after the window is over).

A configuration with `"align": true` (absent: false) is a deployment that
returns an alignment with every hit, asked for through the port's own
entry points as its users ask: every request body, the warm-up's too,
carries `"align": true`; a batch mix calls `engine.align(query, result)`
after each search_many, one query at a time in the batch's order, inside
the window (the warm-up batch's in set-up).  Once the window's seconds and
the wait after it have passed, a batch's remaining queries get no
alignment and count as unanswered, so a traceback far too slow ends the
run with failures.
"""

import json
import os
import threading
import time

import numpy as np

from perfkit import alignment, synth
from perfkit.compare import Answer

WAIT_AFTER_S = 60.0        # how long an answer may come after the window


def aligns(config) -> bool:
    """Whether a configuration asks for an alignment with every hit."""
    return bool(config.get("align", False))


class SpanEngine:
    """The engine with a span around search_many, (start, end, query
    residues), and one around align, (start, end, hits), into `spans`;
    every other attribute is the engine's.

    The profiler sees the device work of the thread that starts it only,
    and the service searches on its own drain thread; so `trace_between`
    has the tracer started by the first search_many that begins at or
    after `start` (monotonic seconds) and stopped after the first one that
    ends at or after `stop`, on whichever thread calls it."""

    def __init__(self, engine, spans):
        self._engine = engine
        self._spans = spans
        self._trace = None

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def trace_between(self, tracer, start, stop):
        self._trace = None if tracer is None else (tracer, start, stop)

    def search_many(self, queries, titles=None, batch=True):
        tr = self._trace
        if tr is not None and not tr[0].started and \
                time.monotonic() >= tr[1]:
            tr[0].start()
        t0 = time.monotonic_ns()
        try:
            return self._engine.search_many(queries, titles, batch)
        finally:
            self._spans.add("search_many", t0, time.monotonic_ns(),
                            sum(len(q) for q in queries))
            if tr is not None and tr[0].started and \
                    not tr[0].stopped and time.monotonic() >= tr[2]:
                tr[0].stop()

    def align(self, query, result):
        t0 = time.monotonic_ns()
        try:
            return self._engine.align(query, result)
        finally:
            self._spans.add("align", t0, time.monotonic_ns(),
                            len(result.seq_ids))


def _answer(a: Answer, title, length, hits):
    a.answered = True
    a.title, a.length = title, int(length)
    a.scores = np.asarray([h["score"] for h in hits], np.int64)
    a.ids = np.asarray([h["id"] for h in hits], np.int64)
    a.titles = [h["title"] for h in hits]
    a.alignments = [h.get("alignment") for h in hits]
    ev = [h.get("evalue") for h in hits]
    a.evalues = None if any(e is None for e in ev) else np.asarray(ev)


def _hits(result, alignments=None):
    """A SearchResult's hits in the served form: score, id, title and,
    where given, the alignment's ten fields."""
    hits = [{"score": int(s), "id": int(i), "title": t}
            for s, i, t in zip(result.scores, result.seq_ids, result.titles)]
    for h, aln in zip(hits, alignments or ()):
        h["alignment"] = {f: getattr(aln, f) for f in alignment.FIELDS}
    return hits


class System:
    """The port, set up for one cell."""

    def __init__(self, cell, corpus, device, root, spans, log, align=False):
        """align: whether the configuration aligns (`aligns`)."""
        from oswald_tpu_torch.utils import compile_cache
        compile_cache.enable_compile_cache(
            os.path.join(root, "build", "benchmark", "kernels"), quiet=True)
        from oswald_tpu_torch.io.db import pack_sequences
        from oswald_tpu_torch.engine.search import SearchConfig, SearchEngine
        c = cell.config
        t = time.perf_counter()
        self.db = pack_sequences(corpus.flat, corpus.lengths, corpus.titles)
        log(f"setup: pack_sequences {time.perf_counter() - t:.2f} s")
        cfg = SearchConfig(matrix=c["matrix"], open_gap=int(c["open_gap"]),
                           extend_gap=int(c["extend_gap"]),
                           top=int(c["top"]),
                           max_query_len=int(c["max_query_len"]),
                           profile_mode=c["profile_mode"])
        t = time.perf_counter()
        self.engine = SpanEngine(SearchEngine(self.db, cfg, device=device),
                                 spans)
        log(f"setup: engine {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        warm = cell.traffic["warm_lengths"]
        self.engine.warmup(max_query_len=max(warm), batch=True)
        log(f"setup: warmup {time.perf_counter() - t:.2f} s")
        self.align = align
        self.server = self.service = None

    def start_server(self):
        from oswald_tpu_torch.serve import SearchService, make_server
        self.service = SearchService(self.db, self.engine)
        self.server = make_server(self.service)
        # the stdlib's listen backlog of 5 drops connections that arrive
        # together while the accept thread waits for the interpreter lock
        self.server.socket.listen(128)
        self.server.daemon_threads = True
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        name="bench-http", daemon=True)
        self._thread.start()
        return self.server.server_address[:2]

    def close(self):
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self._thread.join(timeout=30)
            self.service.close()
        self.server = self.service = self.engine = self.db = None


# --- batch ------------------------------------------------------------------
def batch_warm(system, traffic, tracer=None):
    """The warm-up batch; profiled (and the profile dropped) with a
    tracer."""
    qs = traffic.warm()
    if tracer is not None:
        tracer.start()
    res = system.engine.search_many(qs, [f"warm{i}" for i in range(len(qs))])
    if tracer is not None:
        tracer.stop()
    if system.align:
        for q, r in zip(qs, res):
            system.engine.align(q, r)


def batch_window(system, traffic, seconds, tracer=None):
    """Returns (answers, window seconds); with a tracer, traces batches
    1 .. n of the window (n: the mix's `trace_batches`), running on past
    the window's seconds until they are done.  A configuration that
    aligns stops asking, and ends the loop, once the wait after the window
    is over too."""
    n_trace = int(traffic.spec.get("trace_batches", 2))
    answers = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    last = deadline + WAIT_AFTER_S

    def late():
        return system.align and time.perf_counter() >= last
    b = 0
    while True:
        if tracer is not None and b == 1:
            tracer.start()
        qs = traffic.batch(b)
        titles = [f"b{b}q{i}" for i in range(len(qs))]
        res = system.engine.search_many(qs, titles)
        for j, (q, t) in enumerate(zip(qs, titles)):
            a = Answer(q, t)
            if j < len(res) and not late():
                r = res[j]
                alns = system.engine.align(q, r) if system.align else None
                _answer(a, r.query_title, r.query_length, _hits(r, alns))
                a.evalues = None if r.evalues is None else \
                    np.asarray(r.evalues)
            answers.append(a)
        b += 1
        over = late()
        if tracer is not None and tracer.started and not tracer.stopped \
                and (b == 1 + n_trace or over):
            tracer.stop()
        tracing = tracer is not None and not tracer.stopped
        if over or (time.perf_counter() >= deadline and not tracing):
            break
    window_s = time.perf_counter() - t0
    if tracer is not None and tracer.stopped:
        tracer.finish()
    return answers, window_s


# --- serve ------------------------------------------------------------------
def request_body(query, title, align=False) -> bytes:
    body = {"query": synth.decode(query), "titles": [title]}
    if align:
        body["align"] = True
    return json.dumps(body).encode()


def _reply(client, limit_s):
    """The client's reply, or an error once `limit_s` has passed."""
    if not client.poll(limit_s):
        raise RuntimeError(f"the client gave no reply in {limit_s:.0f} s")
    return client.recv()


def serve_warm(system, client, address, traffic, tracer=None):
    """The warm-up requests, all due at once; with a tracer, the first
    dispatch is profiled on the drain thread (and the profile dropped)."""
    jobs = [(0.0, request_body(q, f"warm{i}", system.align))
            for i, q in enumerate(traffic.warm())]
    if tracer is not None:
        system.engine.trace_between(tracer, 0.0, 0.0)
    client.send(("send", *address, jobs, time.monotonic(), WAIT_AFTER_S))
    got = _reply(client, WAIT_AFTER_S + 30)
    system.engine.trace_between(None, 0.0, 0.0)
    bad = [r for r in got if r[3] != 200]
    if bad:
        raise RuntimeError(f"warm-up request failed: {bad[0][3]} "
                           f"{bad[0][4][:200]!r}")


def serve_window(system, client, address, schedule, bodies, seconds,
                 trace_seconds=None, tracer=None):
    """Returns (answers, latencies ms, (health before, after, seconds
    between), lateness of the sends [s])."""
    jobs = [(due, body) for (due, _), body in zip(schedule, bodies)]
    t0 = time.monotonic() + 0.5
    client.send(("send", *address, jobs, t0, WAIT_AFTER_S))
    time.sleep(max(0.0, t0 - time.monotonic()))
    if tracer is not None:
        start = t0 + max(0.0, (seconds - trace_seconds) / 2)
        system.engine.trace_between(tracer, start, start + trace_seconds)
    h0 = system.service.health()
    got = _reply(client, t0 + seconds + WAIT_AFTER_S + 30 - time.monotonic())
    h1 = system.service.health()
    span_s = time.monotonic() - t0
    if tracer is not None:
        if not tracer.stopped:
            raise RuntimeError("no search began and ended in the traced "
                               "part of the window")
        tracer.finish()
    answers, lat, late = [], [], []
    for i, ((due, q), (_, sent, done, status, payload)) in enumerate(
            zip(schedule, got)):
        a = Answer(q, f"r{i}")
        if sent is not None:
            late.append(sent - (t0 + due))
        if done is not None and status == 200:
            res = json.loads(payload)["results"]
            if len(res) == 1:
                _answer(a, res[0]["query"], res[0]["length"],
                        res[0]["hits"])
        answers.append(a)
        lat.append((done - (t0 + due)) * 1e3 if a.answered else float("inf"))
    return answers, lat, (h0, h1, span_s), late
