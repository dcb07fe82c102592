"""Warm search server: one engine on the card behind an HTTP JSON API; the
port of oswald_tpu/serve.py.

A one-shot search repays process start, the CUDA context, the kernels'
module load and the database's copy to the card, which dwarf one search of
tens of milliseconds.  A deployment therefore keeps ONE warm engine
resident and streams queries at it; this module is that deployment shape.

Endpoints (JSON in/out):

  GET  /healthz   liveness + request counters (uptime, queries served,
                  aggregate GCUPS, queue waits, the engine's phase
                  totals) — the load-balancer probe.
  GET  /info      database / config / device inventory.
  POST /search    {"query": "MKTAYI..."}, {"queries": [...]}, or
                  {"fasta": ">q1\\nMKT..."} (multi-record FASTA text,
                  titles from the headers) with optional "titles", "top"
                  (<= the engine's configured top-k), and "align"
                  (gapped traceback per hit).
                  Returns per-query hit lists with scores, ids, titles,
                  and — when the database supports the significance fit —
                  E-values and bit scores.

Concurrency: requests are parsed/serialised on a thread per connection
(ThreadingHTTPServer); engine dispatches run on ONE dispatcher thread
that drains the request queue through `search_many` — concurrent
single-query clients coalesce into cross-request micro-batches (while
batch i computes, arrivals accumulate into batch i+1), so N concurrent
clients share packed launches instead of queueing single searches.  A
single client with an idle engine dispatches immediately — the batching
window is the engine's own busy time, not a fixed delay.

Module-level and engine state this relies on: the engine's one kernel
scratch (`SearchEngine.scratch`), its host_stream buffers and the
process-global launch counters of `kernels.sw_lanes` are used by every
launch, and the dispatcher is the only thread that searches, so no two
launches race for them.  Alignments run on the request threads
(`SearchEngine.align`, numpy on the host) and touch no device state.  The
service never moves work to another device: a failed coalesced dispatch is
retried one request at a time on the same engine, and a request that still
fails gets an HTTP 500.

Pod serving (a world of more than one rank, `DistributedSearchEngine`):
only rank 0 talks HTTP.  Each search runs collectives, so every rank must
enter the same `search_many` with the same queries: rank 0's engine proxy
first broadcasts the dispatcher's batch over the process group, and the
other ranks run a mirror loop (`pod_worker_loop`).  Collectives run on the
dispatcher thread only (warmup runs before it starts); request threads
parse, align and serialise, none of which touches the process group.
Closing the service drains the pending requests, then one more broadcast
releases the workers.
"""

import itertools
import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from oswald_tpu_torch.alphabet import encode
from oswald_tpu_torch.engine.search import ENGINE_PHASES
from oswald_tpu_torch.utils.metrics import Metrics

MAX_BODY_BYTES = 64 << 20  # refuse absurd request bodies early


class _Pending:
    """One request's slot in the micro-batch queue: its id and the
    perf_counter time it was queued at are set when it is queued."""

    __slots__ = ("rid", "t_queued", "enc", "titles", "done", "results",
                 "error")

    def __init__(self, enc, titles):
        self.rid = self.t_queued = None
        self.enc = enc
        self.titles = titles
        self.done = threading.Event()
        self.results = None
        self.error = None


def _dispatch_args(batch, waits):
    """The args of a serve.dispatch span: its requests' ids and their
    waits in the queue, in ms."""
    return lambda: {"ids": [p.rid for p in batch],
                    "wait_ms": [round(w * 1e3, 3) for w in waits]}


class SearchService:
    """Engine wrapper with request accounting; independent of HTTP so it
    can be embedded (tests drive it directly too).

    `metrics` holds the dispatcher's spans and counters: `serve.wait` (the
    dispatcher waiting on an empty queue), `serve.dispatch` (one
    search_many, its args the requests' ids and queue waits) and
    `serve.queue_wait` (each request's wait from being queued to the start
    of the dispatch that takes it, added once per request)."""

    def __init__(self, db, engine):
        self.db = db
        self.engine = engine
        self.lock = threading.Lock()
        self.t_start = time.time()
        self.n_requests = 0
        self.n_queries = 0
        self.n_dispatches = 0   # engine search_many calls (<= n_requests
                                # under concurrent load: the micro-batcher)
        self.cells = 0          # true query-residues x db-residues scored
        self.busy_s = 0.0       # engine time (not per-request wall time)
        self.metrics = Metrics()
        self._ids = itertools.count()
        self._cv = threading.Condition()
        self._queue = []        # [_Pending]
        self._closed = False
        self._dispatcher = threading.Thread(
            target=self._drain_loop, name="oswald-dispatch", daemon=True)
        self._dispatcher.start()

    def close(self):
        """Stop the dispatcher (pending requests still complete)."""
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._dispatcher.join(timeout=60)

    def _drain_loop(self):
        """Dispatcher: drain ALL queued requests into one `search_many`
        per round.  Because the engine computes while new requests queue,
        the coalescing window adapts to load with zero idle latency tax —
        a lone request on an idle engine dispatches immediately."""
        while True:
            with self._cv:
                if not self._queue and not self._closed:
                    with self.metrics.phase("serve.wait"):
                        while not self._queue and not self._closed:
                            self._cv.wait()
                if not self._queue and self._closed:
                    return
                batch, self._queue = self._queue, []
            queries = [q for p in batch for q in p.enc]
            titles = [t for p in batch for t in p.titles]
            t0 = time.perf_counter()
            waits = [t0 - p.t_queued for p in batch]
            for w in waits:
                self.metrics.add("serve.queue_wait", w)
            try:
                with self.metrics.phase("serve.dispatch",
                                        _dispatch_args(batch, waits)):
                    results = self.engine.search_many(queries, titles)
            except Exception as batch_exc:  # noqa: BLE001 - isolate the
                # offender: retry each coalesced request individually so
                # one pathological query doesn't fail its batch-mates
                # (each gets its OWN exception instance, not a shared
                # one).  A single-request batch has no mates — don't
                # re-run its identical failing search.
                for p, w in zip(batch, waits):
                    if len(batch) == 1:
                        p.error = batch_exc
                        p.done.set()
                        break
                    t1 = time.perf_counter()
                    try:
                        with self.metrics.phase("serve.dispatch",
                                                _dispatch_args([p], [w])):
                            p.results = self.engine.search_many(p.enc,
                                                                p.titles)
                        with self.lock:     # retries still count as work
                            self.n_dispatches += 1
                            self.cells += sum(len(q) for q in p.enc) \
                                * self.db.n_residues
                            self.busy_s += time.perf_counter() - t1
                    except Exception as e:  # noqa: BLE001
                        p.error = e
                    p.done.set()
                continue
            dt = time.perf_counter() - t0
            with self.lock:
                self.n_dispatches += 1
                self.cells += sum(len(q) for q in queries) \
                    * self.db.n_residues
                self.busy_s += dt
            off = 0
            for p in batch:
                p.results = results[off:off + len(p.enc)]
                off += len(p.enc)
                p.done.set()

    def search(self, payload: dict) -> dict:
        fasta = payload.get("fasta")
        if fasta is not None:
            # multi-record FASTA text: titles come from the headers
            if not isinstance(fasta, str):
                raise ValueError("'fasta' must be a string")
            if payload.get("query") is not None or \
                    payload.get("queries") is not None:
                raise ValueError("'fasta' is exclusive with "
                                 "'query'/'queries'")
            from oswald_tpu_torch.io.fasta import parse_fasta_bytes
            titles, flat, lengths = parse_fasta_bytes(
                fasta.encode("ascii", errors="replace"))
            if (lengths == 0).any():
                raise ValueError("FASTA contains an empty record")
            offs = np.concatenate([[0], np.cumsum(lengths)])
            enc = [flat[offs[i]:offs[i + 1]] for i in range(len(lengths))]
        else:
            queries = payload.get("queries")
            if queries is None:
                q = payload.get("query")
                if q is None:
                    raise ValueError(
                        "body must have 'query', 'queries', or 'fasta'")
                queries = [q]
            if not isinstance(queries, list) or not queries:
                raise ValueError("'queries' must be a non-empty list")
            titles = payload.get("titles")
            if titles is not None:
                if not isinstance(titles, list) or \
                        not all(isinstance(t, str) for t in titles):
                    raise ValueError("'titles' must be a list of strings")
                if len(titles) != len(queries):
                    raise ValueError("'titles' length must match 'queries'")
            enc = []
            for i, q in enumerate(queries):
                if not isinstance(q, str) or not q.strip():
                    raise ValueError(f"query {i} must be a non-empty "
                                     "residue string")
                enc.append(encode(q.strip()))
        top = payload.get("top")
        k_max = min(self.engine.config.top, self.db.n_seqs)
        if top is not None:
            if not isinstance(top, int) or isinstance(top, bool):
                raise ValueError("'top' must be an integer")
            if top < 1:
                raise ValueError("'top' must be >= 1")
            if top > k_max:
                raise ValueError(
                    f"'top' exceeds the server's configured top-k ({k_max});"
                    " restart the server with a larger -r")
        want_align = bool(payload.get("align", False))

        t0 = time.perf_counter()
        # per-request default titles BEFORE coalescing, so batched requests
        # report the same names as unbatched ones
        p = _Pending(enc, titles if titles is not None else
                     [f"query{i}" for i in range(len(enc))])
        with self._cv:
            if self._closed:
                raise RuntimeError("service is shut down")
            p.rid, p.t_queued = next(self._ids), time.perf_counter()
            self._queue.append(p)
            self._cv.notify()
        p.done.wait()
        if p.error is not None:
            raise p.error
        results = p.results
        # alignment traceback is a host-side numpy post-pass over k hits
        # (engine/align.py) — thread-safe, so it runs on the request
        # thread, off the dispatcher's critical path
        alns = [self.engine.align(q, r)
                for q, r in zip(enc, results)] if want_align else None
        dt = time.perf_counter() - t0

        out = []
        for qi, res in enumerate(results):
            k = top if top is not None else len(res.scores)
            hits = [{"score": int(s), "id": int(i), "title": t}
                    for s, i, t in zip(res.scores[:k], res.seq_ids[:k],
                                       res.titles[:k])]
            if res.evalues is not None:
                for h, e, b in zip(hits, res.evalues[:k],
                                   res.bit_scores[:k]):
                    h["evalue"] = float(e)
                    h["bits"] = round(float(b), 1)
            if alns is not None:
                for h, a in zip(hits, alns[qi][:k]):
                    h["alignment"] = {
                        "q_start": a.q_start, "q_end": a.q_end,
                        "s_start": a.s_start, "s_end": a.s_end,
                        "q_aln": a.q_aln, "s_aln": a.s_aln,
                        "midline": a.midline, "identities": a.identities,
                        "positives": a.positives, "gaps": a.gaps}
            out.append({"query": res.query_title,
                        "length": res.query_length, "hits": hits})

        Q = int(sum(len(q) for q in enc))
        # counter updates under the lock: ThreadingHTTPServer runs one
        # thread per connection, and unlocked read-modify-writes would
        # under-count /healthz stats under concurrent load (cells/busy_s
        # are engine-side and accounted by the dispatcher)
        with self.lock:
            self.n_requests += 1
            self.n_queries += len(enc)
        return {"results": out,
                "search_s": round(dt, 4),
                "gcups": round(Q * self.db.n_residues / dt / 1e9, 2)}

    def health(self) -> dict:
        """The counters: requests, queries and dispatches; busy_s (time in
        the dispatcher's search_many calls) and lifetime_gcups over it;
        queue_wait_s and waited (every dispatched request's wait in the
        queue, summed, and their count); phases (the engine's spans of
        ENGINE_PHASES, seconds in all)."""
        waited = self.metrics.as_dict().get("serve.queue_wait",
                                            {"total_s": 0.0, "count": 0})
        return {"status": "ok",
                "uptime_s": round(time.time() - self.t_start, 1),
                "requests": self.n_requests,
                "queries": self.n_queries,
                "dispatches": self.n_dispatches,
                "busy_s": round(self.busy_s, 3),
                "lifetime_gcups": round(
                    self.cells / max(self.busy_s, 1e-9) / 1e9, 2),
                "queue_wait_s": round(waited["total_s"], 6),
                "waited": waited["count"],
                "phases": {n: round(self.engine.metrics.total(n), 6)
                           for n in ENGINE_PHASES}}

    def info(self) -> dict:
        import torch
        cfg = self.engine.config
        dev = self.engine.device
        if dev.type == "cuda":
            devices = [f"{i}:{torch.cuda.get_device_name(i)}"
                       for i in range(torch.cuda.device_count())]
        else:
            devices = ["cpu"]
        return {"db": {"n_seqs": self.db.n_seqs,
                       "n_residues": self.db.n_residues,
                       "bins": [int(b) for b in self.db.bin_lengths]},
                "config": {"matrix": cfg.matrix, "gap_open": cfg.open_gap,
                           "gap_extend": cfg.extend_gap, "top": cfg.top,
                           "profile_mode": getattr(self.engine, "mode",
                                                   cfg.profile_mode)},
                "backend": dev.type,
                "device": str(dev),
                "devices": devices}


def _make_handler(service: SearchService):
    class Handler(BaseHTTPRequestHandler):
        # stdlib default logs every request to stderr; keep the server
        # quiet (counters live in /healthz)
        def log_message(self, fmt, *args):
            pass

        def _reply(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, service.health())
            elif self.path == "/info":
                self._reply(200, service.info())
            else:
                self._reply(404, {"error": f"no such path: {self.path}"})

        def do_POST(self):
            if self.path != "/search":
                self._reply(404, {"error": f"no such path: {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > MAX_BODY_BYTES:
                    self._reply(413, {"error": "request body too large"})
                    return
                payload = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": f"bad request body: {e}"})
                return
            try:
                self._reply(200, service.search(payload))
            except (ValueError, TypeError) as e:
                # payload validation raises ValueError/TypeError: a 400.
                # (Catching AttributeError/KeyError here would disguise
                # genuine server-side bugs as client errors.)
                self._reply(400, {"error": str(e)})
            except Exception as e:          # noqa: BLE001
                # engine/server-side failure: a 500 JSON error, not a
                # dropped connection — and distinguishable from a bad
                # payload for monitoring
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def make_server(service: SearchService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral; read server.server_address)."""
    return ThreadingHTTPServer((host, port), _make_handler(service))


# --- pod (multi-rank) serving ----------------------------------------------
#
# The broadcast is two collectives from rank 0: an int64 header [op, batch
# flag, byte count], then the encoded batch as a byte tensor of that size
# (the reference broadcasts one fixed 4 MiB buffer).  A blocked worker is
# the synchronisation.

_POD_OP_SEARCH = 1
_POD_OP_SHUTDOWN = 2


def _pod_encode(enc) -> np.ndarray:
    """[n, len_0..n-1 (int32 as 4 x int8), residues...] as int8."""
    lens = np.asarray([len(q) for q in enc], np.int32)
    head = np.concatenate([np.asarray([len(enc)], np.int32), lens])
    return np.concatenate([head.view(np.int8)] +
                          [np.asarray(q, np.int8) for q in enc])


def _pod_decode(buf: np.ndarray):
    """Inverse of _pod_encode: the list of queries (int8 arrays)."""
    buf = np.asarray(buf, np.int8)
    n = int(buf[:4].view(np.int32)[0])
    lens = buf[4:4 + 4 * n].view(np.int32)
    out, off = [], 4 + 4 * n
    for length in lens:
        out.append(buf[off:off + int(length)].copy())
        off += int(length)
    return out


def _pod_broadcast(op: int, batch: bool = True, payload=None):
    """Rank 0's side of one broadcast; the workers' side is _pod_receive."""
    import torch
    import torch.distributed as tdist
    data = np.zeros(0, np.int8) if payload is None else payload
    tdist.broadcast(torch.tensor([op, int(batch), data.size],
                                 dtype=torch.int64), src=0)
    if data.size:
        tdist.broadcast(torch.from_numpy(np.ascontiguousarray(data)), src=0)


def _pod_receive():
    """(op, batch, queries) of rank 0's next broadcast."""
    import torch
    import torch.distributed as tdist
    head = torch.zeros(3, dtype=torch.int64)
    tdist.broadcast(head, src=0)
    op, batch, size = (int(v) for v in head)
    queries = []
    if size:
        buf = torch.empty(size, dtype=torch.int8)
        tdist.broadcast(buf, src=0)
        queries = _pod_decode(buf.numpy())
    return op, bool(batch), queries


class _PodBroadcastEngine:
    """Rank 0's engine proxy: every search_many first broadcasts the batch
    so that the worker ranks enter the same collectives; everything else
    (config, align, db, metrics) passes through."""

    def __init__(self, engine):
        self._engine = engine

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def search_many(self, queries, titles=None, batch: bool = True):
        _pod_broadcast(_POD_OP_SEARCH, batch, _pod_encode(queries))
        return self._engine.search_many(queries, titles, batch)


def pod_worker_loop(engine) -> int:
    """A worker rank's mirror loop: wait for rank 0's broadcast, run the
    same search_many (its results are rank 0's to send; the collectives
    inside are the point), return the number of queries served at the
    shutdown broadcast.  A search that fails here fails alike on rank 0,
    before any collective (the engine checks its queries first), and rank
    0 answers the request with the error; the loop goes on."""
    import traceback
    served = 0
    while True:
        op, batch, queries = _pod_receive()
        if op == _POD_OP_SHUTDOWN:
            return served
        try:
            engine.search_many(queries, batch=batch)
        except ValueError:
            traceback.print_exc()
        served += len(queries)


def pod_shutdown_broadcast():
    """Rank 0: release the workers (pairs with their waiting receive)."""
    _pod_broadcast(_POD_OP_SHUTDOWN)


def serve_forever(db, engine, host: str, port: int,
                  warmup_qlen: int | None = 512, warmup_jobs: int = 1):
    """CLI entry: warm the engine (kernel libraries, first searches), bind,
    serve until interrupted.  In a world of more than one rank every rank
    calls this with the same arguments (see _serve_forever_pod)."""
    from oswald_tpu_torch.dist.bootstrap import world
    if world()[1] > 1:
        return _serve_forever_pod(db, engine, host, port, warmup_qlen)
    service = SearchService(db, engine)
    if warmup_qlen:
        t0 = time.perf_counter()
        libs = engine.warmup(warmup_qlen,
                             log=lambda s: print(s, flush=True),
                             jobs=warmup_jobs)
        print(f"warmup: loaded kernel libraries {libs} "
              f"in {time.perf_counter() - t0:.1f}s")
    httpd = make_server(service, host, port)
    addr = httpd.server_address
    print(f"oswald-tpu-torch serving {db.n_seqs} sequences "
          f"({db.n_residues} residues) on {engine.device} at "
          f"http://{addr[0]}:{addr[1]}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.close()
    return 0


def _serve_forever_pod(db, engine, host: str, port: int,
                       warmup_qlen: int | None):
    """Pod serving: rank 0 serves HTTP and broadcasts each dispatch, the
    other ranks mirror it.  Warmup is collective, so every rank runs it
    alike first."""
    from oswald_tpu_torch.dist.bootstrap import world
    rank, size = world()
    if warmup_qlen:
        t0 = time.perf_counter()
        libs = engine.warmup(
            warmup_qlen,
            log=(lambda s: print(s, flush=True)) if rank == 0 else None)
        if rank == 0:
            print(f"warmup: loaded kernel libraries {libs} "
                  f"in {time.perf_counter() - t0:.1f}s")
    if rank != 0:
        n = pod_worker_loop(engine)
        print(f"oswald-tpu-torch pod worker rank {rank}: exiting after "
              f"{n} queries", flush=True)
        return 0
    service = SearchService(db, _PodBroadcastEngine(engine))
    httpd = make_server(service, host, port)
    addr = httpd.server_address
    print(f"oswald-tpu-torch serving {db.n_seqs} sequences "
          f"({db.n_residues} residues) on {engine.device} at "
          f"http://{addr[0]}:{addr[1]} [pod: {size} ranks]", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if threading.current_thread() is threading.main_thread():
            # a second interrupt must not cut the release of the workers
            signal.signal(signal.SIGINT, signal.SIG_IGN)
        httpd.server_close()
        service.close()           # drains the pending requests
        pod_shutdown_broadcast()  # then releases the workers
    return 0
