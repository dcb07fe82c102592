"""The port's HTTP search server against oswald_tpu's SearchService.

Both services search the same 60-sequence database (tests/test_serve.py's
fixture), packed by the JAX package and carried to the port by
`from_reference`.  The port's server runs on an ephemeral port over a CPU
engine; the JAX side is driven through `SearchService.search(payload)`
directly, with no second HTTP server.  Scores, ids and titles must be equal;
E-values of a query drawn at random at rtol 1e-5 (single) and 1e-4
(batch), as tests/test_torch_engine.py and tests/test_torch_batch.py hold
them: the float32 moments of the two sides sum in their own orders; bits,
rounded to 0.1 in the JSON, within one step.  Most queries here are
database sequences, as in tests/test_serve.py, and a self-hit scores far
above the rest (704 against a mean of 23): its square moves the float32 sum
of squares by a few ulps between the two orders of summation, the
hit-excluded variance by 2.6e-5 relative, lambda by 1.3e-5 and ln(E) by
4e-3 at E = 4e-139 (measured on this fixture).  For those queries ln(E) is
compared at rtol SELF_RTOL = 1e-4, atol 1e-4, as tests/test_torch_cli.py
compares ln(E) for queries cut from database sequences.
Each test of tests/test_serve.py has its mirror here, except the
distributed engine's, which is not ported; one more drives a host_stream
engine.
"""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from oswald_tpu.alphabet import ALPHABET
from oswald_tpu.engine import SearchConfig as JaxConfig
from oswald_tpu.engine import SearchEngine as JaxEngine
from oswald_tpu.io import pack_sequences
from oswald_tpu.serve import SearchService as JaxService
from oswald_tpu_torch.cli.main import build_parser
from oswald_tpu_torch.engine import SearchConfig, SearchEngine
from oswald_tpu_torch.io import from_reference
from oswald_tpu_torch.serve import SearchService, make_server

from conftest import random_protein


@pytest.fixture(scope="module")
def server():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rng = np.random.default_rng(7)
    n = 60
    lengths = rng.integers(20, 150, size=n)
    seqs = [random_protein(rng, int(l)) for l in lengths]
    db = pack_sequences(np.concatenate(seqs), lengths,
                        [f"srv{i}" for i in range(n)])
    jax_service = JaxService(db, JaxEngine(db, JaxConfig(top=5)))
    port_db = from_reference(db)
    engine = SearchEngine(port_db, SearchConfig(top=5), device="cpu")
    service = SearchService(port_db, engine)
    httpd = make_server(service, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://{httpd.server_address[0]}:{httpd.server_address[1]}"
    yield base, service, engine, seqs, jax_service
    httpd.shutdown()
    httpd.server_close()
    service.close()
    jax_service.close()
    t.join(timeout=60)
    assert not t.is_alive()
    torch.set_num_threads(n_threads)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _to_str(codes):
    return "".join(ALPHABET[c] for c in codes)


SELF_RTOL = 1e-4
RANDOM_RTOL = 1e-5


def _assert_same_results(got, want, rtol=SELF_RTOL):
    """The results of two /search answers: hits exact, ln(E) at rtol (atol
    1e-4), bits within a rounding step, alignments equal."""
    assert len(got["results"]) == len(want["results"])
    for g, w in zip(got["results"], want["results"]):
        assert (g["query"], g["length"]) == (w["query"], w["length"])
        assert [(h["score"], h["id"], h["title"]) for h in g["hits"]] == \
            [(h["score"], h["id"], h["title"]) for h in w["hits"]]
        assert all(("evalue" in h) == ("evalue" in v)
                   for h, v in zip(g["hits"], w["hits"]))
        if w["hits"] and "evalue" in w["hits"][0]:
            np.testing.assert_allclose(
                np.log([h["evalue"] for h in g["hits"]]),
                np.log([h["evalue"] for h in w["hits"]]), rtol=rtol,
                atol=1e-4)
            np.testing.assert_allclose([h["bits"] for h in g["hits"]],
                                       [h["bits"] for h in w["hits"]],
                                       atol=0.1 + 1e-9)
        assert [h.get("alignment") for h in g["hits"]] == \
            [h.get("alignment") for h in w["hits"]]


def test_healthz_and_info(server):
    base, service, engine, seqs, jax_service = server
    code, h = _get(base + "/healthz")
    assert code == 200 and h["status"] == "ok"
    # the reference's counters, and the port's queue waits and engine spans
    assert set(h) == set(jax_service.health()) | {"queue_wait_s", "waited",
                                                  "phases"}
    code, info = _get(base + "/info")
    assert code == 200
    want = jax_service.info()
    assert set(want) <= set(info)
    assert info["db"] == want["db"] and info["db"]["n_seqs"] == 60
    assert info["config"] == want["config"]
    assert info["config"]["matrix"] == "blosum62"
    assert info["backend"] == "cpu" and info["devices"] == ["cpu"]


def test_search_parity_with_jax_service(server):
    base, service, engine, seqs, jax_service = server
    payload = {"query": _to_str(seqs[11])}
    code, out = _post(base + "/search", payload)
    assert code == 200
    _assert_same_results(out, jax_service.search(payload))
    hits = out["results"][0]["hits"]
    direct = engine.search(seqs[11])
    assert [h["score"] for h in hits] == direct.scores.tolist()
    assert hits[0]["title"] == "srv11"
    assert "evalue" in hits[0] and "bits" in hits[0]
    assert out["search_s"] > 0 and out["gcups"] >= 0
    payload = {"query": _to_str(random_protein(np.random.default_rng(3),
                                               80))}
    code, out = _post(base + "/search", payload)
    want = jax_service.search(payload)
    _assert_same_results(out, want, rtol=RANDOM_RTOL)
    np.testing.assert_allclose(
        [h["evalue"] for h in out["results"][0]["hits"]],
        [h["evalue"] for h in want["results"][0]["hits"]], rtol=RANDOM_RTOL)


def test_batch_titles_top_and_counters(server):
    base, service, engine, seqs, jax_service = server
    before = service.n_queries
    payload = {"queries": [_to_str(seqs[3]), _to_str(seqs[4][:30])],
               "titles": ["a", "b"], "top": 2}
    code, out = _post(base + "/search", payload)
    assert code == 200
    _assert_same_results(out, jax_service.search(payload))
    assert [r["query"] for r in out["results"]] == ["a", "b"]
    assert all(len(r["hits"]) == 2 for r in out["results"])
    code, h = _get(base + "/healthz")
    assert h["queries"] == before + 2
    rng = np.random.default_rng(4)
    payload = {"queries": [_to_str(random_protein(rng, n)) for n in (50, 90)]}
    code, out = _post(base + "/search", payload)
    want = jax_service.search(payload)
    _assert_same_results(out, want)
    for g, w in zip(out["results"], want["results"]):
        np.testing.assert_allclose([h["evalue"] for h in g["hits"]],
                                   [h["evalue"] for h in w["hits"]],
                                   rtol=1e-4)


def test_align_equals_jax_and_rescores(server):
    base, service, engine, seqs, jax_service = server
    payload = {"query": _to_str(seqs[20]), "align": True}
    code, out = _post(base + "/search", payload)
    assert code == 200
    _assert_same_results(out, jax_service.search(payload))
    top = out["results"][0]["hits"][0]["alignment"]
    # self-hit: a gapless identity alignment over the full sequence
    assert top["gaps"] == 0 and top["identities"] == len(seqs[20])
    assert top["q_aln"] == top["s_aln"] == _to_str(seqs[20])
    res = engine.search(seqs[20])
    for h, aln in zip(out["results"][0]["hits"], engine.align(seqs[20], res)):
        assert aln.score == h["score"]


def test_fasta_payload(server):
    base, service, engine, seqs, jax_service = server
    fasta = (f">qa first query\n{_to_str(seqs[5])}\n"
             f">qb second\n{_to_str(seqs[8][:40])}\n")
    payload = {"fasta": fasta, "top": 1}
    code, out = _post(base + "/search", payload)
    assert code == 200
    _assert_same_results(out, jax_service.search(payload))
    assert [r["query"] for r in out["results"]] == ["qa first query",
                                                    "qb second"]
    assert out["results"][0]["hits"][0]["title"] == "srv5"
    for bad in ({"fasta": fasta, "query": "MKT"},
                {"fasta": "not fasta at all"}):
        code, out = _post(base + "/search", bad)
        assert code == 400
        with pytest.raises(ValueError) as e:
            jax_service.search(bad)
        assert out["error"] == str(e.value)


def test_concurrent_requests(server):
    """Concurrent clients each get their own correct result."""
    base, service, engine, seqs, jax_service = server
    results = {}

    def hit(qi):
        code, out = _post(base + "/search", {"query": _to_str(seqs[qi])})
        results[qi] = (code, out["results"][0]["hits"][0]["title"])

    threads = [threading.Thread(target=hit, args=(qi,))
               for qi in (7, 13, 25, 31)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert results == {qi: (200, f"srv{qi}") for qi in (7, 13, 25, 31)}


def test_micro_batching_coalesces_concurrent_requests(server):
    """Requests that arrive while the engine is busy coalesce into ONE
    `search_many` dispatch: 4 single-query clients cost exactly 2
    dispatches when the first is gated until the other 3 have queued."""
    base, service, engine, seqs, jax_service = server
    calls = []
    release = threading.Event()
    real = engine.search_many

    def gated(queries, titles=None, batch=True):
        calls.append(len(queries))
        if len(calls) == 1:
            assert release.wait(timeout=60)
        return real(queries, titles, batch)

    engine.search_many = gated
    try:
        results = {}

        def hit(qi):
            out = service.search({"query": _to_str(seqs[qi])})
            results[qi] = out["results"][0]["hits"][0]["title"]

        threads = [threading.Thread(target=hit, args=(7,))]
        threads[0].start()
        for _ in range(600):
            if calls:
                break
            time.sleep(0.01)
        assert calls, "dispatcher never picked up the first request"
        for qi in (13, 25, 31):
            threads.append(threading.Thread(target=hit, args=(qi,)))
            threads[-1].start()
        for _ in range(600):
            with service._cv:
                if len(service._queue) == 3:
                    break
            time.sleep(0.01)
        release.set()
        for t in threads:
            t.join(timeout=120)
        assert results == {qi: f"srv{qi}" for qi in (7, 13, 25, 31)}
        assert calls == [1, 3], calls
    finally:
        engine.search_many = real
        release.set()


def test_failed_batch_retried_per_request(server):
    """A coalesced dispatch that raises is retried request by request, so
    one bad request fails alone (the reference's isolation)."""
    base, service, engine, seqs, jax_service = server
    real = engine.search_many
    release = threading.Event()
    calls = []

    def flaky(queries, titles=None, batch=True):
        calls.append(list(titles))
        if len(calls) == 1:
            assert release.wait(timeout=60)
        if "poison" in titles:
            raise RuntimeError("engine failure")
        return real(queries, titles, batch)

    engine.search_many = flaky
    try:
        out = {}

        def hit(name, qi):
            try:
                out[name] = service.search({"queries": [_to_str(seqs[qi])],
                                            "titles": [name]})
            except RuntimeError as e:
                out[name] = e

        threads = [threading.Thread(target=hit, args=("first", 1))]
        threads[0].start()
        for _ in range(600):
            if calls:
                break
            time.sleep(0.01)
        for name, qi in (("poison", 2), ("good", 3)):
            threads.append(threading.Thread(target=hit, args=(name, qi)))
            threads[-1].start()
        for _ in range(600):
            with service._cv:
                if len(service._queue) == 2:
                    break
            time.sleep(0.01)
        release.set()
        for t in threads:
            t.join(timeout=120)
        assert isinstance(out["poison"], RuntimeError)
        assert out["good"]["results"][0]["hits"][0]["title"] == "srv3"
        assert out["first"]["results"][0]["hits"][0]["title"] == "srv1"
        assert sorted(map(tuple, calls[1:])) == sorted(
            [("poison", "good"), ("poison",), ("good",)])
    finally:
        engine.search_many = real
        release.set()
    # over HTTP an engine failure is a 500 with the exception's name
    engine.search_many = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("engine failure"))
    try:
        code, body = _post(base + "/search", {"query": "MKT"})
    finally:
        engine.search_many = real
    assert code == 500 and body["error"] == "RuntimeError: engine failure"


def test_service_close_rejects_new_requests(server):
    base, service, engine, seqs, jax_service = server
    svc = SearchService(service.db, engine)
    out = svc.search({"query": _to_str(seqs[2])})
    assert out["results"][0]["hits"][0]["title"] == "srv2"
    svc.close()
    assert not svc._dispatcher.is_alive()
    with pytest.raises(RuntimeError, match="shut down"):
        svc.search({"query": _to_str(seqs[2])})


BAD_PAYLOADS = [
    {}, {"queries": []}, {"query": "MKT", "top": 99}, {"query": "   "},
    {"queries": ["MKT"], "titles": ["a", "b"]},
    # type-confused fields
    {"fasta": 123}, {"query": "MKT", "top": [1]},
    {"query": "MKT", "top": "ten"}, {"query": "MKT", "top": True},
    {"query": "MKT", "top": 0},
    {"queries": ["MKT"], "titles": "a"}, {"queries": ["MKT"], "titles": [7]},
    {"queries": [123]}, {"query": 42}, {"queries": "MKT"},
    {"fasta": ">empty\n>x\nMKT\n"},
]


@pytest.mark.parametrize("payload", BAD_PAYLOADS)
def test_bad_payloads_400_like_jax(server, payload):
    """Every malformed payload is a 400 JSON error with the reference's
    message, not a dropped connection."""
    base, service, engine, seqs, jax_service = server
    code, out = _post(base + "/search", payload)
    assert code == 400
    with pytest.raises((ValueError, TypeError)) as e:
        jax_service.search(payload)
    assert out["error"] == str(e.value)


def test_error_paths(server):
    base, service, engine, seqs, jax_service = server
    code, out = _post(base + "/search", {})
    assert code == 400 and "query" in out["error"]
    req = urllib.request.Request(
        base + "/search", data=b"{not json",
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    assert json.loads(e.value.read())["error"].startswith("bad request body")
    req = urllib.request.Request(base + "/search", data=b"[1, 2]")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    code, out = _get(base + "/nope")
    assert code == 404 and "no such path" in out["error"]
    code, out = _post(base + "/elsewhere", {"query": "MKT"})
    assert code == 404


def test_oversized_body_413(server, monkeypatch):
    from oswald_tpu_torch import serve
    base, service, engine, seqs, jax_service = server
    monkeypatch.setattr(serve, "MAX_BODY_BYTES", 16)
    code, out = _post(base + "/search", {"query": "MKTAYIAKQRQISFVK"})
    assert code == 413 and out["error"] == "request body too large"


def test_cli_serve_parser():
    """The serve subcommand parses its flags (no server started)."""
    args = build_parser().parse_args(
        ["serve", "-d", "x.oswt", "-r", "20", "--port", "0",
         "--warmup-qlen", "0", "--device", "cpu", "--blocks-per-sm", "3",
         "--long-from", "2048"])
    assert args.op == "serve" and args.top == 20 and args.warmup_qlen == 0
    assert args.port == 0 and args.host == "127.0.0.1"
    assert (args.blocks_per_sm, args.long_from) == (3, 2048)
    args = build_parser().parse_args(["serve", "-d", "x"])
    assert (args.port, args.warmup_qlen, args.warmup_jobs) == (8731, 512, 1)
    assert args.blocks_per_sm is None and args.long_from is None


def test_serve_stress_mixed_concurrency(server):
    """30 requests from 6 concurrent client threads with mixed payload
    shapes (single, multi-query, fasta): every reply correct, queue
    drained, counters consistent."""
    base, service, engine, seqs, jax_service = server
    req0, q0 = service.n_requests, service.n_queries
    errors = []
    lock = threading.Lock()

    def client(ci):
        rng = np.random.default_rng(ci)
        for r in range(5):
            qi = int(rng.integers(0, len(seqs)))
            kind = (ci + r) % 3
            if kind == 0:
                payload = {"query": _to_str(seqs[qi])}
            elif kind == 1:
                payload = {"queries": [_to_str(seqs[qi]),
                                       _to_str(seqs[(qi + 1) % len(seqs)])]}
            else:
                payload = {"fasta": f">x{qi}\n{_to_str(seqs[qi])}\n"}
            code, out = _post(base + "/search", payload)
            if code != 200 or \
                    out["results"][0]["hits"][0]["title"] != f"srv{qi}":
                with lock:
                    errors.append((ci, r, code, out))

    threads = [threading.Thread(target=client, args=(ci,))
               for ci in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert service.n_requests == req0 + 30
    assert service.n_queries == q0 + 40
    assert service.n_dispatches <= service.n_requests
    with service._cv:
        assert not service._queue


def test_host_stream_service_matches_jax(server):
    """The service over a host_stream engine answers as the JAX service."""
    base, service, engine, seqs, jax_service = server
    hs = SearchEngine(service.db, dataclasses.replace(
        engine.config, profile_mode="host_stream", host_stream_slice_mb=1),
        device="cpu")
    svc = SearchService(service.db, hs)
    try:
        for payload in ({"query": _to_str(seqs[11])},
                        {"queries": [_to_str(seqs[3]), _to_str(seqs[4][:30])],
                         "titles": ["a", "b"], "top": 2, "align": True}):
            _assert_same_results(svc.search(payload),
                                 jax_service.search(payload))
        assert svc.info()["config"]["profile_mode"] == "host_stream"
    finally:
        svc.close()


def test_serve_forever_warms_binds_and_closes(server, monkeypatch, capsys):
    """serve_forever warms the engine, binds, announces itself and, when
    interrupted, closes the socket and the service."""
    from oswald_tpu_torch import serve
    base, service, engine, seqs, jax_service = server
    made = []
    real = serve.make_server

    def interrupted(svc, host, port):
        httpd = real(svc, host, port)

        def stop():
            raise KeyboardInterrupt
        httpd.serve_forever = stop
        made.append((svc, httpd))
        return httpd

    monkeypatch.setattr(serve, "make_server", interrupted)
    assert serve.serve_forever(service.db, engine, "127.0.0.1", 0,
                               warmup_qlen=16) == 0
    out = capsys.readouterr().out
    assert "warmup [" in out and "warmup: loaded kernel libraries []" in out
    assert "oswald-tpu-torch serving 60 sequences" in out and " on cpu at " \
        in out
    svc, httpd = made[0]
    assert svc._closed and not svc._dispatcher.is_alive()
    assert httpd.socket.fileno() == -1
