#!/usr/bin/env python3
"""The knee of a serve cell: the highest offered rate the port sustains
without a growing backlog, found by a sweep on the card.

    python3 benchmark/sweep.py --workload <serve cell> --seed 1
                               --rates 10,20,30 [--seconds 15]

One set-up, then for each rate one open-loop window of the cell's mix at
that rate (its sizes drawn as the mix draws them).  One JSON line a rate:
requests, answered within the wait, p50/p95 (ms, from due time), the
answered rate, and `growth`: the median latency of the window's last
fifth over that of its first fifth (about 1 while the queue is steady, and
rising with the rate once the backlog grows through the window).  The
benchmark's runs never run it: a serve mix carries the rate chosen from
it (PERF.md).
"""

import argparse
import json
import multiprocessing
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    args = p.parse_args(argv)
    for path in (HERE, ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)
    import numpy as np
    import torch
    from perfkit import data, system as sut
    from perfkit.accounting import percentile
    from perfkit.client import client_main
    from perfkit.harness import log
    from perfkit.spec import Spec
    from perfkit.trace import Spans
    if not torch.cuda.is_available():
        log("no CUDA device")
        return 2
    cell = Spec(ROOT).cell(args.workload, trace=False)
    mp = multiprocessing.get_context("spawn")
    client, child = mp.Pipe()
    proc = mp.Process(target=client_main, args=(child,), daemon=True)
    proc.start()
    system = None
    try:
        corpus = data.make_corpus(cell.config, args.seed, "cuda")
        warm = data.Traffic(cell.traffic, corpus, args.seed, args.seconds)
        system = sut.System(cell, corpus, "cuda", ROOT, Spans(), log)
        address = system.start_server()
        sut.serve_warm(system, client, address, warm)
        for rate in (float(r) for r in args.rates.split(",")):
            spec = dict(cell.traffic, rate=rate)
            traffic = data.Traffic(spec, corpus, args.seed, args.seconds)
            sched = traffic.schedule()
            bodies = [sut.request_body(q, f"r{i}")
                      for i, (_, q) in enumerate(sched)]
            answers, lat, health, _ = sut.serve_window(
                system, client, address, sched, bodies, args.seconds)
            ok = [x for x in lat if np.isfinite(x)]
            fifth = max(1, len(lat) // 5)
            first = float(np.median(lat[:fifth]))
            last = float(np.median(lat[-fifth:]))
            h0, h1, span = health
            print(json.dumps({
                "rate": rate, "requests": len(lat), "answered": len(ok),
                "answered_per_s": len(ok) / span,
                "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
                "growth": last / first if first > 0 else None,
                "queries_per_dispatch": (h1["queries"] - h0["queries"]) /
                max(1, h1["dispatches"] - h0["dispatches"])}), flush=True)
            time.sleep(1.0)
    finally:
        if system is not None:
            system.close()
        client.send(("stop",))
        proc.join(timeout=30)
        if proc.is_alive():
            proc.kill()
            proc.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
