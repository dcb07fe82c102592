"""One run of one cell, from the seed to the result line.

1. data: the corpus and the queries from the seed (not in setup_s);
2. set-up (setup_s): the port takes the corpus (system.System);
3. the window: `seconds` of batches or of served requests, traced in part
   with `--trace 1`;
4. the device's memory peak is read, the program's state is freed;
5. the check: the plain reference on the card judges the answers
   (compare.check); its time is printed and is in no metric;
6. the metrics, by their readers; the isolation check; the result line.
"""

import dataclasses
import gc
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time

from perfkit import compare, data, system as sut
from perfkit.client import client_main
from perfkit.spec import Spec
from perfkit.trace import Spans, Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "oswald_tpu")


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules():
    """Modules of jax, jaxlib, flax or the JAX package loaded in this
    process, compared by whole top-level name (`oswald_tpu_torch` is not
    `oswald_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_info():
    """The card's name, power limit and clocks as nvidia-smi reads them."""
    q = "name,power.limit,clocks.sm,clocks.max.sm"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return {}
    if not out:
        return {}
    return dict(zip(q.split(","), (v.strip() for v in
                                    out.splitlines()[0].split(","))))


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""
    mode: str
    setup_s: float
    window_s: float
    query_residues: int         # of the answered queries of the window
    db_residues: int
    latencies_ms: list | None = None
    health: tuple | None = None
    trace: dict | None = None


def run_cell(root, workload, seed, seconds, trace, device="cuda"):
    """The result dict of one run (`correct`, `attempted`, `failed`,
    `metrics`, `device`, ...; `checks` last)."""
    import numpy as np
    import torch
    spec = Spec(root)
    cell = spec.cell(workload, trace=bool(trace))
    mode = cell.traffic["mode"]
    align = sut.aligns(cell.config)
    on_card = torch.device(device).type == "cuda"
    build = os.path.join(root, "build", "benchmark")

    client = None
    if mode == "serve":
        ctx_mp = multiprocessing.get_context("spawn")
        client, child = ctx_mp.Pipe()
        proc = ctx_mp.Process(target=client_main, args=(child,),
                              daemon=True)
        proc.start()
    try:
        t = time.perf_counter()
        corpus = data.make_corpus(cell.config, seed, device)
        traffic = data.Traffic(cell.traffic, corpus, seed, seconds)
        if mode == "serve":
            schedule = traffic.schedule()
            bodies = [sut.request_body(q, f"r{i}", align)
                      for i, (_, q) in enumerate(schedule)]
        log(f"data: {len(corpus.lengths)} sequences, {corpus.n_residues} "
            f"residues, {time.perf_counter() - t:.2f} s")
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

        spans = Spans()
        tracer = Tracer(os.path.join(build, "trace"), spans) if trace \
            else None
        # a traced run profiles its warm-up once, on the searching thread,
        # so that the profiler's first start (seconds, on a card) falls in
        # set-up and not in the traced part of the window
        warm_tracer = Tracer(build, Spans()) if trace else None
        t_setup = time.perf_counter()
        system = sut.System(cell, corpus, device, root, spans, log, align)
        if mode == "batch":
            sut.batch_warm(system, traffic, warm_tracer)
        else:
            address = system.start_server()
            sut.serve_warm(system, client, address, traffic, warm_tracer)
        setup_s = time.perf_counter() - t_setup
        log(f"setup_s {setup_s:.3f}")
        health = lat = None
        if mode == "batch":
            answers, window_s = sut.batch_window(system, traffic,
                                                     seconds, tracer)
        else:
            answers, lat, health, late = sut.serve_window(
                system, client, address, schedule, bodies, seconds,
                float(cell.traffic.get("trace_seconds", seconds / 2)),
                tracer)
            window_s = float(seconds)
            if late:
                log(f"client lateness: median {np.median(late) * 1e3:.3f} "
                    f"ms, max {max(late) * 1e3:.3f} ms")
        memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
        db_residues = system.db.n_residues
        system.close()
        del system
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    finally:
        if client is not None:
            client.send(("stop",))
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()

    # the check: the reference on the card, the program's state freed
    from perfkit import alignment, reference
    t = time.perf_counter()
    cfg = cell.config
    matrix = reference.load_matrix(reference.matrix_path(root, cfg["matrix"]))
    ref = reference.Reference(
        corpus.lengths, torch.as_tensor(corpus.flat, device=device),
        corpus.titles, matrix, cfg["open_gap"], cfg["extend_gap"],
        cfg["top"])
    log(f"check: the reference's database in {time.perf_counter() - t:.2f} s")
    judge = alignment.Judge(
        matrix, cfg["open_gap"], cfg["extend_gap"], alignment.corpus_subjects(
            ref.order, corpus.flat, corpus.offsets)) if align else None
    sample = compare.draw_sample(answers, seed, cell.traffic["check"])
    checks = compare.check(ref, answers, sample, cell.traffic["limits"], log,
                           judge)
    log(f"check: {len(answers)} answers, {len(sample)} searched in full "
        f"({sum(answers[i].query.size for i in sample)} residues), "
        f"{time.perf_counter() - t:.2f} s")
    del ref

    answered = [a for a in answers if a.answered]
    ctx = Context(mode=mode, setup_s=setup_s, window_s=window_s,
                  query_residues=sum(a.query.size for a in answered),
                  db_residues=db_residues, latencies_ms=lat, health=health,
                  trace=tracer.summary if tracer else None)
    metrics = {}
    for entry, reader in cell.metrics:
        v = reader(ctx)
        if v is None:
            continue
        if not math.isfinite(v):
            v = sut.WAIT_AFTER_S * 1e3 + window_s * 1e3
        metrics[entry["name"]] = {"value": float(v), "unit": entry["unit"]}

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    out = {"correct": compare.passed(checks), "attempted": len(answers),
           "failed": len(answers) - len(answered), "metrics": metrics,
           "device": dev}
    if tracer is not None and tracer.summary is not None:
        s = tracer.summary
        dev["busy_s"], dev["window_s"] = s["busy_s"], s["window_s"]
        out["breakdown"] = {"device_ops": s["device_ops"],
                            "idle_gaps": s["idle_gaps"]}
    out["card"] = card_info()
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def main(args, root) -> int:
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < _chips(root, args.workload):
        log("no CUDA device (or fewer than the cell needs): no result")
        return 2
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(root, "build", "benchmark", sub)
    import oswald_tpu_torch
    pkg = os.path.abspath(oswald_tpu_torch.__file__)
    if not pkg.startswith(os.path.abspath(root) + os.sep):
        log(f"oswald_tpu_torch comes from {pkg}, not from this checkout")
        return 2
    log(f"card: {card_info()}")
    out = run_cell(root, args.workload, args.seed, args.seconds,
                   args.trace, "cuda")
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return 3
    for k, c in out["checks"].items():
        print(f"{k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def _chips(root, workload) -> int:
    return int(Spec(root).workload(workload)["chips"])
