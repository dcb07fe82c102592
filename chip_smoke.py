#!/usr/bin/env python3
"""Smoke run of oswald_tpu_torch on one CUDA card: python3 chip_smoke.py

Run from the root of a checkout on a machine with an H100 (compute
capability 9.0), the CUDA toolkit and PyTorch built for CUDA.  It points the
kernel cache (oswald_tpu_torch.utils.compile_cache) at the checkout's
build/oswald_tpu_torch/ and builds the port's kernels there from the
checkout's sources (one nvcc per source, all started together), then:

1. probe: PyTorch, CUDA, nvcc, compute capability, Triton, and the card's
   name and power limit;
   Then, before any measurement, the parity gate
   (oswald_tpu_torch.utils.parity.run_parity, the port of the reference's
   pre-stage) at the reference's hardware sizes: 4096 random subjects of
   1-699 residues (seed 7), SearchEngine on the card against the
   anti-diagonal wavefront oracle (oswald_tpu_torch/core/oracle.py, plain
   PyTorch on the host CPU, no code shared with the kernels) for blosum62
   10/2 and pam30 7/1 at query lengths 64, 65, 512 (every subject) and
   5478 (256 sampled subjects), exact int32 equality of score_all over the
   valid slots, and search_many of 8 mixed short queries (one packed
   launch) against search one by one; 24 checks, each printed with the
   engine's and the oracle's seconds and the card.  Any mismatch fails the
   run; the gate's 24 sw_groups and 2 sw_groups_packed launches count in
   the kernels record;
2. database: a SwissProt-shaped synthetic corpus of 570,000 sequences with
   one planted homolog of a 512-residue query, packed and moved to the card
   by SearchEngine(db, device="cuda");
3. kernel against plain version: sw_groups and sw_groups_ref on one group
   of every bin, at query lengths 512 and 65; the int32 scores must be
   equal (tolerance: exact).  A lone group is too small a launch to fill
   the card, so its default work table pipelines it whatever its length and
   splits its slabs over clusters; the same group dealt out as rows (the
   role of short groups in a whole-database launch) and its plain launch
   (each slab one block) are held to the same scores;
4. main path: SearchEngine.search for the 512-residue query and a random
   65-residue one, each one warm-up plus 3 timed runs, with the kernel's
   launch count read around them; the planted homolog must rank first with
   E < 1e-3 and every hit's score must equal the plain version's on the CPU.
   Then sw_groups over the whole database beside its bound, over the
   longest bin alone and over one group of it alone (the latency case), at
   both query lengths;
4b. giants (alone: `python3 chip_smoke.py --giants`): the kernels'
   registers and the clusters of 2, 4 and 8 blocks the card holds at once
   (cudaOccupancyMaxActiveClusters); then sw_groups over a database with
   the Swiss-Prot 2013_11 length spectrum the benchmark uses (its
   release_lengths: 541,561 sequences, the longest 35,213) and random
   residues, at m = 5478 and 144: the default table, whose giant group's
   slabs are split over clusters (K printed), and its plain launch (each
   slab one block) timed in turn A B B A, their scores equal, the cluster
   launch counted; the giant group alone, split and plain; and a database
   of as many sequences capped at 5478, whose table must split nothing and
   launch as a plain grid; the giant group alone at m = 144 against
   sw_groups_ref.  Then a batch of 512 peptides of 10-30 residues (PAM30
   9/1) packed as the engine packs the peptide cell's, every launch of its
   plan split and plain, 8 rounds in turn, every score tensor equal, and
   the first 12 segments of one bin on the giant group against
   sw_groups_packed_ref.  Each time beside its bound, which it must not
   beat;
5. packed kernel against plain version: sw_groups_packed and
   sw_groups_packed_ref on one group of every bin, for the packing plan of
   20 mixed queries of 100-400 residues and for a uniform layout of 8
   queries of 65 residues; equal int32 scores (tolerance: exact);
6. batched main path: SearchEngine.search_many of the 20 mixed queries, of
   10 queries of 512 residues, and of a batch with one 2000-residue query
   among short ones (which runs unpacked), and search_stream of 8 queries
   of 65 residues at window 4, each one warm-up plus 3 timed runs with the
   kernels' launch counts set to 0 before and read after; results must
   equal per-query search (scores and ids exact), launch counts must be the
   plan's, the planted homolog must rank first for its query, and one
   query per batch is rescored on the CPU.  Seconds and GCUPS of each batch
   stand beside those of the same queries searched one by one;
7. lab kernel against plain version: every built kernel of sw_groups_lab
   (each variant at strip height U = 16 with a column's shared-memory reads
   in place and one column ahead; base and dpx ahead at U = 8 and 32) on
   one group of every bin at query length 512, pipelined (the default
   table) and as rows, held to the sw_groups_ref scores of phase 3
   (tolerance: exact); each variant's tiled plain version
   (sw_groups_lab_tiled_ref) at each built U on the shortest bin; every
   built kernel equal to sw_groups over the whole database (lengths 512 and
   65, the engine's gaps and 11/1); then oswald_tpu_torch.lab.run_variants
   over the whole database at m = 512, at U = 16 in place and ahead and at
   U = 8 and 32 ahead: one line per kernel with milliseconds, Gcells/s, the
   share of the bound, registers and spills.  Last, base ahead at U = 16,
   which is sw_groups' own code, and sw_groups are timed in turn over the
   whole database on the 512-residue query (A B B A, four times), so that
   a drift of the card's clock between phases cannot pass for a difference
   of code.  It fails if a lab time is under its bound, and if the median
   times of those two are not within 3% of each other;
8. host_stream main path: a second engine with profile_mode="host_stream"
   on the same database and card.  Its score_all must equal the resident
   engine's on every valid slot (lengths 512 and 65, three in a row each),
   its searches the resident engine's hits (E-values at rtol 1e-4: float64
   moments on the host against float32 ones on the card), with one kernel
   launch per slice and launch of the call; one search_many of the 20 mixed
   queries must equal the resident batch; host_stream_overlap=False must
   give identical results; and profile_mode="auto" must resolve to
   host_stream under a budget below the resident need and to precompute
   with the card's own memory.  Search seconds and GCUPS of the overlapped
   and the serial schedule stand beside the resident engine's, with setup
   seconds, each engine's peak device memory beside the planner's
   estimate, and where a host_stream search's time goes (kernels alone
   slice by slice, the sweep, the host's top-k and moments);
9. serving, on phase 2's resident engine: the kernel directory is packed
   into a tarball (utils.compile_cache.pack_cache) and unpacked into a fresh
   directory, the build pointed there, and SearchEngine.warmup(512) must
   load both engine kernels from it without running nvcc (its seconds are
   printed).  A SearchService behind make_server on an ephemeral port
   answers: the 512-residue query, 20 times from one client (per-request
   latency p50/p95/p99 and requests per second, the first request after
   warmup beside them); the same query with "align": true (the planted
   homolog first with E < 1e-3, every hit's alignment rescored with the
   matrix and gaps equal to its score; the host time of a 10-hit traceback
   printed); the 20 mixed queries of phase 6 as requests of 1-3 queries
   from 8 client threads, each response equal to the same queries searched
   one by one (scores, ids and titles exact, E-values at rtol 1e-4), with
   /healthz counting every request and query in fewer dispatches than
   requests (the micro-batcher coalesced); /info naming the card; and the
   mixed queries one a request from 8 clients at once (latency and
   throughput).  One search of the 512-residue query under
   utils.metrics.profile_trace: the Chrome trace must name sw_groups_kernel;
   its summed device time and that of all device work are printed beside
   the search's wall time under the profiler.  Both kernels' launches are
   counted over the phase up to here and must be non-zero.  Last,
   tune.autotune(iters=1): every candidate's Gcells/s and the winner are
   printed, and every candidate's checksum must equal the shipped
   geometry's;
10. preprocess: phase 2's corpus written as FASTA, then `python -m
   oswald_tpu_torch.cli preprocess` of it in-core (with --to-oswald) and
   with --streaming, each timed (seconds and MB/s of FASTA, process start
   included): the native I/O library must build from native/oswald_io.cpp
   into the checkout's kernel directory and each command must say on
   stderr that its scan and packing took it, both artifacts must load equal to
   phase 2's PackedDB (bin lengths, residues, lengths, ids, titles); the
   export to OSWALD's format (export_reference_db, timed), read by
   `preprocess --from-oswald --to-oswald`, must give the database again
   and its three files byte for byte;
11. distributed: (a) world size 1 in this process (a gloo group on a
   file:// store): DistributedSearchEngine on phase 2's database equals the
   resident SearchEngine on the 512- and 65-residue queries, search_many of
   the 20 mixed queries and search_stream of the 8 x 65 queries, with the
   single engine's launch counts, both timed in turn, and where a search's
   time goes step by step beside the single engine's; (b) two ranks sharing
   the card (spawned processes, gloo, both on cuda:0, phase 10's .oswt
   memory-mapped): search of the 512-residue query, search_many of the
   mixed queries and one host_stream search equal the single engine's,
   each rank's launches its shard's plan, each rank's sw_groups time (alone
   on the card, and with the other rank's) and share of the cells printed
   (balance and overhead, not scaling), beside
   the shares the re-cut to quanta 2 would give; (c) `serve --distributed`
   on two ranks sharing the card, rank 0 on an ephemeral port: /healthz
   answers, /search of the planted query equals the single engine, and an
   interrupt of rank 0 releases the worker, both exiting 0 within
   POD_EXIT_TIMEOUT_S.  Comparisons: scores and ids exact, E-values at rtol
   1e-4, the planted homolog first with E < 1e-3.  Every process started
   has a timeout; a hang fails the phase.

One call of a kernel's wrapper is one launch, whatever roles its work table
mixes, so the launch counts are those of the calls.  The probe prints the
registers and spills nvcc reports for every kernel and fails if an engine
kernel spills.

Every phase raises on failure (non-zero exit, no result line).  The
second-to-last line is a JSON object with, for each kernel, its launches on
the main path, its error against the plain version, its time, the plain
version's and the least time the card could take for the same work (the
larger of the bytes moved over the memory rate and the fused instructions
the recurrence needs over the rate an SM issues instructions at); a kernel
timed under that bound fails the run, since it would prove the count wrong.
The probe prints the card's maximum SM clock, which that rate assumes.  The last
line is {"ok": true, "device": {...}}.
Times are CUDA-event times for kernels and host wall times (ended by a
synchronising readback) for searches.
"""

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

SEED = 0
N_SEQS = 570_000
Q_LONG, Q_SHORT = 512, 65
TIMED_RUNS = 3
N_MIXED, MIXED_LO, MIXED_HI = 20, 100, 400
N_LONG_BATCH = 10
Q_LEFTOVER = 2000
N_UNIFORM = 8
STREAM_WINDOW = 4
SOURCES = {"sw_groups": "oswald_tpu_torch/kernels/csrc/sw_groups.cu",
           "sw_groups_packed":
               "oswald_tpu_torch/kernels/csrc/sw_groups_packed.cu",
           "sw_groups_lab": "oswald_tpu_torch/kernels/csrc/sw_groups_lab.cu"}
REPLACES = "oswald_tpu/kernels/sw_lanes.py:309"
REPLACES_LAB = "scripts/kernel_lab.py:176"
# base ahead at U = 16 is sw_groups' code: timed in turn, SAME_CODE_ROUNDS
# times A B B A, their median times agree within SAME_CODE_RTOL
SAME_CODE_ROUNDS = 4
SAME_CODE_RTOL = 0.03
# phase 4b: the peptide cell's batch (512 peptides of 10-30 residues,
# PAM30 9/1), its plan's launches split and plain PEPTIDE_ROUNDS times, and
# the first PEPTIDE_REF_SEGS segments of one bin on the giant group held to
# the plain PyTorch version (each segment a loop over 35,232 columns)
N_PEPTIDES, PEPTIDE_LO, PEPTIDE_HI = 512, 10, 30
PEPTIDE_ROUNDS = 8
PEPTIDE_REF_SEGS = 12
# phase 9: client threads, and the single-client latency run's requests
SERVE_CLIENTS = 8
SERVE_SINGLE_REQUESTS = 20
# the parity gate: the reference's hardware sizes (bench.py's pre-stage)
PARITY_N, PARITY_LMAX, PARITY_TITIN = 4096, 700, 256
# phases 10-11: limits of the processes they start, in seconds
PREPROCESS_TIMEOUT_S = 300
RANK_TIMEOUT_S = 300
POD_EXIT_TIMEOUT_S = 60
CHECKOUT_BUILD = Path(__file__).resolve().parent / "build" / "oswald_tpu_torch"


def say(msg=""):
    print(msg, flush=True)


def timed(fn, reps):
    """(result, mean milliseconds) of fn() over reps runs after one
    warm-up, timed with CUDA events."""
    out = fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def bound(cells, n_bytes):
    """(least milliseconds the card could take, what bounds it): the
    larger of the bytes over the memory rate and 5.5 instructions a cell
    over the issue rate (oswald_tpu_torch.lab.bound has the derivation)."""
    from oswald_tpu_torch.lab import bound as card_bound
    return card_bound(cells, n_bytes)


def hold_to_bound(what, ms, b_ms):
    """A time under the least the card could take disproves the bound."""
    if ms < b_ms:
        raise AssertionError(f"{what}: {ms:.3f} ms is under its bound of "
                             f"{b_ms:.3f} ms: the bound counts more work "
                             f"than the function needs")


def probe():
    """Phase 1.  Returns the nvidia-smi "name, power limit" line."""
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    from oswald_tpu_torch.kernels import build
    nvcc = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout
    say("nvcc: " + [l for l in nvcc.splitlines() if "release" in l][-1])
    cap = torch.cuda.get_device_capability(0)
    say(f"compute capability {cap[0]}.{cap[1]}, "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    if cap != (9, 0):
        raise RuntimeError(f"the kernels target sm_90a; this card is "
                           f"{cap[0]}.{cap[1]}")
    triton = importlib.util.find_spec("triton") is not None
    say(f"triton: {'present' if triton else 'absent'}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    say(f"maximum SM clock {clock.splitlines()[0]}")
    t0 = time.perf_counter()
    build.build_all(sorted(SOURCES))
    say(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name in sorted(SOURCES):
        build.load(name)
        log = build.build_logs.get(name)
        say(f"{name} {'built' if log is not None else 'loaded (built before)'}"
            f": {build.library_path(name)}")
        if name == "sw_groups_lab":
            from oswald_tpu_torch.kernels.sw_lab import ptxas_report
            for label, used in sorted(ptxas_report(log).items()):
                say(f"  ptxas: {label}: {used}")
            continue
        for line in (log or "").splitlines():
            if "registers" in line or "spill" in line:
                say("  ptxas: " + line.strip())
            if "spill" in line and "0 bytes spill stores, 0 bytes spill " \
                    "loads" not in line:
                raise AssertionError(f"{name} spills registers: "
                                     f"{line.strip()}")
    return smi


def parity_gate(card):
    """The parity gate, right after the build.  Returns {kernel:
    launches} of its searches; raises on any mismatch."""
    from oswald_tpu_torch.kernels import sw_lanes
    from oswald_tpu_torch.utils.parity import run_parity
    sw_lanes.launches = sw_lanes.launches_packed = 0
    out = run_parity(n=PARITY_N, lmax=PARITY_LMAX,
                     titin_sample=PARITY_TITIN,
                     log=lambda msg: say(f"{msg} [{card}]"),
                     device=torch.device("cuda", 0), oracle_device="cpu")
    launched = {"sw_groups": sw_lanes.launches,
                "sw_groups_packed": sw_lanes.launches_packed}
    say(f"parity: {json.dumps(out)}, launches {launched}, oracle on the "
        f"host CPU [{card}]")
    if out["parity"] != "ok" or out["checks"] != 24 or \
            out["backend"] != "cuda":
        raise AssertionError(f"the parity gate failed: {out}")
    # per matrix: 4 score_all and 8 single searches, one packed launch
    if launched != {"sw_groups": 24, "sw_groups_packed": 2}:
        raise AssertionError(f"the parity gate launched {launched}")
    return launched


def make_database(n_seqs, seed):
    """Phase 2: (db, q_long, q_short, (flat, lengths, titles) of the
    corpus in file order)."""
    from oswald_tpu_torch.io import pack_sequences
    from oswald_tpu_torch.io.synth import (make_realistic_corpus, mutate,
                                           realistic_residues)
    rng = np.random.default_rng(seed)
    q_long = realistic_residues(rng, Q_LONG)
    q_short = realistic_residues(rng, Q_SHORT)
    t0 = time.perf_counter()
    flat, lengths, titles = make_realistic_corpus(
        rng, n_seqs, planted=[mutate(q_long, rng)])
    db = pack_sequences(flat, lengths, titles)
    packed = sum(b["seq"].nbytes for b in db.bins.values())
    say(f"database: {db.n_seqs} sequences, {db.n_residues} residues, "
        f"{len(db.bin_lengths)} bins (longest {max(db.bin_lengths)}), "
        f"{packed / 1e6:.1f} MB packed, built in "
        f"{time.perf_counter() - t0:.1f} s")
    return db, q_long, q_short, (flat, lengths, titles)


def first_groups(engine):
    """(group table on the host, index of the first group of every bin)."""
    table = engine.state.groups.cpu().numpy()
    return table, [int(np.flatnonzero(table[:, 1] == L)[0])
                   for L in engine.db.bin_lengths]


def sub_table(engine, gi):
    """(group gi alone as a table, its default work table (the lone group's
    slabs split over clusters), its work table with no group pipelined),
    on the device."""
    from oswald_tpu_torch.kernels.sw_lanes import work_table
    grp = engine.state.groups[gi:gi + 1].contiguous()
    return grp, work_table(grp), work_table(grp, 1 << 30)


def kernel_vs_plain(engine, queries):
    """Phase 3: sw_groups against sw_groups_ref on one group of every bin.
    Returns (max_abs_err, kernel ms, plain ms, bound ms, bound by, wants):
    the times summed over the bins at the first query length, and the plain
    version's scores there, {group index: int32[1, 8, 128]}."""
    from oswald_tpu_torch.kernels.sw_lanes import sw_groups, sw_groups_ref
    st, dev = engine.state, engine.device
    table, firsts = first_groups(engine)
    cfg = engine.config
    worst, sums, wants = 0, {}, {}
    say("bin L, query m, kernel ms, plain ms")
    for m, q in queries:
        qt = torch.as_tensor(q, dtype=torch.int32, device=dev)
        for gi in firsts:
            grp, work, row_work = sub_table(engine, gi)
            args = (st.residues, grp, qt, engine.submat_dev, cfg.open_gap,
                    cfg.extend_gap)
            got, k_ms = timed(lambda: sw_groups(*args, engine.scratch, work),
                              TIMED_RUNS)
            want, p_ms = timed(lambda: sw_groups_ref(*args), 1)
            as_rows = sw_groups(*args, engine.scratch, row_work)
            one_block = sw_groups(*args, engine.scratch, work.plain())
            err = max(int((got - want).abs().max()),
                      int((as_rows - want).abs().max()),
                      int((one_block - want).abs().max()))
            worst = max(worst, err)
            if m == queries[0][0]:
                wants[gi] = want
            s = sums.setdefault(m, [0.0, 0.0])
            s[0] += k_ms
            s[1] += p_ms
            say(f"{int(table[gi, 1])}, {m}, {k_ms:.3f}, {p_ms:.1f}")
            if err:
                raise AssertionError(f"sw_groups differs from sw_groups_ref "
                                     f"by {err} on bin {table[gi, 1]}, "
                                     f"m={m}")
        say(f"all bins, m={m}: kernel {s[0]:.3f} ms, plain {s[1]:.1f} ms")
    m = queries[0][0]
    lanes = 8 * 128
    cols = sum(int(table[gi, 1]) for gi in firsts)
    b_ms, b_by = bound(
        cols * lanes * m,
        cols * lanes + len(firsts) * (8 + 4 * m + 4 * 24 * 24 + 4 * lanes))
    say(f"all bins, m={m}: bound {b_ms:.3f} ms (by {b_by})")
    hold_to_bound(f"sw_groups, one group of every bin, m={m}", sums[m][0],
                  b_ms)
    return worst, sums[m][0], sums[m][1], b_ms, b_by, wants


def rescore_on_cpu(engine, query, res):
    """The plain version's scores of `query` against the hits' sequences."""
    from oswald_tpu_torch.alphabet import DUMMY
    from oswald_tpu_torch.kernels.sw_lanes import sw_lanes_ref
    seqs = [engine.db.sequence_of(int(i)) for i in res.seq_ids]
    cols = np.full((max(len(s) for s in seqs), len(seqs)), DUMMY, np.int8)
    for j, s in enumerate(seqs):
        cols[:len(s), j] = s
    return sw_lanes_ref(torch.from_numpy(cols),
                        torch.as_tensor(query, dtype=torch.int32),
                        torch.as_tensor(engine.submat, dtype=torch.int32),
                        engine.config.open_gap,
                        engine.config.extend_gap).numpy()


def main_path(engine, queries):
    """Phase 4: searches through the engine, counting kernel launches.
    Returns (launches, {m: (result, seconds per search)})."""
    from oswald_tpu_torch.kernels import sw_lanes
    out = {}
    sw_lanes.launches = 0
    for m, q in queries:
        engine.search(q)                                    # warm-up
        times = []
        for _ in range(TIMED_RUNS):
            t0 = time.perf_counter()
            res = engine.search(q, f"q{m}")
            times.append(time.perf_counter() - t0)
        out[m] = (res, statistics.median(times))
    return sw_lanes.launches, out


def check_results(engine, queries, results):
    k = min(engine.config.top, engine.db.n_seqs)
    for m, q in queries:
        res, _ = results[m]
        if len(res.scores) != k or res.evalues is None or \
                not np.isfinite(res.evalues).all():
            raise AssertionError(f"m={m}: malformed result {res}")
        if (np.diff(res.scores) > 0).any():
            raise AssertionError(f"m={m}: scores not descending")
        want = rescore_on_cpu(engine, q, res)
        if not np.array_equal(want, res.scores):
            raise AssertionError(f"m={m}: hit scores {res.scores.tolist()} "
                                 f"!= CPU rescoring {want.tolist()}")
        say(f"m={m}: top {res.titles[0]} score {int(res.scores[0])} "
            f"E={res.evalues[0]:.3g}; {k} hits rescored equal on CPU")
    top = results[queries[0][0]][0]
    if top.titles[0] != "planted_0" or not top.evalues[0] < 1e-3:
        raise AssertionError(f"planted homolog not first with E < 1e-3: "
                             f"{top.titles[0]} E={top.evalues[0]}")


def wall_ms(fn):
    """(result, milliseconds) of one fn() on the host clock, with the card
    idle before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def packed_layouts(engine, mixed, uniform):
    """{name: [(q_packed, segs) on the device, ...]}: the packing plan of
    the mixed queries (unequal segments, filler blocks) and the uniform
    queries as equal segments of one q_packed."""
    from oswald_tpu_torch.engine.search import (mixed_pack_plan,
                                                plan_segments)
    cfg, dev = engine.config, engine.device
    bins, rest = mixed_pack_plan(cfg.batch_query_pack_rows, cfg.u_rows, mixed)
    if rest or not bins:
        raise AssertionError(f"mixed queries did not all pack: rest {rest}")
    out = {"mixed": [
        (torch.from_numpy(qp).to(dev),
         torch.from_numpy(plan_segments(idxs, sm, used, cfg.u_rows,
                                        mixed)).to(dev))
        for idxs, qp, sm, used in bins]}
    m = len(uniform[0])
    out["uniform"] = [(
        torch.as_tensor(np.concatenate(uniform), dtype=torch.int32,
                        device=dev),
        torch.tensor([(i * m, m) for i in range(len(uniform))],
                     dtype=torch.int32, device=dev))]
    return out


def packed_vs_plain(engine, layouts):
    """Phase 5: sw_groups_packed against sw_groups_packed_ref on one group
    of every bin, every launch of every layout.  Returns (max_abs_err,
    kernel ms, plain ms, bound ms, bound by), the times summed over the
    bins and launches of the first layout."""
    from oswald_tpu_torch.kernels.sw_lanes import (sw_groups_packed,
                                                   sw_groups_packed_ref)
    st, cfg = engine.state, engine.config
    table, firsts = first_groups(engine)
    lanes = 8 * 128
    worst, sums = 0, {}
    say("layout, launch, segments, rows, kernel ms, plain ms (all bins)")
    for name, launches in layouts.items():
        s = sums.setdefault(name, [0.0, 0.0, 0, 0])
        for li, (qp, segs) in enumerate(launches):
            rows = int(segs[:, 1].sum())
            k_sum = p_sum = 0.0
            for gi in firsts:
                grp, work, row_work = sub_table(engine, gi)
                args = (st.residues, grp, qp, segs, engine.submat_dev,
                        cfg.open_gap, cfg.extend_gap)
                got, k_ms = timed(
                    lambda: sw_groups_packed(*args, engine.scratch, work),
                    TIMED_RUNS)
                # the plain version is a launch-bound Python loop: one run
                want, p_ms = wall_ms(lambda: sw_groups_packed_ref(*args))
                as_rows = sw_groups_packed(*args, engine.scratch, row_work)
                err = max(int((got - want).abs().max()),
                          int((as_rows - want).abs().max()))
                worst = max(worst, err)
                if err:
                    raise AssertionError(
                        f"sw_groups_packed differs from its plain version "
                        f"by {err} on bin {table[gi, 1]}, layout {name}, "
                        f"launch {li}")
                k_sum += k_ms
                p_sum += p_ms
                L = int(table[gi, 1])
                s[2] += L * lanes * rows
                s[3] += (L * lanes + 8 + 4 * qp.numel() + 8 * len(segs) +
                         4 * 24 * 24 + 4 * lanes * len(segs))
            s[0] += k_sum
            s[1] += p_sum
            say(f"{name}, {li}, {len(segs)}, {rows}, {k_sum:.3f}, "
                f"{p_sum:.1f}")
        say(f"{name}: kernel {s[0]:.3f} ms, plain {s[1]:.1f} ms")
    first = sums[next(iter(layouts))]
    b_ms, b_by = bound(first[2], first[3])
    say(f"{next(iter(layouts))}: bound {b_ms:.3f} ms (by {b_by})")
    hold_to_bound(f"sw_groups_packed, {next(iter(layouts))} layout", first[0],
                  b_ms)
    return worst, first[0], first[1], b_ms, b_by


def same_hits(a, b):
    return np.array_equal(a.scores, b.scores) and \
        np.array_equal(a.seq_ids, b.seq_ids) and a.titles == b.titles


def batched_path(engine, sets, stream_queries, card):
    """Phase 6: search_many of each query set and search_stream, with the
    kernels' launch counts set to 0 before each and read after.  Returns
    {kernel: launches} summed over the batched and stream runs."""
    from oswald_tpu_torch.engine.search import mixed_pack_plan
    from oswald_tpu_torch.kernels import sw_lanes
    from oswald_tpu_torch.utils.metrics import gcups
    cfg, D = engine.config, engine.db.n_residues
    total = {"sw_groups": 0, "sw_groups_packed": 0}
    runs = TIMED_RUNS + 1

    def drive(label, qs, fn, want_packed, want_plain, planted):
        sw_lanes.launches = sw_lanes.launches_packed = 0
        fn()                                                # warm-up
        times = []
        for _ in range(TIMED_RUNS):
            t0 = time.perf_counter()
            res = fn()
            times.append(time.perf_counter() - t0)
        got = (sw_lanes.launches_packed, sw_lanes.launches)
        if got != (runs * want_packed, runs * want_plain):
            raise AssertionError(
                f"{label}: {got[0]} packed and {got[1]} sw_groups launches "
                f"in {runs} runs, the plan gives {want_packed} and "
                f"{want_plain} per run")
        total["sw_groups_packed"] += got[0]
        total["sw_groups"] += got[1]
        # the same queries one by one: the results to hold the batch to,
        # and the time to set beside it
        singles, s_times = None, []
        for _ in range(runs):
            t0 = time.perf_counter()
            singles = [engine.search(q) for q in qs]
            s_times.append(time.perf_counter() - t0)
        for i, (a, b) in enumerate(zip(singles, res)):
            if not same_hits(a, b):
                raise AssertionError(f"{label}: query {i} differs from its "
                                     f"single search")
        if planted is not None and (
                res[planted].titles[0] != "planted_0" or
                not res[planted].evalues[0] < 1e-3):
            raise AssertionError(f"{label}: planted homolog not first for "
                                 f"query {planted}: {res[planted].titles[0]}")
        i = planted if planted is not None else 0
        want = rescore_on_cpu(engine, qs[i], res[i])
        if not np.array_equal(want, res[i].scores):
            raise AssertionError(f"{label}: query {i} hit scores != CPU "
                                 f"rescoring")
        Q = sum(len(q) for q in qs)
        sec, one = statistics.median(times), statistics.median(s_times[1:])
        say(f"{label}: {len(qs)} queries, {Q} residues, "
            f"{want_packed} packed + {want_plain} sw_groups launches: "
            f"{sec:.4f} s = {gcups(Q, D, sec):.1f} GCUPS; one by one "
            f"{one:.4f} s = {gcups(Q, D, one):.1f} GCUPS [{card}]")
        return res

    for label, qs, planted in sets:
        bins, rest = mixed_pack_plan(cfg.batch_query_pack_rows, cfg.u_rows,
                                     qs)
        res = drive(f"batch {label}", qs, lambda: engine.search_many(qs),
                    len(bins), len(rest), planted)
        if any(r.batch_n != len(qs) or r.elapsed != res[0].elapsed
               for r in res):
            raise AssertionError(f"batch {label}: results do not share the "
                                 f"batch's time and size")
    drive(f"stream window {STREAM_WINDOW}", stream_queries,
          lambda: engine.search_stream(stream_queries), 0,
          len(stream_queries), None)
    return total


def longest_bin(engine):
    """[(label, group table, work table)] of the longest bin alone and of
    one group of it alone, on the device."""
    from oswald_tpu_torch.kernels.sw_lanes import work_table
    st = engine.state
    table = st.groups.cpu().numpy()
    top = int(table[:, 1].max())
    longest = st.groups[torch.from_numpy(table[:, 1] == top).to(
        st.groups.device)].contiguous()
    one = longest[:1].contiguous()
    return [(f"the {len(longest)} groups of L={top} alone", longest,
             work_table(longest)),
            ("one group of them alone", one, work_table(one))]


def release_database(capped: bool, seed=SEED):
    """(PackedDB, the lengths' source) of the database the benchmark's
    swissprot-blosum62 configuration holds: the Swiss-Prot 2013_11 length
    spectrum (benchmark/perfkit/data.py::release_lengths: 541,561 sequences,
    192,480,382 residues, the longest 35,213), or with `capped` as many
    sequences of the port's synthetic model capped at 5478 (the first
    database of the benchmark, with no giants).  Random residues."""
    from oswald_tpu_torch.io import pack_sequences
    from oswald_tpu_torch.io.synth import realistic_lengths
    bench = Path(__file__).resolve().parent / "benchmark"
    config = json.loads((bench / "configs" /
                         "swissprot-blosum62.json").read_text())
    rng = np.random.default_rng(seed)
    if capped:
        lengths = realistic_lengths(rng, int(config["n_seqs"]), 5478)
        what = "capped at 5478"
    else:
        sys.path.insert(0, str(bench))
        from perfkit.data import release_lengths
        lengths = release_lengths(config)
        what = "Swiss-Prot 2013_11 spectrum"
    flat = rng.integers(0, 20, size=int(lengths.sum()), dtype=np.int8)
    db = pack_sequences(flat, lengths, [""] * len(lengths))
    return db, what


def giants(card, seed=SEED):
    """Phase 4b: sw_groups over the release database, whose last group
    holds the giants, split over clusters, and its plain launch (nothing
    split), timed in turn A B B A at m = 5478 and 144, their scores
    equal; the giant group alone, split and plain; the capped database,
    which must split nothing (its table its plain one, no cluster
    launch); the giant group alone at m = 144 against sw_groups_ref; the
    peptide cell's launches (peptide_launches).  Prints K, the kernels'
    registers and the clusters the card holds.  Fails if a time is under
    its bound or a score differs."""
    from oswald_tpu_torch.io.device_db import to_device
    from oswald_tpu_torch.kernels import build, sw_lanes
    from oswald_tpu_torch.kernels.sw_lanes import (LONG_FROM, card_blocks,
                                                   max_active_clusters,
                                                   sw_groups, sw_groups_ref,
                                                   work_table)
    from oswald_tpu_torch.submat import get_submat
    from oswald_tpu_torch.utils.metrics import gcups
    dev = torch.device("cuda", 0)
    sm = torch.as_tensor(get_submat("blosum62"), dtype=torch.int32,
                         device=dev)
    for name in ("sw_groups", "sw_groups_packed"):
        for line in (build.build_logs.get(name) or "").splitlines():
            if "registers" in line:
                say(f"{name}: {line.strip()}")
        held = {K: max_active_clusters(K, name) for K in (2, 4, 8)}
        say(f"{name}: clusters the card holds at once (K: clusters, "
            f"blocks): " + ", ".join(f"{K}: {n}, {n * K}"
                                     for K, n in held.items()) +
            f"; the card's block slots {card_blocks()} [{card}]")
    rng = np.random.default_rng(seed + 2)
    for capped in (False, True):
        db, what = release_database(capped, seed)
        st = to_device(db, dev)
        work = st.work
        scratch = torch.empty((2,) + tuple(st.residues.shape),
                              dtype=torch.int32, device=dev)
        top = int(st.groups[:, 1].max())
        say(f"{what}: {db.n_seqs} sequences, {db.n_residues} residues, "
            f"{st.groups.shape[0]} groups, the longest {top} columns; work "
            f"table {len(work)} blocks, K = {work.cluster}, "
            f"{work.split_slabs} slabs split")
        if capped != (work.plain() is work):
            raise AssertionError(f"{what}: {work.split_slabs} slabs split")
        tables = [("whole database", st.groups, work)]
        if not capped:
            last = st.groups[-1:].contiguous()
            tables.append((f"the giant group alone ({top} columns)", last,
                           work_table(last, LONG_FROM)))
        for m in (5478, 144):
            q = torch.from_numpy(rng.integers(0, 20, size=m).astype(
                np.int32)).to(dev)
            for label, groups, w in tables:
                runs = {"plain": w} if capped else {"split": w,
                                                    "plain": w.plain()}

                def launch(k):
                    return sw_groups(st.residues, groups, q, sm, 10, 2,
                                     scratch, runs[k])

                before = sw_lanes.cluster_launches
                got = {k: launch(k) for k in runs}
                if sw_lanes.cluster_launches - before != (not capped):
                    raise AssertionError(f"{what}, {label}: cluster "
                                         f"launches counted wrong")
                if not capped and not torch.equal(got["split"],
                                                  got["plain"]):
                    diff = int((got["split"] - got["plain"]).abs().max())
                    raise AssertionError(f"{what}, {label}, m={m}: split "
                                         f"and plain launches differ by "
                                         f"{diff}")
                if not capped and groups is not st.groups and m == 144:
                    # the split path against the plain PyTorch version, on
                    # the longest group there is
                    want = sw_groups_ref(st.residues, groups, q, sm, 10, 2)
                    if not torch.equal(got["split"], want):
                        raise AssertionError(
                            f"{what}, {label}, m={m}: the split launch "
                            f"differs from sw_groups_ref in "
                            f"{int((got['split'] != want).sum())} lanes")
                    say(f"{what}, {label}, m={m}: split launch == "
                        f"sw_groups_ref (exact) [{card}]")
                times = {k: [] for k in runs}
                for r in range(1 if capped else 2):
                    for k in sorted(runs, reverse=r % 2 == 1):
                        times[k].append(timed(lambda: launch(k),
                                              TIMED_RUNS)[1])
                cols = int(groups[:, 1].sum())
                b_ms, b_by = bound(cols * 1024 * m, cols * 1024)
                parts = []
                for k, v in times.items():
                    ms = statistics.mean(v)
                    hold_to_bound(f"{what}, {label}, {k}, m={m}", ms, b_ms)
                    rate = f", {gcups(m, db.n_residues, ms / 1e3):.1f} " \
                        f"GCUPS" if groups is st.groups else ""
                    each = " / ".join(f"{x:.2f}" for x in v)
                    parts.append(f"{k} {ms:.2f} ms ({each}{rate})")
                say(f"{what}, {label}, m={m}: " + "; ".join(parts) +
                    f"; bound {b_ms:.2f} ms by {b_by} [{card}]")
        if not capped:
            peptide_launches(st, scratch, rng, what, card)
        del st, scratch
        torch.cuda.empty_cache()


def peptide_launches(st, scratch, rng, what, card):
    """Phase 4b, the peptide cell's launches on the release database: a
    batch of N_PEPTIDES peptides packed as the engine packs it (batch_plan:
    bins of 32 segments of 1-2 strips, so a split slab's strips cross sets,
    blocks and, through the scratch, wrap round to set 0), PAM30 9/1.
    Every launch of the plan, split and on the plain table, PEPTIDE_ROUNDS
    rounds in turn: every score tensor equal to the first round's plain
    one, and the rounds' times.  Then the first PEPTIDE_REF_SEGS segments
    of the first bin on the giant group alone, split, against
    sw_groups_packed_ref."""
    from oswald_tpu_torch.engine.search import SearchConfig, batch_plan
    from oswald_tpu_torch.kernels.sw_lanes import (LONG_FROM, STRIP_ROWS,
                                                   sw_groups_packed,
                                                   sw_groups_packed_ref,
                                                   work_table)
    from oswald_tpu_torch.submat import get_submat
    dev = st.groups.device
    sm = torch.as_tensor(get_submat("pam30"), dtype=torch.int32, device=dev)
    og, eg = 9, 1
    peptides = [rng.integers(0, 20, size=int(n)).astype(np.int32)
                for n in rng.integers(PEPTIDE_LO, PEPTIDE_HI + 1,
                                      size=N_PEPTIDES)]
    plan = batch_plan(SearchConfig(matrix="pam30", open_gap=og,
                                   extend_gap=eg), peptides)
    launches = [(torch.from_numpy(np.ascontiguousarray(rows)).to(dev),
                 torch.from_numpy(np.ascontiguousarray(segs)).to(dev))
                for _, ls in plan for rows, segs in ls]
    if any(segs is None for _, ls in plan for _, segs in ls):
        raise AssertionError("the peptide batch left a query unpacked")
    tables = {"split": st.work, "plain": st.work.plain()}

    def run(k):
        return [sw_groups_packed(st.residues, st.groups, rows, segs, sm, og,
                                 eg, scratch, tables[k])
                for rows, segs in launches]

    want = run("plain")
    times = {k: [] for k in tables}
    bad = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for r in range(PEPTIDE_ROUNDS):
        for k in sorted(tables, reverse=r % 2 == 1):
            start.record()
            got = run(k)
            end.record()
            torch.cuda.synchronize()
            times[k].append(start.elapsed_time(end))
            bad += sum(int((a != b).sum()) for a, b in zip(got, want))
            del got
    if bad:
        raise AssertionError(f"{what}, peptides: {bad} scores of the split "
                             f"and plain rounds differ from the first plain "
                             f"round's")
    say(f"{what}, a batch of {N_PEPTIDES} peptides of {PEPTIDE_LO}-"
        f"{PEPTIDE_HI} (PAM30 {og}/{eg}), {len(launches)} packed launches of "
        f"{max(len(s) for _, s in launches)} segments at most, "
        f"{PEPTIDE_ROUNDS} rounds in turn, every score tensor equal: " +
        "; ".join(f"{k} median {statistics.median(v):.2f} ms a batch "
                  f"({min(v):.2f}-{max(v):.2f})" for k, v in times.items()) +
        f" [{card}]")
    last = st.groups[-1:].contiguous()
    rows, segs = launches[0]
    segs = segs[:PEPTIDE_REF_SEGS].contiguous()
    w = work_table(last, LONG_FROM)
    got = sw_groups_packed(st.residues, last, rows, segs, sm, og, eg,
                           scratch, w)
    ref = sw_groups_packed_ref(st.residues, last, rows, segs, sm, og, eg)
    if not torch.equal(got, ref):
        raise AssertionError(f"{what}, peptides on the giant group: the "
                             f"split launch differs from "
                             f"sw_groups_packed_ref in "
                             f"{int((got != ref).sum())} lanes")
    strips = int(((segs[:, 1] + STRIP_ROWS - 1) // STRIP_ROWS).sum())
    say(f"{what}, the first {len(segs)} peptides of a bin ({strips} "
        f"strips) on the giant group alone, K = {w.cluster}: split launch "
        f"== sw_groups_packed_ref (exact) [{card}]")


def whole_and_longest(engine, launch):
    """CUDA-event times of launch(groups, work) over the whole database,
    over the longest bin alone and over one group of it alone: (whole
    milliseconds, the other two as text)."""
    st = engine.state
    _, all_ms = timed(lambda: launch(st.groups, st.work), TIMED_RUNS)
    parts = []
    for label, groups, work in longest_bin(engine):
        _, ms = timed(lambda: launch(groups, work), TIMED_RUNS)
        parts.append(f"{label}: {ms:.2f} ms")
    return all_ms, "; ".join(parts)


def single_tail(engine, queries, card):
    """sw_groups over the whole database beside its bound, over the longest
    bin alone and over one group of it alone (the latency case).  Returns
    {m: milliseconds over the whole database}."""
    from oswald_tpu_torch.kernels.sw_lanes import sw_groups
    from oswald_tpu_torch.utils.metrics import gcups
    st, cfg = engine.state, engine.config
    out = {}
    for m, q in queries:
        qt = torch.as_tensor(q, dtype=torch.int32, device=engine.device)
        all_ms, parts = whole_and_longest(
            engine, lambda groups, work: sw_groups(
                st.residues, groups, qt, engine.submat_dev, cfg.open_gap,
                cfg.extend_gap, engine.scratch, work))
        b_ms, b_by = bound(st.residues.shape[0] * 1024 * m,
                           st.residues.numel())
        say(f"sw_groups over the whole database, m={m}: {all_ms:.2f} ms "
            f"({gcups(m, engine.db.n_residues, all_ms / 1e3):.1f} GCUPS; "
            f"bound {b_ms:.2f} ms by {b_by}, {100 * b_ms / all_ms:.0f}% of "
            f"the time); {parts} [{card}]")
        hold_to_bound(f"sw_groups over the whole database, m={m}", all_ms,
                      b_ms)
        out[m] = all_ms
    return out


def packed_tail(engine, layout, card):
    """The first packed launch over the whole database beside its bound,
    over the longest bin alone and over one group of it alone."""
    from oswald_tpu_torch.kernels.sw_lanes import sw_groups_packed
    st, cfg = engine.state, engine.config
    qp, segs = layout[0]
    all_ms, parts = whole_and_longest(
        engine, lambda groups, work: sw_groups_packed(
            st.residues, groups, qp, segs, engine.submat_dev, cfg.open_gap,
            cfg.extend_gap, engine.scratch, work))
    rows = int(segs[:, 1].sum())
    b_ms, b_by = bound(st.residues.shape[0] * 1024 * rows,
                       st.residues.numel())
    say(f"sw_groups_packed over the whole database, {len(segs)} segments, "
        f"{rows} rows: {all_ms:.2f} ms (bound {b_ms:.2f} ms by {b_by}, "
        f"{100 * b_ms / all_ms:.0f}% of the time); {parts} [{card}]")
    hold_to_bound("sw_groups_packed over the whole database", all_ms, b_ms)


def same_code(engine, q_long, card, engine_ms):
    """Lab base ahead at U = 16 and sw_groups, the same code, over the whole
    database on the same query, timed in turn: A B B A, SAME_CODE_ROUNDS
    times, each time the mean of TIMED_RUNS launches after a warm-up.  The
    two medians must agree within SAME_CODE_RTOL; phase 4's sw_groups time
    (engine_ms), taken minutes earlier, is printed beside them.  Returns
    {kernel: median milliseconds}."""
    from oswald_tpu_torch.kernels.sw_lab import label, sw_groups_lab
    from oswald_tpu_torch.kernels.sw_lanes import STRIP_ROWS, sw_groups
    st, cfg = engine.state, engine.config
    qt = torch.as_tensor(q_long, dtype=torch.int32, device=engine.device)
    args = (st.residues, st.groups, qt, engine.submat_dev, cfg.open_gap,
            cfg.extend_gap)
    lab_name = label("base", STRIP_ROWS, True)
    # the lab launches a table's plain version as a plain grid: so does
    # sw_groups here, on the same code
    kernels = {
        "sw_groups": lambda: sw_groups(*args, engine.scratch,
                                       st.work.plain()),
        lab_name: lambda: sw_groups_lab(*args, "base", engine.scratch, True,
                                        st.work, STRIP_ROWS)}
    times = {k: [] for k in kernels}
    for r in range(2 * SAME_CODE_ROUNDS):
        for k in sorted(kernels, reverse=r % 2 == 1):
            _, ms = timed(kernels[k], TIMED_RUNS)
            times[k].append(ms)
    med = {k: statistics.median(v) for k, v in times.items()}
    lab_ms, eng_ms = med[lab_name], med["sw_groups"]
    say(f"lab {lab_name} and sw_groups over the whole database, m={Q_LONG}, "
        f"timed in turn ({2 * SAME_CODE_ROUNDS} x {TIMED_RUNS} launches "
        f"each): medians {lab_ms:.2f} and {eng_ms:.2f} ms "
        f"({100 * (lab_ms / eng_ms - 1):+.2f}%; lab "
        f"{min(times[lab_name]):.2f}-{max(times[lab_name]):.2f}, sw_groups "
        f"{min(times['sw_groups']):.2f}-{max(times['sw_groups']):.2f}); "
        f"phase 4's sw_groups {engine_ms:.2f} ms [{card}]")
    if abs(lab_ms / eng_ms - 1) > SAME_CODE_RTOL:
        raise AssertionError(f"base ahead at U = {STRIP_ROWS} is sw_groups' "
                             f"code, but takes {lab_ms:.2f} ms against "
                             f"{eng_ms:.2f} ms, timed in turn")
    return med


def lab_vs_plain(engine, q_long, wants, card, engine_ms):
    """Phase 7; engine_ms is phase 4's sw_groups time over the whole
    database at Q_LONG.  Returns (max_abs_err over every built kernel,
    bound of one group of every bin, {label: ms summed over one group of
    every bin}, {variant: ms over the whole database} at U = 16 with each
    column's reads in place, the same with them ahead, {label: ms} at the
    other strip heights, launches of run_variants)."""
    from oswald_tpu_torch import lab
    from oswald_tpu_torch.kernels import build, sw_lab
    from oswald_tpu_torch.kernels.sw_lab import (VARIANTS, label,
                                                 sw_groups_lab,
                                                 sw_groups_lab_tiled_ref)
    from oswald_tpu_torch.kernels.sw_lanes import STRIP_ROWS, work_table
    st, cfg, dev = engine.state, engine.config, engine.device
    table, firsts = first_groups(engine)
    qt = torch.as_tensor(q_long, dtype=torch.int32, device=dev)
    gaps = (cfg.open_gap, cfg.extend_gap)
    regs = sw_lab.ptxas_report(build.build_logs.get("sw_groups_lab"))
    lanes = 8 * 128
    cols = sum(int(table[gi, 1]) for gi in firsts)
    bins_b_ms, _ = bound(
        cols * lanes * Q_LONG,
        cols * lanes + len(firsts) * (8 + 4 * Q_LONG + 4 * 24 * 24 +
                                      4 * lanes))
    built = lab._built(list(VARIANTS))
    worst, bins_ms = 0, {}
    for v, u, ahead in built:
        name, total = label(v, u, ahead), 0.0
        for gi in firsts:
            grp, work, row_work = sub_table(engine, gi)
            args = (st.residues, grp, qt, engine.submat_dev, *gaps, v,
                    engine.scratch, ahead)
            got, ms = timed(lambda: sw_groups_lab(*args, work, u),
                            TIMED_RUNS)
            as_rows = sw_groups_lab(*args, row_work, u)
            err = max(int((got - wants[gi]).abs().max()),
                      int((as_rows - wants[gi]).abs().max()))
            worst = max(worst, err)
            if err:
                raise AssertionError(
                    f"sw_groups_lab {name} differs from sw_groups_ref by "
                    f"{err} on bin {table[gi, 1]}, m={Q_LONG}")
            total += ms
        bins_ms[name] = total
        hold_to_bound(f"sw_groups_lab {name}, one group of every bin", total,
                      bins_b_ms)
        say(f"lab {name}: one group of every bin, m={Q_LONG}: {total:.3f} ms "
            f"(bound {bins_b_ms:.3f}), pipelined and as rows equal to the "
            f"plain version; {regs.get(name, 'built before')}")
    # each variant's tiled plain version at each built strip height, on the
    # shortest bin's first group, dealt out as rows
    gi = firsts[0]
    c0, L = (int(x) for x in table[gi])
    host = (st.residues[c0:c0 + L].cpu(),
            torch.tensor([[0, L]], dtype=torch.int32),
            torch.as_tensor(q_long, dtype=torch.int32),
            torch.as_tensor(engine.submat, dtype=torch.int32))
    rows = work_table(host[1], 1 << 30)
    for v, u in sorted({(v, u) for v, u, _ in built}):
        want, p_ms = wall_ms(lambda: sw_groups_lab_tiled_ref(
            *host, *gaps, v, work=rows, strip_rows=u))
        if not torch.equal(want, wants[gi].cpu()):
            raise AssertionError(f"sw_groups_lab_tiled_ref {label(v, u)} "
                                 f"differs from sw_groups_ref on bin {L}")
        say(f"lab {label(v, u)}: sw_groups_lab_tiled_ref on bin {L}, "
            f"m={Q_LONG}: {p_ms:.1f} ms, equal")
    bad = lab.check_variants(engine, list(VARIANTS), say)
    if bad:
        raise AssertionError(f"{bad} lab kernel cases differ from "
                             f"sw_groups over the whole database")
    sw_lab.launches_lab = 0
    whole_ms = lab.run_variants(engine, list(VARIANTS), Q_LONG, card, say)
    ahead_ms = lab.run_variants(engine, list(VARIANTS), Q_LONG, card, say,
                                load_ahead=True)
    rows_ms = {}
    for u in sorted({u for _, u, _ in built} - {STRIP_ROWS}):
        for v, ms in lab.run_variants(engine, list(VARIANTS), Q_LONG, card,
                                      say, True, u).items():
            rows_ms[label(v, u)] = ms
    launches = sw_lab.launches_lab
    whole_b_ms, _ = bound(st.residues.shape[0] * lanes * Q_LONG,
                          st.residues.numel())
    timed_all = {**{label(v, STRIP_ROWS): ms for v, ms in whole_ms.items()},
                 **{label(v, STRIP_ROWS, True): ms
                    for v, ms in ahead_ms.items()},
                 **{k + sw_lab.AHEAD: ms for k, ms in rows_ms.items()}}
    for name, ms in timed_all.items():
        hold_to_bound(f"sw_groups_lab {name} over the whole database", ms,
                      whole_b_ms)
    same_code(engine, q_long, card, engine_ms)
    return worst, bins_b_ms, bins_ms, whole_ms, ahead_ms, rows_ms, launches


def host_stream_breakdown(engine, hs, queries, card):
    """Where a host_stream search's time goes: the kernels alone, launched
    slice by slice on the resident engine's copy of the same groups (CUDA
    events); the whole sweep, with fills, copies and drains (host clock);
    and the host's top-k and moments."""
    from oswald_tpu_torch.engine.search import check_query
    from oswald_tpu_torch.kernels.sw_lanes import sw_groups, work_table
    st, cfg = engine.state, engine.config
    k = min(cfg.top, engine.db.n_seqs)
    tables = [st.groups[sl.slot0 // 1024:
                        sl.slot0 // 1024 + sl.groups.shape[0]].contiguous()
              for sl in hs._hs_slices]
    tables = [(t, work_table(t)) for t in tables]
    for m, q in queries:
        qc = check_query(q, cfg)
        qt = torch.from_numpy(qc).to(engine.device)

        def sliced():
            for table, work in tables:
                sw_groups(st.residues, table, qt, engine.submat_dev,
                          cfg.open_gap, cfg.extend_gap, engine.scratch, work)
        _, kernels_ms = timed(sliced, TIMED_RUNS)
        sweeps, reduces = [], []
        for _ in range(TIMED_RUNS):
            scores, ms = wall_ms(lambda: hs._host_stream_scores(qc))
            sweeps.append(ms)
            t0 = time.perf_counter()
            hs._host_reduce(scores[None], k)
            reduces.append((time.perf_counter() - t0) * 1e3)
        say(f"host_stream m={m}: kernels alone, slice by slice "
            f"{kernels_ms:.2f} ms; sweep {statistics.median(sweeps):.2f} ms; "
            f"host top-k and moments {statistics.median(reduces):.2f} ms "
            f"[{card}]")


def host_stream_path(db, engine, queries, mixed, card, resident_peak):
    """Phase 8.  Returns {kernel: launches} of the host_stream engines'
    searches."""
    from oswald_tpu_torch.engine import SearchConfig, SearchEngine
    from oswald_tpu_torch.engine import planner
    from oswald_tpu_torch.engine.search import mixed_pack_plan
    from oswald_tpu_torch.kernels import sw_lanes
    from oswald_tpu_torch.utils.metrics import gcups
    dev, D = engine.device, db.n_residues
    mib = 1 << 20
    valid = engine.valid
    want_scores = {m: engine.score_all(q)[valid] for m, q in queries}
    want_hits = {m: engine.search(q) for m, q in queries}
    want_batch = engine.search_many(mixed)
    bins, rest = mixed_pack_plan(engine.config.batch_query_pack_rows,
                                 engine.config.u_rows, mixed)
    Q = sum(len(q) for q in mixed)
    total = {"sw_groups": 0, "sw_groups_packed": 0}

    def same_stats(a, b, what):
        if not same_hits(a, b):
            raise AssertionError(f"{what}: hits differ from the resident "
                                 f"engine's")
        if not np.allclose(a.evalues, b.evalues, rtol=1e-4, atol=0):
            raise AssertionError(f"{what}: E-values differ beyond rtol 1e-4")

    def drive(label, **kw):
        """Build a host_stream engine and hold every result of it to the
        resident engine's; returns (engine, peak device bytes)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        hs = SearchEngine(db, SearchConfig(profile_mode="host_stream", **kw),
                          device=dev)
        setup_s = time.perf_counter() - t0
        slices = hs._hs_slices
        if len(slices) < 2 or not any(len(s.spans) > 1 for s in slices):
            raise AssertionError(
                f"host_stream cut {len(slices)} slices, none of several "
                f"spans: nothing to overlap")
        say(f"host_stream {label}: {len(slices)} slices of at most "
            f"{max(s.n_bytes for s in slices) / 1e6:.1f} MB, "
            f"{sum(len(s.spans) for s in slices)} spans, setup "
            f"{setup_s:.2f} s [{card}]")
        if not np.array_equal(hs.ids_flat, engine.ids_flat):
            raise AssertionError("host_stream slots differ from the "
                                 "resident engine's")
        sw_lanes.launches = sw_lanes.launches_packed = 0
        searches = 0
        for m, q in queries:
            for _ in range(3):
                if not torch.equal(hs.score_all(q)[valid], want_scores[m]):
                    raise AssertionError(
                        f"host_stream {label}: score_all differs from the "
                        f"resident engine's at m={m}")
            hs.search(q)                                    # warm-up
            ts = []
            for _ in range(TIMED_RUNS):
                t0 = time.perf_counter()
                res = hs.search(q)
                ts.append(time.perf_counter() - t0)
                same_stats(want_hits[m], res, f"host_stream {label} m={m}")
            searches += 3 + 1 + TIMED_RUNS
            sec = statistics.median(ts)
            say(f"host_stream {label} search m={m}: {sec:.4f} s, "
                f"{gcups(m, D, sec):.1f} GCUPS [{card}]")
        if (sw_lanes.launches, sw_lanes.launches_packed) != \
                (len(slices) * searches, 0):
            raise AssertionError(
                f"host_stream {label}: {sw_lanes.launches} sw_groups "
                f"launches in {searches} searches over {len(slices)} slices")
        total["sw_groups"] += sw_lanes.launches
        sw_lanes.launches = sw_lanes.launches_packed = 0
        t0 = time.perf_counter()
        got = hs.search_many(mixed)
        sec = time.perf_counter() - t0
        for i, (a, b) in enumerate(zip(want_batch, got)):
            same_stats(a, b, f"host_stream {label} batch query {i}")
        if (sw_lanes.launches_packed, sw_lanes.launches) != \
                (len(slices) * len(bins), len(slices) * len(rest)):
            raise AssertionError(
                f"host_stream {label} batch: {sw_lanes.launches_packed} "
                f"packed and {sw_lanes.launches} sw_groups launches; "
                f"{len(slices)} slices x ({len(bins)} + {len(rest)}) plan "
                f"launches")
        total["sw_groups"] += sw_lanes.launches
        total["sw_groups_packed"] += sw_lanes.launches_packed
        say(f"host_stream {label} batch mixed 100-400: {len(mixed)} "
            f"queries, {Q} residues, {len(bins)} packed launches x "
            f"{len(slices)} slices: {sec:.4f} s = {gcups(Q, D, sec):.1f} "
            f"GCUPS (one run) [{card}]")
        torch.cuda.synchronize()
        return hs, torch.cuda.max_memory_allocated() - base

    hs, hs_peak = drive("overlap")
    big = max(hs._hs_slices, key=lambda s: s.n_bytes)
    hs_plan = planner.host_stream_bytes(big.n_bytes, big.n_slots)
    host_stream_breakdown(engine, hs, queries, card)
    del hs
    drive("serial", host_stream_overlap=False)
    plan = planner.plan_profile_mode(db, planner.device_hbm_bytes(dev),
                                     config=engine.config)
    say(f"peak device memory: resident engine {resident_peak / mib:.1f} MiB "
        f"(planner: {plan.resident_bytes / mib:.1f} MiB); host_stream "
        f"engine {hs_peak / mib:.1f} MiB (planner: {hs_plan / mib:.1f} MiB) "
        f"[{card}]")

    def auto_mode(**kw):
        return SearchEngine(db, SearchConfig(profile_mode="auto", **kw),
                            device=dev).mode

    mode = auto_mode(hbm_budget_bytes=plan.resident_bytes // 2)
    if mode != "host_stream":
        raise AssertionError(f"auto under half the resident need resolved "
                             f"to {mode}")
    mode = auto_mode()
    if mode != "precompute":
        raise AssertionError(f"auto with the card's memory resolved to "
                             f"{mode}")
    return total


def _post(base, payload):
    req = urllib.request.Request(
        base + "/search", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return json.loads(r.read())


def rescore_alignment(aln, submat, og, eg):
    """The score of a served alignment, from its aligned rows."""
    from oswald_tpu_torch.alphabet import encode
    score, in_gap = 0, False
    qa = encode(aln["q_aln"].replace("-", "*"))
    sa = encode(aln["s_aln"].replace("-", "*"))
    for qc, sc, qg, sg in zip(qa, sa, aln["q_aln"], aln["s_aln"]):
        if qg == "-" or sg == "-":
            score -= eg + (0 if in_gap else og)
            in_gap = True
        else:
            score += int(submat[qc, sc])
            in_gap = False
    return score


def latency_line(label, lat, wall, residues, card):
    """Print per-request percentiles and rates; returns the p50 in ms."""
    p = np.percentile(np.asarray(lat) * 1e3, [50, 95, 99])
    say(f"serve {label}: {len(lat)} requests, p50 {p[0]:.2f} ms, p95 "
        f"{p[1]:.2f} ms, p99 {p[2]:.2f} ms, {len(lat) / wall:.2f} requests/s"
        f", {residues / wall:.0f} query residues/s [{card}]")
    return p[0]


def cache_round_trip(engine, tmp, card):
    """Phase 9, first part: the kernel directory packed, unpacked into a
    fresh one and the build pointed there; warmup must run no nvcc."""
    from oswald_tpu_torch.kernels import build
    from oswald_tpu_torch.utils import compile_cache
    tar = os.path.join(tmp, "kernels.tar.gz")
    packed = compile_cache.pack_cache(tar)
    fresh = os.path.join(tmp, "kernels")
    unpacked = compile_cache.unpack_cache(tar, fresh)
    say(f"kernel cache: packed {packed['entries']} files "
        f"({packed['bytes'] / 1e6:.1f} MB) of {compile_cache.current_dir()}, "
        f"unpacked {unpacked['extracted']} into a fresh directory")
    compile_cache.enable_compile_cache(fresh, quiet=True)
    # the loaded-library table is keyed by directory: nothing loaded from
    # the checkout's build is reused below
    build.build_logs.clear()
    t0 = time.perf_counter()
    loaded = engine.warmup(Q_LONG, log=say)
    warm_s = time.perf_counter() - t0
    if build.build_logs:
        raise AssertionError("warmup from the unpacked cache ran nvcc")
    for name in ("sw_groups", "sw_groups_packed"):
        if name not in loaded or \
                build.library_path(name).parent != Path(fresh) or \
                (name, build.BLOCKS_PER_SM, Path(fresh)) not in build._libs:
            raise AssertionError(f"warmup did not load {name} from the "
                                 f"unpacked directory: {loaded}")
    say(f"warmup from the unpacked cache: {warm_s:.3f} s, no nvcc [{card}]")


def serve_requests(db, engine, q_long, mixed, card):
    """Phase 9, the server: the requests and checks the module describes."""
    from oswald_tpu_torch.alphabet import decode
    from oswald_tpu_torch.serve import SearchService, make_server
    cfg = engine.config
    service = SearchService(db, engine)
    httpd = make_server(service, port=0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        # one client, the 512-residue query without alignments: the first
        # request after warmup, then the steady state.  The client's first
        # urlopen builds urllib's opener (tens of ms, an ssl context), so a
        # /healthz comes first: the times are the server's
        _get(base, "/healthz")
        lat = []
        t_all = time.perf_counter()
        for _ in range(SERVE_SINGLE_REQUESTS):
            t0 = time.perf_counter()
            _post(base, {"query": decode(q_long)})
            lat.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t_all
        p50 = latency_line(f"1 client, m={Q_LONG}", lat, wall,
                           Q_LONG * len(lat), card)
        say(f"serve: first request after warmup {lat[0] * 1e3:.2f} ms, "
            f"{100 * (lat[0] * 1e3 / p50 - 1):+.1f}% against the p50 "
            f"[{card}]")

        # the planted query with alignments
        t0 = time.perf_counter()
        out = _post(base, {"query": decode(q_long), "align": True})
        a_ms = (time.perf_counter() - t0) * 1e3
        hits = out["results"][0]["hits"]
        if hits[0]["title"] != "planted_0" or not hits[0]["evalue"] < 1e-3:
            raise AssertionError(f"served align: planted homolog not first "
                                 f"with E < 1e-3: {hits[0]['title']} "
                                 f"E={hits[0]['evalue']}")
        for h in hits:
            got = rescore_alignment(h["alignment"], engine.submat,
                                    cfg.open_gap, cfg.extend_gap)
            if got != h["score"]:
                raise AssertionError(f"served align: {h['title']} rescores "
                                     f"{got}, hit score {h['score']}")
        res = engine.search(q_long)
        t0 = time.perf_counter()
        engine.align(q_long, res)
        tb_ms = (time.perf_counter() - t0) * 1e3
        say(f"serve align: {len(hits)} hits, each alignment rescored equal "
            f"to its score; request {a_ms:.1f} ms (p50 without {p50:.1f}); "
            f"traceback of {len(res.scores)} hits at m={Q_LONG} "
            f"{tb_ms:.1f} ms on the host [{card}]")

        # the mixed queries as requests of 1, 2, 3, 1, ... queries from
        # 8 clients at once, held to the same queries searched one by one
        titles = [f"mixed{i}" for i in range(len(mixed))]
        singles = [engine.search(q, t) for q, t in zip(mixed, titles)]
        spans, lo = [], 0
        while lo < len(mixed):
            spans.append((lo, min(lo + 1 + len(spans) % 3, len(mixed))))
            lo = spans[-1][1]
        todo, answers, errors = list(spans), {}, []
        lock = threading.Lock()

        def client():
            while True:
                with lock:
                    if not todo:
                        return
                    a, b = todo.pop()
                try:
                    answers[a, b] = _post(base, {
                        "queries": [decode(q) for q in mixed[a:b]],
                        "titles": titles[a:b]})
                except Exception as e:          # noqa: BLE001 - reported
                    errors.append(f"{a}:{b}: {e!r}")

        h0 = _get(base, "/healthz")
        threads = [threading.Thread(target=client)
                   for _ in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if errors or len(answers) != len(spans):
            raise AssertionError(f"served batch: {len(answers)} of "
                                 f"{len(spans)} answered; {errors[:3]}")
        for (a, b), out in answers.items():
            for i, got in zip(range(a, b), out["results"]):
                want, hits = singles[i], got["hits"]
                if got["query"] != titles[i] or \
                        [h["score"] for h in hits] != want.scores.tolist() \
                        or [h["id"] for h in hits] != want.seq_ids.tolist() \
                        or [h["title"] for h in hits] != want.titles:
                    raise AssertionError(f"served query {i} differs from its "
                                         f"single search")
                if not np.allclose([h["evalue"] for h in hits],
                                   want.evalues, rtol=1e-4, atol=0):
                    raise AssertionError(f"served query {i}: E-values beyond "
                                         f"rtol 1e-4")
        h1 = _get(base, "/healthz")
        d_req = h1["requests"] - h0["requests"]
        d_q = h1["queries"] - h0["queries"]
        d_disp = h1["dispatches"] - h0["dispatches"]
        if (d_req, d_q) != (len(spans), len(mixed)) or not d_disp < d_req:
            raise AssertionError(
                f"/healthz: {d_req} requests, {d_q} queries, {d_disp} "
                f"dispatches for {len(spans)} requests of {len(mixed)} "
                f"queries (fewer dispatches than requests: coalesced)")
        say(f"serve: {len(spans)} requests of 1-3 mixed queries from "
            f"{SERVE_CLIENTS} clients in {d_disp} dispatches, each equal to "
            f"its queries searched one by one")
        info = _get(base, "/info")
        if info["backend"] != "cuda" or \
                torch.cuda.get_device_name(0) not in info["devices"][0]:
            raise AssertionError(f"/info does not name the card: {info}")

        # 8 clients, one mixed query a request
        lat, lat_lock = [], threading.Lock()

        def one_by_one():
            for q in mixed:
                t0 = time.perf_counter()
                _post(base, {"query": decode(q)})
                with lat_lock:
                    lat.append(time.perf_counter() - t0)

        h0 = _get(base, "/healthz")
        threads = [threading.Thread(target=one_by_one)
                   for _ in range(SERVE_CLIENTS)]
        t_all = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t_all
        h1 = _get(base, "/healthz")
        if len(lat) != SERVE_CLIENTS * len(mixed):
            raise AssertionError(f"{SERVE_CLIENTS} clients: {len(lat)} of "
                                 f"{SERVE_CLIENTS * len(mixed)} answered")
        latency_line(f"{SERVE_CLIENTS} clients, mixed {MIXED_LO}-{MIXED_HI}",
                     lat, wall, SERVE_CLIENTS * sum(len(q) for q in mixed),
                     card)
        say(f"serve: {h1['requests'] - h0['requests']} requests in "
            f"{h1['dispatches'] - h0['dispatches']} dispatches; /healthz "
            f"{json.dumps(h1)} [{card}]")
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
        server.join(timeout=60)


def traced_search(engine, q_long, tmp, card):
    """Phase 9: one search under profile_trace; the trace must name
    sw_groups_kernel."""
    from oswald_tpu_torch.utils.metrics import profile_trace
    trace_dir = os.path.join(tmp, "trace")
    torch.cuda.synchronize()
    with profile_trace(trace_dir) as prof:
        t0 = time.perf_counter()
        engine.search(q_long)                  # ends with its readback
        window_ms = (time.perf_counter() - t0) * 1e3
    files = os.listdir(trace_dir)
    if len(files) != 1:
        raise AssertionError(f"profile_trace wrote {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        if "sw_groups_kernel" not in f.read():
            raise AssertionError("the trace does not name sw_groups_kernel")
    # the card's own events (kernels, copies), each once
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    kern_ms = sum(e.time_range.elapsed_us() for e in dev
                  if "sw_groups_kernel" in e.name) / 1e3
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    if not kern_ms:
        raise AssertionError("the profiler timed no sw_groups_kernel")
    say(f"trace: sw_groups_kernel {kern_ms:.2f} ms, all device work "
        f"{busy_ms:.2f} ms, of a {window_ms:.2f} ms search under the "
        f"profiler ({100 * kern_ms / window_ms:.1f}% and "
        f"{100 * busy_ms / window_ms:.1f}%) [{card}]")


def serving(db, engine, q_long, mixed, card):
    """Phase 9.  Returns {kernel: launches} of its searches: warmup, the
    served requests and the traced search."""
    from oswald_tpu_torch.kernels import sw_lanes
    from oswald_tpu_torch.tune import autotune
    from oswald_tpu_torch.utils.compile_cache import enable_compile_cache
    sw_lanes.launches = sw_lanes.launches_packed = 0
    with tempfile.TemporaryDirectory() as tmp:
        cache_round_trip(engine, tmp, card)
        serve_requests(db, engine, q_long, mixed, card)
        traced_search(engine, q_long, tmp, card)
        launched = {"sw_groups": sw_lanes.launches,
                    "sw_groups_packed": sw_lanes.launches_packed}
        if not all(launched.values()):
            raise AssertionError(f"phase 9 launched {launched}")
        t0 = time.perf_counter()
        out = autotune(iters=1, log=say)
        bad = [r for r in out["results"] if "error" in r]
        if bad:
            raise AssertionError(f"tune disqualified {bad}")
        say(f"tune: best --blocks-per-sm {out['blocks_per_sm']} --long-from "
            f"{out['long_from']} ({out['gcells']} Gcells/s) of "
            f"{len(out['results'])} candidates, checksums equal, "
            f"{time.perf_counter() - t0:.1f} s [{card}]")
    enable_compile_cache(str(CHECKOUT_BUILD), quiet=True)
    return launched


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def checkout_env(**extra):
    """The environment of a process this script starts: the checkout on
    the path, its kernel directory as the kernel cache."""
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, OSWALD_TPU_TORCH_COMPILE_CACHE=str(CHECKOUT_BUILD),
               **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def run_cli(args, timeout):
    """(seconds, stdout, stderr) of `python -m oswald_tpu_torch.cli ARGS`;
    fails on a non-zero exit or on the timeout."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "oswald_tpu_torch.cli",
                          *args], env=checkout_env(), capture_output=True,
                         text=True, timeout=timeout)
    sec = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"cli {' '.join(args)} exited "
                             f"{out.returncode}: {out.stderr[-3000:]}")
    return sec, out.stdout, out.stderr


def same_db(got, want, what):
    """Bin lengths, residues, lengths, ids and titles equal."""
    if got.bin_lengths != want.bin_lengths or got.n_seqs != want.n_seqs:
        raise AssertionError(f"{what}: bins {got.bin_lengths[:4]}... "
                             f"differ from the packed database's")
    if not np.array_equal(np.asarray(got.lengths), np.asarray(want.lengths)):
        raise AssertionError(f"{what}: lengths differ")
    for L in want.bin_lengths:
        for k in ("seq", "len", "id"):
            if not np.array_equal(np.asarray(got.bins[L][k]),
                                  np.asarray(want.bins[L][k])):
                raise AssertionError(f"{what}: bin {L} {k} differs")
    if list(got.titles) != list(want.titles):
        raise AssertionError(f"{what}: titles differ")


def preprocess_phase(db, corpus, tmp, card):
    """Phase 10.  Returns the path of the in-core artifact."""
    from oswald_tpu_torch.io import load_db, native
    from oswald_tpu_torch.io.synth import write_fasta
    t0 = time.perf_counter()
    fasta = os.path.join(tmp, "corpus.fasta")
    write_fasta(fasta, *corpus)
    mb = os.path.getsize(fasta) / 1e6
    say(f"preprocess: wrote {mb:.1f} MB of FASTA in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError(f"the native I/O library is not available: "
                             f"{native.build_log}")
    say(f"preprocess: native library {native.library_path()} in "
        f"{time.perf_counter() - t0:.2f} s")
    from oswald_tpu_torch.io.db import export_reference_db
    out = {}
    for label, flags in (("in-core", []), ("streaming", ["--streaming"])):
        path = os.path.join(tmp, label)
        sec, _, err = run_cli(["preprocess", "-i", fasta, "-o", path,
                               *flags], PREPROCESS_TIMEOUT_S)
        # the command's own process loads the library again: it must say
        # that its scan and packing took it
        if f"native I/O on ({native.library_path()})" not in err:
            raise AssertionError(f"preprocess {label} did not take the "
                                 f"native library: {err[-2000:]}")
        same_db(load_db(path), db, f"preprocess {label}")
        out[label] = path
        say(f"preprocess {label}: {sec:.2f} s = {mb / sec:.1f} MB/s of "
            f"FASTA (the command, process start included); the artifact "
            f"equals the packed database [{card}; the chip machine's host]")
    # the export, then the CLI's import of it with the export again
    base = os.path.join(tmp, "exported")
    t0 = time.perf_counter()
    export_reference_db(load_db(out["in-core"]), base, verbose=False)
    ex_s = time.perf_counter() - t0
    back = os.path.join(tmp, "back")
    sec, _, _ = run_cli(["preprocess", "-i", base, "-o", back,
                         "--from-oswald", "--to-oswald"],
                        PREPROCESS_TIMEOUT_S)
    same_db(load_db(back), db, "--from-oswald of the export")
    for ext in (".desc", ".info", ".seq"):
        with open(base + ext, "rb") as a, open(back + ext, "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"--to-oswald wrote another {ext}")
    say(f"preprocess: export_reference_db {ex_s:.2f} s; --from-oswald "
        f"--to-oswald of it {sec:.2f} s: the database equal again, the "
        f"export's files equal byte for byte [{card}; the chip machine's "
        f"host]")
    return out["in-core"] + ".oswt"


def rank_main(argv):
    """One rank of phase 11 (b): `chip_smoke.py --rank R WORLD INIT DB
    QUERIES OUT`.  Searches the database (memory-mapped) on cuda:0 with
    its share and writes the results, its launches, its kernel time and
    its cell share to OUT."""
    rank, world_size = int(argv[0]), int(argv[1])
    init, db_path, q_path, out_path = argv[2:6]
    from oswald_tpu_torch.dist import (DistributedSearchEngine, bootstrap,
                                       shard_cells, shutdown)
    from oswald_tpu_torch.engine import SearchConfig
    from oswald_tpu_torch.engine.search import check_query
    from oswald_tpu_torch.io import load_db
    from oswald_tpu_torch.kernels import sw_lanes
    from oswald_tpu_torch.utils.compile_cache import enable_compile_cache
    import torch.distributed as tdist
    enable_compile_cache(str(CHECKOUT_BUILD), quiet=True)
    bootstrap(init, world_size, rank)
    qs = np.load(q_path)
    q_long = qs["q_long"]
    mixed = [qs[f"mixed{i}"] for i in range(int(qs["n_mixed"]))]
    db = load_db(db_path)
    dev = torch.device("cuda", 0)
    rec = {}
    try:
        eng = DistributedSearchEngine(db, SearchConfig(), device=dev)
        eng.search(q_long)                                  # warm-up
        sw_lanes.launches = sw_lanes.launches_packed = 0
        t0 = time.perf_counter()
        one = eng.search(q_long)
        rec["search_s"] = time.perf_counter() - t0
        rec["search_launches"] = sw_lanes.launches
        sw_lanes.launches = sw_lanes.launches_packed = 0
        t0 = time.perf_counter()
        many = eng.search_many(mixed)
        rec["many_s"] = time.perf_counter() - t0
        rec["many_launches"] = [sw_lanes.launches_packed, sw_lanes.launches]
        cells = shard_cells(eng.bounds)
        rec["cells_share"] = cells[rank] / sum(cells)
        q = check_query(q_long, eng.config)

        def launch_ms():
            if eng.engine is None:              # a rank that owns no group
                return 0.0
            return timed(lambda: eng.engine._launch(q), TIMED_RUNS)[1]

        # the rank's launch alone on the card (the other rank waits at the
        # barrier), then both ranks' launches at once
        for r in range(world_size):
            tdist.barrier()
            if r == rank:
                rec["kernel_ms"] = launch_ms()
        tdist.barrier()
        rec["kernel_both_ms"] = launch_ms()
        del eng
        hs = DistributedSearchEngine(
            db, SearchConfig(profile_mode="host_stream"), device=dev)
        sw_lanes.launches = 0
        hs_res = hs.search(q_long)
        rec["hs_launches"] = sw_lanes.launches
        rec["hs_slices"] = 0 if hs.engine is None else \
            len(hs.engine._hs_slices)
        rec["results"] = {
            name: [{"scores": r.scores.tolist(), "ids": r.seq_ids.tolist(),
                    "evalues": r.evalues.tolist(), "title": r.titles[0]}
                   for r in res]
            for name, res in (("search", [one]), ("many", many),
                              ("host_stream", [hs_res]))}
    finally:
        shutdown()
    with open(out_path, "w") as f:
        json.dump(rec, f)
    return 0


def wait_all(procs, timeout, what):
    """Each process's (exit code, stdout) within `timeout` seconds; a hang
    kills them all and fails the phase."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 1))
            outs.append((p.returncode, out))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"{what}: no end within {timeout} s")
    bad = [f"process {i} exited {code}: {out[-3000:]}"
           for i, (code, out) in enumerate(outs) if code != 0]
    if bad:
        raise AssertionError(f"{what}: " + "\n".join(bad))
    return outs


def same_as(want, got, what):
    """Results (phase 11): scores and ids exact, E-values at rtol 1e-4."""
    for i, (w, g) in enumerate(zip(want, got)):
        scores, ids, ev = (g["scores"], g["ids"], g["evalues"]) \
            if isinstance(g, dict) else \
            (g.scores.tolist(), g.seq_ids.tolist(), g.evalues)
        if scores != w.scores.tolist() or ids != w.seq_ids.tolist():
            raise AssertionError(f"{what}: query {i} hits differ from the "
                                 f"single engine's")
        if not np.allclose(ev, w.evalues, rtol=1e-4, atol=0):
            raise AssertionError(f"{what}: query {i} E-values differ "
                                 f"beyond rtol 1e-4")


def world1(db, engine, queries, mixed, uniform, tmp, card):
    """Phase 11 (a).  Returns {kernel: launches}."""
    from oswald_tpu_torch.dist import (DistributedSearchEngine, bootstrap,
                                       shutdown)
    from oswald_tpu_torch.engine import SearchConfig
    from oswald_tpu_torch.kernels import sw_lanes
    bootstrap(f"file://{tmp}/store1", 1, 0)
    try:
        dist = DistributedSearchEngine(
            db, SearchConfig(stream_readback_window=STREAM_WINDOW),
            device=engine.device)
        total = {"sw_groups": 0, "sw_groups_packed": 0}

        def both(label, fn):
            """fn(engine) on both engines, in turn, TIMED_RUNS + 1 times
            each; equal results and launch counts; median seconds."""
            counts, secs, res = {}, {"single": [], "dist": []}, {}
            for _ in range(TIMED_RUNS + 1):
                for name, eng in (("single", engine), ("dist", dist)):
                    sw_lanes.launches = sw_lanes.launches_packed = 0
                    t0 = time.perf_counter()
                    res[name] = fn(eng)
                    secs[name].append(time.perf_counter() - t0)
                    got = (sw_lanes.launches, sw_lanes.launches_packed)
                    if counts.setdefault(name, got) != got:
                        raise AssertionError(f"{label}: launches vary")
            if counts["single"] != counts["dist"]:
                raise AssertionError(f"world 1 {label}: launches "
                                     f"{counts['dist']} against the single "
                                     f"engine's {counts['single']}")
            same_as(res["single"], res["dist"], f"world 1 {label}")
            total["sw_groups"] += counts["dist"][0] * (TIMED_RUNS + 1)
            total["sw_groups_packed"] += counts["dist"][1] * (TIMED_RUNS + 1)
            one, dst = (statistics.median(secs[k][1:])
                        for k in ("single", "dist"))
            say(f"world 1 {label}: {dst:.4f} s against the single engine's "
                f"{one:.4f} s ({(dst - one) * 1e3:+.2f} ms), launches "
                f"{counts['dist']} [{card}]")
            return res["dist"]

        for m, q in queries:
            res = both(f"search m={m}", lambda e: [e.search(q)])
            if m == queries[0][0] and (res[0].titles[0] != "planted_0" or
                                       not res[0].evalues[0] < 1e-3):
                raise AssertionError("world 1: planted homolog not first")
        both(f"search_many mixed {len(mixed)}", lambda e: e.search_many(mixed))
        both(f"search_stream {len(uniform)} x {len(uniform[0])}",
             lambda e: e.search_stream(uniform))
        world1_breakdown(dist, engine, queries, card)
    finally:
        shutdown()
    return total


def world1_breakdown(dist, engine, queries, card):
    """Where a world-1 search's time goes beside the single engine's: the
    launch (to the scores on the card), step 1 (top-k and sums, read
    back), step 2 (the all_gather and the merge), step 3 (thresholds, the
    counts on the card, read back, all_reduce), and steps 1-3 once more
    with the statistics (`_complete`); the single engine's launch and its
    one top-k with moments and readback.  Host clock, synchronised;
    medians of TIMED_RUNS + 2 searches."""
    from oswald_tpu_torch.engine.search import _topk, _unpack_topk
    k = min(dist.config.top, dist.db.n_seqs)
    for m, q in queries:
        steps = {n: [] for n in ("launch", "step 1", "step 2", "step 3",
                                 "steps 1-3 with the statistics",
                                 "single launch", "single top-k")}
        for _ in range(TIMED_RUNS + 2):
            torch.cuda.synchronize()
            t = [time.perf_counter()]
            groups = dist._stream_group([q])
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            rows = dist._local(groups, 1, k)
            t.append(time.perf_counter())
            top_s, top_i, sums = dist._exchange(rows, k)
            t.append(time.perf_counter())
            dist._tails(groups, sums, top_s)
            t.append(time.perf_counter())
            dist._complete([q], ["q"], groups)
            t.append(time.perf_counter())
            scores = engine.score_all(q)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            _unpack_topk(_topk(scores, engine.valid, engine.lnl,
                               k).cpu().numpy())
            t.append(time.perf_counter())
            for n, v in zip(steps, np.diff(t) * 1e3):
                steps[n].append(v)
        say(f"world 1 m={m}, ms: " + ", ".join(
            f"{n} {statistics.median(v):.3f}" for n, v in steps.items()) +
            f" [{card}]")


def two_ranks(db, engine, q_long, mixed, db_path, tmp, card):
    """Phase 11 (b).  Returns {kernel: launches} of both ranks."""
    from oswald_tpu_torch.dist import repack, shard_bounds, shard_cells
    from oswald_tpu_torch.engine.search import mixed_pack_plan
    q_path = os.path.join(tmp, "queries.npz")
    np.savez(q_path, q_long=q_long, n_mixed=len(mixed),
             **{f"mixed{i}": q for i, q in enumerate(mixed)})
    init = f"file://{tmp}/store2"
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--rank", str(r),
         "2", init, db_path, q_path, os.path.join(tmp, f"rank{r}.json")],
        env=checkout_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    wait_all(procs, RANK_TIMEOUT_S, "two ranks")
    recs = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
            for r in range(2)]
    want_one = [engine.search(q_long)]
    want_many = engine.search_many(mixed)
    cfg = engine.config
    bins, rest = mixed_pack_plan(cfg.batch_query_pack_rows, cfg.u_rows,
                                 mixed)
    total = {"sw_groups": 0, "sw_groups_packed": 0}
    for r, rec in enumerate(recs):
        res = rec["results"]
        same_as(want_one, res["search"], f"rank {r} search")
        same_as(want_many, res["many"], f"rank {r} search_many")
        same_as(want_one, res["host_stream"], f"rank {r} host_stream")
        if res["search"][0]["title"] != "planted_0":
            raise AssertionError(f"rank {r}: planted homolog not first")
        if rec["search_launches"] != 1 or \
                rec["many_launches"] != [len(bins), len(rest)] or \
                rec["hs_launches"] != rec["hs_slices"]:
            raise AssertionError(f"rank {r}: launches {rec} against the "
                                 f"plan's 1, [{len(bins)}, {len(rest)}] and "
                                 f"one per slice")
        total["sw_groups"] += 1 + len(rest) + rec["hs_launches"]
        total["sw_groups_packed"] += len(bins)
        say(f"two ranks on one card (balance and overhead, not scaling): "
            f"rank {r}: {rec['cells_share'] * 100:.2f}% of the cells, "
            f"sw_groups at m={Q_LONG} {rec['kernel_ms']:.2f} ms alone, "
            f"{rec['kernel_both_ms']:.2f} ms with the other rank's, search "
            f"{rec['search_s']:.4f} s, mixed batch {rec['many_s']:.4f} s, "
            f"host_stream {rec['hs_slices']} slices [{card}]")
    # the alternative split: the re-cut to quanta 2 (equal group counts)
    geo = repack.group_geometry(db)
    plan = repack.mesh_bin_plan(geo, 2)
    even = shard_cells(shard_bounds(db, 2))
    recut = repack.plan_sharded_cells(geo, 2, plan)
    say(f"two ranks: the even split gives {even[0]} and {even[1]} cells "
        f"(of {sum(even)}); the re-cut to quanta 2 gives {recut // 2} each "
        f"(of {recut}, {len(plan)} bins)")
    return total


def pod_serving(db, engine, q_long, db_path, card):
    """Phase 11 (c): `serve --distributed` on two ranks sharing the card,
    rank 0 on an ephemeral port."""
    import select
    import signal
    from oswald_tpu_torch.alphabet import decode
    port = free_port()
    procs = []
    for r in range(2):
        env = checkout_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                           RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "oswald_tpu_torch.cli", "serve", "-d",
             db_path, "--distributed", "--device", "cuda:0", "--port", "0",
             "--warmup-qlen", str(Q_LONG)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        deadline, base = time.monotonic() + RANK_TIMEOUT_S, None
        while base is None and time.monotonic() < deadline:
            if select.select([procs[0].stdout], [], [], 1.0)[0]:
                line = procs[0].stdout.readline()
                if not line:
                    break
                if "[pod: 2 ranks]" in line:
                    base = line.split(" at ")[1].split()[0]
        if base is None:
            raise AssertionError("pod: rank 0 did not start serving")
        if _get(base, "/healthz")["status"] != "ok":
            raise AssertionError("pod: /healthz")
        t0 = time.perf_counter()
        out = _post(base, {"query": decode(q_long)})
        sec = time.perf_counter() - t0
        hits = out["results"][0]["hits"]
        want = engine.search(q_long)
        if [h["score"] for h in hits] != want.scores.tolist() or \
                [h["id"] for h in hits] != want.seq_ids.tolist():
            raise AssertionError("pod: /search differs from the single "
                                 "engine")
        procs[0].send_signal(signal.SIGINT)
        t0 = time.perf_counter()
        outs = wait_all(procs, POD_EXIT_TIMEOUT_S, "pod shutdown")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if "exiting after 1 queries" not in outs[1][1]:
        raise AssertionError(f"pod: the worker did not mirror the request: "
                             f"{outs[1][1][-1000:]}")
    say(f"pod: /search of the planted query {sec * 1e3:.2f} ms, equal to "
        f"the single engine; shutdown released the worker, both ranks "
        f"exited 0 in {time.perf_counter() - t0:.2f} s (limit "
        f"{POD_EXIT_TIMEOUT_S} s) [{card}]")


def distributed(db, engine, queries, mixed, uniform, db_path, card):
    """Phase 11.  Returns {kernel: launches} of (a) and (b)."""
    with tempfile.TemporaryDirectory() as tmp:
        a = world1(db, engine, queries, mixed, uniform, tmp, card)
        b = two_ranks(db, engine, queries[0][1], mixed, db_path, tmp, card)
    pod_serving(db, engine, queries[0][1], db_path, card)
    return {k: a[k] + b[k] for k in a}


def run(device, n_seqs, card, parity_launches, seed=SEED):
    """Phases 2-11 on `device` (`card` labels the times); returns the
    kernels record, whose launches include the parity gate's
    (`parity_launches`)."""
    from oswald_tpu_torch.engine import SearchConfig, SearchEngine
    from oswald_tpu_torch.io.synth import realistic_residues
    from oswald_tpu_torch.utils.metrics import gcups
    db, q_long, q_short, corpus = make_database(n_seqs, seed)
    mem_base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine = SearchEngine(
        db, SearchConfig(stream_readback_window=STREAM_WINDOW), device=device)
    say(f"engine setup {time.perf_counter() - t0:.2f} s on {device}")
    queries = [(Q_LONG, q_long), (Q_SHORT, q_short)]
    err, k_ms, p_ms, b_ms, b_by, wants = kernel_vs_plain(engine, queries)
    torch.cuda.reset_peak_memory_stats()
    launches, results = main_path(engine, queries)
    resident_peak = torch.cuda.max_memory_allocated() - mem_base
    if launches != len(queries) * (TIMED_RUNS + 1):
        raise AssertionError(f"{launches} sw_groups launches in "
                             f"{len(queries) * (TIMED_RUNS + 1)} searches")
    check_results(engine, queries, results)
    for m, (res, sec) in results.items():
        say(f"search m={m}: {sec:.4f} s, "
            f"{gcups(m, db.n_residues, sec):.1f} GCUPS [{card}]")
    engine_ms = single_tail(engine, queries, card)
    giants(card, seed)

    # the batch queries come from their own generator, so the database
    # stays the one the seed gives
    rng = np.random.default_rng(seed + 1)
    mixed = [q_long[:300]] + [
        realistic_residues(rng, int(n))
        for n in rng.integers(MIXED_LO, MIXED_HI + 1, N_MIXED - 1)]
    longs = [q_long] + [realistic_residues(rng, Q_LONG)
                        for _ in range(N_LONG_BATCH - 1)]
    uniform = [realistic_residues(rng, Q_SHORT) for _ in range(N_UNIFORM)]
    leftover = [q_short, realistic_residues(rng, Q_LEFTOVER), q_long[:200],
                realistic_residues(rng, 120), realistic_residues(rng, 33)]
    layouts = packed_layouts(engine, mixed, uniform)
    perr, pk_ms, pp_ms, pb_ms, pb_by = packed_vs_plain(engine, layouts)
    torch.cuda.reset_peak_memory_stats()
    batch_launches = batched_path(
        engine, [("mixed 100-400", mixed, 0), (f"{N_LONG_BATCH} x {Q_LONG}",
                                               longs, 0),
                 ("with a leftover", leftover, 2)], uniform, card)
    resident_peak = max(resident_peak,
                        torch.cuda.max_memory_allocated() - mem_base)
    packed_tail(engine, layouts["mixed"], card)
    lerr, lab_b_ms, lab_bins_ms, lab_whole_ms, lab_ahead_ms, lab_rows_ms, \
        lab_launches = lab_vs_plain(engine, q_long, wants, card,
                                    engine_ms[Q_LONG])
    from oswald_tpu_torch.kernels.sw_lab import label
    from oswald_tpu_torch.kernels.sw_lanes import STRIP_ROWS
    lab_all = {**{label(v): ms for v, ms in lab_whole_ms.items()},
               **{label(v, STRIP_ROWS, True): ms
                  for v, ms in lab_ahead_ms.items()},
               **{k + "+ahead": ms for k, ms in lab_rows_ms.items()}}
    fastest = min(lab_all, key=lab_all.get)
    say(f"lab: fastest over the whole database, m={Q_LONG}: {fastest}, "
        f"{lab_all[fastest]:.2f} ms [{card}]")
    hs_launches = host_stream_path(db, engine, queries, mixed, card,
                                   resident_peak)
    serve_launches = serving(db, engine, q_long, mixed, card)
    with tempfile.TemporaryDirectory() as tmp:
        db_path = preprocess_phase(db, corpus, tmp, card)
        dist_launches = distributed(db, engine, queries, mixed, uniform,
                                    db_path, card)
    common = {"route": "cuda", "library_ms": None}
    return {"kernels": [
        {"name": "sw_groups", "source": SOURCES["sw_groups"],
         "replaces": REPLACES,
         "launches": parity_launches["sw_groups"] + launches +
         batch_launches["sw_groups"] + hs_launches["sw_groups"] +
         serve_launches["sw_groups"] + dist_launches["sw_groups"],
         "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
         "bound_ms": b_ms, "bound_by": b_by, **common},
        {"name": "sw_groups_packed", "source": SOURCES["sw_groups_packed"],
         "replaces": REPLACES,
         "launches": parity_launches["sw_groups_packed"] +
         batch_launches["sw_groups_packed"] +
         hs_launches["sw_groups_packed"] +
         serve_launches["sw_groups_packed"] +
         dist_launches["sw_groups_packed"],
         "max_abs_err": perr, "ms": pk_ms, "plain_ms": pp_ms,
         "bound_ms": pb_ms, "bound_by": pb_by, **common},
        # the lab kernel does sw_groups' work on sw_groups' inputs: phase
        # 3's plain time stands for it.  `variant` is the fastest kernel
        # over the whole database (label: variant@U, +ahead for the reads
        # one column ahead); `ms` is its time summed over one group of every
        # bin, as for sw_groups, beside the bound of that work;
        # `variants_bins_ms` holds that time for every built kernel;
        # `variants` every variant's time over the whole database at U = 16
        # with the reads in place, `variants_load_ahead` with them ahead,
        # `variants_rows` the times ahead at the other strip heights
        {"name": "sw_groups_lab", "source": SOURCES["sw_groups_lab"],
         "replaces": REPLACES_LAB, "launches": lab_launches,
         "max_abs_err": lerr, "variant": fastest,
         "ms": lab_bins_ms[fastest], "plain_ms": p_ms, "bound_ms": lab_b_ms,
         "bound_by": b_by, "variants": lab_whole_ms,
         "variants_bins_ms": lab_bins_ms,
         "variants_load_ahead": lab_ahead_ms,
         "variants_rows": lab_rows_ms, **common}]}


def main():
    if sys.argv[1:2] == ["--rank"]:
        return rank_main(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from oswald_tpu_torch.utils.compile_cache import enable_compile_cache
    enable_compile_cache(str(CHECKOUT_BUILD))
    smi = probe()
    say(smi)
    if sys.argv[1:2] == ["--giants"]:
        giants(smi)                  # phase 4b alone
        say(json.dumps({"ok": True}))
        return 0
    parity_launches = parity_gate(smi)
    record = run(torch.device("cuda", 0), N_SEQS, smi, parity_launches)
    say(json.dumps(record))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
