"""Command-line interface of the port: preprocess | search | serve | info |
tune | cache.

`search` takes the flags of oswald_tpu's `search` (the reference's -q -d -s
-g -e -r surface and the engine flags) plus `--device`, and prints the same
text report, `--json` lines, `--tab` lines, alignment blocks (`--align`)
and score histograms (`-H`).  `--profile-mode` picks where the database
lives (auto, precompute and stream: resident on the device; host_stream:
on the host, streamed through the device on every search), and
`--hbm-budget-mb` is the device memory that `auto` plans for; the engine
announces an `auto` plan on stderr, so `--json` output stays clean.
`--trace DIR` writes a torch.profiler trace of the search into DIR.
`serve` keeps one warm engine behind the HTTP JSON API of
`oswald_tpu_torch.serve`; `tune` measures the kernels' geometry on the card
and prints the `--blocks-per-sm`/`--long-from` flags to pass to `search`
and `serve`; `cache` packs, unpacks and reports the directory the kernel
libraries are built into (`--compile-cache DIR`, `--no-compile-cache`).
`preprocess` packs a FASTA (gzip, bzip2 or xz too) into the `.oswt`
database both packages read; `--streaming` builds it out of core (on by
itself above 2 GiB of FASTA), `--from-oswald` imports the FPGA tool's
`.desc/.info/.seq` triple and `--to-oswald` also writes one; its native
scan and packing build into the kernel directory, and a stderr line says
whether they ran.  A
multi-query FASTA runs as one batch (packed launches) unless --no-batch is
given.

Across ranks (`DistributedSearchEngine`, one device each): `--distributed`
joins the process group torchrun describes (`torchrun --nproc-per-node N
-m oswald_tpu_torch.cli search --distributed ...`), and `--devices N`
without it starts N local ranks itself, rank r on cuda:r (all on the one
card `--device cuda:K` names, or on the CPU under `--device cpu`).  Every
rank runs the command; rank 0 prints, and the command fails if any rank
fails.
"""

import argparse
import contextlib
import sys
import time

PROG = "oswald-tpu-torch"


class _CLIError(Exception):
    """User-input error already formatted for the terminal."""


@contextlib.contextmanager
def _user_errors():
    """Turn user-input failures inside this block into _CLIError (exit 2);
    internal errors elsewhere still traceback."""
    try:
        yield
    except (ValueError, FileNotFoundError) as e:
        raise _CLIError(str(e)) from e


def _add_device_arg(sp):
    sp.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; cpu "
                         "runs the plain PyTorch scorer)")


def _add_cache_args(sp):
    sp.add_argument("--compile-cache", metavar="DIR", default=None,
                    help="directory of the compiled kernel libraries "
                         "(default: $OSWALD_TPU_TORCH_COMPILE_CACHE, else "
                         "~/.cache/oswald-tpu-torch/kernels); a library "
                         "built once is loaded by later processes instead "
                         "of running nvcc again")
    sp.add_argument("--no-compile-cache", action="store_true",
                    help="build the kernel libraries into a temporary "
                         "directory of this process, removed at exit")


def _add_engine_args(sp):
    """Flags shared by `search` and `serve`: everything that shapes the
    engine rather than a single query run."""
    sp.add_argument("-d", "--db", required=True,
                    help="preprocessed database path (.oswt)")
    sp.add_argument("-s", "--sm", default="blosum62",
                    help="substitution matrix: blosum45/50/62/80/90, "
                         "pam30/70/250 (default: blosum62)")
    sp.add_argument("-g", "--gap-open", type=int, default=10,
                    help="gap open penalty (default: 10)")
    sp.add_argument("-e", "--gap-extend", type=int, default=2,
                    help="gap extend penalty (default: 2)")
    sp.add_argument("-r", "--top", type=int, default=10,
                    help="number of scores to show (default: 10)")
    _add_device_arg(sp)
    sp.add_argument("--devices", type=int, default=None,
                    help="ranks in the search, one device each (default: "
                         "1, or the world torchrun starts under "
                         "--distributed); above 1 without --distributed "
                         "this command starts the ranks itself, rank r on "
                         "cuda:r")
    sp.add_argument("--distributed", action="store_true",
                    help="join the torch.distributed process group "
                         "torchrun describes (MASTER_ADDR, MASTER_PORT, "
                         "RANK, WORLD_SIZE) and search across its ranks; "
                         "every rank runs the same command, rank 0 prints")
    sp.add_argument("--profile-mode",
                    choices=("auto", "precompute", "stream", "host_stream"),
                    default="auto",
                    help="where the database lives: auto picks the most "
                         "resident mode that fits the device's memory; "
                         "precompute and stream keep it on the device "
                         "(one path here: the kernels need no profile); "
                         "host_stream keeps it on the host and streams it "
                         "through the device on every search, for "
                         "databases larger than device memory")
    sp.add_argument("--hbm-budget-mb", type=int, default=None,
                    help="device memory, in MiB, that --profile-mode auto "
                         "plans for (default: the device's own)")
    sp.add_argument("--max-query-len", type=int, default=5478,
                    help="longest accepted query (default: 5478)")
    _add_cache_args(sp)
    sp.add_argument("--blocks-per-sm", type=int, default=None,
                    help="blocks per SM the kernels are built for (kernel "
                         "geometry, see `tune`; default: 4)")
    sp.add_argument("--long-from", type=int, default=None,
                    help="groups of this many columns or more run as "
                         "pipelined slabs (kernel geometry, see `tune`; "
                         "default: 1024)")
    sp.add_argument("--u-rows", type=int, default=8,
                    help="row quantum of the batch packing plan "
                         "(default: 8)")
    sp.add_argument("--group-block", type=int, default=2)
    sp.add_argument("--col-unroll", type=int, default=32)
    sp.add_argument("--stream-window", type=int, default=4,
                    help="queries of an unbatched stream read back from "
                         "the device together (default: 4)")


def _add_search_args(sp):
    _add_engine_args(sp)
    sp.add_argument("-q", "--query", required=True,
                    help="query FASTA filename")
    sp.add_argument("--no-batch", action="store_true",
                    help="search queries one at a time, each in its own "
                         "launch, instead of packing them into batched "
                         "launches")
    sp.add_argument("--trace", metavar="DIR", default=None,
                    help="write a torch.profiler trace of the search (the "
                         "CPU, and the card's kernels) into DIR as a "
                         "Chrome trace (view in Perfetto)")
    sp.add_argument("--metrics", action="store_true",
                    help="print phase timing metrics after the report")
    sp.add_argument("--json", action="store_true",
                    help="machine-readable output: one JSON object per "
                         "query plus a run summary")
    sp.add_argument("-a", "--align", action="store_true",
                    help="print a gapped alignment (traceback) for every "
                         "reported hit — a host-side pass over the top-k "
                         "only")
    sp.add_argument("--tab", action="store_true",
                    help="BLAST outfmt-6 tabular output (qseqid sseqid "
                         "pident length mismatch gapopen qstart qend "
                         "sstart send evalue bitscore), one line per hit "
                         "— computes alignments, replaces the text report")
    sp.add_argument("-H", "--histogram", action="store_true",
                    help="print the observed score histogram per query "
                         "with the expected chance counts under the "
                         "fitted null model (text mode; scores the "
                         "database once more per query)")


def build_parser():
    p = argparse.ArgumentParser(
        prog=PROG,
        description="Smith-Waterman protein database search on PyTorch "
                    "and CUDA")
    sub = p.add_subparsers(dest="op", required=True)

    pp = sub.add_parser("preprocess", help="FASTA -> packed database")
    pp.add_argument("-i", "--input", required=True,
                    help="input FASTA filename (gzip, bzip2 or xz too)")
    pp.add_argument("-o", "--output", required=True,
                    help="output database path (writes <output>.oswt/)")
    pp.add_argument("--streaming", action="store_true",
                    help="out-of-core build (bounded host memory) for "
                         "databases larger than RAM; on by itself for "
                         "FASTA files over 2 GiB (compressed input counts "
                         "four times its size)")
    pp.add_argument("--from-oswald", action="store_true",
                    help="INPUT is the base path of a database the FPGA "
                         "tool OSWALD preprocessed (<input>.desc/.info/"
                         ".seq) instead of FASTA")
    pp.add_argument("--to-oswald", action="store_true",
                    help="also write OSWALD's <output>.desc/.info/.seq "
                         "triple next to the .oswt")

    sp = sub.add_parser("search", help="search a packed database")
    _add_search_args(sp)

    sv = sub.add_parser(
        "serve",
        help="HTTP JSON search server over a warm engine (the kernels, "
             "the CUDA context and the database stay resident across "
             "queries)")
    _add_engine_args(sv)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8731)
    sv.add_argument("--warmup-qlen", type=int, default=512,
                    help="before accepting requests, load the kernel "
                         "libraries and run a search and a packed batch of "
                         "queries this long (0 = skip; default: 512)")
    sv.add_argument("--warmup-jobs", type=int, default=1,
                    help="accepted for compatibility with oswald-tpu "
                         "(the port's warmup has no parallel steps)")

    sub.add_parser("info", help="PyTorch and CUDA device information")

    tn = sub.add_parser(
        "tune",
        help="measure kernel-geometry candidates (blocks per SM, the "
             "long-role threshold) on the card and print the fastest "
             "--blocks-per-sm/--long-from flags")
    tn.add_argument("--m", type=int, default=512,
                    help="query rows of the synthetic workload")
    tn.add_argument("--groups", type=int, default=96,
                    help="groups of 1024 subjects (at least 66 to fill "
                         "an H100 at 4 blocks per SM)")
    tn.add_argument("--chunks", type=int, default=32,
                    help="group lengths run 128, 256, ..., 128 * CHUNKS "
                         "columns")
    tn.add_argument("--iters", type=int, default=3)
    tn.add_argument("--json", action="store_true",
                    help="print the full result object as JSON")
    _add_device_arg(tn)
    _add_cache_args(tn)

    ca = sub.add_parser(
        "cache",
        help="manage the kernel library directory (pack a warmed one into "
             "a shippable tarball / pre-seed a fresh deployment from one)")
    ca.add_argument("action", choices=("pack", "unpack", "info"),
                    help="pack: kernel directory -> tar.gz; unpack: tar.gz "
                         "-> kernel directory (existing entries kept); "
                         "info: entry count and size")
    ca.add_argument("tar", nargs="?", default=None,
                    help="tarball path (required for pack/unpack)")
    ca.add_argument("--overwrite", action="store_true",
                    help="unpack: replace existing entries")
    _add_cache_args(ca)
    return p


def _enable_cache(args):
    from oswald_tpu_torch.utils import compile_cache
    if getattr(args, "no_compile_cache", False):
        compile_cache.disable_compile_cache()
        return None
    return compile_cache.enable_compile_cache(
        getattr(args, "compile_cache", None))


def _device(args, world_size: int = 1):
    """The torch device of --device, refused (exit 2) where it cannot run.
    A rank of a world above 1 takes cuda:LOCAL_RANK for a bare `cuda`."""
    import os
    import torch
    try:
        device = torch.device(args.device)
    except RuntimeError as e:
        raise ValueError(f"bad --device {args.device!r}: {e}") from e
    if device.type == "cuda" and not torch.cuda.is_available():
        raise ValueError("CUDA is not available; pass --device cpu to run "
                         "on the CPU")
    if device.type == "cuda" and device.index is None and world_size > 1:
        device = torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", 0)) %
            torch.cuda.device_count())
    return device


def _rank_main(argv, rank: int, world_size: int, init: str):
    """One rank started by --devices: join the group, then run the command
    as a rank of it."""
    import os
    import signal
    import torch
    from oswald_tpu_torch.dist import bootstrap
    os.environ["LOCAL_RANK"] = str(rank)
    if rank:
        # an interrupt ends the run through rank 0 (a pod server drains,
        # then releases the other ranks)
        signal.signal(signal.SIGINT, signal.SIG_IGN)
    # the ranks share this host's cores (all of the work under --device
    # cpu): without a share each, their thread pools contend
    torch.set_num_threads(max(1, torch.get_num_threads() // world_size))
    bootstrap(init, world_size, rank)
    sys.exit(main(list(argv) + ["--distributed"]))


def _spawn_ranks(args, argv) -> int:
    """--devices N without --distributed: start N ranks (spawned processes
    joined through a file store in a temporary directory), wait for them;
    the first rank to fail stops the others and gives the exit code."""
    import os
    import signal
    import tempfile
    import torch
    import torch.multiprocessing as mp
    n = args.devices
    with _user_errors():
        device = _device(args)
        if device.type == "cuda" and device.index is None and \
                n > torch.cuda.device_count():
            raise ValueError(
                f"--devices {n}: only {torch.cuda.device_count()} CUDA "
                f"devices here (pass --device cuda:K to put every rank on "
                f"card K)")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="oswald-ranks-") as tmp:
        init = f"file://{tmp}/store"
        procs = [ctx.Process(target=_rank_main, args=(argv, r, n, init))
                 for r in range(n)]
        for p in procs:
            p.start()
        code = 0
        while not code and any(p.is_alive() for p in procs):
            try:
                for p in procs:
                    p.join(timeout=0.1)
                    if p.exitcode:
                        code = p.exitcode if p.exitcode > 0 else 1
                        break
            except KeyboardInterrupt:
                if procs[0].is_alive():
                    os.kill(procs[0].pid, signal.SIGINT)
        for p in procs:
            if code:
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
            if p.exitcode and not code:
                code = p.exitcode if p.exitcode > 0 else 1
        return code


def _build_engine(args):
    """Engine construction shared by `search` and `serve`: validate the
    flags, point the kernel build at its directory and geometry, load the
    database, build the engine (DistributedSearchEngine in a world above
    1).  Returns (db, engine, setup_s, rank, world size)."""
    from oswald_tpu_torch.dist import bootstrap
    rank, size = bootstrap() if args.distributed else (0, 1)
    if args.distributed and args.devices is not None and \
            args.devices != size:
        raise _CLIError(f"--devices {args.devices} under --distributed: "
                        f"the process group has {size} ranks")
    from oswald_tpu_torch.engine import SearchEngine, SearchConfig
    from oswald_tpu_torch.io.db import load_db
    from oswald_tpu_torch.kernels import build
    from oswald_tpu_torch.submat import get_submat

    with _user_errors():
        get_submat(args.sm)
        cfg = SearchConfig(matrix=args.sm, open_gap=args.gap_open,
                           extend_gap=args.gap_extend, top=args.top,
                           u_rows=args.u_rows,
                           group_block=args.group_block,
                           col_unroll=args.col_unroll,
                           profile_mode=args.profile_mode,
                           stream_readback_window=args.stream_window,
                           max_query_len=args.max_query_len,
                           hbm_budget_bytes=args.hbm_budget_mb << 20
                           if args.hbm_budget_mb else None)
        device = _device(args, size)
        if args.blocks_per_sm is not None and args.blocks_per_sm < 1:
            raise ValueError(f"--blocks-per-sm must be >= 1, got "
                             f"{args.blocks_per_sm}")
        if args.long_from is not None and args.long_from < 0:
            raise ValueError(f"--long-from must be >= 0, got "
                             f"{args.long_from}")
        _enable_cache(args)
        if args.blocks_per_sm is not None:
            # before any library loads: the value is a build flag
            build.BLOCKS_PER_SM = args.blocks_per_sm
        t_setup = time.perf_counter()
        db = load_db(args.db)
    if size > 1:
        from oswald_tpu_torch.dist import DistributedSearchEngine
        engine = DistributedSearchEngine(db, cfg, device=device,
                                         long_from=args.long_from)
    else:
        engine = SearchEngine(db, cfg, device=device,
                              long_from=args.long_from)
    return db, engine, time.perf_counter() - t_setup, rank, size


def _alignment_json(a):
    return {"q_start": a.q_start, "q_end": a.q_end,
            "s_start": a.s_start, "s_end": a.s_end,
            "q_aln": a.q_aln, "s_aln": a.s_aln,
            "midline": a.midline, "identities": a.identities,
            "positives": a.positives, "gaps": a.gaps}


def cmd_search(args):
    import torch
    from oswald_tpu_torch.io.db import load_queries
    from oswald_tpu_torch.stats import format_evalue
    from oswald_tpu_torch.utils.metrics import gcups as _gcups

    with _user_errors():
        queries_titles, queries = load_queries(args.query)
        # over-cap queries are user input: refuse them before device work
        for t, q in zip(queries_titles, queries):
            if len(q) > args.max_query_len:
                raise ValueError(
                    f"query '{t}' length {len(q)} exceeds --max-query-len "
                    f"{args.max_query_len} (raise the flag to accept longer "
                    f"queries)")
    db, engine, setup_s, rank, size = _build_engine(args)
    device = engine.device

    trace_ctx = contextlib.nullcontext()
    if args.trace:
        from oswald_tpu_torch.utils.metrics import profile_trace
        trace_ctx = profile_trace(args.trace)
    before = _launch_counts()
    t0 = time.perf_counter()
    with trace_ctx:
        results = engine.search_many(queries, queries_titles,
                                     batch=not args.no_batch)
    search_s = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in _launch_counts().items()}
    Q = sum(len(q) for q in queries)
    gcups = _gcups(Q, db.n_residues, search_s)

    flats = None
    if args.histogram and not (args.json or args.tab):
        # score_all is a collective across ranks: every rank scores
        flats = []
        for q in queries:
            try:
                flats.append(engine.score_all(q).cpu().numpy())
            except ValueError as e:
                flats.append(e)
    # every rank ran the search; rank 0 prints
    if rank != 0:
        return 0

    alignments = None
    if args.align or args.tab:
        # engine.align scores with the engine's own matrix and gaps
        alignments = [engine.align(q, res)
                      for q, res in zip(queries, results)]

    if args.tab:
        from oswald_tpu_torch.engine.align import format_tabular
        for qi, res in enumerate(results):
            for hi, (title, aln) in enumerate(zip(res.titles,
                                                  alignments[qi])):
                ev = float(res.evalues[hi]) if res.evalues is not None \
                    else None
                bs = float(res.bit_scores[hi]) if res.bit_scores is not \
                    None else None
                print(format_tabular(res.query_title, title, aln, ev, bs))
        return 0

    if args.json:
        import json
        for qi, res in enumerate(results):
            hits = [{"score": int(s), "id": int(i), "title": t}
                    for s, i, t in zip(res.scores, res.seq_ids, res.titles)]
            if res.evalues is not None:
                for h, e, b in zip(hits, res.evalues, res.bit_scores):
                    h["evalue"] = float(e)
                    h["bits"] = round(float(b), 1)
            if alignments is not None:
                for h, a in zip(hits, alignments[qi]):
                    h["alignment"] = _alignment_json(a)
            print(json.dumps({"query": res.query_title,
                              "length": res.query_length, "hits": hits}))
        print(json.dumps({
            "summary": {"n_queries": len(queries), "db_seqs": db.n_seqs,
                        "db_residues": db.n_residues,
                        "search_s": round(search_s, 4),
                        "setup_s": round(setup_s, 4),
                        "gcups": round(gcups, 2), "devices": size,
                        "matrix": args.sm, "gap_open": args.gap_open,
                        "gap_extend": args.gap_extend}}))
        if args.metrics:
            print(json.dumps({"metrics": engine.metrics.as_dict(),
                              "launches": launched}))
        return 0

    for i, res in enumerate(results):
        print(f"\nQuery no.\t\t\t{i + 1}")
        print(f"Query description: \t\t{res.query_title}")
        print(f"Query length:\t\t\t{res.query_length} residues")
        if res.evalues is not None:
            print("\nScore\tBits\tE-value\t\tSequence description")
            for sc, b, e, title in zip(res.scores, res.bit_scores,
                                       res.evalues, res.titles):
                print(f"{int(sc)}\t{b:.1f}\t{format_evalue(float(e)):<8}"
                      f"\t{title}")
        else:
            print("\nScore\tSequence description")
            for sc, title in zip(res.scores, res.titles):
                print(f"{int(sc)}\t{title}")
        if flats is not None:
            from oswald_tpu_torch.stats import histogram_report
            flat = flats[i]
            if isinstance(flat, ValueError):
                print(f"\n(--histogram: {flat})", file=sys.stderr)
            else:
                print("\n" + histogram_report(
                    flat[engine.ids_flat >= 0], res.stats,
                    engine._len_hist), end="")
        if alignments is not None:
            from oswald_tpu_torch.engine.align import format_alignment
            for title, aln in zip(res.titles, alignments[i]):
                print(f"\n> {title}\n Score: {aln.score}")
                print(format_alignment(aln), end="")
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"\nSearch date:\t\t\t{time.ctime()}")
    print(f"Database:\t\t\t{args.db} ({db.n_seqs} sequences, "
          f"{db.n_residues} residues)")
    print(f"Substitution matrix:\t\t{args.sm}")
    print(f"Gap open penalty:\t\t{args.gap_open}")
    print(f"Gap extend penalty:\t\t{args.gap_extend}")
    print(f"Setup time:\t\t\t{setup_s:.4f} seconds")
    print(f"Search time:\t\t\t{search_s:.4f} seconds")
    print(f"Search speed:\t\t\t{gcups:.2f} GCUPS")
    print(f"Devices:\t\t\t{size} ({device}: {kind})")
    print(f"Group lanes:\t\t\t1024 (8x128 lanes, one subject per thread)")
    if args.metrics:
        print("\nPhase timings:")
        print(engine.metrics.report())
        n = launched["kernels"]
        share = f"{100 * launched['cluster'] / n:.1f}%" if n else "-"
        print(f"Kernel launches:\t\t{n} ({launched['cluster']} in "
              f"thread-block clusters, {share}; {launched['split_slabs']} "
              f"slabs split)")
    return 0


def _launch_counts():
    """This process's engine kernel launches so far: all of them, those
    that ran thread-block clusters, and the slabs those split."""
    from oswald_tpu_torch.kernels import sw_lanes
    return {"kernels": sw_lanes.launches + sw_lanes.launches_packed,
            "cluster": sw_lanes.cluster_launches,
            "split_slabs": sw_lanes.split_slabs}


def cmd_serve(args):
    from oswald_tpu_torch.serve import serve_forever
    db, engine, setup_s, rank, _ = _build_engine(args)
    if rank == 0:
        print(f"engine ready in {setup_s:.2f}s")
    return serve_forever(db, engine, args.host, args.port,
                         warmup_qlen=args.warmup_qlen or None,
                         warmup_jobs=args.warmup_jobs)


def _say_native():
    """One stderr line: whether the FASTA scan and the packing take the
    native library (the test that io.fasta and io.db make) and, if not,
    why."""
    import os
    from oswald_tpu_torch.io import native
    if os.environ.get("OSWALD_NO_NATIVE"):
        print(f"{PROG} preprocess: native I/O off (OSWALD_NO_NATIVE)",
              file=sys.stderr)
    elif native.available():
        print(f"{PROG} preprocess: native I/O on ({native.loaded_from()})",
              file=sys.stderr)
    else:
        why = native.build_log.strip().splitlines()
        print(f"{PROG} preprocess: native I/O off "
              f"({why[-1] if why else 'no library'})", file=sys.stderr)


def cmd_preprocess(args):
    import os
    with _user_errors():
        if args.from_oswald:
            from oswald_tpu_torch.io.db import import_reference_db, save_db
            db = import_reference_db(args.input)
            save_db(db, args.output)
            print(f"{PROG} preprocess: wrote {args.output}.oswt")
        else:
            # the native library builds into the kernel directory
            _enable_cache(args)
            _say_native()
            size = os.path.getsize(args.input) \
                if os.path.exists(args.input) else 0
            if size:
                with open(args.input, "rb") as fh:
                    head = fh.read(6)
                if head[:2] == b"\x1f\x8b" or head[:3] == b"BZh" \
                        or head[:6] == b"\xfd7zXZ\x00":
                    size *= 4    # compressed: judge by ~decompressed size
            if args.streaming or size > 2 << 30:
                from oswald_tpu_torch.io.stream import \
                    preprocess_db_streaming
                preprocess_db_streaming(args.input, args.output)
            else:
                from oswald_tpu_torch.io.db import preprocess_db
                preprocess_db(args.input, args.output)
        if args.to_oswald:
            # read the artifact back (memory-mapped), so the export is the
            # same for in-core, streaming and imported builds
            from oswald_tpu_torch.io.db import load_db, export_reference_db
            export_reference_db(load_db(args.output), args.output)
    return 0


def cmd_info(args):
    import torch
    from oswald_tpu_torch.dist import bootstrap
    from oswald_tpu_torch.utils.compile_cache import cache_stats
    print(f"PyTorch {torch.__version__}, CUDA {torch.version.cuda}")
    rank, size = bootstrap()
    print(f"Rank {rank} of {size}")
    if not torch.cuda.is_available():
        print("Devices (0 total): CUDA is not available")
    else:
        n = torch.cuda.device_count()
        print(f"Devices ({n} total):")
        for i in range(n):
            p = torch.cuda.get_device_properties(i)
            print(f"  [{i}] {p.name} (compute capability "
                  f"{p.major}.{p.minor}, {p.multi_processor_count} SMs, "
                  f"{p.total_memory / 2**30:.1f} GiB)")
    st = cache_stats()
    print(f"Kernel cache:\t{st['dir']} ({st['entries']} kernel libraries, "
          f"{st['bytes'] / 2**20:.1f} MiB)")
    return 0


def cmd_tune(args):
    import json
    from oswald_tpu_torch.tune import autotune
    with _user_errors():
        device = _device(args)
        _enable_cache(args)
        out = autotune(m=args.m, groups=args.groups, chunks=args.chunks,
                       iters=args.iters, device=device,
                       log=lambda s: print(s, file=sys.stderr))
    if args.json:
        print(json.dumps(out))
    else:
        print(f"best geometry on {out['device']}: "
              f"--blocks-per-sm {out['blocks_per_sm']} "
              f"--long-from {out['long_from']} ({out['gcells']} Gcells/s)")
    return 0


def cmd_cache(args):
    from oswald_tpu_torch.utils.compile_cache import (cache_stats,
                                                      pack_cache,
                                                      unpack_cache)
    d = getattr(args, "compile_cache", None)
    with _user_errors():
        if args.action == "info":
            st = cache_stats(d)
            print(f"kernel cache: {st['dir']} ({st['entries']} kernel "
                  f"libraries, {st['bytes'] / 2**20:.1f} MiB)")
            return 0
        if not args.tar:
            raise ValueError(f"cache {args.action} requires a tarball "
                             "path argument")
        if args.action == "pack":
            out = pack_cache(args.tar, d)
            print(f"packed {out['entries']} kernel libraries "
                  f"({out['bytes'] / 2**20:.1f} MiB) -> {out['tar']}")
        else:
            out = unpack_cache(args.tar, d, overwrite=args.overwrite)
            print(f"unpacked {out['extracted']} kernel libraries into "
                  f"{out['dir']} ({out['skipped']} already present)")
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    try:
        if args.op in ("search", "serve") and not args.distributed and \
                (args.devices or 1) > 1:
            return _spawn_ranks(args, argv)
        return {"preprocess": cmd_preprocess, "search": cmd_search,
                "serve": cmd_serve, "info": cmd_info, "tune": cmd_tune,
                "cache": cmd_cache}[args.op](args)
    except _CLIError as e:
        print(f"{PROG}: error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
