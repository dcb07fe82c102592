"""Command-line interface of the port: search | info.

`search` takes the flags of oswald_tpu's `search` (the reference's -q -d -s
-g -e -r surface and the engine flags) plus `--device`, and prints the same
text report and `--json` lines.  `--profile-mode` picks where the database
lives (auto, precompute and stream: resident on the device; host_stream:
on the host, streamed through the device on every search), and
`--hbm-budget-mb` is the device memory that `auto` plans for; the engine
announces an `auto` plan on stderr, so `--json` output stays clean.  Flags
whose paths are not ported yet exit 2 with a "not yet ported" error; the
rest of oswald_tpu's subcommands (preprocess, serve, tune, cache) are not
ported yet either.  The `.oswt`
databases are those both packages read: `oswald_tpu_torch.io.preprocess_db`
or `python -m oswald_tpu.cli preprocess` writes them.  A multi-query FASTA
runs as one batch (packed launches) unless --no-batch is given.
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


def _add_engine_args(sp):
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
    sp.add_argument("--device", default="cuda",
                    help="torch device to search on (default: cuda; cpu "
                         "runs the plain PyTorch scorer)")
    sp.add_argument("--devices", type=int, default=None,
                    help="devices in the search (only 1 is ported)")
    sp.add_argument("--distributed", action="store_true",
                    help="multi-host run (not yet ported)")
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
    sp.add_argument("--compile-cache", metavar="DIR", default=None,
                    help="accepted for compatibility (kernels build into "
                         "build/oswald_tpu_torch/)")
    sp.add_argument("--no-compile-cache", action="store_true",
                    help="accepted for compatibility")
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
                    help="device trace (not yet ported)")
    sp.add_argument("--metrics", action="store_true",
                    help="print phase timing metrics after the report")
    sp.add_argument("--json", action="store_true",
                    help="machine-readable output: one JSON object per "
                         "query plus a run summary")
    sp.add_argument("-a", "--align", action="store_true",
                    help="alignments of the hits (not yet ported)")
    sp.add_argument("--tab", action="store_true",
                    help="BLAST tabular output (not yet ported)")
    sp.add_argument("-H", "--histogram", action="store_true",
                    help="score histogram (not yet ported)")


def build_parser():
    p = argparse.ArgumentParser(
        prog=PROG,
        description="Smith-Waterman protein database search on PyTorch "
                    "and CUDA")
    sub = p.add_subparsers(dest="op", required=True)
    sp = sub.add_parser("search", help="search a packed database")
    _add_search_args(sp)
    sub.add_parser("info", help="PyTorch and CUDA device information")
    return p


def _not_ported(args):
    """The first flag given whose path this port does not have yet."""
    for flag, given in (("--align", args.align), ("--tab", args.tab),
                        ("-H/--histogram", args.histogram),
                        ("--trace", args.trace is not None),
                        ("--distributed", args.distributed),
                        ("--devices > 1", (args.devices or 1) > 1)):
        if given:
            return flag
    return None


def cmd_search(args):
    flag = _not_ported(args)
    if flag:
        raise _CLIError(f"{flag} is not yet ported")
    import torch
    from oswald_tpu_torch.io.db import load_db, load_queries
    from oswald_tpu_torch.stats import format_evalue
    from oswald_tpu_torch.submat import get_submat
    from oswald_tpu_torch.utils.metrics import gcups as _gcups
    from oswald_tpu_torch.engine import SearchEngine, SearchConfig

    with _user_errors():
        queries_titles, queries = load_queries(args.query)
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
        try:
            device = torch.device(args.device)
        except RuntimeError as e:
            raise ValueError(f"bad --device {args.device!r}: {e}") from e
        if device.type == "cuda" and not torch.cuda.is_available():
            raise ValueError("CUDA is not available; pass --device cpu to "
                             "search on the CPU")
        for t, q in zip(queries_titles, queries):
            if len(q) > cfg.max_query_len:
                raise ValueError(
                    f"query '{t}' length {len(q)} exceeds --max-query-len "
                    f"{cfg.max_query_len} (raise the flag to accept longer "
                    f"queries)")
        t_setup = time.perf_counter()
        db = load_db(args.db)
    engine = SearchEngine(db, cfg, device=device)
    setup_s = time.perf_counter() - t_setup

    t0 = time.perf_counter()
    results = engine.search_many(queries, queries_titles,
                                 batch=not args.no_batch)
    search_s = time.perf_counter() - t0
    Q = sum(len(q) for q in queries)
    gcups = _gcups(Q, db.n_residues, search_s)

    if args.json:
        import json
        for res in results:
            hits = [{"score": int(s), "id": int(i), "title": t}
                    for s, i, t in zip(res.scores, res.seq_ids, res.titles)]
            if res.evalues is not None:
                for h, e, b in zip(hits, res.evalues, res.bit_scores):
                    h["evalue"] = float(e)
                    h["bits"] = round(float(b), 1)
            print(json.dumps({"query": res.query_title,
                              "length": res.query_length, "hits": hits}))
        print(json.dumps({
            "summary": {"n_queries": len(queries), "db_seqs": db.n_seqs,
                        "db_residues": db.n_residues,
                        "search_s": round(search_s, 4),
                        "setup_s": round(setup_s, 4),
                        "gcups": round(gcups, 2), "devices": 1,
                        "matrix": args.sm, "gap_open": args.gap_open,
                        "gap_extend": args.gap_extend}}))
        if args.metrics:
            print(json.dumps({"metrics": engine.metrics.as_dict()}))
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
    print(f"Devices:\t\t\t1 ({device}: {kind})")
    print(f"Group lanes:\t\t\t1024 (8x128 lanes, one subject per thread)")
    if args.metrics:
        print("\nPhase timings:")
        print(engine.metrics.report())
    return 0


def cmd_info(args):
    import torch
    print(f"PyTorch {torch.__version__}, CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("Devices (0 total): CUDA is not available")
        return 0
    n = torch.cuda.device_count()
    print(f"Devices ({n} total):")
    for i in range(n):
        p = torch.cuda.get_device_properties(i)
        print(f"  [{i}] {p.name} (compute capability {p.major}.{p.minor}, "
              f"{p.multi_processor_count} SMs, "
              f"{p.total_memory / 2**30:.1f} GiB)")
    return 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        return {"search": cmd_search, "info": cmd_info}[args.op](args)
    except _CLIError as e:
        print(f"{PROG}: error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
