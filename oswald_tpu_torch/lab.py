"""Kernel timings over a whole database on one CUDA card, the counterpart of
scripts/kernel_lab.py:

    python -m oswald_tpu_torch.lab [--variants base,fscan,ks,...] [--check]
                                   [--m M] [--rows 8,16,32] [--seqs N]
                                   [--long-from 256,1024,...]
                                   [--blocks-per-sm 2,3,4]
    python -m oswald_tpu_torch.lab --sass DIR [--sass-against OTHER]

Builds the SwissProt-shaped synthetic database of chip_smoke.py (seed 0) and
moves it to the card.  With --check every built (variant, strip rows,
placement) of `sw_groups_lab` among the chosen variants is held to
`sw_groups` over the whole database (exact int32 scores) at query lengths
512 and 65, under the engine's gaps and under 11/1, and the exit code is
non-zero on a difference.  Otherwise it times `sw_groups` and
`sw_groups_packed` over every group with CUDA events (one warm-up, mean of
3), for one query of 512 residues and for packed layouts of the same and of
twice the rows, every packed result held to `sw_groups` on the same rows
(exact), and then every chosen lab variant at query length --m, at each
strip height of --rows (the JAX lab's U; its group_block and col_unroll set
the TPU's schedule and have no counterpart here) where that variant is built
there: one line each with milliseconds, Gcells/s, the share of the bound,
registers and spills, first with each column's shared-memory reads where
they are used, then with them one column ahead.  Each line carries the
card's name and power limit.  With --long-from, `sw_groups` (query length
--m) and `sw_groups_packed` (8 x 65 and 2 x 512 rows) are timed over the
whole database, and `sw_groups` over the longest bin and over one group of
it alone, with groups dealt to the pipelined role from each given length on
(a length beyond the longest bin pipelines nothing), and lab `base` and
`dpx` with their reads ahead at every built strip height over the whole
database; each result is held to the default table's `sw_groups`.  With
--blocks-per-sm the same lines are timed with every kernel built for each
given number of blocks an SM must hold (the register cap of their
__launch_bounds__), at each --long-from value (default: the shipped one),
with the registers and spills nvcc reports for each build.

With --sass nothing is timed: the kernels are built, their SASS (cuobjdump)
is written to DIR, one file per library, and the instruction count of every
kernel is printed; with --sass-against, the counts of the `*.sass` files in
OTHER (another build's, for example a parent commit's) are printed beside
them, and the exit code is non-zero if a kernel of both has another count.
"""

import argparse
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROWS = 512
# (label, [(first row, row count), ...]) over a q_packed of 2 * ROWS rows
LAYOUTS = [
    ("1 x 512", [(0, 512)]),
    ("2 x 256", [(0, 256), (256, 256)]),
    ("4 x 128", [(i * 128, 128) for i in range(4)]),
    ("8 x 64", [(i * 64, 64) for i in range(8)]),
    ("8 x 65", [(i * 65, 65) for i in range(8)]),
    ("1 x 1024", [(0, 1024)]),
    ("2 x 512", [(0, 512), (512, 512)]),
    ("4 x 256", [(i * 256, 256) for i in range(4)]),
]

# H100 SXM data sheet: 3.35 TB/s of HBM.  An SM issues at most four warp
# instructions a clock, 128 lanes, whatever pipe executes them: the rate of
# the data sheet's 67 TFLOP/s of float32 (one FMA, 2 FLOP, per lane and
# clock; 128 lanes x 132 SMs x 1.98 GHz, the card's maximum SM clock).
HBM_BYTES_PER_S = 3.35e12
INSTR_PER_S = 67e12 / 2
# The fewest instructions of this card for one cell of the recurrence.  Its
# ten additions and maxima (diag + s, max 0, max E, cur' - oe, max into
# best, max(cur', F), E - e, max, F - e, max) fuse on Hopper: an add with a
# max and a floor of 0 is one instruction (VIADDMNMX with relu), an add with
# a max another, and one three-way max (VIMNMX3) serves two cells:
#   cur' = max(diag + s, E, 0)   1      H  = max(cur', F)           1
#   c    = cur' - oe             1      E' = max(E - e, c)          1
#   best = max(best, cur', cur'_next)   0.5   F' = max(F - e, c)    1
# No rewrite known to this port does it in fewer (biasing E and F by oe
# trades the subtraction for a second floor).  Each is charged at the issue
# rate: charged at the INT32 pipe's 64 lanes an SM instead, the bound was
# 34.85 ms at m = 512 over a SwissProt-sized database, and the lab's base
# at 32 rows a strip ran in 34.60 ms (NVIDIA H100 80GB HBM3, 700.00 W), so
# some of the 5.5 execute on another pipe; which ones is not measured.  (An
# earlier count of all ten at 64 lanes gave 63.36 ms, which the engine
# kernels beat too.)  16-bit lanes would halve the count, but the function
# is int32 in and out.
INSTR_PER_CELL = 5.5


def bound(cells, n_bytes):
    """(least milliseconds the card could take, what bounds it) for `cells`
    cell updates over inputs and outputs of `n_bytes` bytes."""
    by_ops = cells * INSTR_PER_CELL / INSTR_PER_S * 1e3
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else \
        (by_bytes, "bytes")


def timed(fn, reps=3):
    out = fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def card_line():
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _query(m, device):
    """The lab's query of m residues (seeded by m)."""
    from oswald_tpu_torch.io.synth import realistic_residues
    return torch.from_numpy(realistic_residues(
        np.random.default_rng(m), m).astype(np.int32)).to(device)


def _lab_launch(engine, query, variant, gaps=None, load_ahead=False,
                strip_rows=16, groups=None, work=None):
    """sw_groups_lab over the engine's groups (or `groups`, with `work`)."""
    from oswald_tpu_torch.kernels.sw_lab import sw_groups_lab
    st, cfg = engine.state, engine.config
    og, eg = gaps or (cfg.open_gap, cfg.extend_gap)
    if groups is None:
        groups, work = st.groups, st.work
    return sw_groups_lab(st.residues, groups, query, engine.submat_dev, og,
                         eg, variant, engine.scratch, load_ahead, work,
                         strip_rows)


def _built(variants):
    """[(variant, strip rows, loads ahead)] built among `variants`, by strip
    height, in place before ahead."""
    from oswald_tpu_torch.kernels.sw_lab import BUILT
    return [(v, u, a) for u in sorted({u for _, u, _ in BUILT})
            for a in (False, True) for v in variants if (v, u, a) in BUILT]


def run_variants(engine, variants, m, card="", say=print, load_ahead=False,
                 strip_rows=16):
    """Time every lab variant built at `strip_rows` with this placement over
    the engine's whole database for one query of m residues (seeded by m),
    with each column's reads where they are used or, with load_ahead, one
    column ahead.  Prints one line per variant and returns {variant:
    milliseconds}.  The engine must be resident on a CUDA card."""
    from oswald_tpu_torch.kernels import build
    from oswald_tpu_torch.kernels.sw_lab import BUILT, label, ptxas_report
    q = _query(m, engine.device)
    cells = engine.state.residues.shape[0] * 1024 * m
    b_ms, b_by = bound(cells, engine.state.residues.numel())
    build.load("sw_groups_lab")
    regs = ptxas_report(build.build_logs.get("sw_groups_lab"))
    out = {}
    for v in variants:
        if (v, strip_rows, bool(load_ahead)) not in BUILT:
            continue
        name = label(v, strip_rows, load_ahead)
        _, ms = timed(lambda: _lab_launch(engine, q, v, None, load_ahead,
                                          strip_rows))
        out[v] = ms
        say(f"sw_groups_lab {name}, m={m}: {ms:.2f} ms, "
            f"{cells / ms / 1e6:.1f} Gcells/s, {100 * b_ms / ms:.1f}% of "
            f"the bound ({b_ms:.2f} ms by {b_by}), "
            f"{regs.get(name, 'registers not reported: built before')} "
            f"[{card}]")
    return out


# (kernel, blocks per SM) whose ptxas report run_long_from has printed
_ptxas_said = set()


def run_long_from(engine, values, m, card="", say=print, blocks=None):
    """Time the engine kernels with the long role starting at each length
    of `values` (work_table's long_from), and lab `base` and `dpx` with
    their reads ahead at every built strip height, all built for `blocks`
    blocks per SM (default: the shipped number); returns {value: sw_groups
    ms over the whole database}."""
    from oswald_tpu_torch.io.synth import realistic_residues
    from oswald_tpu_torch.kernels import build
    from oswald_tpu_torch.kernels.sw_lab import label, ptxas_report
    from oswald_tpu_torch.kernels.sw_lanes import (sw_groups,
                                                   sw_groups_packed,
                                                   work_table)
    st, cfg, dev = engine.state, engine.config, engine.device
    rng = np.random.default_rng(m)
    q = torch.from_numpy(realistic_residues(rng, m).astype(np.int32)).to(dev)
    qp = torch.from_numpy(realistic_residues(rng, 2 * ROWS)
                          .astype(np.int32)).to(dev)
    layouts = [(label_, torch.tensor(segs, dtype=torch.int32, device=dev))
               for label_, segs in LAYOUTS if label_ in ("8 x 65", "2 x 512")]
    table = st.groups.cpu().numpy()
    longest = st.groups[torch.from_numpy(
        table[:, 1] == table[:, 1].max()).to(dev)].contiguous()
    tables = [("whole database", st.groups), ("longest bin", longest),
              ("one group of it", longest[:1].contiguous())]
    lab_runs = [(v, u) for v, u, a in _built(["base", "dpx"]) if a]
    gaps = (cfg.open_gap, cfg.extend_gap)
    # the shipped build's scores, which every other build must equal
    want = {label_: sw_groups(st.residues, t, q, engine.submat_dev, *gaps,
                              engine.scratch) for label_, t in tables}
    want_p = {label_: sw_groups_packed(st.residues, st.groups, qp, segs,
                                       engine.submat_dev, *gaps,
                                       engine.scratch, st.work)
              for label_, segs in layouts}
    out = {}
    shipped = build.BLOCKS_PER_SM
    build.BLOCKS_PER_SM = blocks or shipped
    tag = f"{build.BLOCKS_PER_SM} blocks per SM, long_from"
    try:
        build.build_all()
        for name in ("sw_groups", "sw_groups_packed", "sw_groups_lab"):
            build.load(name)
            key = (name, build.BLOCKS_PER_SM)
            if key in _ptxas_said:
                continue
            _ptxas_said.add(key)
            log = build.build_logs.get(key) or ""
            if name == "sw_groups_lab":
                report = ptxas_report(log)
                for v, u in lab_runs:
                    say(f"{build.BLOCKS_PER_SM} blocks per SM, "
                        f"{label(v, u, True)}: ptxas: "
                        f"{report.get(label(v, u, True), 'not reported')}")
                continue
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    say(f"{build.BLOCKS_PER_SM} blocks per SM, {name}: "
                        f"ptxas: {line.strip()}")
        for v in values:
            for label_, t in tables:
                work = work_table(t, v)
                got, ms = timed(lambda: sw_groups(
                    st.residues, t, q, engine.submat_dev, *gaps,
                    engine.scratch, work))
                if not torch.equal(got, want[label_]):
                    raise AssertionError(f"{tag} {v}: sw_groups over the "
                                         f"{label_} differs")
                if t is st.groups:
                    out[v] = ms
                say(f"{tag} {v}: sw_groups m={m}, {label_} ({len(t)} "
                    f"groups, {len(work)} items): {ms:.2f} ms [{card}]")
            work = work_table(st.groups, v)
            for label_, segs in layouts:
                got, ms = timed(lambda: sw_groups_packed(
                    st.residues, st.groups, qp, segs, engine.submat_dev,
                    *gaps, engine.scratch, work))
                if not torch.equal(got, want_p[label_]):
                    raise AssertionError(f"{tag} {v}: sw_groups_packed "
                                         f"{label_} differs")
                say(f"{tag} {v}: sw_groups_packed {label_}, whole database: "
                    f"{ms:.2f} ms [{card}]")
            for var, u in lab_runs:
                got, ms = timed(lambda: _lab_launch(
                    engine, q, var, None, True, u, st.groups, work))
                if not torch.equal(got, want["whole database"]):
                    raise AssertionError(f"{tag} {v}: "
                                         f"{label(var, u, True)} differs")
                say(f"{tag} {v}: sw_groups_lab {label(var, u, True)} m={m}, "
                    f"whole database: {ms:.2f} ms [{card}]")
    finally:
        build.BLOCKS_PER_SM = shipped
    return out


def check_variants(engine, variants, say=print):
    """Every built (variant, strip rows, placement) of `variants` against
    sw_groups over the whole database, exact, at query lengths 512 and 65
    under the engine's gaps and under 11/1.  Returns the number of cases
    that differ."""
    from oswald_tpu_torch.kernels.sw_lab import label
    from oswald_tpu_torch.kernels.sw_lanes import sw_groups
    st, cfg = engine.state, engine.config
    bad = 0
    for gaps in ((cfg.open_gap, cfg.extend_gap), (11, 1)):
        for m in (512, 65):
            q = _query(m, engine.device)
            want = sw_groups(st.residues, st.groups, q, engine.submat_dev,
                             *gaps, engine.scratch, st.work)
            diffs = {label(v, u, a): int(
                (_lab_launch(engine, q, v, gaps, a, u) - want).abs().max())
                for v, u, a in _built(variants)}
            worse = {k: d for k, d in diffs.items() if d}
            bad += len(worse)
            say(f"check m={m}, gaps {gaps[0]}/{gaps[1]}: {len(diffs)} lab "
                f"kernels " + (f"DIFFER from sw_groups: {worse}" if worse
                               else "equal to sw_groups"))
    return bad


def sass_counts(sass):
    """{kernel: instruction lines} of `cuobjdump -sass` output: a lab kernel
    under its label, any other under its mangled name."""
    from oswald_tpu_torch.kernels.sw_lab import kernel_label
    out, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            # the anonymous namespace carries a hash of the build
            current = kernel_label(name) or \
                re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", name)
            out[current] = 0
        elif current is not None and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            out[current] += 1
    return out


def write_sass(out, against=None):
    """--sass: the SASS of every built library to out/<name>.sass and the
    instruction count of each kernel; with `against`, each count beside
    that of the same kernel in against/*.sass.  Returns 1 if a kernel of
    both builds has two counts, else 0."""
    from oswald_tpu_torch.kernels import build
    out.mkdir(parents=True, exist_ok=True)
    counts = {}
    for name in sorted(build.SIGNATURES):
        sass = subprocess.run(
            ["cuobjdump", "-sass", str(build.library_path(name))],
            capture_output=True, text=True, check=True).stdout
        (out / f"{name}.sass").write_text(sass)
        counts.update(sass_counts(sass))
    other = {}
    for f in sorted(Path(against).glob("*.sass")) if against else ():
        other.update(sass_counts(f.read_text()))
    moved = 0
    for kernel, n in sorted(counts.items()):
        was = other.get(kernel)
        moved += was is not None and was != n
        print(f"{kernel}: {n} instruction lines" +
              ("" if was is None else f", {was} in {against}" +
               (" (equal)" if was == n else " (DIFFERENT)")))
    return 1 if moved else 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m oswald_tpu_torch.lab")
    ap.add_argument("--seqs", type=int, default=570_000)
    ap.add_argument("--sass", metavar="DIR", default=None,
                    help="write the kernels' SASS to DIR and count it")
    ap.add_argument("--sass-against", metavar="OTHER", default=None,
                    help="with --sass: compare with OTHER/*.sass")
    ap.add_argument("--variants", default=None,
                    help="comma list of lab variants (default: all)")
    ap.add_argument("--check", action="store_true",
                    help="hold every built variant to sw_groups and exit")
    ap.add_argument("--m", type=int, default=ROWS,
                    help="query length of the variant timings")
    ap.add_argument("--rows", default=None,
                    help="comma list of strip heights U of the variant "
                         "timings (default: every built one)")
    ap.add_argument("--long-from", default=None,
                    help="comma list of lengths from which groups are "
                         "pipelined; times the engine kernels for each")
    ap.add_argument("--blocks-per-sm", default=None,
                    help="comma list of blocks an SM must hold; times the "
                         "kernels built for each")
    args = ap.parse_args(argv)
    from oswald_tpu_torch.kernels.sw_lab import BUILT, VARIANTS
    variants = args.variants.split(",") if args.variants else list(VARIANTS)
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}; choose from "
                 f"{', '.join(VARIANTS)}")
    built_rows = sorted({u for _, u, _ in BUILT})
    rows = [int(u) for u in args.rows.split(",")] if args.rows else \
        built_rows
    if any(u not in built_rows for u in rows):
        ap.error(f"strip heights {rows}: built are {built_rows}")
    if not torch.cuda.is_available():
        print("lab: CUDA is not available", file=sys.stderr)
        return 1
    from oswald_tpu_torch.engine import SearchConfig, SearchEngine
    from oswald_tpu_torch.io import pack_sequences
    from oswald_tpu_torch.io.synth import (make_realistic_corpus,
                                           realistic_residues)
    from oswald_tpu_torch.kernels import build
    from oswald_tpu_torch.kernels.sw_lanes import sw_groups, sw_groups_packed

    build.build_all()
    if args.sass:
        return write_sass(Path(args.sass), args.sass_against)
    card = card_line()
    rng = np.random.default_rng(0)
    q = realistic_residues(rng, 2 * ROWS).astype(np.int32)
    flat, lengths, titles = make_realistic_corpus(rng, args.seqs)
    engine = SearchEngine(pack_sequences(flat, lengths, titles),
                          SearchConfig(), device="cuda")
    st, cfg = engine.state, engine.config
    qp = torch.from_numpy(q).cuda()
    cells = st.residues.shape[0] * 1024
    if args.check:
        return 1 if check_variants(engine, variants) else 0
    if args.long_from or args.blocks_per_sm:
        from oswald_tpu_torch.kernels.sw_lanes import LONG_FROM
        values = [int(v) for v in (args.long_from or str(LONG_FROM)).split(",")]
        for b in (args.blocks_per_sm or "0").split(","):
            run_long_from(engine, values, args.m, card, blocks=int(b))
        return 0

    def single(r0, n):
        return sw_groups(st.residues, st.groups, qp[r0:r0 + n].contiguous(),
                         engine.submat_dev, cfg.open_gap, cfg.extend_gap,
                         engine.scratch, st.work)

    def report(label, rows, ms):
        print(f"{label}: {ms:.2f} ms, {ms / rows:.4f} ms per row, "
              f"{cells * rows / ms / 1e6:.1f} Gcells/s [{card}]", flush=True)

    _, ms = timed(lambda: single(0, ROWS))
    report(f"sw_groups 1 x {ROWS}", ROWS, ms)
    _, ms = timed(lambda: single(0, 2 * ROWS))
    report(f"sw_groups 1 x {2 * ROWS}", 2 * ROWS, ms)
    for label, segs in LAYOUTS:
        seg_t = torch.tensor(segs, dtype=torch.int32, device="cuda")
        got, ms = timed(lambda: sw_groups_packed(
            st.residues, st.groups, qp, seg_t, engine.submat_dev,
            cfg.open_gap, cfg.extend_gap, engine.scratch, st.work))
        for s, (r0, n) in enumerate(segs):
            if not torch.equal(got[s], single(r0, n)):
                raise AssertionError(f"{label}: segment {s} differs from "
                                     f"sw_groups")
        report(f"sw_groups_packed {label}", sum(n for _, n in segs), ms)
    for u in rows:
        for ahead in (False, True):
            run_variants(engine, variants, args.m, card, load_ahead=ahead,
                         strip_rows=u)
    return 0


if __name__ == "__main__":
    sys.exit(main())
