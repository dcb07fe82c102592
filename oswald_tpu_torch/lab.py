"""Kernel timings over a whole database on one CUDA card, the counterpart of
scripts/kernel_lab.py:

    python -m oswald_tpu_torch.lab [--variants base,fscan,ks,...] [--check]
                                   [--m M] [--seqs N] [--sass DIR]
                                   [--long-from 256,1024,...]
                                   [--blocks-per-sm 3,4,5]

Builds the SwissProt-shaped synthetic database of chip_smoke.py (seed 0) and
moves it to the card.  With --check every chosen variant of `sw_groups_lab`
is held to `sw_groups` over the whole database (exact int32 scores) at query
lengths 512 and 65, under the engine's gaps and under 11/1, and the exit
code is non-zero on a difference.  Otherwise it times `sw_groups` and
`sw_groups_packed` over every group with CUDA events (one warm-up, mean of
3), for one query of 512 residues and for packed layouts of the same and of
twice the rows, every packed result held to `sw_groups` on the same rows
(exact), and then every chosen lab variant at query length --m: one line
each with milliseconds, Gcells/s, registers and spills, first with each
column's loads where they are used, then with them one column ahead.  Each line carries
the card's name and power limit.  With --long-from, `sw_groups` (query length
--m) and `sw_groups_packed` (8 x 65 and 2 x 512 rows) are timed over the
whole database, and `sw_groups` over the longest bin and over one group of it
alone, with groups dealt to the pipelined role from each given length on (a
length beyond the longest bin pipelines nothing); each result is held to the
default table's.  With --blocks-per-sm the same lines are
timed with the engine kernels built for each given number of blocks an SM must
hold (the register cap of their __launch_bounds__), at each --long-from value
(default: the shipped one), with the registers and spills nvcc reports for
each build.  With --sass, the kernels' SASS (cuobjdump)
is written to DIR, one file per library, and the instruction count of each
lab variant is printed.
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


def _lab_launch(engine, query, variant, gaps=None, load_ahead=False):
    from oswald_tpu_torch.kernels.sw_lab import sw_groups_lab
    st, cfg = engine.state, engine.config
    og, eg = gaps or (cfg.open_gap, cfg.extend_gap)
    return sw_groups_lab(st.residues, st.groups, query, engine.submat_dev,
                         og, eg, variant, engine.scratch, load_ahead)


def run_variants(engine, variants, m, card="", say=print, load_ahead=False):
    """Time every lab variant over the engine's whole database for one
    query of m residues (seeded by m), with each column's loads where they
    are used or, with load_ahead, one column ahead.  Prints one line per
    variant and returns {variant: milliseconds}.  The engine must be
    resident on a CUDA card."""
    from oswald_tpu_torch.io.synth import realistic_residues
    from oswald_tpu_torch.kernels import build
    from oswald_tpu_torch.kernels.sw_lab import AHEAD, ptxas_report
    q = torch.from_numpy(realistic_residues(
        np.random.default_rng(m), m).astype(np.int32)).to(engine.device)
    cells = engine.state.residues.shape[0] * 1024 * m
    build.load("sw_groups_lab")
    regs = ptxas_report(build.build_logs.get("sw_groups_lab"))
    out = {}
    tag = AHEAD if load_ahead else ""
    for v in variants:
        _, ms = timed(lambda: _lab_launch(engine, q, v,
                                          load_ahead=load_ahead))
        out[v] = ms
        say(f"sw_groups_lab {v}{tag}, m={m}: {ms:.2f} ms, "
            f"{cells / ms / 1e6:.1f} Gcells/s, "
            f"{regs.get(v + tag, 'registers not reported: built before')} "
            f"[{card}]")
    return out


# (kernel, blocks per SM) whose ptxas report run_long_from has printed
_ptxas_said = set()


def run_long_from(engine, values, m, card="", say=print, blocks=None):
    """Time the engine kernels with the long role starting at each length
    of `values` (work_table's long_from), built for `blocks` blocks per SM
    (default: the shipped number); returns {value: sw_groups ms over the
    whole database}."""
    from oswald_tpu_torch.io.synth import realistic_residues
    from oswald_tpu_torch.kernels import build
    from oswald_tpu_torch.kernels.sw_lanes import (sw_groups,
                                                   sw_groups_packed,
                                                   work_table)
    st, cfg, dev = engine.state, engine.config, engine.device
    rng = np.random.default_rng(m)
    q = torch.from_numpy(realistic_residues(rng, m).astype(np.int32)).to(dev)
    qp = torch.from_numpy(realistic_residues(rng, 2 * ROWS)
                          .astype(np.int32)).to(dev)
    layouts = [(label, torch.tensor(segs, dtype=torch.int32, device=dev))
               for label, segs in LAYOUTS if label in ("8 x 65", "2 x 512")]
    table = st.groups.cpu().numpy()
    longest = st.groups[torch.from_numpy(
        table[:, 1] == table[:, 1].max()).to(dev)].contiguous()
    tables = [("whole database", st.groups), ("longest bin", longest),
              ("one group of it", longest[:1].contiguous())]
    gaps = (cfg.open_gap, cfg.extend_gap)
    # the shipped build's scores, which every other build must equal
    want = {label: sw_groups(st.residues, t, q, engine.submat_dev, *gaps,
                             engine.scratch) for label, t in tables}
    want_p = {label: sw_groups_packed(st.residues, st.groups, qp, segs,
                                      engine.submat_dev, *gaps,
                                      engine.scratch, st.work)
              for label, segs in layouts}
    out = {}
    shipped = build.BLOCKS_PER_SM
    build.BLOCKS_PER_SM = blocks or shipped
    tag = f"{build.BLOCKS_PER_SM} blocks per SM, long_from"
    try:
        for name in ("sw_groups", "sw_groups_packed"):
            build.load(name)
            key = (name, build.BLOCKS_PER_SM)
            if key in _ptxas_said:
                continue
            _ptxas_said.add(key)
            for line in (build.build_logs.get(key) or "").splitlines():
                if "registers" in line or "spill" in line:
                    say(f"{build.BLOCKS_PER_SM} blocks per SM, {name}: "
                        f"ptxas: {line.strip()}")
        for v in values:
            for label, t in tables:
                work = work_table(t, v)
                got, ms = timed(lambda: sw_groups(
                    st.residues, t, q, engine.submat_dev, *gaps,
                    engine.scratch, work))
                if not torch.equal(got, want[label]):
                    raise AssertionError(f"{tag} {v}: sw_groups over the "
                                         f"{label} differs")
                if t is st.groups:
                    out[v] = ms
                say(f"{tag} {v}: sw_groups m={m}, {label} ({len(t)} groups, "
                    f"{len(work)} items): {ms:.2f} ms [{card}]")
            work = work_table(st.groups, v)
            for label, segs in layouts:
                got, ms = timed(lambda: sw_groups_packed(
                    st.residues, st.groups, qp, segs, engine.submat_dev,
                    *gaps, engine.scratch, work))
                if not torch.equal(got, want_p[label]):
                    raise AssertionError(f"{tag} {v}: sw_groups_packed "
                                         f"{label} differs")
                say(f"{tag} {v}: sw_groups_packed {label}, whole database: "
                    f"{ms:.2f} ms [{card}]")
    finally:
        build.BLOCKS_PER_SM = shipped
    return out


def check_variants(engine, variants, say=print):
    """Every variant, with its loads in place and ahead, against sw_groups
    over the whole database, exact, at query lengths 512 and 65 under the
    engine's gaps and under 11/1.  Returns the number of cases that
    differ."""
    from oswald_tpu_torch.io.synth import realistic_residues
    from oswald_tpu_torch.kernels.sw_lanes import sw_groups
    st, cfg = engine.state, engine.config
    bad = 0
    for gaps in ((cfg.open_gap, cfg.extend_gap), (11, 1)):
        for m in (512, 65):
            q = torch.from_numpy(realistic_residues(
                np.random.default_rng(m), m).astype(np.int32)).to(
                    engine.device)
            want = sw_groups(st.residues, st.groups, q, engine.submat_dev,
                             *gaps, engine.scratch, st.work)
            for v in variants:
                diffs = [int((_lab_launch(engine, q, v, gaps, ahead) - want)
                             .abs().max()) for ahead in (False, True)]
                bad += sum(d != 0 for d in diffs)
                say(f"check {v}, m={m}, gaps {gaps[0]}/{gaps[1]}: " +
                    ("equal to sw_groups, loads in place and ahead"
                     if not any(diffs) else
                     f"DIFFERS by {diffs[0]} (in place), {diffs[1]} (ahead)"))
    return bad


def _sass_counts(sass):
    """{kernel label: instruction lines} of the lab library's SASS."""
    from oswald_tpu_torch.kernels.sw_lab import kernel_label
    out, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = kernel_label(line)
            if current is not None:
                out[current] = 0
        elif current is not None and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            out[current] += 1
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m oswald_tpu_torch.lab")
    ap.add_argument("--seqs", type=int, default=570_000)
    ap.add_argument("--sass", metavar="DIR", default=None)
    ap.add_argument("--variants", default=None,
                    help="comma list of lab variants (default: all)")
    ap.add_argument("--check", action="store_true",
                    help="hold every variant to sw_groups and exit")
    ap.add_argument("--m", type=int, default=ROWS,
                    help="query length of the variant timings")
    ap.add_argument("--long-from", default=None,
                    help="comma list of lengths from which groups are "
                         "pipelined; times the engine kernels for each")
    ap.add_argument("--blocks-per-sm", default=None,
                    help="comma list of blocks an SM must hold; times the "
                         "engine kernels built for each")
    args = ap.parse_args(argv)
    from oswald_tpu_torch.kernels.sw_lab import VARIANTS
    variants = args.variants.split(",") if args.variants else list(VARIANTS)
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}; choose from "
                 f"{', '.join(VARIANTS)}")
    if not torch.cuda.is_available():
        print("lab: CUDA is not available", file=sys.stderr)
        return 1
    from oswald_tpu_torch.engine import SearchConfig, SearchEngine
    from oswald_tpu_torch.io import pack_sequences
    from oswald_tpu_torch.io.synth import (make_realistic_corpus,
                                           realistic_residues)
    from oswald_tpu_torch.kernels import build
    from oswald_tpu_torch.kernels.sw_lanes import sw_groups, sw_groups_packed

    card = card_line()
    build.build_all()
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
    run_variants(engine, variants, args.m, card)
    run_variants(engine, variants, args.m, card, load_ahead=True)
    if args.sass:
        out = Path(args.sass)
        out.mkdir(parents=True, exist_ok=True)
        for name in sorted(build.SIGNATURES):
            sass = subprocess.run(
                ["cuobjdump", "-sass", str(build.library_path(name))],
                capture_output=True, text=True, check=True).stdout
            (out / f"{name}.sass").write_text(sass)
            print(f"{name}: {len(sass.splitlines())} lines of SASS in "
                  f"{out / (name + '.sass')}")
            if name == "sw_groups_lab":
                print("instruction lines per variant: "
                      f"{_sass_counts(sass)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
