"""Kernel timings over a whole database on one CUDA card:

    python -m oswald_tpu_torch.lab [--seqs N] [--sass DIR]

Builds the SwissProt-shaped synthetic database of chip_smoke.py (seed 0),
moves it to the card, and times `sw_groups` and `sw_groups_packed` over
every group of it with CUDA events (one warm-up, mean of 3), for one query
of 512 residues and for packed layouts of the same and of twice the rows.
Every packed result is held to `sw_groups` on the same rows (exact).  Each
line carries the card's name and power limit.  With --sass, the kernels'
SASS (cuobjdump) is written to DIR, one file per kernel.
"""

import argparse
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


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m oswald_tpu_torch.lab")
    ap.add_argument("--seqs", type=int, default=570_000)
    ap.add_argument("--sass", metavar="DIR", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lab: CUDA is not available", file=sys.stderr)
        return 1
    from oswald_tpu_torch.engine import SearchConfig, SearchEngine
    from oswald_tpu_torch.io import pack_sequences
    from oswald_tpu_torch.io.synth import (make_realistic_corpus,
                                           realistic_residues)
    from oswald_tpu_torch.kernels import build
    from oswald_tpu_torch.kernels.sw_lanes import sw_groups, sw_groups_packed

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build_all()
    rng = np.random.default_rng(0)
    q = realistic_residues(rng, 2 * ROWS).astype(np.int32)
    flat, lengths, titles = make_realistic_corpus(rng, args.seqs)
    engine = SearchEngine(pack_sequences(flat, lengths, titles),
                          SearchConfig(), device="cuda")
    st, cfg = engine.state, engine.config
    qp = torch.from_numpy(q).cuda()
    cells = st.residues.shape[0] * 1024

    def single(r0, n):
        return sw_groups(st.residues, st.groups, qp[r0:r0 + n].contiguous(),
                         engine.submat_dev, cfg.open_gap, cfg.extend_gap,
                         engine.scratch)

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
            cfg.open_gap, cfg.extend_gap, engine.scratch))
        for s, (r0, n) in enumerate(segs):
            if not torch.equal(got[s], single(r0, n)):
                raise AssertionError(f"{label}: segment {s} differs from "
                                     f"sw_groups")
        report(f"sw_groups_packed {label}", sum(n for _, n in segs), ms)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
