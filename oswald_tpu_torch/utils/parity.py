"""Hardware correctness certification: the card's kernels against an
independent oracle.  The port of oswald_tpu.utils.parity.

The CPU tests hold every kernel's plain version to the JAX package; on the
card `chip_smoke.py` holds each kernel to its plain version, which walks the
same column-by-column recurrence, so a fault shared by both would pass.
This module closes that gap: the engine's scores, from the compiled kernels
on the card, must equal exactly those of the anti-diagonal wavefront oracle
(core/oracle.py), which shares no code and no formulation with them.
`chip_smoke.py` runs it first, as an asserting phase: a silent miscompile
fails the run instead of shipping a fast wrong answer.

Coverage, and the random draws, are the reference's: two matrices
including a negative-minimum one (pam30 7/1), query lengths 64, 65, 512 and
a titin-length 5478 (checked on a sample of subjects), and the packed
batch (search_many of 8 mixed short queries against search one by one).
The same seed certifies the same inputs in both packages.

Standalone: python -m oswald_tpu_torch.utils.parity [--device cpu]
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from oswald_tpu_torch.alphabet import DUMMY


def _oracle_layout(seqs, lengths):
    """Length-ascending padded [n, nmax] matrix + lengths, matching the
    packed db's sorted order."""
    n = len(seqs)
    order = np.argsort(lengths, kind="stable")
    nmax = int(lengths.max())
    bs = np.full((n, nmax), DUMMY, np.int32)
    for i, src in enumerate(order):
        bs[i, : lengths[src]] = seqs[src]
    return bs, lengths[order].astype(np.int32)


def run_parity(n: int = 4096, lmax: int = 700, seed: int = 7,
               titin_sample: int = 256, log=None, device=None,
               oracle_device="cpu") -> dict:
    """Run the full parity suite; returns {"parity": "ok"|"FAIL", ...}.

    The engines under test run on `device` (None: CUDA, and it raises when
    there is none; "cpu" scores with the plain PyTorch versions); the
    oracle runs on `oracle_device`, the host CPU by default.  Exactness is
    exact int equality; every mismatch is reported with its first failing
    slots and makes the result "FAIL".
    """
    from oswald_tpu_torch.core import sw_score_diag_batch
    from oswald_tpu_torch.engine import SearchConfig, SearchEngine
    from oswald_tpu_torch.io import pack_sequences
    from oswald_tpu_torch.submat import get_submat

    if device is None and not torch.cuda.is_available():
        raise RuntimeError("run_parity: CUDA is not available; pass "
                           "device='cpu' to certify the CPU path")

    def say(msg):
        if log:
            log(msg)

    t_start = time.perf_counter()
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, lmax, size=n)
    seqs = [rng.integers(0, 23, int(l)).astype(np.int8) for l in lengths]
    db = pack_sequences(np.concatenate(seqs), lengths,
                        [f"s{i}" for i in range(n)])
    bs, ns = _oracle_layout(seqs, lengths)
    bs = torch.from_numpy(bs).to(oracle_device)
    ns = torch.from_numpy(ns).to(oracle_device)
    checks = 0
    failures = []
    backend = None

    for matrix, og, eg in (("blosum62", 10, 2), ("pam30", 7, 1)):
        eng = SearchEngine(db, SearchConfig(matrix=matrix, open_gap=og,
                                            extend_gap=eg), device=device)
        backend = eng.device.type
        sm = get_submat(matrix)
        # 64/512: the reference's exact pad multiples; 65: one row past its
        # quantum; 5478: titin-scale, the longest query the engine takes
        for qlen in (64, 65, 512, 5478):
            q = rng.integers(0, 23, size=qlen).astype(np.int8)
            t0 = time.perf_counter()
            got = eng.score_all(q)[eng.valid].cpu().numpy()
            t1 = time.perf_counter()
            # titin-length diagonal scans are too slow for the full db on
            # the host: verify a random sample (the engine scores the full
            # db either way)
            if qlen > 2048:
                sample = rng.choice(n, size=titin_sample, replace=False)
            else:
                sample = np.arange(n)
            rows = torch.from_numpy(sample).to(oracle_device)
            want = sw_score_diag_batch(
                q.astype(np.int32), bs[rows], ns[rows], sm, og, eg).cpu(
                ).numpy()
            got_cmp = got[sample]
            ok = np.array_equal(got_cmp, want)
            checks += 1
            say(f"parity {matrix} {og}/{eg} qlen {qlen}: "
                f"{'EXACT' if ok else 'MISMATCH'} over {len(sample)} seqs "
                f"(engine {t1 - t0:.2f}s, oracle "
                f"{time.perf_counter() - t1:.2f}s)")
            if not ok:
                bad = np.flatnonzero(got_cmp != want)[:5]
                failures.append(
                    {"check": f"{matrix}:{qlen}", "slots": bad.tolist(),
                     "got": got_cmp[bad].tolist(),
                     "want": want[bad].tolist()})

        # packed-segment batched path: a mixed batch of short queries
        # through search_many must equal per-query search results (which
        # the score_all checks above certify against the oracle)
        qs = [rng.integers(0, 23, size=int(l)).astype(np.int8)
              for l in (40, 64, 55, 128, 100, 61, 200, 90)]
        n_fail = len(failures)
        batched = eng.search_many(qs, batch=True)
        singles = [eng.search(q) for q in qs]
        for b, s in zip(batched, singles):
            ok = (np.array_equal(b.scores, s.scores) and
                  np.array_equal(b.seq_ids, s.seq_ids))
            checks += 1
            if not ok:
                failures.append(
                    {"check": f"{matrix}:packed",
                     "got": b.scores.tolist(), "want": s.scores.tolist()})
        say(f"parity {matrix} packed batch ({len(qs)} mixed short "
            f"queries): {'EXACT' if len(failures) == n_fail else 'MISMATCH'}")
        del eng

    out = {"parity": "ok" if not failures else "FAIL",
           "checks": checks,
           "backend": backend,
           "seconds": round(time.perf_counter() - t_start, 1)}
    if failures:
        out["failures"] = failures
    return out


def main(argv=None) -> int:
    """Run the suite, print each check and the result as JSON; exit 1 on
    any mismatch."""
    ap = argparse.ArgumentParser(
        prog="python -m oswald_tpu_torch.utils.parity",
        description="the engine's scores against the anti-diagonal oracle")
    ap.add_argument("--device", default=None,
                    help="where the engine runs (default: cuda)")
    ap.add_argument("--n", type=int, default=4096,
                    help="database sequences")
    ap.add_argument("--lmax", type=int, default=700,
                    help="longest subject + 1")
    ap.add_argument("--titin-sample", type=int, default=256,
                    help="subjects the 5478-residue query is checked on")
    args = ap.parse_args(argv)
    if args.device is None and torch.cuda.is_available():
        print(f"device: {torch.cuda.get_device_name(0)}")
    out = run_parity(n=args.n, lmax=args.lmax,
                     titin_sample=args.titin_sample, log=print,
                     device=args.device)
    print(json.dumps(out))
    if out["parity"] != "ok":
        return 1
    print("ALL PARITY CHECKS PASSED on", out["backend"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
