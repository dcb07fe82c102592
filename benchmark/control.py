#!/usr/bin/env python3
"""The control of `correct`, at a cell's own size, on the card:

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
                                 [--seconds 30] [--batches 8]

For each seed it makes the cell's database and traffic, draws the sample
that a run's check searches in full (from the queries a window sends:
the schedule of a serve mix, the first `--batches` batches of a batch
mix), puts the control (the reference one precision step down: 16-bit
saturating scores, moments rounded to bfloat16) in the program's place
for that sample, and judges its answers by the run's own comparison
(`compare.check` with the mix's limits).  One JSON line a seed, with
`correct` (which has to come out false) and every number beside its
limit.  The benchmark's own runs never run it; it gives the upper
readings the limits are set from (PERF.md).
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(root, workload, seed, seconds, batches, device):
    """The control's line of one seed: `correct` and every number
    compared, each beside its limit."""
    import torch
    from perfkit import compare, data, reference
    from perfkit.spec import Spec
    cell = Spec(root).cell(workload, trace=False)
    cfg = cell.config
    t = time.perf_counter()
    corpus = data.make_corpus(cfg, seed, device)
    traffic = data.Traffic(cell.traffic, corpus, seed, seconds)
    if cell.traffic["mode"] == "batch":
        queries = [q for b in range(batches) for q in traffic.batch(b)]
    else:
        queries = [q for _, q in traffic.schedule()]
    sent = [compare.Answer(q, "", answered=True) for q in queries]
    sample = compare.draw_sample(sent, seed, cell.traffic["check"])
    ref = reference.Reference(
        corpus.lengths, torch.as_tensor(corpus.flat, device=device),
        corpus.titles, reference.load_matrix(
            reference.matrix_path(root, cfg["matrix"])),
        cfg["open_gap"], cfg["extend_gap"], cfg["top"])
    answers = compare.control_answers(ref, [queries[i] for i in sample])
    checks = compare.check(ref, answers, range(len(answers)),
                           cell.traffic["limits"])
    return dict(workload=workload, seed=seed, sample=len(sample),
                residues=sum(queries[i].size for i in sample),
                seconds=round(time.perf_counter() - t, 2),
                correct=compare.passed(checks),
                checks={k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--batches", type=int, default=8)
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(ROOT, args.workload, seed, args.seconds,
                                  args.batches, "cuda")), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
