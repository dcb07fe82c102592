#!/usr/bin/env python3
"""The benchmark of oswald_tpu_torch on one NVIDIA H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout.  It runs one cell of BENCHMARK.json: makes
the database and the traffic from the seed, sets the port up, drives it
for `--seconds`, judges every answer against the plain reference in
`benchmark/perfkit/reference.py`, and prints one JSON line last on
standard output (`--trace 0`: the cell's end-to-end metrics; `--trace 1`:
its per-layer metrics, the device's busy and window seconds and a
breakdown).  The numbers compared, each with its limit, are the last
lines of standard error and the line's last key.  Without a card it
exits 2 and prints no result.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for path in (HERE, ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)
    from perfkit import harness
    return harness.main(args, ROOT)


if __name__ == "__main__":
    sys.exit(main())
