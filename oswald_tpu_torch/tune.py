"""Kernel-geometry tuner (`oswald-tpu-torch tune`): the port's counterpart
of oswald_tpu/tune.py.

The JAX package tunes its Pallas kernel's u_rows / group_block /
col_unroll.  The port's kernels have two knobs of their own:
- blocks per SM (`kernels.build.BLOCKS_PER_SM`): a build flag, the launch
  bounds nvcc compiles the sweep for, so each value is a library of its own
  (built on first use into the kernel cache directory);
- the long-role threshold (`long_from` of `kernels.sw_lanes.work_table`,
  shipped as LONG_FROM): groups of that many columns or more are dealt out
  as pipelined 32-subject slabs, shorter ones as 128-lane rows.
A deployment on another card runs `tune` once and passes the winner to
`search`/`serve` as --blocks-per-sm N --long-from L.

The measurement drives the engine's own kernel, `sw_groups`, over a
synthetic set of groups made from seed 0: `groups` groups of 1024 subjects
whose lengths run 128, 256, ..., 128 * `chunks` columns in turn, so that
they straddle every long_from candidate.  On a card the set must fill it
(at least card_blocks() row items at the largest blocks per SM measured):
a smaller table is pipelined whole (`fill_long_from`) and the long_from
axis would measure nothing.  Tuning is coordinate descent from the shipped
geometry, blocks per SM first; every candidate's score checksum must equal
the baseline's (a miscompiled candidate disqualifies itself rather than
winning), and one that fails to build or launch scores 0 and is recorded.
On the CPU the descent runs over the plain version, where blocks per SM and
long_from change nothing: it exercises the descent, not the card.
"""

import time

import numpy as np
import torch

from oswald_tpu_torch.kernels import build
from oswald_tpu_torch.kernels.sw_lanes import (LONG_FROM, ROWS_PER_GROUP,
                                               card_blocks, fill_long_from,
                                               sw_groups, work_table)
from oswald_tpu_torch.submat import get_submat

# coordinate-descent axes; the shipped geometry is (build.BLOCKS_PER_SM,
# LONG_FROM) = (4, 1024)
BLOCKS_PER_SM_AXIS = (2, 3, 4)
LONG_FROM_AXIS = (512, 1024, 2048)
COLS_QUANTUM = 128              # group lengths are multiples of this
LANES = 8 * 128


def _workload(m, groups, chunks, device):
    """(residues, groups table on the device and on the host, query,
    submat, scratch, cells) of the synthetic set, from seed 0."""
    lengths = COLS_QUANTUM * (1 + np.arange(groups) % chunks)
    first = np.cumsum(lengths) - lengths
    host = torch.from_numpy(np.stack([first, lengths], 1).astype(np.int32))
    gen = torch.Generator(device).manual_seed(0)
    n_cols = int(lengths.sum())
    residues = torch.randint(0, 23, (n_cols, 8, 128), generator=gen,
                             dtype=torch.int8, device=device)
    query = torch.randint(0, 23, (m,), generator=gen, dtype=torch.int32,
                          device=device)
    submat = torch.as_tensor(get_submat("blosum62"), dtype=torch.int32,
                             device=device)
    scratch = torch.empty((2, n_cols, 8, 128), dtype=torch.int32,
                          device=device) if device.type == "cuda" else None
    return (residues, host.to(device), host, query, submat, scratch,
            m * n_cols * LANES)


def _measure(w, blocks_per_sm, long_from, iters):
    """(Gcells/s, checksum) of sw_groups over workload w with the current
    build.BLOCKS_PER_SM (== blocks_per_sm) and long_from; the best of
    `iters` launches after one that gives the checksum, CUDA-event timed on
    a card."""
    residues, groups, host, query, submat, scratch, cells = w
    work = work_table(groups, fill_long_from(len(host), long_from), host)

    def run():
        return sw_groups(residues, groups, query, submat, 10, 2, scratch,
                         work)

    checksum = int(run().sum(dtype=torch.int64))      # synchronises
    times = []
    for _ in range(iters):
        if residues.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
    return cells / min(times) / 1e9, checksum


def autotune(m: int = 512, groups: int = 96, chunks: int = 32,
             iters: int = 3, log=None, device=None) -> dict:
    """Coordinate-descent tune on `device` (None: the card; raises without
    one).  Returns {"blocks_per_sm", "long_from", "gcells", "device",
    "results": [every candidate measured, with "error" where it was
    disqualified]}.  build.BLOCKS_PER_SM is restored on return."""
    def say(msg):
        if log:
            log(msg)

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("autotune: CUDA is not available; pass "
                               "device='cpu' to tune the plain version")
        device = "cuda"
    device = torch.device(device)
    shipped = build.BLOCKS_PER_SM
    if device.type == "cuda":
        sms = card_blocks() // shipped
        need = sms * max(BLOCKS_PER_SM_AXIS)
        if ROWS_PER_GROUP * groups < need:
            raise ValueError(
                f"groups={groups} gives {ROWS_PER_GROUP * groups} row items, "
                f"fewer than the {need} blocks the card holds at "
                f"{max(BLOCKS_PER_SM_AXIS)} blocks per SM: every group "
                "would be pipelined and long_from would measure nothing")
        kind = torch.cuda.get_device_name(device)
    else:
        kind = "cpu"
    if m < 1 or groups < 1 or chunks < 1 or iters < 1:
        raise ValueError("autotune: m, groups, chunks and iters must be "
                         "positive")
    w = _workload(m, groups, chunks, device)

    # baseline = the shipped geometry where the axes include it, else the
    # first entry of each (possibly narrowed) axis
    best = {"blocks_per_sm": shipped if shipped in BLOCKS_PER_SM_AXIS
            else BLOCKS_PER_SM_AXIS[0],
            "long_from": LONG_FROM if LONG_FROM in LONG_FROM_AXIS
            else LONG_FROM_AXIS[0]}
    results = []
    ref_sum = None

    def try_cfg(bps, lf):
        nonlocal ref_sum
        for r in results:                     # don't re-measure
            if (r["blocks_per_sm"], r["long_from"]) == (bps, lf):
                return r["gcells"]
        tag = f"  blocks_per_sm={bps} long_from={lf}"
        build.BLOCKS_PER_SM = bps
        try:
            gc, s = _measure(w, bps, lf, iters)
        except Exception as e:                # noqa: BLE001 — a candidate
            say(f"{tag}: FAILED ({type(e).__name__}: {str(e)[:200]})")
            results.append({"blocks_per_sm": bps, "long_from": lf,
                            "gcells": 0.0, "error": str(e)[:200]})
            return 0.0                        # that cannot build loses
        finally:
            build.BLOCKS_PER_SM = shipped
        if ref_sum is None:
            ref_sum = s
        if s != ref_sum:                      # exactness gate
            say(f"{tag}: CHECKSUM MISMATCH — disqualified")
            results.append({"blocks_per_sm": bps, "long_from": lf,
                            "gcells": 0.0, "error": "checksum"})
            return 0.0
        say(f"{tag}: {gc:.1f} Gcells/s")
        results.append({"blocks_per_sm": bps, "long_from": lf,
                        "gcells": round(gc, 3)})
        return gc

    n_cols = int(w[2][:, 1].sum())
    say(f"tuning on {kind} (m={m}, {groups} groups of 128-"
        f"{COLS_QUANTUM * min(chunks, groups)} columns, {n_cols} columns)")
    best_gc = try_cfg(best["blocks_per_sm"], best["long_from"])
    for axis, values in (("blocks_per_sm", BLOCKS_PER_SM_AXIS),
                         ("long_from", LONG_FROM_AXIS)):
        for v in values:
            if v == best[axis]:
                continue
            cand = dict(best, **{axis: v})
            gc = try_cfg(cand["blocks_per_sm"], cand["long_from"])
            if gc > best_gc:
                best, best_gc = cand, gc
    if not any("error" not in r for r in results):
        raise RuntimeError(
            "no tuning candidate ran successfully; see the per-candidate "
            "errors in the log")
    return {**best, "gcells": round(best_gc, 3), "device": kind,
            "results": results}
