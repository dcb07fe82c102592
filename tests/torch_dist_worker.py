"""One rank of the port's distributed engine, for tests/test_torch_dist.py.

Run as `python torch_dist_worker.py MODE INIT WORLD RANK OUT`: it joins the
gloo group at INIT (a file:// store), builds the databases below from
their seeds (every rank the same ones, as every rank of a deployment maps
the same .oswt) and then, in mode `search`, searches them on the CPU and
writes its results to OUT as JSON; in mode `pod` it serves the `pod`
database through `serve.serve_forever` on an ephemeral port (rank 0 prints
the address) until rank 0 is interrupted.  It imports the port only.
"""

import json
import sys

import numpy as np
import torch

# the databases and queries both sides use: name -> (seed, n, lo, hi)
DBS = {"mixed": (42, 2000, 1, 150),
       # one bin of 34 groups of L = 64: each of two ranks streams its 17
       # groups in two 1 MiB slices
       "slices": (1234, 34000, 33, 60),
       # one group: a second rank owns none, and top > a rank's slots
       "one_group": (7, 600, 1, 60)}
QUERY_LENGTHS = {"mixed": (33, 57, 150), "slices": (16, 24),
                 "one_group": (30, 45)}
CONFIGS = {"mixed": dict(top=12, batch_query_pack_rows=128,
                         stream_readback_window=2),
           "slices": dict(top=9, profile_mode="host_stream",
                          host_stream_slice_mb=1),
           "one_group": dict(top=50)}


def make_db(name):
    """(port PackedDB, queries) of a named database."""
    from oswald_tpu_torch.io import pack_sequences
    seed, n, lo, hi = DBS[name]
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi, size=n)
    flat = rng.integers(0, 20, size=int(lengths.sum())).astype(np.int8)
    db = pack_sequences(flat, lengths, [f"{name}{i}" for i in range(n)])
    queries = [rng.integers(0, 20, size=m).astype(np.int8)
               for m in QUERY_LENGTHS[name]]
    return db, queries


def as_json(results):
    return [{"scores": r.scores.tolist(), "ids": r.seq_ids.tolist(),
             "evalues": None if r.evalues is None else r.evalues.tolist()}
            for r in results]


def search(out_path):
    from oswald_tpu_torch.dist import DistributedSearchEngine
    from oswald_tpu_torch.engine import SearchConfig
    out = {}
    for name in DBS:
        db, qs = make_db(name)
        eng = DistributedSearchEngine(db, SearchConfig(**CONFIGS[name]),
                                      device="cpu")
        rec = {"search": as_json([eng.search(qs[0])]),
               "many": as_json(eng.search_many(qs)),
               "stream": as_json(eng.search_stream(qs)),
               "slots": 0 if eng.engine is None else eng.engine.n_slots,
               "mode": eng.mode}
        if eng.mode == "host_stream":
            rec["slices"] = len(eng.engine._hs_slices)
            rec["bins"] = len(eng.engine.db.bin_lengths)
        else:
            rec["score_all"] = eng.score_all(qs[1]).tolist()
        out[name] = rec
    with open(out_path, "w") as f:
        json.dump(out, f)


def pod():
    from oswald_tpu_torch.dist import DistributedSearchEngine
    from oswald_tpu_torch.engine import SearchConfig
    from oswald_tpu_torch.serve import serve_forever
    db, _ = make_db("mixed")
    eng = DistributedSearchEngine(db, SearchConfig(**CONFIGS["mixed"]),
                                  device="cpu")
    return serve_forever(db, eng, "127.0.0.1", 0, warmup_qlen=16)


def main():
    mode, init, world, rank, out_path = sys.argv[1:6]
    from oswald_tpu_torch.dist import bootstrap, shutdown
    torch.set_num_threads(1)
    assert bootstrap(init, int(world), int(rank)) == (int(rank), int(world))
    try:
        if mode == "search":
            search(out_path)
        else:
            pod()
    finally:
        shutdown()


if __name__ == "__main__":
    main()
