"""The database and the traffic, made from the seed.

One general generator reads a traffic mix's parameters (`traffic/<name>.json`)
and a configuration's (`configs/<name>.json`); nothing in a mix needs code.

Database: the release's length spectrum (`release_lengths`: `n_seqs`
sequences, `residues` in all, the longest `longest`, as the release's
statistics give them), drawn once from the configuration's `length_seed`
(the deployment's database has one length spectrum), put in an order drawn
from the run's seed; residues drawn on the device from the run's seed.  So
every seed gives the card the same work on other data.

Queries (`residues` of a mix):
- `random`: Robinson-Robinson residues; with `homolog_share`, that share
  are instead a window of a database sequence of at least the query's
  length, point-mutated to `identity` with no indels (the length stays):
  a true hit with a small E-value.
- `db_substring`: a window of a database sequence; `substitution_share` of
  them get 1 to `max_substitutions` point substitutions.

Lengths (`lengths` of a mix): `fixed` (a list), `uniform` (lo..hi) or
`swissprot` (the length model, capped).  A batch mix has one multiset of
lengths, each batch in its own seeded order.  A serve mix draws its
arrivals (exponential gaps at `rate`) and its lengths once from `base_seed`,
as many as fit in the window, and sends them in that order with every
seed: under a heavy tail of sizes, the order of arrivals alone moved the
95th percentile by 30% from seed to seed, far more than two runs of one
seed differ (PERF.md), so the seed draws only the residues.
"""

import dataclasses

import numpy as np

from perfkit import synth


@dataclasses.dataclass
class Corpus:
    """The database as the benchmark made it, in record order."""
    lengths: np.ndarray          # int64[n]
    flat: np.ndarray             # int8[sum(lengths)], host
    titles: list
    offsets: np.ndarray          # int64[n + 1]

    @property
    def n_residues(self) -> int:
        return int(self.lengths.sum())


def release_lengths(config: dict) -> np.ndarray:
    """int64[n_seqs]: the frozen SwissProt length model held to a release's
    published statistics.  Lengths over `longest` are drawn again from the
    model until none is left (the model below the release's longest, with
    no pile-up at it); the longest drawn becomes `longest`; every other is
    scaled, rounded by largest remainder, so that the lengths sum to
    `residues` (none above `longest` - 1)."""
    n, total = int(config["n_seqs"]), int(config["residues"])
    longest = int(config["longest"])
    rng = np.random.default_rng(int(config["length_seed"]))
    unbounded = 1 << 40
    lengths = synth.realistic_lengths(rng, n, unbounded, include_titin=False)
    over = np.flatnonzero(lengths > longest)
    while over.size:
        lengths[over] = synth.realistic_lengths(rng, over.size, unbounded,
                                                include_titin=False)
        over = over[lengths[over] > longest]
    top = int(np.argmax(lengths))
    rest = np.flatnonzero(np.arange(n) != top)
    x = lengths[rest] * ((total - longest) / lengths[rest].sum())
    scaled = np.clip(np.floor(x), 1, longest - 1).astype(np.int64)
    short = total - longest - int(scaled.sum())
    frac = np.where(scaled < longest - 1, x - np.floor(x), -1.0)
    if not 0 <= short <= int(np.sum(frac >= 0)):
        raise ValueError("these lengths cannot make the release's total")
    scaled[np.argsort(-frac, kind="stable")[:short]] += 1
    lengths[rest] = scaled
    lengths[top] = longest
    return lengths


def make_corpus(config: dict, seed: int, device) -> Corpus:
    lengths = release_lengths(config)
    n = lengths.size
    rng = np.random.default_rng([int(seed), 1])
    lengths = lengths[rng.permutation(n)]
    flat = synth.device_residues(seed, int(lengths.sum()), device)
    flat = flat.cpu().numpy()
    titles = [f"sp{i:07d}" for i in range(n)]
    return Corpus(lengths, flat, titles,
                  np.concatenate([[0], np.cumsum(lengths)]))


class Traffic:
    """The queries of one run: `batch(b)` for a batch mix, `schedule()` for
    a serve mix, `warm()` for either, each a list of int8 code arrays (with
    due times for the schedule)."""

    def __init__(self, spec: dict, corpus: Corpus, seed: int,
                 seconds: float):
        self.spec = spec
        self.corpus = corpus
        self.seed = int(seed)
        self.seconds = float(seconds)
        self._long = {}
        base = np.random.default_rng(int(spec.get("base_seed", 0)))
        if spec["mode"] == "batch":
            self.batch_lengths = self._lengths(base, int(spec["batch"]))
        else:
            rate = float(spec["rate"])
            gaps = base.exponential(1.0 / rate,
                                    int(rate * self.seconds * 2) + 64)
            n = int(np.searchsorted(np.cumsum(gaps), self.seconds,
                                    side="right"))
            self.gaps = gaps[:n]
            self.serve_lengths = self._lengths(base, n)

    # --- lengths and residues -------------------------------------------
    def _lengths(self, rng, n: int) -> np.ndarray:
        ls = self.spec["lengths"]
        kind = ls["kind"]
        if kind == "fixed":
            vals = np.asarray(ls["values"], np.int64)
            if vals.size != n:
                raise ValueError("a fixed length list needs one length "
                                 "per query of the batch")
            return vals
        if kind == "uniform":
            return rng.integers(int(ls["lo"]), int(ls["hi"]) + 1, size=n)
        if kind == "swissprot":
            return synth.realistic_lengths(rng, n, int(ls["cap"]),
                                           include_titin=False)
        raise ValueError(f"unknown length kind {kind!r}")

    def _window_of_db(self, rng, m: int) -> np.ndarray:
        """A window of m residues of a database sequence of length >= m."""
        c = self.corpus
        pool = self._long.get(m)
        if pool is None:
            pool = self._long[m] = np.flatnonzero(c.lengths >= m)
        if not pool.size:
            raise ValueError(f"no database sequence of {m} residues")
        s = int(pool[rng.integers(pool.size)])
        off = int(c.offsets[s]) + int(rng.integers(c.lengths[s] - m + 1))
        return c.flat[off:off + m].copy()

    def query(self, rng, m: int) -> np.ndarray:
        r = self.spec.get("residues", {})
        kind = r.get("kind", "random")
        if kind == "random":
            if rng.random() < float(r.get("homolog_share", 0.0)):
                return synth.mutate(self._window_of_db(rng, m), rng,
                                    identity=float(r.get("identity", 0.6)),
                                    indel_rate=0.0)
            return synth.realistic_residues(rng, m)
        if kind == "db_substring":
            q = self._window_of_db(rng, m)
            if rng.random() < float(r.get("substitution_share", 0.0)):
                codes, probs = synth.residue_distribution()
                k = int(rng.integers(1, int(r.get("max_substitutions",
                                                  1)) + 1))
                for pos in rng.choice(m, size=min(k, m), replace=False):
                    new = q[pos]
                    while new == q[pos]:
                        new = rng.choice(codes, p=probs)
                    q[pos] = new
            return q
        raise ValueError(f"unknown residue kind {kind!r}")

    # --- batch mixes ----------------------------------------------------
    def batch(self, b: int):
        """The queries of batch b (b >= 0)."""
        rng = np.random.default_rng([self.seed, 2, b + (1 << 20)])
        lengths = self.batch_lengths[rng.permutation(self.batch_lengths.size)]
        return [self.query(rng, int(m)) for m in lengths]

    # --- serve mixes ----------------------------------------------------
    def schedule(self):
        """[(due seconds from the window's start, query)] of the window:
        the mix's arrivals and sizes in the mix's order, the residues from
        the run's seed."""
        rng = np.random.default_rng([self.seed, 4])
        return [(float(t), self.query(rng, int(m)))
                for t, m in zip(np.cumsum(self.gaps), self.serve_lengths)]

    def warm(self):
        """The warm-up queries (one batch, or one request each) of the
        mix's `warm_lengths`, from their own stream of the seed."""
        rng = np.random.default_rng([self.seed, 5])
        return [self.query(rng, int(m)) for m in self.spec["warm_lengths"]]
