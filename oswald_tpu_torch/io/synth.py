"""Realistic synthetic protein corpora for smoke runs and validation (the
port's own copy of oswald_tpu.io.synth: the same draws from the same numpy
generator, so a seed gives both packages the same corpus).

Real protein databases have a skewed length distribution (fragment tail,
SwissProt-like body, a handful of multi-kilo-residue giants) and a biased
residue composition.  Machines without a real FASTA generate corpora of the
same statistical shape:

- **Lengths**: a mixture calibrated to UniProtKB/Swiss-Prot statistics —
  ~82% lognormal body (median ~290 aa), ~15% fragment tail (20-120 aa),
  ~3% long tail up to a configurable cap (titin 5478 included by default).
- **Residues**: Robinson & Robinson (1991) background amino-acid
  frequencies (the standard null composition used by BLAST's statistics),
  plus a trace of ambiguity codes (B/X/Z) like real databases carry.
- **Planted homologs**: point-mutated + indel'd copies of a query at a
  controlled identity level — the E << 1 true-positive control for the
  significance fit (oswald_tpu_torch.stats).
"""

import numpy as np

from oswald_tpu_torch.alphabet import decode, encode

# Robinson & Robinson (1991) amino-acid background frequencies (as used
# for BLAST statistics), by residue letter.
_RR_FREQ = {
    "A": 0.07805, "C": 0.01925, "D": 0.05364, "E": 0.06295, "F": 0.03856,
    "G": 0.07377, "H": 0.02199, "I": 0.05142, "K": 0.05744, "L": 0.09019,
    "M": 0.02243, "N": 0.04487, "P": 0.05203, "Q": 0.04264, "R": 0.05129,
    "S": 0.07120, "T": 0.05841, "V": 0.06441, "W": 0.01330, "Y": 0.03216,
}
# trace ambiguity codes real databases carry (~0.1% total)
_AMBIG_FREQ = {"B": 0.0003, "X": 0.0005, "Z": 0.0002}


def residue_distribution():
    """(codes int8[k], probs float64[k]) over the engine alphabet."""
    freq = dict(_RR_FREQ)
    freq.update(_AMBIG_FREQ)
    codes = encode("".join(freq.keys()))
    probs = np.asarray(list(freq.values()), np.float64)
    return codes, probs / probs.sum()


def realistic_lengths(rng, n: int, max_len: int = 5478,
                      include_titin: bool = True) -> np.ndarray:
    """SwissProt-shaped length sample: body + fragment tail + giants."""
    kind = rng.choice(3, size=n, p=[0.82, 0.15, 0.03])
    body = np.clip(rng.lognormal(np.log(290.0), 0.55, n), 50, 2000)
    frag = rng.integers(20, 121, size=n)
    # Pareto-ish long tail from 800 up to the cap
    giant = np.clip(800 * (1.0 + rng.pareto(1.7, n)), 800, max_len)
    lengths = np.where(kind == 0, body,
                       np.where(kind == 1, frag, giant)).astype(np.int64)
    if include_titin and n:
        lengths[rng.integers(n)] = min(5478, max_len)   # titin itself
    return lengths


def realistic_residues(rng, total: int) -> np.ndarray:
    """int8[total] residue codes with Robinson-Robinson composition."""
    codes, probs = residue_distribution()
    return rng.choice(codes, size=total, p=probs).astype(np.int8)


def mutate(seq, rng, identity: float = 0.6, indel_rate: float = 0.02):
    """A homolog of `seq`: point mutations to ~`identity` fraction kept,
    plus short indels — the planted true positive."""
    seq = np.asarray(seq, np.int8)
    codes, probs = residue_distribution()
    keep = rng.random(seq.size) < identity
    out = np.where(keep, seq,
                   rng.choice(codes, size=seq.size, p=probs)).astype(np.int8)
    # indels: delete or insert 1-5 residues at ~indel_rate sites
    parts, pos = [], 0
    for site in np.nonzero(rng.random(seq.size) < indel_rate)[0]:
        parts.append(out[pos:site])
        if rng.random() < 0.5:
            pos = min(site + int(rng.integers(1, 6)), seq.size)  # delete
        else:
            parts.append(rng.choice(codes, size=int(rng.integers(1, 6)),
                                    p=probs).astype(np.int8))    # insert
            pos = site
    parts.append(out[pos:])
    merged = np.concatenate(parts) if parts else out
    return merged if merged.size else out[:1]


def make_realistic_corpus(rng, n_seqs: int, max_len: int = 5478,
                          planted=None):
    """(flat int8[], lengths int64[n], titles) with `planted` sequences
    (list of code arrays, e.g. mutated queries) appended as extra
    records titled 'planted_<i>'."""
    lengths = realistic_lengths(rng, n_seqs, max_len)
    flat = realistic_residues(rng, int(lengths.sum()))
    titles = [f"realistic_{i}" for i in range(n_seqs)]
    if planted:
        planted = [np.asarray(p, np.int8) for p in planted]
        flat = np.concatenate([flat] + planted)
        lengths = np.concatenate(
            [lengths, [p.size for p in planted]]).astype(np.int64)
        titles += [f"planted_{i}" for i in range(len(planted))]
    return flat, lengths, titles


def write_fasta(path: str, flat, lengths, titles, width: int = 70):
    """Write a corpus as FASTA text."""
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    with open(path, "w") as fh:
        for i, t in enumerate(titles):
            fh.write(f">{t}\n")
            s = decode(flat[offsets[i]:offsets[i + 1]])
            for j in range(0, len(s), width):
                fh.write(s[j:j + width] + "\n")
