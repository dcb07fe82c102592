"""SwissProt-shaped synthetic proteins: a frozen copy of the length model,
the residue composition and the homolog mutation of
`oswald_tpu_torch.io.synth`, pinned by tests to golden values so that a
later change to the port's module cannot move the benchmark's inputs.

- Lengths: ~82% lognormal body (median ~290), ~15% fragments (20-120),
  ~3% Pareto giants from 800 up to a cap (titin, 5478, by default).
- Residues: Robinson & Robinson (1991) background frequencies plus a trace
  of the ambiguity codes B/X/Z.
- `mutate`: point mutations to about `identity`, plus short indels.

The alphabet is the engine's: 23 residue letters in alphabetical order
(codes 0..22) and the padding code 23, which every matrix scores 0.
"""

import numpy as np
import torch

ALPHABET = "ABCDEFGHIKLMNPQRSTVWXYZ"
DUMMY = 23

_RR_FREQ = {
    "A": 0.07805, "C": 0.01925, "D": 0.05364, "E": 0.06295, "F": 0.03856,
    "G": 0.07377, "H": 0.02199, "I": 0.05142, "K": 0.05744, "L": 0.09019,
    "M": 0.02243, "N": 0.04487, "P": 0.05203, "Q": 0.04264, "R": 0.05129,
    "S": 0.07120, "T": 0.05841, "V": 0.06441, "W": 0.01330, "Y": 0.03216,
}
_AMBIG_FREQ = {"B": 0.0003, "X": 0.0005, "Z": 0.0002}


def encode(text: str) -> np.ndarray:
    """int8 codes of a residue string (letters outside the alphabet: 23)."""
    lut = {c: i for i, c in enumerate(ALPHABET)}
    return np.asarray([lut.get(c, DUMMY) for c in text.upper()], np.int8)


def decode(codes) -> str:
    table = np.frombuffer((ALPHABET + "*").encode(), np.uint8)
    return table[np.clip(np.asarray(codes, np.int64), 0, DUMMY)].tobytes() \
        .decode("ascii")


def residue_distribution():
    """(codes int8[k], probs float64[k])."""
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
    giant = np.clip(800 * (1.0 + rng.pareto(1.7, n)), 800, max_len)
    lengths = np.where(kind == 0, body,
                       np.where(kind == 1, frag, giant)).astype(np.int64)
    if include_titin and n:
        lengths[rng.integers(n)] = min(5478, max_len)
    return lengths


def realistic_residues(rng, total: int) -> np.ndarray:
    """int8[total] residue codes with Robinson-Robinson composition."""
    codes, probs = residue_distribution()
    return rng.choice(codes, size=total, p=probs).astype(np.int8)


def device_residues(seed: int, total: int, device,
                    chunk: int = 1 << 25) -> torch.Tensor:
    """int8[total] residue codes with the same composition, drawn on
    `device` by a torch.Generator seeded with `seed`, in chunks: the
    database's residues, made where they are served and in a few large
    calls."""
    codes, probs = residue_distribution()
    cdf = torch.as_tensor(np.cumsum(probs), dtype=torch.float32,
                          device=device)
    cdf[-1] = 2.0                          # every uniform draw lands
    lut = torch.as_tensor(codes, dtype=torch.int8, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = torch.empty(total, dtype=torch.int8, device=device)
    for lo in range(0, total, chunk):
        n = min(chunk, total - lo)
        u = torch.rand(n, generator=gen, device=device)
        out[lo:lo + n] = lut[torch.searchsorted(cdf, u, right=True)]
    return out


def mutate(seq, rng, identity: float = 0.6, indel_rate: float = 0.02):
    """A homolog of `seq`: point mutations to ~`identity` fraction kept,
    plus short indels (none at indel_rate 0, which keeps the length)."""
    seq = np.asarray(seq, np.int8)
    codes, probs = residue_distribution()
    keep = rng.random(seq.size) < identity
    out = np.where(keep, seq,
                   rng.choice(codes, size=seq.size, p=probs)).astype(np.int8)
    parts, pos = [], 0
    for site in np.nonzero(rng.random(seq.size) < indel_rate)[0]:
        parts.append(out[pos:site])
        if rng.random() < 0.5:
            pos = min(site + int(rng.integers(1, 6)), seq.size)
        else:
            parts.append(rng.choice(codes, size=int(rng.integers(1, 6)),
                                    p=probs).astype(np.int8))
            pos = site
    parts.append(out[pos:])
    merged = np.concatenate(parts) if parts else out
    return merged if merged.size else out[:1]
