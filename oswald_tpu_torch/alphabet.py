"""Protein alphabet encoding (the port's own copy of oswald_tpu.alphabet).

Residue letters 'A'..'Z' with the non-amino letters J, O, U mapped to a
dummy symbol, and the remaining 23 letters remapped densely to 0..22 in
alphabetical order.  Code 23 (DUMMY) is the padding residue; every
substitution matrix scores it as 0 against everything, so padded positions
can never create a new local-alignment maximum (H propagates diagonally
unchanged, E/F decay).

Encoding is one lookup in a 256-entry table; lowercase input maps like
uppercase, and any byte outside the alphabet maps to DUMMY.
"""

import numpy as np

# 23 real residue codes + 1 dummy/padding code
ALPHABET = "ABCDEFGHIKLMNPQRSTVWXYZ"  # code 0..22
DUMMY = 23
ALPHA_SIZE = 24  # codes 0..23

_LUT = np.full(256, DUMMY, dtype=np.int8)
for _i, _c in enumerate(ALPHABET):
    _LUT[ord(_c)] = _i
    _LUT[ord(_c.lower())] = _i

_INV = np.frombuffer((ALPHABET + "*").encode(), dtype=np.uint8)


def encode(seq) -> np.ndarray:
    """Encode a protein string / bytes / uint8 array to int8 codes 0..23."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    if isinstance(seq, (bytes, bytearray)):
        buf = np.frombuffer(bytes(seq), dtype=np.uint8)
    else:
        buf = np.asarray(seq, dtype=np.uint8)
    return _LUT[buf]


def decode(codes) -> str:
    """Decode int codes back to a residue string ('*' for dummy)."""
    codes = np.asarray(codes, dtype=np.int64)
    return _INV[np.clip(codes, 0, DUMMY)].tobytes().decode("ascii")
