"""Substitution matrices (BLOSUM45/50/62/80/90, PAM30/70/250).

The standard public NCBI matrices in the package's alphabet order (see
oswald_tpu_torch.alphabet), one [24, 24] int8 table per matrix; row and
column 23 are the dummy/padding residue and score 0 against everything.
Values are loaded from the package's own data/submat.npz.
"""

import functools
import os

import numpy as np

MATRIX_NAMES = ("blosum45", "blosum50", "blosum62", "blosum80", "blosum90",
                "pam30", "pam70", "pam250")

_DATA = os.path.join(os.path.dirname(__file__), "data", "submat.npz")


@functools.lru_cache(maxsize=None)
def _load():
    with np.load(_DATA) as z:
        return {k: z[k] for k in z.files}


def get_submat(name: str) -> np.ndarray:
    """The [24, 24] int8 substitution matrix for `name`; ValueError for an
    unknown name."""
    key = name.lower()
    mats = _load()
    if key not in mats:
        raise ValueError(
            f"unknown substitution matrix {name!r}; "
            f"valid: {', '.join(MATRIX_NAMES)}")
    return mats[key]
