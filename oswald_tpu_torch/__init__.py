"""oswald-tpu-torch: the oswald-tpu search engine on PyTorch and CUDA.

The port of `oswald_tpu` (JAX/Pallas on a TPU) to an NVIDIA H100: plain
PyTorch around hand-written CUDA Smith-Waterman kernels (`kernels/csrc/`).
The package stands alone: it keeps its own copy of the device-free code
(alphabet, substitution matrices, the `.oswt` database format, statistics)
and imports neither jax nor anything of `oswald_tpu`.
"""

__version__ = "0.1.0"

from oswald_tpu_torch.alphabet import encode, decode, ALPHABET, DUMMY
from oswald_tpu_torch.submat import get_submat, MATRIX_NAMES

__all__ = [
    "encode", "decode", "ALPHABET", "DUMMY",
    "get_submat", "MATRIX_NAMES", "__version__",
]
