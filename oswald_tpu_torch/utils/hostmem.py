"""Host-memory allocation helpers for loading and packing databases (the
port's own copy of oswald_tpu.utils.hostmem).

Numpy madvises MADV_HUGEPAGE on every allocation >= 4 MiB (its default
hugepage policy on Linux).  On kernels with `transparent_hugepage/defrag =
madvise`, each 2 MiB huge-page fault in such a region runs synchronous
direct compaction, which makes first-touch of a large buffer many times
slower than with MADV_NOHUGEPAGE and can dominate loading and packing a
large database.

`alloc_nohuge` returns a numpy array backed by an anonymous mmap explicitly
madvised NOHUGEPAGE, sidestepping numpy's policy without relying on the
import-time NUMPY_MADVISE_HUGEPAGE env var (which a library cannot set for
its host process).  Falls back to plain np.empty off-Linux.
"""
from __future__ import annotations

import ctypes
import mmap
import sys

import numpy as np

_MADV_NOHUGEPAGE = 15
_libc = None


def _get_libc():
    global _libc
    if _libc is None and sys.platform.startswith("linux"):
        try:
            _libc = ctypes.CDLL("libc.so.6", use_errno=True)
        except OSError:
            _libc = False
    return _libc or None


def alloc_nohuge(n: int, dtype) -> np.ndarray:
    """1-D uninitialised array of n elements whose backing pages are
    madvised MADV_NOHUGEPAGE (fast first-touch on defrag=madvise kernels).

    The mmap stays alive via the returned array's .base chain."""
    dtype = np.dtype(dtype)
    nbytes = max(int(n) * dtype.itemsize, 1)
    libc = _get_libc()
    if libc is None:
        return np.empty(n, dtype)
    buf = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
    addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    libc.madvise(ctypes.c_void_p(addr), ctypes.c_size_t(nbytes),
                 _MADV_NOHUGEPAGE)
    return np.frombuffer(buf, dtype, count=n)


class numpy_nohuge:
    """Context manager: disable numpy's MADV_HUGEPAGE policy for ALL numpy
    allocations while active (restored on exit).

    `alloc_nohuge` covers buffers we allocate explicitly, but the
    preprocess also produces block-scale numpy TEMPORARIES (argsort/cumsum
    outputs, fancy-index gathers, ascontiguousarray copies) whose >=4 MiB
    allocations numpy madvises MADV_HUGEPAGE — each paying the first-touch
    compaction penalty on defrag=madvise kernels.  Numpy exposes a runtime
    toggle
    (the documented NUMPY_MADVISE_HUGEPAGE env var only works before numpy
    is imported, which a library cannot guarantee); where the private
    hook is missing this is a no-op and only explicit allocations are
    protected."""

    def __enter__(self):
        self._prev = None
        try:
            from numpy._core.multiarray import _set_madvise_hugepage
        except ImportError:
            try:
                from numpy.core.multiarray import _set_madvise_hugepage
            except ImportError:
                return self
        self._set = _set_madvise_hugepage
        self._prev = _set_madvise_hugepage(False)
        return self

    def __exit__(self, *exc):
        if self._prev is not None:
            self._set(self._prev)
        return False
