"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

Each kernel is one `csrc/<name>.cu` file with a plain C interface (no
PyTorch headers, so nvcc takes seconds); the `csrc/*.cuh` headers are
shared by all of them.  The shared library goes to `build_dir()`, the
kernel cache directory of `oswald_tpu_torch.utils.compile_cache` (the user's
cache directory unless another was enabled), named after a hash of the
sources and flags, so an edited source builds anew and an unchanged one is
reused by later processes.  Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from oswald_tpu_torch.utils import compile_cache

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the measurement stands beside kBlocksPerSm in csrc/sw_tile.cuh
BLOCKS_PER_SM = 4

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every entry point: (argtypes, restype)
SIGNATURES = {
    "sw_groups": {
        "sw_groups_launch": ([_P, _P, _I, _P, _I, _P, _I, _P, _I, _I, _P, _P,
                              _P, _P, _I], _I),
        "sw_groups_max_active_clusters": ([_I], _I),
        "sw_groups_error_string": ([_I], ctypes.c_char_p),
    },
    "sw_groups_packed": {
        "sw_groups_packed_launch": ([_P, _P, _I, _P, _I, _P, _I, _P, _I, _P,
                                     _I, _I, _P, _P, _P, _P, _I], _I),
        "sw_groups_packed_max_active_clusters": ([_I], _I),
        "sw_groups_packed_error_string": ([_I], ctypes.c_char_p),
    },
    "sw_groups_lab": {
        "sw_groups_lab_launch": ([_P, _P, _I, _P, _I, _P, _I, _P, _I, _I, _P,
                                  _P, _P, _P, _I, _I, _I], _I),
        "sw_groups_lab_error_string": ([_I], ctypes.c_char_p),
    },
}

# loaded libraries by (name, blocks per SM, directory): a directory enabled
# later loads its own copies
_libs = {}
_lock = threading.Lock()
# nvcc's -Xptxas -v report (registers, shared memory, spills) per kernel
# built by this process: under the kernel's name its last build's, under
# (name, blocks per SM) each build's
build_logs = {}


def _keep_log(name: str, log: str):
    build_logs[name] = build_logs[(name, int(BLOCKS_PER_SM))] = log


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the oswald_tpu_torch kernels")


def nvcc_flags():
    return NVCC_FLAGS + [f"-DSW_BLOCKS_PER_SM={int(BLOCKS_PER_SM)}"]


def _sources(name: str):
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    """The directory the libraries are built into and loaded from: the one
    compile_cache enabled, else its default."""
    return Path(compile_cache.current_dir())


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(nvcc_flags()).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def _compile(name: str, out: Path) -> str:
    out.parent.mkdir(parents=True, exist_ok=True)
    # build under a temporary name and rename: a concurrent process sees
    # either no library or a whole one
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *nvcc_flags(), "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc.stdout + proc.stderr


def build_all(names=None):
    """Build every kernel library that has no build yet, one nvcc per
    source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    with _lock:
        todo = [(n, library_path(n)) for n in (names or sorted(SIGNATURES))]
        todo = [(n, p) for n, p in todo if not p.exists()]
        if not todo:
            return
        with ThreadPoolExecutor(len(todo)) as pool:
            logs = list(pool.map(lambda np_: _compile(*np_), todo))
        for (n, _), log in zip(todo, logs):
            _keep_log(n, log)


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if this source has no build."""
    with _lock:
        key = (name, int(BLOCKS_PER_SM), build_dir())
        lib = _libs.get(key)
        if lib is not None:
            return lib
        path = library_path(name)
        if not path.exists():
            _keep_log(name, _compile(name, path))
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[key] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, err: int):
    """Raise when a launch entry returned a CUDA error."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{err} ({msg})")
