"""ctypes bindings for the native I/O library (`native/oswald_io.cpp`): the
port's own copy of oswald_tpu.io.native.

The library speeds up the host side of building a database: the FASTA scan
and encode, and the packing of groups.  It is optional: `available()` says
whether it is loaded, and oswald_tpu_torch.io falls back to its numpy
implementations when it is not (no C++ compiler) or when the environment
sets OSWALD_NO_NATIVE.

It is built at first use from the repository's `native/oswald_io.cpp`, with
that directory's Makefile flags (-O3 -fPIC -fopenmp, no -march=native: a
copied build must not fault on an older CPU) and the first of $CXX, g++ and
c++ that succeeds, into the port's kernel directory
(`kernels.build.build_dir()`), under a name hashed from the source and the
flags; `native/` itself is left untouched.
"""

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "oswald_io.cpp"
CXX_FLAGS = ["-O3", "-fPIC", "-fopenmp", "-Wall", "-Wextra", "-shared"]

# must match oswald_io_version() in native/oswald_io.cpp; a library of
# another version is refused (the numpy path runs) instead of diverging
_EXPECTED_VERSION = 5

_lib = None
_build_attempted = False
_lock = threading.Lock()
# why the library is not available, when it is not (the compiler's output,
# or the loader's error), for callers that must say so
build_log = ""
# the file the loaded library came from
loaded_from = None


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    from oswald_tpu_torch.kernels.build import build_dir
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return build_dir() / f"liboswald_io_{h.hexdigest()[:16]}.so"


def _compilers():
    """$CXX, then the system's g++ and c++: a toolchain named in $CXX may
    lack OpenMP (no libgomp), which the flags need."""
    names = [os.environ["CXX"]] if os.environ.get("CXX") else []
    return list(dict.fromkeys(names + ["g++", "c++"]))


def _build(out: Path):
    """Compile the library into `out` with the first compiler that
    succeeds; quiet on failure (no compiler, no source), which build_log
    records: the numpy path is always there."""
    global build_log
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
    except OSError as e:
        build_log = f"no build directory: {e}"
        return
    logs = []
    try:
        for cxx in _compilers():
            cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                logs.append(f"{' '.join(cmd)}: {e}")
                continue
            logs.append(f"{' '.join(cmd)}: exit {proc.returncode}\n"
                        f"{proc.stderr}")
            if proc.returncode == 0:
                # built under a temporary name, then renamed: a concurrent
                # process sees no library or a whole one
                os.replace(tmp, out)
                break
    finally:
        build_log = "\n".join(logs)
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _build_attempted, build_log, loaded_from
    with _lock:
        if _lib is not None:
            return _lib
        if not SOURCE.is_file():
            # an installed package without the repository beside it
            if not _build_attempted:
                _build_attempted = True
                build_log = (f"{SOURCE} is missing: the library builds "
                             "from the repository's source tree")
                print(f"oswald-tpu-torch: native I/O off, {build_log}; "
                      "the numpy path runs", file=sys.stderr)
            return None
        path = library_path()
        if not path.exists() and not _build_attempted:
            _build_attempted = True
            _build(path)
        if path.exists():
            _lib = _bind(path)
            if _lib is not None:
                loaded_from = path
        return _lib


def _bind(path: Path):
    """The loaded library with every entry point declared, or None for a
    library that does not load or has another version (build_log says
    which)."""
    global build_log
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        build_log = f"{path} does not load: {e}"
        return None
    try:
        lib.oswald_io_version.restype = ctypes.c_int
        if lib.oswald_io_version() != _EXPECTED_VERSION:
            build_log = f"{path} is not version {_EXPECTED_VERSION}"
            return None
    except AttributeError:
        build_log = f"{path} has no oswald_io_version"
        return None
    c_i8p = ctypes.POINTER(ctypes.c_int8)
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    lib.oswald_fasta_count.restype = ctypes.c_int64
    lib.oswald_fasta_count.argtypes = [c_u8p, ctypes.c_int64, c_i64p]
    lib.oswald_fasta_encode.restype = ctypes.c_int64
    lib.oswald_fasta_encode.argtypes = [
        c_u8p, ctypes.c_int64, c_i8p, c_i64p, c_i64p, c_i64p]
    lib.oswald_pack_groups.restype = None
    lib.oswald_pack_groups.argtypes = [
        c_i8p, c_i64p, c_i64p, ctypes.c_int64, c_i64p, c_i8p, c_i64p]
    lib.oswald_fasta_count_mt.restype = ctypes.c_int64
    lib.oswald_fasta_count_mt.argtypes = lib.oswald_fasta_count.argtypes
    lib.oswald_fasta_encode_mt.restype = ctypes.c_int64
    lib.oswald_fasta_encode_mt.argtypes = lib.oswald_fasta_encode.argtypes
    lib.oswald_pack_groups_sl.restype = None
    lib.oswald_pack_groups_sl.argtypes = [
        c_i8p, c_i64p, c_i64p, c_i64p, ctypes.c_int64, c_i64p, c_i8p,
        c_i64p]
    lib.oswald_fasta_encode_titles_mt.restype = ctypes.c_int64
    lib.oswald_fasta_encode_titles_mt.argtypes = [
        c_u8p, ctypes.c_int64, c_i8p, c_i64p, c_i64p, c_i64p, c_u8p, c_i64p]
    lib.oswald_gather_spans.restype = None
    lib.oswald_gather_spans.argtypes = [
        c_u8p, c_i64p, c_i64p, c_i64p, ctypes.c_int64, c_u8p]
    lib.oswald_fasta_num_chunks.restype = ctypes.c_int
    lib.oswald_fasta_num_chunks.argtypes = [ctypes.c_int64]
    lib.oswald_fasta_plan.restype = ctypes.c_int64
    lib.oswald_fasta_plan.argtypes = [
        c_u8p, ctypes.c_int64, ctypes.c_int, c_i64p, c_i64p, c_i64p, c_i64p,
        c_i64p, c_i64p]
    lib.oswald_fasta_execute.restype = ctypes.c_int64
    lib.oswald_fasta_execute.argtypes = [
        c_u8p, ctypes.c_int64, ctypes.c_int, c_i64p, c_i64p, c_i64p, c_i64p,
        c_i8p, c_i64p, c_i64p, c_i64p, c_u8p]
    return lib


def available() -> bool:
    return _load() is not None


def _require(lib):
    if lib is None:
        raise RuntimeError("the native I/O library is not available (no C++ "
                           "compiler, or native/oswald_io.cpp missing)")


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def _ws_array(ws, key, size, dtype, zero=False):
    """Persistent workspace array: grown (never shrunk) across calls.
    Fresh numpy allocations of block-scale buffers cost more in first-touch
    page faults than the C scan itself (numpy madvises MADV_HUGEPAGE and
    defrag=madvise kernels compact synchronously — see utils/hostmem.py),
    so the streaming preprocess passes one `workspace` dict through every
    block and buffers are allocated NOHUGEPAGE."""
    from oswald_tpu_torch.utils.hostmem import alloc_nohuge
    a = ws.get(key) if ws is not None else None
    if a is None or a.size < size:
        a = alloc_nohuge(size, dtype)
        if ws is not None:
            ws[key] = a
    if zero:
        a[:size] = 0
    return a


def parse_fasta_bytes(data: bytes, titles: str | None = "list",
                      workspace: dict | None = None,
                      seq_alloc=None, titles_alloc=None):
    """Native single-pass FASTA parse; same contract as
    oswald_tpu_torch.io.fasta.parse_fasta_bytes (including its ValueErrors for
    non-FASTA input — the C scanner itself skips malformed content, so the
    validation lives here).  titles: "list" (list[str]), "bytes"
    ((joined_bytes, lens) with one b"\\n" after each title, no Python
    per-record loop), or None (skip title work).

    workspace: optional dict reused across calls; returned arrays are then
    VIEWS into workspace buffers, invalidated by the next call — copy what
    must survive.

    seq_alloc / titles_alloc: optional `(nbytes) -> uint8/int8 view | None`
    callbacks; when one returns a view the C walk writes that output
    DIRECTLY into it (a staging arena — see io/stream._Staging) and the
    returned array is a slice of it; on None the workspace buffer is
    used."""
    lib = _load()
    _require(lib)
    if isinstance(data, np.ndarray):
        buf = data.view(np.uint8).reshape(-1)
    else:
        buf = np.frombuffer(data, dtype=np.uint8)
    if buf.size:
        # match the numpy reference exactly: the first line must be a
        # header, and at least one header must exist
        if buf[0] != 0x3E:                            # b">"
            # error path only — fine to materialise bytes here
            blob = buf.tobytes()
            if b"\n>" not in blob:
                raise ValueError(
                    "not a FASTA file: no '>' header lines found")
            raise ValueError("FASTA content before first '>' header")
    n = np.int64(buf.size)
    if titles == "bytes":
        # two-walk plan/execute pipeline: ONE parallel pre-walk sizes
        # everything (records, residues, title bytes), ONE main walk emits
        # residues AND the spill-ready "title\n" stream
        nt = lib.oswald_fasta_num_chunks(n)
        cb = _ws_array(workspace, "cb", nt + 1, np.int64)
        rec_base = _ws_array(workspace, "rec_base", nt + 1, np.int64)
        w_base = _ws_array(workspace, "w_base", nt + 1, np.int64)
        t_base = _ws_array(workspace, "t_base", nt + 1, np.int64)
        sb = ctypes.c_int64(0)
        tb = ctypes.c_int64(0)
        nrec = lib.oswald_fasta_plan(
            _ptr(buf, ctypes.c_uint8), n, nt, _ptr(cb, ctypes.c_int64),
            _ptr(rec_base, ctypes.c_int64), _ptr(w_base, ctypes.c_int64),
            _ptr(t_base, ctypes.c_int64), ctypes.byref(sb),
            ctypes.byref(tb))
        seq = seq_alloc(max(sb.value, 1)) if seq_alloc is not None else None
        seq = seq.view(np.int8) if seq is not None else \
            _ws_array(workspace, "seq", max(sb.value, 1), np.int8)
        touts = titles_alloc(max(tb.value, 1)) \
            if titles_alloc is not None else None
        if touts is None:
            touts = _ws_array(workspace, "touts", max(tb.value, 1),
                              np.uint8)
        lengths = _ws_array(workspace, "lengths", max(nrec, 1), np.int64,
                            zero=True)
        hs = _ws_array(workspace, "hs", max(nrec, 1), np.int64, zero=True)
        he = _ws_array(workspace, "he", max(nrec, 1), np.int64, zero=True)
        wrote = lib.oswald_fasta_execute(
            _ptr(buf, ctypes.c_uint8), n, nt, _ptr(cb, ctypes.c_int64),
            _ptr(rec_base, ctypes.c_int64), _ptr(w_base, ctypes.c_int64),
            _ptr(t_base, ctypes.c_int64), _ptr(seq, ctypes.c_int8),
            _ptr(lengths, ctypes.c_int64), _ptr(hs, ctypes.c_int64),
            _ptr(he, ctypes.c_int64), _ptr(touts, ctypes.c_uint8))
        tw = tb
        out_titles = (touts[:tw.value] if workspace is not None else
                      touts[:tw.value].tobytes(), he[:nrec] - hs[:nrec])
        return out_titles, seq[:wrote], lengths[:nrec]
    ub = ctypes.c_int64(0)
    nrec = lib.oswald_fasta_count_mt(_ptr(buf, ctypes.c_uint8), n,
                                     ctypes.byref(ub))
    seq = seq_alloc(max(ub.value, 1)) if seq_alloc is not None else None
    if seq is not None:
        seq = seq.view(np.int8)
    else:
        seq = _ws_array(workspace, "seq", max(ub.value, 1), np.int8)
    lengths = _ws_array(workspace, "lengths", max(nrec, 1), np.int64,
                        zero=True)
    hs = _ws_array(workspace, "hs", max(nrec, 1), np.int64, zero=True)
    he = _ws_array(workspace, "he", max(nrec, 1), np.int64, zero=True)
    wrote = lib.oswald_fasta_encode_mt(
        _ptr(buf, ctypes.c_uint8), n, _ptr(seq, ctypes.c_int8),
        _ptr(lengths, ctypes.c_int64), _ptr(hs, ctypes.c_int64),
        _ptr(he, ctypes.c_int64))
    if titles == "list":
        hs, he = hs[:nrec], he[:nrec]
        out_titles = [bytes(buf[hs[i]:he[i]]).decode("utf-8",
                                                     errors="replace")
                      for i in range(nrec)]
    else:
        out_titles = None
    return out_titles, seq[:wrote], lengths[:nrec]


def pack_groups(seqs_flat, offsets, group_starts, padded_lengths):
    """Pack length-sorted sequences into [L_g, 1024] lane-major groups.

    seqs_flat:      int8[total] concatenated encoded residues (sorted order)
    offsets:        int64[n+1] per-sequence extents into seqs_flat
    group_starts:   int64[G+1] first sequence index of each group
    padded_lengths: int64[G]   padded length per group
    Returns a list of int8[L_g, 1024] arrays.
    """
    lib = _load()
    _require(lib)
    seqs_flat = np.ascontiguousarray(seqs_flat, np.int8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    group_starts = np.ascontiguousarray(group_starts, np.int64)
    Ls = np.ascontiguousarray(padded_lengths, np.int64)
    G = len(Ls)
    out_offsets = np.concatenate([[0], np.cumsum(Ls * 1024)]).astype(np.int64)
    outs = np.empty(int(out_offsets[-1]), np.int8)
    lib.oswald_pack_groups(
        _ptr(seqs_flat, ctypes.c_int8), _ptr(offsets, ctypes.c_int64),
        _ptr(group_starts, ctypes.c_int64), np.int64(G),
        _ptr(Ls, ctypes.c_int64), _ptr(outs, ctypes.c_int8),
        _ptr(out_offsets, ctypes.c_int64))
    return [outs[out_offsets[g]:out_offsets[g + 1]].reshape(int(Ls[g]), 1024)
            for g in range(G)]


def pack_groups_sl(seqs_flat, starts, lens, group_starts, padded_lengths,
                   out=None):
    """Like pack_groups but with per-sequence (start, len) extents, so the
    source can be a file-order staging array addressed through a sorted
    permutation (the out-of-core preprocess path; no permuted rewrite of
    the residue data is needed).

    out: optional preallocated int8[sum(L_g) * 1024] destination (e.g. a
    memmap slice) — written in group order.  Returns out (flat).
    """
    lib = _load()
    _require(lib)
    seqs_flat = np.ascontiguousarray(seqs_flat, np.int8)
    starts = np.ascontiguousarray(starts, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    group_starts = np.ascontiguousarray(group_starts, np.int64)
    Ls = np.ascontiguousarray(padded_lengths, np.int64)
    G = len(Ls)
    out_offsets = np.concatenate([[0], np.cumsum(Ls * 1024)]).astype(np.int64)
    if out is None:
        out = np.empty(int(out_offsets[-1]), np.int8)
    if out.dtype != np.int8 or out.size != int(out_offsets[-1]):
        raise ValueError(f"pack_groups_sl: out must be int8[{out_offsets[-1]}]"
                         f", got {out.dtype}[{out.size}]")
    lib.oswald_pack_groups_sl(
        _ptr(seqs_flat, ctypes.c_int8), _ptr(starts, ctypes.c_int64),
        _ptr(lens, ctypes.c_int64), _ptr(group_starts, ctypes.c_int64),
        np.int64(G), _ptr(Ls, ctypes.c_int64), _ptr(out, ctypes.c_int8),
        _ptr(out_offsets, ctypes.c_int64))
    return out


def gather_spans(src_buf, starts, lens, dst_off, out):
    """out[dst_off[k] : +lens[k]] = src_buf[starts[k] : +lens[k]] for all k
    (OpenMP memcpy per span); separators are whatever `out` holds."""
    lib = _load()
    _require(lib)
    src_buf = np.ascontiguousarray(src_buf, np.uint8)
    starts = np.ascontiguousarray(starts, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    dst_off = np.ascontiguousarray(dst_off, np.int64)
    if out.dtype != np.uint8 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError("gather_spans: out must be a contiguous uint8 array")
    lib.oswald_gather_spans(
        _ptr(src_buf, ctypes.c_uint8), _ptr(starts, ctypes.c_int64),
        _ptr(lens, ctypes.c_int64), _ptr(dst_off, ctypes.c_int64),
        np.int64(len(starts)), _ptr(out, ctypes.c_uint8))
    return out
