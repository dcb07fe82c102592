"""Out-of-core database preprocessing for huge FASTA files.

`preprocess_db_streaming` builds the same `.oswt` artifact as
`oswald_tpu_torch.io.db.preprocess_db` but never holds the FASTA or the
packed database in RAM (the port's own copy of oswald_tpu.io.stream).  Peak
host memory is O(block) + O(n_seqs) index arrays: an Environmental-NR-scale
database (~100M sequences, tens of GB of FASTA) preprocesses on a host with
a few GB of RAM.

Structure (the FASTA is read once, through a read-ahead thread):

  scan:   stream record-aligned blocks -> the native OpenMP scanner
          emits per-record lengths, title bytes (spilled to a temp file)
          and encoded residues (spilled to a file-order staging file) in
          one walk per block
  sort:   argsort of the length array (RAM: 8 bytes/sequence)
  titles: rewrite the title spill in sorted order (OpenMP span gather)
  plan:   group/bin geometry from sorted lengths (io/db.py rules:
          1024-lane groups, 64-quantum lengths, bin-partition DP)
  pack:   gather each group's records from the staging file through the
          sorted permutation straight into the np.memmap'd bin files
          (OpenMP position-major packer)
"""

import json
import os

import numpy as np

from oswald_tpu_torch.alphabet import DUMMY
from oswald_tpu_torch.utils.hostmem import alloc_nohuge, numpy_nohuge
from oswald_tpu_torch.io.db import (
    GROUP_LANES, SUBLANES, LANES, LENGTH_QUANTUM, FORMAT_VERSION,
    _round_up, _partition_bins, _ragged_arange, _argsort_lengths,
    _BIN_COST_RESIDUES, PackedDB, load_db,
)

DEFAULT_BLOCK = 256 * 1024 * 1024


def _iter_blocks(path: str, block_bytes: int):
    """Yield FASTA blocks split at record boundaries ('\\n>').
    Compressed input (gzip/bzip2/xz) decompresses transparently."""
    from oswald_tpu_torch.io.fasta import open_maybe_compressed
    with open_maybe_compressed(path) as f:
        carry = b""
        while True:
            buf = f.read(block_bytes)
            if not buf:
                if carry:
                    yield carry
                return
            buf = carry + buf
            # cut at the LAST record start so records never straddle blocks
            cut = buf.rfind(b"\n>")
            if cut < 0:
                carry = buf
                continue
            yield buf[:cut + 1]
            carry = buf[cut + 1:]


def _iter_blocks_prefetch(path: str, block_bytes: int, depth: int = 2):
    """_iter_blocks through a reader thread: the next block's file read
    (and the GIL-free part of its split) overlaps the current block's
    parse/pack — file IO and the native scan both release the GIL.

    If the consumer abandons the generator (an exception mid-preprocess),
    the stop event unblocks the reader so it exits and closes the file
    instead of parking forever on a full queue."""
    import queue
    import threading
    q = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def reader():
        try:
            for b in _iter_blocks(path, block_bytes):
                if not _put(b):
                    return
            _put(None)
        except BaseException as e:        # surface IO errors in the consumer
            _put(e)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def _rfind_record_cut(view: np.ndarray) -> int:
    """Index of the LAST b"\\n>" in view (position of the '\\n'), or -1.
    Scans a growing tail window — records are small, so the cut is almost
    always within the last MiB."""
    n = view.size
    w = 1 << 20
    while True:
        lo = max(0, n - w)
        seg = view[lo:n]
        hits = np.flatnonzero((seg[:-1] == 0x0A) & (seg[1:] == 0x3E))
        if hits.size:
            return lo + int(hits[-1])
        if lo == 0:
            return -1
        w *= 4


def _iter_blocks_recycled(path: str, block_bytes: int):
    """Record-aligned FASTA blocks as numpy uint8 VIEWS of a small pool of
    recycled NOHUGEPAGE buffers (valid until the next iteration).  A reader
    thread refills free buffers ahead of the consumer, so the file read
    overlaps the parse; recycling means no block-scale allocations or
    bytes-concat copies at all after warmup (the copies' first-touch page
    faults cost more than the C scan on lazily-backed VMs)."""
    import queue
    import threading
    free: "queue.Queue" = queue.Queue()
    out: "queue.Queue" = queue.Queue()
    NBUF = 3
    for _ in range(NBUF):
        free.put(alloc_nohuge(block_bytes, np.uint8))
    stop = threading.Event()

    def _get(qq):
        while not stop.is_set():
            try:
                return qq.get(timeout=0.2)
            except queue.Empty:
                continue
        return None

    def _put(item):
        out.put(item)

    def reader():
        from oswald_tpu_torch.io.fasta import open_maybe_compressed
        carry = np.zeros(0, np.uint8)
        try:
            # gzip/bz2/xz readers support readinto (BufferedIOBase); zlib
            # releases the GIL, so decompression overlaps the parse too
            with open_maybe_compressed(path) as f:
                while True:
                    buf = _get(free)
                    if buf is None:
                        return
                    cl = carry.size
                    if buf.size < cl + block_bytes:
                        buf = alloc_nohuge(cl + block_bytes, np.uint8)
                    buf[:cl] = carry
                    m = f.readinto(memoryview(buf[cl:]))
                    total = cl + (m or 0)
                    if not m:
                        if total:
                            _put((buf, total))
                        _put(None)
                        return
                    view = buf[:total]
                    cut = _rfind_record_cut(view)
                    if cut < 0:
                        # no record start in the whole buffer: grow via the
                        # carry (rare — a record larger than block_bytes)
                        carry = np.array(view)
                        free.put(buf)        # reader still owns it
                        continue
                    carry = np.array(view[cut + 1:total])
                    _put((buf, cut + 1))
        except BaseException as e:
            _put(e)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        pending = None
        while True:
            item = out.get()
            if pending is not None:          # consumer done with prev block
                free.put(pending)
                pending = None
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            buf, used = item
            pending = buf
            yield buf[:used]
    finally:
        stop.set()


class _DirectFile:
    """Sequential file writer over O_DIRECT with an aligned bounce buffer.

    On hosts whose buffered page-cache writes are throttled to disk speed
    whatever the free memory, O_DIRECT writes run several times faster:
    the biggest I/O lever of the preprocess there.
    All data passes through a page-aligned bounce buffer so callers can
    write arbitrary sizes; the tail is padded to the 4 KiB block size and
    ftruncate'd back to the logical size at close.  Falls back to plain
    buffered IO where O_DIRECT is unavailable (non-Linux, some tmpfs)."""

    _BLOCK = 4096
    _BOUNCE = 16 << 20

    def __init__(self, path: str):
        self.size = 0
        self.fd = None
        self.fallback = None
        flag = getattr(os, "O_DIRECT", 0)
        if flag:
            try:
                self.fd = os.open(path, os.O_WRONLY | os.O_CREAT |
                                  os.O_TRUNC | flag, 0o644)
            except OSError:
                pass
        if self.fd is None:
            self.fallback = open(path, "wb", buffering=1 << 22)
            return
        self.buf = alloc_nohuge(self._BOUNCE, np.uint8)   # page-aligned
        self.fill = 0

    def write(self, data):
        """data: bytes / memoryview / contiguous numpy array."""
        if self.fallback is not None:
            self.fallback.write(data if isinstance(data, (bytes, memoryview))
                                else memoryview(np.ascontiguousarray(data)))
            self.size += len(data) if isinstance(data, bytes) else \
                np.asarray(data).nbytes
            return
        a = np.frombuffer(data, np.uint8) \
            if isinstance(data, (bytes, memoryview)) else \
            np.ascontiguousarray(data).reshape(-1).view(np.uint8)
        # zero-copy fast path: an aligned buffer at an aligned offset goes
        # straight to O_DIRECT, skipping the bounce copy (pack chunks are
        # mmap page-aligned and 4 KiB multiples; the npy header is padded
        # to 4 KiB to keep offsets aligned — see _npy_header_padded)
        if a.size and a.size % self._BLOCK == 0 and \
                a.ctypes.data % self._BLOCK == 0 and \
                self.fill % self._BLOCK == 0:
            if self.fill:
                os.write(self.fd, memoryview(self.buf[:self.fill]))
                self.fill = 0
            os.write(self.fd, memoryview(a))
            self.size += a.size
            return
        pos, n = 0, a.size
        while pos < n:
            take = min(n - pos, self._BOUNCE - self.fill)
            self.buf[self.fill:self.fill + take] = a[pos:pos + take]
            self.fill += take
            pos += take
            if self.fill == self._BOUNCE:
                os.write(self.fd, memoryview(self.buf))
                self.fill = 0
        self.size += n

    def close(self):
        if self.fallback is not None:
            self.fallback.close()
            self.fallback = None
            return
        if self.fd is None:
            return
        if self.fill:
            pad = (-self.fill) % self._BLOCK
            self.buf[self.fill:self.fill + pad] = 0
            os.write(self.fd, memoryview(self.buf[:self.fill + pad]))
            self.fill = 0
        os.ftruncate(self.fd, self.size)
        os.close(self.fd)
        self.fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _npy_header_padded(shape, descr="|i1", pad_to=4096):
    """npy v1.0 header space-padded to `pad_to` bytes, so the array data
    that follows starts at an O_DIRECT-aligned file offset (the format
    allows arbitrary space padding before the closing newline)."""
    import struct
    d = ("{'descr': '%s', 'fortran_order': False, 'shape': %r, }"
         % (descr, tuple(shape))).encode()
    hlen = pad_to - 10                       # magic(6)+ver(2)+len(2)
    if len(d) + 1 > hlen:
        raise ValueError("npy header dict exceeds its padding")
    return (b"\x93NUMPY\x01\x00" + struct.pack("<H", hlen) +
            d + b" " * (hlen - len(d) - 1) + b"\n")


def _mem_available_bytes() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 4 << 30                            # conservative default


class _Staging:
    """RAM-first staging arena with temp-file spill (the bounded-memory
    fallback for databases larger than RAM).

    The fast path hands out write-in-place views (`reserve`/`commit`) of
    one NOHUGEPAGE arena so the native scanner's output lands directly in
    its final staging location — zero staging copies.  On a VM with
    lazily host-backed RAM and defrag=madvise THP every distinct GB of
    footprint pays slow first-touch faults, so eliminating the copy+concat
    round-trip matters twice: less memory traffic AND half the footprint.
    Past the budget (or when a reservation can't fit) everything spills to
    a sequential temp file instead."""

    def __init__(self, path: str, budget_bytes: int,
                 upper_bytes: int | None = None):
        self.path = path
        self.budget = budget_bytes
        # arena sized to the known upper bound (e.g. the FASTA file size —
        # residues+titles can never exceed it); virtual until touched
        self.upper = upper_bytes if upper_bytes is not None \
            else budget_bytes
        self.arena = None
        self.total = 0
        self.f = None

    def reserve(self, nbytes: int):
        """View of the next `nbytes` of the arena for in-place writing, or
        None when staging has spilled to disk (caller then uses its own
        scratch buffer and hands the data to `append`)."""
        nbytes = int(nbytes)
        if self.f is None and self.arena is None:
            size = min(self.budget, self.upper)
            if nbytes <= size:
                self.arena = alloc_nohuge(size, np.uint8)
        if self.arena is not None and \
                self.total + nbytes <= self.arena.size:
            return self.arena[self.total:self.total + nbytes]
        if self.f is None:
            self._spill()
        return None

    def commit(self, nbytes: int):
        """The first `nbytes` of the last reservation are now live."""
        self.total += int(nbytes)

    def append(self, arr):
        """Spill-path write: arr is bytes or a numpy view (the caller's
        scratch, reused next block)."""
        if isinstance(arr, (bytes, memoryview)):
            arr = np.frombuffer(arr, np.uint8)
        if self.f is None:
            self._spill()
        self.f.write(arr)
        self.total += arr.nbytes

    def _spill(self):
        self.f = _DirectFile(self.path)
        if self.arena is not None:
            self.f.write(self.arena[:self.total])
            self.arena = None

    def finish(self, dtype):
        """-> flat array of everything staged (arena view or read-only
        memmap of the spill file)."""
        if self.f is None:
            if self.arena is None:
                return np.zeros(0, dtype)
            return self.arena[:self.total].view(dtype)
        self.f.close()
        self.f = None
        return np.memmap(self.path, dtype=dtype, mode="r") \
            if os.path.getsize(self.path) else np.zeros(0, dtype)

    def cleanup(self):
        self.arena = None
        if self.f is not None:
            self.f.close()
            self.f = None
        if os.path.exists(self.path):
            os.remove(self.path)


def _parse_block(data: bytes, titles: str | None = "list",
                 workspace: dict | None = None,
                 seq_alloc=None, titles_alloc=None):
    from oswald_tpu_torch.io import native
    if native.available() and not os.environ.get("OSWALD_NO_NATIVE"):
        return native.parse_fasta_bytes(data, titles=titles,
                                        workspace=workspace,
                                        seq_alloc=seq_alloc,
                                        titles_alloc=titles_alloc)
    from oswald_tpu_torch.io.fasta import parse_fasta_bytes
    if isinstance(data, np.ndarray):
        data = data.tobytes()
    return parse_fasta_bytes(data, titles=titles)


def preprocess_db_streaming(fasta_path: str, out_path: str,
                            block_bytes: int = DEFAULT_BLOCK,
                            bin_cost: int = _BIN_COST_RESIDUES,
                            verbose: bool = True,
                            ram_budget_bytes: int | None = None) -> PackedDB:
    """FASTA -> packed on-disk database, bounded-memory. Returns the
    loaded (memory-mapped) PackedDB.

    ram_budget_bytes: staging (encoded residues + title bytes) stays in RAM
    up to this budget and spills to temp files beyond it (default: half of
    MemAvailable).  Pass 0 to force the spill path."""
    with numpy_nohuge():      # block-scale numpy temporaries would other-
        # wise first-touch slowly on defrag=madvise THP kernels
        return _preprocess_db_streaming(fasta_path, out_path, block_bytes,
                                        bin_cost, verbose, ram_budget_bytes)


def _preprocess_db_streaming(fasta_path, out_path, block_bytes, bin_cost,
                             verbose, ram_budget_bytes) -> PackedDB:
    import time
    t0 = time.perf_counter()
    phase_t = {}

    def _mark(name, t_start):
        phase_t[name] = phase_t.get(name, 0.0) + time.perf_counter() \
            - t_start
        return time.perf_counter()

    d = out_path + ".oswt"
    os.makedirs(d, exist_ok=True)
    from oswald_tpu_torch.io import native
    use_native = native.available() and \
        not os.environ.get("OSWALD_NO_NATIVE")
    if ram_budget_bytes is None:
        ram_budget_bytes = _mem_available_bytes() // 2

    # ---- pass 1 (the ONLY read of the FASTA): parse blocks -> lengths,
    # title bytes, encoded residues in file order.  The native scanner
    # writes residues/titles DIRECTLY into the staging arenas (RAM-first,
    # temp-file spill past the budget).  No per-record Python loop, no
    # staging copies. ----
    lengths = []
    fsize = os.path.getsize(fasta_path)
    # compressed input: the decompressed content exceeds the on-disk size;
    # scale the arena upper-bound hint (only a sizing hint — overflow
    # spills to disk correctly either way; protein FASTA gzips ~3-4x)
    with open(fasta_path, "rb") as _fh:
        _head = _fh.read(6)
    if _head[:2] == b"\x1f\x8b" or _head[:3] == b"BZh" \
            or _head[:6] == b"\xfd7zXZ\x00":
        fsize *= 4
    # each staging's content is bounded by the FASTA size itself
    stg_titles = _Staging(os.path.join(d, "titles.tmp"),
                          ram_budget_bytes // 4, upper_bytes=fsize)
    stg_resid = _Staging(os.path.join(d, "residues.tmp"), ram_budget_bytes,
                         upper_bytes=fsize)
    tlen_parts = []
    # persistent per-block output buffers: fresh block-scale numpy
    # allocations cost more in first-touch page faults than the scan itself
    ws: dict = {}
    in_arena = {"seq": False, "titles": False}

    def _seq_alloc(nb):
        v = stg_resid.reserve(nb)
        in_arena["seq"] = v is not None
        return v

    def _titles_alloc(nb):
        v = stg_titles.reserve(nb)
        in_arena["titles"] = v is not None
        return v

    t = time.perf_counter()
    try:
        for block in _iter_blocks_recycled(fasta_path, block_bytes):
            t = _mark("read1", t)
            in_arena["seq"] = in_arena["titles"] = False
            (tjoined, tlens), flat, ls = _parse_block(
                block, titles="bytes", workspace=ws,
                seq_alloc=_seq_alloc, titles_alloc=_titles_alloc)
            # ls/tlens are workspace views — copy what outlives the block
            lengths.append(np.array(ls, np.int64))
            tlen_parts.append(np.array(tlens, np.int64))
            t = _mark("parse1", t)
            if in_arena["titles"]:
                stg_titles.commit(len(tjoined))
            else:
                stg_titles.append(tjoined)
            if in_arena["seq"]:
                stg_resid.commit(len(flat))
            else:
                stg_resid.append(flat)
            t = _mark("stage1", t)
    except BaseException:
        stg_titles.cleanup()
        stg_resid.cleanup()
        raise
    lengths = np.concatenate(lengths) if lengths else np.zeros(0, np.int64)
    n = len(lengths)
    tlens = np.concatenate(tlen_parts) if tlen_parts else \
        np.zeros(0, np.int64)
    # extents into the title staging ("title\n" stride)
    tends = np.cumsum(tlens + 1) - 1
    tstarts = tends - tlens

    # ---- sort + geometry plan ----
    t = time.perf_counter()
    order = _argsort_lengths(lengths)                # ascending by length
    sorted_lengths = lengths[order]

    # sorted titles.txt ("\n"-joined, no trailing separator — save_db's
    # format) + end-offset index, gathered chunk-wise (bounded memory;
    # native OpenMP span-copy, numpy scatter fallback — the original
    # per-title Python loop dominated pass 1)
    sorted_offs = np.zeros(n + 1, np.int64)
    tbuf = stg_titles.finish(np.uint8)
    with _DirectFile(os.path.join(d, "titles.txt")) as out:
        pos_out = 0
        CH = 1 << 20                          # titles per chunk
        tchunk = np.zeros(0, np.uint8)        # reused across chunks
        for c0 in range(0, n, CH):
            src = order[c0:c0 + CH]
            lt = tlens[src]
            sep = np.ones(len(src), np.int64)
            if c0 == 0:
                sep[0] = 0                    # no separator before title 0
            widths = lt + sep
            dst0 = np.cumsum(widths) - widths + sep
            need = int(widths.sum())
            if tchunk.size < need:            # one alloc, one fault cost
                tchunk = alloc_nohuge(need + need // 4, np.uint8)
            buf_out = tchunk[:need]
            buf_out[:] = ord("\n")
            if use_native:
                native.gather_spans(tbuf, tstarts[src], lt, dst0,
                                    buf_out)
            else:
                dst = np.repeat(dst0, lt) + _ragged_arange(lt)
                gsrc = np.repeat(tstarts[src], lt) + _ragged_arange(lt)
                buf_out[dst] = tbuf[gsrc]
            out.write(buf_out)
            sorted_offs[c0 + 1:c0 + len(src) + 1] = pos_out + dst0 + lt
            pos_out += int(widths.sum())
    del tbuf
    stg_titles.cleanup()
    np.save(os.path.join(d, "titles_idx.npy"), sorted_offs)
    t = _mark("sort_titles", t)

    n_groups = -(-n // GROUP_LANES) if n else 0
    group_Ls = []
    for g in range(n_groups):
        lo, hi = g * GROUP_LANES, min((g + 1) * GROUP_LANES, n)
        group_Ls.append(_round_up(max(int(sorted_lengths[lo:hi].max()), 1),
                                  LENGTH_QUANTUM))
    group_Ls = _partition_bins(group_Ls, [GROUP_LANES] * n_groups, bin_cost)

    # bins: ordered dict L -> list of group indices (ascending runs)
    bins = {}
    for g, L in enumerate(group_Ls):
        bins.setdefault(L, []).append(g)
    # id/len arrays in RAM (small); the seq arrays are written by the pack
    # phase as sequential buffered .npy writes (memmap output pays a
    # zero-fill fault plus writeback per page — ~2x the IO)
    for L, gs in bins.items():
        Gb = len(gs)
        lens = np.zeros((Gb, GROUP_LANES), np.int32)
        ids = np.full((Gb, GROUP_LANES), -1, np.int32)
        for bg, g in enumerate(gs):
            lo, hi = g * GROUP_LANES, min((g + 1) * GROUP_LANES, n)
            cnt = hi - lo
            lens[bg, :cnt] = sorted_lengths[lo:hi]
            ids[bg, :cnt] = np.arange(lo, hi)
        np.save(os.path.join(d, f"bin{L}_len.npy"),
                lens.reshape(Gb, SUBLANES, LANES))
        np.save(os.path.join(d, f"bin{L}_id.npy"),
                ids.reshape(Gb, SUBLANES, LANES))
    t = _mark("alloc_bins", t)

    # ---- pack: gather each group's records straight out of the
    # FILE-ORDER staging area through the sorted permutation (per-record
    # contiguous reads -- no permuted rewrite of the residue data), packed
    # into the [L, 8, 128] lane tiles by the OpenMP native packer (numpy
    # fallback below), chunked to bound RAM ----
    starts_file = np.concatenate([[0], np.cumsum(lengths)])
    staging = stg_resid.finish(np.int8)
    t = _mark("stage_finish", t)
    # double-buffered async writes: a single writer thread drains buffer i
    # while the packer fills buffer 1-i, overlapping disk writeback with
    # the pack compute (single-thread executor => writes stay ordered)
    from concurrent.futures import ThreadPoolExecutor
    pack_bufs = [np.zeros(0, np.int8), np.zeros(0, np.int8)]
    futs = [None, None]
    all_futs = []                             # IO errors surface at the end
    wi = 0
    writer = ThreadPoolExecutor(max_workers=1)
    try:
        for L, gs in bins.items():
            Gb = len(gs)
            g0 = gs[0]
            # ascending lengths => nondecreasing group Ls => each bin's
            # groups are one consecutive run
            if gs != list(range(g0, g0 + Gb)):
                raise ValueError(f"bin {L}: groups not contiguous "
                                 f"({gs[:3]} ... {gs[-3:]})")
            CHG = max(1, (256 << 20) // (L * GROUP_LANES))
            f = _DirectFile(os.path.join(d, f"bin{L}_seq.npy"))
            f.write(_npy_header_padded((Gb, L, SUBLANES, LANES)))
            for b0 in range(0, Gb, CHG):
                t = time.perf_counter()
                ng = min(CHG, Gb - b0)
                lo_seq = (g0 + b0) * GROUP_LANES
                hi_seq = min((g0 + b0 + ng) * GROUP_LANES, n)
                cnt = hi_seq - lo_seq
                ksel = order[lo_seq:hi_seq]
                starts = starts_file[ksel]
                lens_sel = lengths[ksel]      # == sorted_lengths slice
                gstarts = np.minimum(np.arange(ng + 1) * GROUP_LANES, cnt)
                need = ng * L * GROUP_LANES
                t = _mark("pack_prep", t)
                if futs[wi] is not None:
                    futs[wi].result()         # buffer wi free to refill
                    futs[wi] = None
                t = _mark("pack_wait", t)
                if pack_bufs[wi].size < need:
                    pack_bufs[wi] = alloc_nohuge(need, np.int8)
                chunk = pack_bufs[wi][:need]
                t = time.perf_counter()
                if use_native:
                    native.pack_groups_sl(
                        staging, starts, lens_sel, gstarts, [L] * ng,
                        out=chunk)
                else:
                    buf = chunk.reshape(ng, L, GROUP_LANES)
                    buf[...] = DUMMY
                    lcl = np.minimum(lens_sel, L)
                    p = _ragged_arange(lcl)
                    src = np.repeat(starts, lcl) + p
                    kloc = np.arange(cnt)
                    lane_i = (kloc % GROUP_LANES).repeat(lcl)
                    grp_i = (kloc // GROUP_LANES).repeat(lcl)
                    dest = (grp_i * L + p) * GROUP_LANES + lane_i
                    buf.reshape(-1)[dest] = staging[src]
                t = _mark("pack", t)
                futs[wi] = writer.submit(f.write, chunk)
                all_futs.append(futs[wi])
                wi = 1 - wi
            all_futs.append(writer.submit(f.close))  # ordered after writes
        for fu in all_futs:
            fu.result()
    finally:
        writer.shutdown(wait=True)
        t = _mark("pack_write", t)
    del staging
    stg_resid.cleanup()

    np.save(os.path.join(d, "lengths.npy"), sorted_lengths)
    meta = {"version": FORMAT_VERSION, "n_seqs": n,
            "n_residues": int(lengths.sum()),
            "bins": sorted(bins.keys()), "group_lanes": GROUP_LANES}
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)

    if verbose:
        dt = time.perf_counter() - t0
        phases = " ".join(f"{k}={v:.1f}s" for k, v in phase_t.items())
        print(f"oswald-tpu-torch preprocess (streaming): {n} sequences "
              f"({meta['n_residues']} residues) -> {d} "
              f"[bins: {', '.join(map(str, sorted(bins)))}] in {dt:.2f}s "
              f"({phases})")
    return load_db(out_path)
