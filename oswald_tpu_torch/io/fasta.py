"""FASTA parsing, vectorised with numpy (the port's own copy of
oswald_tpu.io.fasta).

A single-pass, whole-buffer parse: one `np.frombuffer` over the file,
header and residue byte masks computed with array ops, per-record residue
extents via `bincount` — no Python-level per-residue loop.  The native C++
scanner (oswald_tpu_torch.io.native) substitutes for it when its library is
built; this module is the portable implementation and the correctness
reference for it.
"""

import numpy as np

from oswald_tpu_torch.alphabet import decode, _LUT

_NL = ord("\n")
_GT = ord(">")


def parse_fasta_bytes(data: bytes, titles: str | None = "list"):
    """Parse FASTA content. Returns (titles, seqs, lengths).

    titles:  with titles="list" (default), list[str] header lines without
             '>' (full line, like the reference's .desc titles); with
             titles="bytes", a (joined: bytes, lens: int64 ndarray) pair —
             every title's raw bytes followed by one b"\\n", built without
             any per-record Python loop (the bulk-preprocess path); with
             titles=None, None (skips title work entirely)
    seqs:    int8 ndarray       all residues encoded 0..23, concatenated
    lengths: int64 ndarray      per-record residue counts (offsets = cumsum)

    Whitespace inside sequence lines ('\\r', ' ', '\\t') is dropped; any other
    byte is encoded (unknown residues become the dummy code).
    """
    buf = np.frombuffer(data, dtype=np.uint8)
    if buf.size == 0:
        empty = {"list": [], "bytes": (b"", np.zeros(0, np.int64)),
                 None: None}[titles]
        return empty, np.zeros(0, np.int8), np.zeros(0, np.int64)
    if buf[-1] != _NL:
        buf = np.concatenate([buf, np.array([_NL], np.uint8)])

    nl_pos = np.flatnonzero(buf == _NL)
    line_starts = np.concatenate([[0], nl_pos[:-1] + 1]).astype(np.int64)
    line_ends = nl_pos.astype(np.int64)                  # exclusive of '\n'
    is_header = buf[line_starts] == _GT
    n_rec = int(is_header.sum())
    if n_rec == 0:
        raise ValueError("not a FASTA file: no '>' header lines found")

    # record id of every line: lines before the first header belong to no
    # record and are rejected
    rec_of_line = np.cumsum(is_header) - 1
    if rec_of_line[0] < 0:
        raise ValueError("FASTA content before first '>' header")

    hdr_idx = np.flatnonzero(is_header)
    hs = line_starts[hdr_idx] + 1
    he = line_ends[hdr_idx]
    while True:                                   # strip ALL trailing \r
        m = (he > hs) & (buf[np.maximum(he - 1, 0)] == 13)
        if not m.any():
            break
        he = he - m
    if titles == "list":
        out_titles = [bytes(buf[s:e]).decode("utf-8", errors="replace")
                      for s, e in zip(hs, he)]
    elif titles == "bytes":
        tlens = he - hs
        joined = np.full(int(tlens.sum()) + n_rec, _NL, np.uint8)
        dst = np.repeat(np.cumsum(tlens + 1) - (tlens + 1), tlens) \
            + _ragged_arange(tlens)
        src = np.repeat(hs, tlens) + _ragged_arange(tlens)
        joined[dst] = buf[src]
        out_titles = (joined.tobytes(), tlens)
    else:
        out_titles = None

    # residue bytes: all bytes of non-header lines, minus whitespace
    seq_line = ~is_header
    line_lens = line_ends - line_starts
    # per-byte record id for sequence-line bytes
    sel_lines = np.flatnonzero(seq_line)
    if sel_lines.size:
        starts = line_starts[sel_lines]
        lens = line_lens[sel_lines]
        # positions of all sequence-line bytes
        byte_pos = np.repeat(starts, lens) + _ragged_arange(lens)
        byte_rec = np.repeat(rec_of_line[sel_lines], lens)
        raw = buf[byte_pos]
        keep = (raw != 13) & (raw != 32) & (raw != 9)    # \r, space, tab
        raw = raw[keep]
        byte_rec = byte_rec[keep]
        seqs = _LUT[raw]
        lengths = np.bincount(byte_rec, minlength=n_rec).astype(np.int64)
    else:
        seqs = np.zeros(0, np.int8)
        lengths = np.zeros(n_rec, np.int64)
    return out_titles, seqs, lengths


def _ragged_arange(lens):
    """[0..l0), [0..l1), ... concatenated."""
    total = int(lens.sum())
    out = np.arange(total, dtype=np.int64)
    offs = np.repeat(np.cumsum(lens) - lens, lens)
    return out - offs


# compressed-input sniffing: real protein databases ship compressed
# (uniprot_sprot.fasta.gz et al.).  Detection is by magic bytes, not
# extension, so renamed files still work.
_MAGICS = (
    (b"\x1f\x8b", "gzip"),
    (b"BZh", "bz2"),
    (b"\xfd7zXZ\x00", "lzma"),
)


def open_maybe_compressed(path: str):
    """Open a file for binary reading, transparently decompressing
    gzip/bzip2/xz by magic-byte sniffing.  Returns a binary file object
    (supports read/readinto)."""
    f = open(path, "rb")
    try:
        head = f.read(6)
        f.seek(0)
    except OSError:
        return f                      # unseekable: treat as plain
    for magic, mod in _MAGICS:
        if head.startswith(magic):
            f.close()
            if mod == "gzip":
                import gzip
                return gzip.open(path, "rb")
            if mod == "bz2":
                import bz2
                return bz2.open(path, "rb")
            import lzma
            return lzma.open(path, "rb")
    return f


def parse_fasta(path: str, use_native: bool | None = None):
    """Parse a FASTA file; see parse_fasta_bytes.

    Uses the native C++ scanner (oswald_tpu_torch.io.native) when its
    library is available, unless use_native=False or OSWALD_NO_NATIVE is
    set.  Compressed input (gzip/bzip2/xz) is decompressed transparently.
    """
    import os
    with open_maybe_compressed(path) as f:
        data = f.read()
    if use_native is None:
        use_native = not os.environ.get("OSWALD_NO_NATIVE")
    if use_native:
        from oswald_tpu_torch.io import native
        if native.available():
            return native.parse_fasta_bytes(data)
    return parse_fasta_bytes(data)


def write_fasta(path: str, titles, seqs, width: int = 60):
    """Write encoded sequences back to FASTA (testing/round-trip helper)."""
    with open(path, "w") as f:
        for t, s in zip(titles, seqs):
            f.write(f">{t}\n")
            txt = decode(np.asarray(s))
            for i in range(0, max(len(txt), 1), width):
                f.write(txt[i:i + width] + "\n")
