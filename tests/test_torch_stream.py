"""The port's out-of-core preprocess (oswald_tpu_torch.io.stream) against its
in-core `preprocess_db` and against oswald_tpu's streaming preprocess on the
same FASTA: every array of the artifact equal (exact), plain and
compressed, through tiny blocks and the forced spill path, on an empty file,
and invalid input refused with no staging file left behind."""

import bz2
import gzip
import lzma
import os

import numpy as np
import pytest

from oswald_tpu.io.stream import preprocess_db_streaming as jax_streaming
from oswald_tpu_torch.alphabet import ALPHABET
from oswald_tpu_torch.io import load_db, preprocess_db
from oswald_tpu_torch.io.stream import preprocess_db_streaming

from conftest import random_protein

COMPRESS = {"plain": lambda b: b, "gzip": gzip.compress,
            "bzip2": bz2.compress, "xz": lzma.compress}


@pytest.fixture(scope="module", autouse=True)
def own_kernel_cache(tmp_path_factory):
    """The native library builds into the kernel directory: keep it under
    this module's own temporary directory (one build for the module)."""
    from oswald_tpu_torch.io import native
    from oswald_tpu_torch.utils import compile_cache
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XDG_CACHE_HOME", str(tmp_path_factory.mktemp("xdg")))
        mp.delenv("OSWALD_TPU_TORCH_COMPILE_CACHE", raising=False)
        mp.setattr(compile_cache, "_enabled_dir", None)
        mp.setattr(native, "_lib", None)
        mp.setattr(native, "_build_attempted", False)
        yield


def _write_fasta(path, rng, n, lmax):
    with open(path, "w") as f:
        for i in range(n):
            body = "".join(ALPHABET[c] for c in
                           random_protein(rng, int(rng.integers(1, lmax))))
            f.write(f">rec{i} d{i}\n")
            for j in range(0, len(body), 57):
                f.write(body[j:j + 57] + "\n")


def assert_db_equal(got, want):
    assert (got.n_seqs, got.n_residues) == (want.n_seqs, want.n_residues)
    assert list(got.titles) == list(want.titles)
    assert got.bin_lengths == want.bin_lengths
    np.testing.assert_array_equal(np.asarray(got.lengths),
                                  np.asarray(want.lengths))
    for L in want.bin_lengths:
        for k in ("seq", "len", "id"):
            np.testing.assert_array_equal(
                np.asarray(got.bins[L][k]), np.asarray(want.bins[L][k]),
                err_msg=f"bin {L} {k}")


@pytest.mark.parametrize("kind,block,budget", [
    ("plain", 4096, None),          # many record-boundary splits
    ("plain", 1 << 20, 0),          # one block, forced spill
    ("gzip", 1 << 16, None),
    ("bzip2", 1 << 16, None),
    ("xz", 1 << 16, None),
    ("gzip", 4096, 0),              # tiny blocks and the spill path
])
def test_streaming_equals_in_core_and_reference(tmp_path, rng, kind, block,
                                                budget):
    plain = tmp_path / "in.fasta"
    _write_fasta(plain, rng, 900, 220)
    src = tmp_path / f"in.{kind}"
    src.write_bytes(COMPRESS[kind](plain.read_bytes()))
    got = preprocess_db_streaming(str(src), str(tmp_path / "s"),
                                  block_bytes=block, verbose=False,
                                  ram_budget_bytes=budget)
    assert_db_equal(got, preprocess_db(str(plain), str(tmp_path / "m"),
                                       verbose=False))
    assert_db_equal(load_db(str(tmp_path / "s")),
                    jax_streaming(str(src), str(tmp_path / "j"),
                                  block_bytes=block, verbose=False,
                                  ram_budget_bytes=budget))


def test_streaming_numpy_path_equals_native(tmp_path, rng, monkeypatch):
    p = tmp_path / "in.fasta"
    _write_fasta(p, rng, 1200, 200)
    native = preprocess_db_streaming(str(p), str(tmp_path / "n"),
                                     block_bytes=65536, verbose=False)
    monkeypatch.setenv("OSWALD_NO_NATIVE", "1")
    assert_db_equal(preprocess_db_streaming(str(p), str(tmp_path / "py"),
                                            block_bytes=65536,
                                            verbose=False), native)


def test_streaming_empty_file(tmp_path):
    empty = tmp_path / "empty.fasta"
    empty.write_bytes(b"")
    db = preprocess_db_streaming(str(empty), str(tmp_path / "e"),
                                 verbose=False)
    assert db.n_seqs == 0 and db.n_residues == 0
    ref = jax_streaming(str(empty), str(tmp_path / "je"), verbose=False)
    assert_db_equal(db, ref)


def test_streaming_invalid_input_raises_and_cleans_up(tmp_path):
    bad = tmp_path / "junk.bin"
    bad.write_bytes(b"\x00\x01not a fasta at all\njust bytes\n" * 100)
    out = tmp_path / "junkdb"
    with pytest.raises(ValueError):
        preprocess_db_streaming(str(bad), str(out), verbose=False)
    d = str(out) + ".oswt"
    left = [f for f in (os.listdir(d) if os.path.isdir(d) else [])
            if f.endswith(".tmp")]
    assert left == []
