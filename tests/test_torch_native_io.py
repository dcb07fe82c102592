"""The port's native I/O library (oswald_tpu_torch.io.native over the repo's
native/oswald_io.cpp) against the port's numpy path and oswald_tpu's native
library on the same inputs: parse and pack equal, array for array (exact).
The library builds into the port's kernel directory, never into native/."""

import numpy as np
import pytest

from oswald_tpu.io import native as jax_native
from oswald_tpu.io import fasta as jax_fasta
from oswald_tpu_torch.alphabet import ALPHABET
from oswald_tpu_torch.io import fasta, native, pack_sequences


@pytest.fixture(scope="module", autouse=True)
def own_kernel_cache(tmp_path_factory):
    """Build the library into this module's own kernel directory (once)."""
    from oswald_tpu_torch.utils import compile_cache
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XDG_CACHE_HOME", str(tmp_path_factory.mktemp("xdg")))
        mp.delenv("OSWALD_TPU_TORCH_COMPILE_CACHE", raising=False)
        mp.setattr(compile_cache, "_enabled_dir", None)
        mp.setattr(native, "_lib", None)
        mp.setattr(native, "_build_attempted", False)
        yield


def _random_fasta(rng, n, messy=False):
    parts = []
    for i in range(n):
        s = "".join(rng.choice(list(ALPHABET + "jouxz*"))
                    for _ in range(int(rng.integers(1, 200))))
        hdr = f">rec{i} some description {i}"
        body = "\n".join(s[j:j + 61] for j in range(0, len(s), 61))
        if messy and i % 3 == 0:
            hdr += "\r"
            body = body.replace("\n", "\r\n", 1) + " \t"
        parts.append(hdr + "\n" + body + "\n")
    return "".join(parts).encode()


def test_library_builds_into_the_kernel_directory():
    import os
    from oswald_tpu_torch.kernels.build import build_dir
    assert native.available()
    path = native.library_path()
    assert path.parent == build_dir() and path.is_file()
    assert str(path).startswith(os.environ["XDG_CACHE_HOME"])
    assert native.SOURCE.parent.name == "native"
    assert path.parent != native.SOURCE.parent


def test_parse_equals_numpy_and_reference(rng):
    data = _random_fasta(rng, 57, messy=True)
    want = fasta.parse_fasta_bytes(data)
    for got in (native.parse_fasta_bytes(data),
                jax_native.parse_fasta_bytes(data)
                if jax_native.available() else
                jax_fasta.parse_fasta_bytes(data)):
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    (joined, lens), seq, _ = native.parse_fasta_bytes(data, titles="bytes")
    assert joined.decode("utf-8", errors="replace").split("\n")[:-1] == \
        want[0]
    np.testing.assert_array_equal(seq, want[1])


@pytest.mark.parametrize("bad", [b"MKTA\n>late header\nACDE\n",
                                 b"no headers here\n"])
def test_parse_rejects_invalid_like_numpy(bad):
    with pytest.raises(ValueError):
        fasta.parse_fasta_bytes(bad)
    with pytest.raises(ValueError):
        native.parse_fasta_bytes(bad)


def test_parse_fasta_file_native_and_numpy(tmp_path, rng):
    p = tmp_path / "x.fasta"
    p.write_bytes(_random_fasta(rng, 30))
    a = fasta.parse_fasta(str(p))
    b = fasta.parse_fasta(str(p), use_native=False)
    c = jax_fasta.parse_fasta(str(p), use_native=False)
    for x in (b, c):
        assert a[0] == x[0]
        np.testing.assert_array_equal(a[1], x[1])
        np.testing.assert_array_equal(a[2], x[2])


def test_pack_native_equals_numpy_and_reference(rng, monkeypatch):
    from oswald_tpu.io import pack_sequences as jax_pack
    lengths = rng.integers(1, 300, size=2500)
    flat = rng.integers(0, 23, size=int(lengths.sum())).astype(np.int8)
    got = pack_sequences(flat, lengths, None)
    want = jax_pack(flat, lengths, None)
    monkeypatch.setenv("OSWALD_NO_NATIVE", "1")
    numpy_path = pack_sequences(flat, lengths, None)
    for other in (numpy_path, want):
        assert got.bin_lengths == other.bin_lengths
        for L in got.bin_lengths:
            for k in ("seq", "len", "id"):
                np.testing.assert_array_equal(got.bins[L][k],
                                              other.bins[L][k])


def test_pack_groups_sl_equals_offsets_pack(rng):
    n = 2100
    lengths = rng.integers(1, 120, size=n).astype(np.int64)
    flat = rng.integers(0, 23, size=int(lengths.sum())).astype(np.int8)
    starts = np.concatenate([[0], np.cumsum(lengths)])
    order = rng.permutation(n)
    perm_flat = np.concatenate([flat[starts[k]:starts[k + 1]]
                                for k in order])
    perm_offs = np.concatenate([[0], np.cumsum(lengths[order])])
    group_starts = np.array([0, 1024, 2048, n], np.int64)
    Ls = np.array([128, 192, 128], np.int64)
    want = native.pack_groups(perm_flat, perm_offs, group_starts, Ls)
    got = native.pack_groups_sl(flat, starts[order], lengths[order],
                                group_starts, Ls)
    off = 0
    for w, L in zip(want, Ls):
        np.testing.assert_array_equal(
            w, got[off:off + L * 1024].reshape(int(L), 1024))
        off += L * 1024
    with pytest.raises(ValueError, match="out must be"):
        native.pack_groups_sl(flat, starts[order], lengths[order],
                              group_starts, Ls, out=np.zeros(3, np.int8))


def test_a_compiler_without_openmp_falls_back_to_the_next(tmp_path,
                                                         monkeypatch):
    """$CXX first; when it fails (a toolchain without libgomp), the
    system's g++."""
    bad = tmp_path / "cxx"
    bad.write_text("#!/bin/sh\necho 'cannot read spec file libgomp.spec' >&2"
                   "\nexit 1\n")
    bad.chmod(0o755)
    monkeypatch.setenv("CXX", str(bad))
    assert native._compilers()[:2] == [str(bad), "g++"]
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "fresh-cache"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_attempted", False)
    assert native.available()
    assert "libgomp.spec" in native.build_log and "g++ -O3" in \
        native.build_log


def test_no_compiler_falls_back_to_numpy(tmp_path, rng, monkeypatch):
    """Without a compiler the library is unavailable and parsing and
    packing take the numpy path, with the same results."""
    monkeypatch.setattr(native, "_compilers",
                        lambda: [str(tmp_path / "no-such-compiler")])
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "empty-cache"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_attempted", False)
    assert not native.available()
    assert "no-such-compiler" in native.build_log
    data = _random_fasta(rng, 10)
    p = tmp_path / "y.fasta"
    p.write_bytes(data)
    got = fasta.parse_fasta(str(p))
    assert got[0] == fasta.parse_fasta_bytes(data)[0]
    with pytest.raises(RuntimeError, match="not available"):
        native.parse_fasta_bytes(data)


def test_preprocess_says_which_io_path_it_took(tmp_path, rng, capsys,
                                               monkeypatch):
    """The command's stderr names the path its scan and packing take: the
    library it loaded, or why it runs the numpy path."""
    from oswald_tpu_torch.cli.main import main
    fa = tmp_path / "db.fasta"
    fa.write_bytes(_random_fasta(rng, 20))
    assert main(["preprocess", "-i", str(fa), "-o", str(tmp_path / "a")]) \
        == 0
    assert f"native I/O on ({native.library_path()})" in \
        capsys.readouterr().err
    assert native.loaded_from == native.library_path()
    monkeypatch.setenv("OSWALD_NO_NATIVE", "1")
    assert main(["preprocess", "-i", str(fa), "-o", str(tmp_path / "b"),
                 "--streaming"]) == 0
    assert "native I/O off (OSWALD_NO_NATIVE)" in capsys.readouterr().err


def test_missing_source_turns_native_off_and_says_why(tmp_path, capsys,
                                                       monkeypatch):
    """Without the repository's source beside the package (an installed
    copy) the numpy path runs, and one stderr line says why."""
    monkeypatch.setattr(native, "SOURCE", tmp_path / "oswald_io.cpp")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_attempted", False)
    monkeypatch.setattr(native, "build_log", "")
    assert not native.available()
    assert "oswald_io.cpp is missing" in native.build_log
    assert "native I/O off" in capsys.readouterr().err
    assert not native.available()
    assert capsys.readouterr().err == ""           # said once
