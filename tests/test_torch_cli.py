"""The port's CLI against oswald_tpu's on a tiny FASTA database.

`oswald-tpu-torch search --json --device cpu` must report the same hits as
`oswald_tpu.cli search --json`, batched (a multi-query FASTA runs as packed
launches on both sides) and with `--no-batch` (the per-query path).  Hits
must be equal.  The queries are cut from database
sequences, so their top hits score far above the rest, and there the one
float32 ulp by which the two sides' sum(S * lnL) moments can differ (each
reduces in its own order) moves lambda by about 1e-6 relative and
ln(E) = ln(K m n) - lambda S by up to 3e-4 (E = 1.4e-32 here): E-values
are compared as ln(E) at rtol 1e-5, atol 1e-4, not as E at the 1e-5 of
test_torch_engine.py.  Bit scores are rounded to 0.1 in the JSON, so they
may differ by that step.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from oswald_tpu.alphabet import ALPHABET
from oswald_tpu.cli import main as jax_main
from oswald_tpu_torch.cli import main

from conftest import random_protein

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain scorer's tensors are small: one thread is fastest, and the
    test workers do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def own_kernel_cache(tmp_path, monkeypatch):
    """Every CLI run enables a kernel cache directory: keep it under the
    test's own tmp_path, and the process-wide choice, and the blocks per SM
    a flag may set, as they were."""
    from oswald_tpu_torch.kernels import build
    from oswald_tpu_torch.utils import compile_cache
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    monkeypatch.delenv("OSWALD_TPU_TORCH_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    monkeypatch.setattr(build, "BLOCKS_PER_SM", build.BLOCKS_PER_SM)


@pytest.fixture(scope="module")
def fasta_db(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(21)
    seqs = [random_protein(rng, int(l))
            for l in rng.integers(5, 120, size=80)]
    with open(tmp / "db.fasta", "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">dbseq{i} test protein {i}\n")
            body = "".join(ALPHABET[c] for c in s)
            for j in range(0, len(body), 60):
                f.write(body[j:j + 60] + "\n")
    with open(tmp / "q.fasta", "w") as f:
        f.write(">qa\n" + "".join(ALPHABET[c] for c in seqs[7][:40]) + "\n")
        f.write(">qb\n" + "".join(ALPHABET[c] for c in seqs[30][5:60])
                + "\n")
    assert jax_main(["preprocess", "-i", str(tmp / "db.fasta"),
                     "-o", str(tmp / "db")]) == 0
    return tmp


def _json_lines(out):
    lines = [json.loads(line) for line in out.strip().splitlines()]
    return lines[:-1], lines[-1]["summary"]


def test_search_json_matches_jax_cli(fasta_db, capsys):
    args = ["search", "-q", str(fasta_db / "q.fasta"),
            "-d", str(fasta_db / "db"), "-r", "6", "--json"]
    assert jax_main(args + ["--no-batch", "--devices", "1",
                            "--no-compile-cache"]) == 0
    want, _ = _json_lines(capsys.readouterr().out)
    assert main(args + ["--device", "cpu"]) == 0
    got, summary = _json_lines(capsys.readouterr().out)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert (g["query"], g["length"]) == (w["query"], w["length"])
        assert [(h["score"], h["id"], h["title"]) for h in g["hits"]] == \
            [(h["score"], h["id"], h["title"]) for h in w["hits"]]
        np.testing.assert_allclose(np.log([h["evalue"] for h in g["hits"]]),
                                   np.log([h["evalue"] for h in w["hits"]]),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose([h["bits"] for h in g["hits"]],
                                   [h["bits"] for h in w["hits"]],
                                   atol=0.1 + 1e-9)
    assert got[0]["hits"][0]["title"].startswith("dbseq7 ")
    assert summary["n_queries"] == 2 and summary["devices"] == 1
    assert summary["db_seqs"] == 80


def test_search_text_report(fasta_db, capsys):
    assert main(["search", "-q", str(fasta_db / "q.fasta"),
                 "-d", str(fasta_db / "db"), "-r", "3", "--device", "cpu",
                 "--metrics"]) == 0
    out = capsys.readouterr().out
    assert "Query description: \t\tqa" in out
    assert "Score\tBits\tE-value" in out
    assert "Search speed:" in out and "GCUPS" in out
    assert "Devices:\t\t\t1 (cpu: cpu)" in out
    assert "engine_setup" in out and "search" in out


def test_search_metrics_report_cluster_launches(fasta_db, capsys,
                                               monkeypatch):
    """--metrics reports the search's engine kernel launches, the share of
    them that ran thread-block clusters and the slabs they split: the
    counters' growth over the search alone."""
    from oswald_tpu_torch.engine import SearchEngine
    from oswald_tpu_torch.kernels import sw_lanes
    real = SearchEngine.search_many

    def counted(self, *a, **kw):
        sw_lanes.launches += 3
        sw_lanes.cluster_launches += 2
        sw_lanes.split_slabs += 64
        return real(self, *a, **kw)

    monkeypatch.setattr(SearchEngine, "search_many", counted)
    args = ["search", "-q", str(fasta_db / "q.fasta"), "-d",
            str(fasta_db / "db"), "--device", "cpu", "--metrics"]
    assert main(args + ["--json"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["launches"] == {"kernels": 3, "cluster": 2,
                                "split_slabs": 64}
    assert main(args) == 0
    assert "Kernel launches:\t\t3 (2 in thread-block clusters, 66.7%; " \
        "64 slabs split)" in capsys.readouterr().out


@pytest.mark.parametrize("verb,flags,name", [
    ("search", ["--distributed"], "--distributed"),
    ("search", ["--devices", "2"], "--devices > 1"),
    ("serve", ["--distributed"], "--distributed"),
])
def test_unported_flags_exit_2(fasta_db, capsys, monkeypatch, tmp_path, verb,
                               flags, name):
    """These flags exited 2 until the distributed engine was ported (the
    name is kept for the record); now they run.  `--distributed` outside
    torchrun is a world of one rank: `search` prints the single-rank hits,
    `serve` builds the single engine, and a --devices the process group
    contradicts still exits 2.  `search --devices 2` starts two CPU ranks
    (in a subprocess with its own timeout) whose rank 0 prints the hits of
    --devices 1: hits exact, E-values as ln(E) at the tolerance of the
    module docstring (the two ranks sum their moments exactly; the single
    engine's float32 sum(S * lnL) differs from that by its rounding)."""
    args = ["-d", str(fasta_db / "db"), "--device", "cpu", "-r", "5"]
    query = ["-q", str(fasta_db / "q.fasta"), "--json"]
    if verb == "serve":
        from oswald_tpu_torch import serve
        got = {}
        monkeypatch.setattr(serve, "serve_forever",
                            lambda db, engine, *a, **k: got.update(e=engine) or 0)
        assert main(["serve", *args, "--port", "0", *flags]) == 0
        assert type(got["e"]).__name__ == "SearchEngine"
        return
    assert main(["search", *query, *args]) == 0
    want, _ = _json_lines(capsys.readouterr().out)
    if name == "--distributed":
        assert main(["search", *query, *args, *flags]) == 0
        got, summary = _json_lines(capsys.readouterr().out)
        assert got == want and summary["devices"] == 1
        assert main(["search", *query, *args, *flags, "--devices", "3"]) == 2
        assert "the process group has 1 ranks" in capsys.readouterr().err
        return
    env = dict(os.environ, OMP_NUM_THREADS="1",
               XDG_CACHE_HOME=str(tmp_path / "xdg"))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run(
        [sys.executable, "-m", "oswald_tpu_torch.cli", "search", *query,
         *args, *flags], env=env, cwd=tmp_path, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got, summary = _json_lines(out.stdout)
    assert summary["devices"] == 2 and len(got) == len(want)
    for g, w in zip(got, want):
        assert [(h["score"], h["id"], h["title"]) for h in g["hits"]] == \
            [(h["score"], h["id"], h["title"]) for h in w["hits"]]
        np.testing.assert_allclose(np.log([h["evalue"] for h in g["hits"]]),
                                   np.log([h["evalue"] for h in w["hits"]]),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("flags,msg", [
    (["-s", "blosum63"], "unknown substitution matrix"),
    (["-g", "300"], "open_gap"),
    (["--device", "cuda"], "CUDA is not available"),
    (["--device", "nonsense"], "bad --device"),
])
def test_bad_input_exit_2(fasta_db, capsys, monkeypatch, flags, msg):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["search", "-q", str(fasta_db / "q.fasta"),
                 "-d", str(fasta_db / "db"), "--device", "cpu",
                 *flags]) == 2
    err = capsys.readouterr().err
    assert err.startswith("oswald-tpu-torch: error:") and msg in err


def test_missing_files_exit_2(tmp_path, capsys):
    assert main(["search", "-q", str(tmp_path / "none.fasta"),
                 "-d", str(tmp_path / "db"), "--device", "cpu"]) == 2
    assert "oswald-tpu-torch: error:" in capsys.readouterr().err


def test_info(capsys):
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"PyTorch {torch.__version__}")
    assert "Devices (" in out
    assert "Rank 0 of 1" in out


def _hits(lines):
    return [[(h["score"], h["id"], h["title"]) for h in q["hits"]]
            for q in lines]


def test_multi_query_batched_matches_jax_cli(fasta_db, capsys):
    """The default (batched) path of both CLIs on a multi-query FASTA, and
    the port's --no-batch path: the same hits, statistics at the module's
    tolerance."""
    args = ["search", "-q", str(fasta_db / "q.fasta"),
            "-d", str(fasta_db / "db"), "-r", "6", "--json"]
    assert jax_main(args + ["--devices", "1", "--no-compile-cache"]) == 0
    want, _ = _json_lines(capsys.readouterr().out)
    assert main(args + ["--device", "cpu", "--metrics"]) == 0
    lines = [json.loads(line)
             for line in capsys.readouterr().out.strip().splitlines()]
    got, summary, metrics = lines[:-2], lines[-2]["summary"], lines[-1]
    assert metrics["metrics"]["search_batch"]["count"] == 1
    assert "search" not in metrics["metrics"]
    assert main(args + ["--device", "cpu", "--no-batch", "--stream-window",
                        "1", "--metrics"]) == 0
    lines = [json.loads(line)
             for line in capsys.readouterr().out.strip().splitlines()]
    unbatched, metrics = lines[:-2], lines[-1]
    assert metrics["metrics"]["search"]["count"] == 2
    assert "search_batch" not in metrics["metrics"]
    assert len(got) == len(want) == 2 and summary["n_queries"] == 2
    assert _hits(got) == _hits(want) == _hits(unbatched)
    for g, w, u in zip(got, want, unbatched):
        assert (g["query"], g["length"]) == (w["query"], w["length"])
        for other in (w, u):
            np.testing.assert_allclose(
                np.log([h["evalue"] for h in g["hits"]]),
                np.log([h["evalue"] for h in other["hits"]]),
                rtol=1e-5, atol=1e-4)
            np.testing.assert_allclose([h["bits"] for h in g["hits"]],
                                       [h["bits"] for h in other["hits"]],
                                       atol=0.1 + 1e-9)


def test_search_on_database_packed_by_the_port(fasta_db, tmp_path, capsys):
    """A database written by oswald_tpu_torch.io.preprocess_db gives the
    hits of the one written by the JAX CLI."""
    from oswald_tpu_torch.io import preprocess_db
    preprocess_db(str(fasta_db / "db.fasta"), str(tmp_path / "own"),
                  verbose=False)
    out = []
    for path in (fasta_db / "db", tmp_path / "own"):
        assert main(["search", "-q", str(fasta_db / "q.fasta"), "-d",
                     str(path), "-r", "4", "--json", "--device", "cpu"]) == 0
        out.append(_json_lines(capsys.readouterr().out)[0])
    assert _hits(out[0]) == _hits(out[1])


def test_help_describes_batching(capsys):
    with pytest.raises(SystemExit):
        main(["search", "--help"])
    out = " ".join(capsys.readouterr().out.split())
    assert "--no-batch" in out and "--stream-window" in out
    assert "the port always does" not in out
    assert "instead of packing them into batched launches" in out


@pytest.mark.parametrize("flags,mode", [
    (["--profile-mode", "host_stream"], None),
    (["--profile-mode", "stream"], None),
    (["--profile-mode", "precompute"], None),
    (["--hbm-budget-mb", "1"], "host_stream"),
    (["--hbm-budget-mb", "100000"], "precompute"),
    ([], "precompute"),
])
def test_profile_modes_report_the_same_hits(fasta_db, capsys, flags, mode):
    """Every profile mode prints the default mode's hits; `auto` (the
    default) announces its plan on stderr and leaves the JSON on stdout
    clean, and --hbm-budget-mb moves that plan.  An explicit mode asks no
    planner."""
    args = ["search", "-q", str(fasta_db / "q.fasta"),
            "-d", str(fasta_db / "db"), "-r", "6", "--json", "--device",
            "cpu"]
    assert main(args + ["--profile-mode", "precompute"]) == 0
    want, _ = _json_lines(capsys.readouterr().out)
    assert main(args + flags) == 0
    cap = capsys.readouterr()
    got, summary = _json_lines(cap.out)
    assert _hits(got) == _hits(want)
    assert summary["n_queries"] == 2
    for g, w in zip(got, want):
        # host moments in float64 against float32 ones
        np.testing.assert_allclose(
            np.log([h["evalue"] for h in g["hits"]]),
            np.log([h["evalue"] for h in w["hits"]]), rtol=1e-5, atol=1e-4)
    if mode is None:
        assert cap.err == ""
    else:
        assert cap.err.startswith(
            f"oswald-tpu-torch engine: profile_mode={mode} (planner:")


def test_host_stream_text_report_and_no_batch(fasta_db, capsys):
    """The text report under host_stream equals the default mode's, hit
    table for hit table, batched and one by one."""
    args = ["search", "-q", str(fasta_db / "q.fasta"),
            "-d", str(fasta_db / "db"), "-r", "4", "--device", "cpu"]

    def tables(extra):
        assert main(args + extra) == 0
        out = capsys.readouterr().out
        return [line for line in out.splitlines()
                if line[:1].isdigit() and "\t" in line]

    want = tables(["--profile-mode", "precompute"])
    assert len(want) == 8
    assert tables(["--profile-mode", "host_stream"]) == want
    assert tables(["--profile-mode", "host_stream", "--no-batch"]) == want


def test_help_describes_memory_modes(capsys):
    with pytest.raises(SystemExit):
        main(["search", "--help"])
    out = " ".join(capsys.readouterr().out.split())
    assert "host_stream keeps it on the host" in out
    assert "that --profile-mode auto plans for" in out
    assert "host_stream is not yet ported" not in out
    assert "no memory planner" not in out


def _search_args(fasta_db, *extra):
    return ["search", "-q", str(fasta_db / "q.fasta"),
            "-d", str(fasta_db / "db"), "-r", "4", *extra]


def _jax_and_port(fasta_db, capsys, *extra):
    """(JAX CLI stdout, port CLI stdout) of the same search."""
    assert jax_main(_search_args(fasta_db, *extra) +
                    ["--devices", "1", "--no-compile-cache"]) == 0
    want = capsys.readouterr().out
    assert main(_search_args(fasta_db, *extra) + ["--device", "cpu"]) == 0
    return want, capsys.readouterr().out


def test_tab_matches_jax_cli(fasta_db, capsys):
    """--tab prints the JAX CLI's BLAST outfmt-6 lines: every field equal,
    the E-value and bit score at the module's tolerance."""
    want, got = _jax_and_port(fasta_db, capsys, "--tab")
    want = [line.split("\t") for line in want.strip().splitlines()]
    got = [line.split("\t") for line in got.strip().splitlines()]
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert len(g) == 12 and g[:10] == w[:10]
        np.testing.assert_allclose(np.log(float(g[10])),
                                   np.log(float(w[10])), rtol=1e-5,
                                   atol=1e-4 + 0.05)
        assert abs(float(g[11]) - float(w[11])) <= 0.1 + 1e-9
    assert got[0][:2] == ["qa", "dbseq7"] and float(got[0][2]) == 100.0


def test_json_align_matches_jax_cli(fasta_db, capsys):
    want, got = _jax_and_port(fasta_db, capsys, "--json", "--align")
    want, _ = _json_lines(want)
    got, _ = _json_lines(got)
    assert _hits(got) == _hits(want)
    for g, w in zip(got, want):
        assert [h["alignment"] for h in g["hits"]] == \
            [h["alignment"] for h in w["hits"]]
        np.testing.assert_allclose(np.log([h["evalue"] for h in g["hits"]]),
                                   np.log([h["evalue"] for h in w["hits"]]),
                                   rtol=1e-5, atol=1e-4)
    top = got[0]["hits"][0]["alignment"]
    assert top["identities"] == got[0]["length"]
    assert top["q_aln"] == top["s_aln"]


def _blocks(out, start):
    """The lines of each block that begins with a line starting `start`,
    up to the next blank line."""
    blocks, cur = [], None
    for line in out.splitlines():
        if line.startswith(start):
            cur = [line]
            blocks.append(cur)
        elif cur is not None:
            if not line.strip():
                cur = None
            else:
                cur.append(line)
    return blocks


def test_align_text_matches_jax_cli(fasta_db, capsys):
    """--align prints the JAX CLI's alignment blocks, character for
    character, after the same hit tables."""
    want, got = _jax_and_port(fasta_db, capsys, "--align")
    assert _blocks(got, "> ") == _blocks(want, "> ")
    assert got.count("Identities:") == 8
    assert "> dbseq7 test protein 7" in got


def test_histogram_matches_jax_cli(fasta_db, capsys):
    """-H prints the JAX CLI's histogram per query: the same buckets and
    observed counts, expected counts within one printed step."""
    want, got = _jax_and_port(fasta_db, capsys, "-H")
    gh, wh = _blocks(got, " score  obs"), _blocks(want, " score  obs")
    assert len(gh) == len(wh) == 2
    for g, w in zip(gh, wh):
        assert len(g) == len(w)
        for gl, wl in zip(g[1:-1], w[1:-1]):
            assert gl.split()[:2] == wl.split()[:2]
            assert abs(float(gl.split()[2]) - float(wl.split()[2])) <= \
                0.1 + 1e-9
        assert g[-1].split()[:3] == w[-1].split()[:3]      # obs N seqs


def test_trace_writes_chrome_trace(fasta_db, tmp_path, capsys):
    """--trace DIR leaves a Chrome trace in DIR (created) and the report
    unchanged."""
    def table(extra):
        assert main(_search_args(fasta_db, "--device", "cpu", *extra)) == 0
        return [line for line in capsys.readouterr().out.splitlines()
                if line[:1].isdigit() and "\t" in line]

    want = table([])
    trace = tmp_path / "trace" / "here"
    assert table(["--trace", str(trace)]) == want
    files = list(trace.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_geometry_flags_reach_build_and_engine(fasta_db, capsys,
                                               monkeypatch):
    """--blocks-per-sm sets the build's blocks per SM before any library
    loads, --long-from the engine's work tables; the hits do not move."""
    from oswald_tpu_torch.engine import search
    from oswald_tpu_torch.kernels import build
    seen = []
    real = search.SearchEngine.__init__

    def spy(self, *a, **k):
        real(self, *a, **k)
        seen.append((build.BLOCKS_PER_SM, self.long_from))

    monkeypatch.setattr(search.SearchEngine, "__init__", spy)
    want = _search_args(fasta_db, "--json", "--device", "cpu")
    assert main(want) == 0
    default = _hits(_json_lines(capsys.readouterr().out)[0])
    assert main(want + ["--blocks-per-sm", "3", "--long-from", "64"]) == 0
    assert _hits(_json_lines(capsys.readouterr().out)[0]) == default
    assert seen == [(4, None), (3, 64)]
    for bad in (["--blocks-per-sm", "0"], ["--long-from", "-1"]):
        assert main(want + bad) == 2
        assert capsys.readouterr().err.startswith("oswald-tpu-torch: error:")


def test_compile_cache_flags(fasta_db, tmp_path, capsys):
    """--compile-cache DIR points the kernel build at DIR;
    --no-compile-cache at a temporary directory of the process."""
    from oswald_tpu_torch.kernels import build
    from oswald_tpu_torch.utils import compile_cache
    args = _search_args(fasta_db, "--json", "--device", "cpu")
    assert main(args + ["--compile-cache", str(tmp_path / "kc")]) == 0
    assert build.build_dir() == tmp_path / "kc" and (tmp_path / "kc").is_dir()
    assert main(args + ["--no-compile-cache"]) == 0
    assert build.build_dir() == Path(compile_cache._temp_dir)
    assert main(args) == 0
    assert build.build_dir() == tmp_path / "xdg" / "oswald-tpu-torch" / \
        "kernels"


def test_cache_pack_unpack_info(tmp_path, capsys):
    """`cache pack` archives a kernel directory into one tarball and `cache
    unpack` pre-seeds a fresh one from it; existing entries are kept unless
    --overwrite (tests/test_cli.py's cache test, for kernel libraries)."""
    src = tmp_path / "cache"
    (src / "sub").mkdir(parents=True)
    (src / "a.so").write_bytes(b"AAAA")
    (src / "sub" / "b.so").write_bytes(b"BB")
    tar = str(tmp_path / "warm.tar.gz")
    assert main(["cache", "pack", tar, "--compile-cache", str(src)]) == 0
    assert "packed 2 kernel libraries" in capsys.readouterr().out
    dst = tmp_path / "fresh"
    assert main(["cache", "unpack", tar, "--compile-cache", str(dst)]) == 0
    assert (dst / "a.so").read_bytes() == b"AAAA"
    assert (dst / "sub" / "b.so").read_bytes() == b"BB"
    assert "unpacked 2 kernel libraries" in capsys.readouterr().out
    (dst / "a.so").write_bytes(b"kept")
    assert main(["cache", "unpack", tar, "--compile-cache", str(dst)]) == 0
    assert "(2 already present)" in capsys.readouterr().out
    assert (dst / "a.so").read_bytes() == b"kept"
    assert main(["cache", "unpack", tar, "--compile-cache", str(dst),
                 "--overwrite"]) == 0
    assert (dst / "a.so").read_bytes() == b"AAAA"
    assert not list(dst.rglob("*.part"))
    capsys.readouterr()
    assert main(["cache", "info", "--compile-cache", str(dst)]) == 0
    assert "2 kernel libraries" in capsys.readouterr().out
    assert main(["cache", "pack", "--compile-cache", str(src)]) == 2
    assert main(["cache", "pack", tar,
                 "--compile-cache", str(tmp_path / "nope")]) == 2
    assert main(["info"]) == 0
    assert "Kernel cache:\t" in capsys.readouterr().out


def test_cache_unpack_rejects_path_escape(tmp_path):
    """A cache tarball with ../ members is refused, not written outside the
    directory."""
    import io
    import tarfile
    from oswald_tpu_torch.utils.compile_cache import unpack_cache
    tar = tmp_path / "evil.tar.gz"
    with tarfile.open(tar, "w:gz") as tf:
        data = b"pwned"
        info = tarfile.TarInfo("../escape.so")
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))
    with pytest.raises(ValueError, match="unsafe path"):
        unpack_cache(str(tar), str(tmp_path / "cache"))
    assert not (tmp_path / "escape.so").exists()


def test_tune_parser_and_cli(capsys, monkeypatch):
    import oswald_tpu_torch.tune as tune
    from oswald_tpu_torch.cli.main import build_parser
    args = build_parser().parse_args(["tune"])
    assert (args.m, args.groups, args.chunks, args.iters, args.device) == \
        (512, 96, 32, 3, "cuda")
    monkeypatch.setattr(tune, "BLOCKS_PER_SM_AXIS", (4,))
    monkeypatch.setattr(tune, "LONG_FROM_AXIS", (1024,))
    assert main(["tune", "--m", "8", "--groups", "1", "--chunks", "1",
                 "--iters", "1", "--device", "cpu", "--no-compile-cache"]) \
        == 0
    out = capsys.readouterr()
    assert out.out.startswith("best geometry on cpu: --blocks-per-sm 4 "
                              "--long-from 1024 (")
    assert "tuning on cpu" in out.err
    assert main(["tune", "--m", "8", "--groups", "1", "--chunks", "1",
                 "--iters", "1", "--device", "cpu", "--json"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert set(res) == {"blocks_per_sm", "long_from", "gcells", "device",
                        "results"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["tune"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err


def test_autotune_tiny(monkeypatch):
    """The coordinate descent runs end to end on the CPU (narrowed axes,
    the plain version), measures the shipped geometry, restores the build's
    blocks per SM, and disqualifies a candidate whose checksum differs."""
    import oswald_tpu_torch.tune as tune
    from oswald_tpu_torch.kernels import build
    monkeypatch.setattr(tune, "BLOCKS_PER_SM_AXIS", (3, 4))
    monkeypatch.setattr(tune, "LONG_FROM_AXIS", (512, 1024))
    real = tune._measure
    seen = []

    def measure(w, bps, lf, iters):
        seen.append((bps, lf, build.BLOCKS_PER_SM))
        gc, checksum = real(w, bps, lf, iters)
        return gc, checksum + (bps == 3)          # 3 blocks: miscompiled

    monkeypatch.setattr(tune, "_measure", measure)
    lines = []
    out = tune.autotune(m=16, groups=2, chunks=2, iters=1, log=lines.append,
                        device="cpu")
    assert build.BLOCKS_PER_SM == 4
    assert [s[:2] for s in seen] == [(4, 1024), (3, 1024), (4, 512)]
    assert all(bps == current for bps, _, current in seen)
    by = {(r["blocks_per_sm"], r["long_from"]): r for r in out["results"]}
    assert by[3, 1024] == {"blocks_per_sm": 3, "long_from": 1024,
                           "gcells": 0.0, "error": "checksum"}
    assert "error" not in by[4, 1024] and by[4, 1024]["gcells"] > 0
    assert out["blocks_per_sm"] == 4 and out["device"] == "cpu"
    assert any("CHECKSUM MISMATCH" in line for line in lines)
    # a candidate that cannot launch scores 0 and is recorded; with no
    # candidate left the tune raises
    monkeypatch.setattr(tune, "_measure", lambda *a: 1 / 0)
    with pytest.raises(RuntimeError, match="no tuning candidate"):
        tune.autotune(m=16, groups=2, chunks=2, iters=1, device="cpu")


def test_autotune_refuses_a_workload_that_cannot_fill_the_card(monkeypatch):
    import oswald_tpu_torch.tune as tune
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="long_from would measure nothing"):
        tune.autotune(groups=65, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tune.autotune()


def test_serve_verb_builds_the_engine(fasta_db, capsys, monkeypatch):
    """`serve` builds the engine of `search` (the same flags) and hands it
    to serve_forever with the host, port and warmup flags."""
    from oswald_tpu_torch import serve
    got = {}

    def fake(db, engine, host, port, warmup_qlen, warmup_jobs):
        got.update(db=db, engine=engine, host=host, port=port,
                   warmup_qlen=warmup_qlen, warmup_jobs=warmup_jobs)
        return 0

    monkeypatch.setattr(serve, "serve_forever", fake)
    assert main(["serve", "-d", str(fasta_db / "db"), "--device", "cpu",
                 "-r", "3", "--port", "0", "--warmup-qlen", "0",
                 "--long-from", "256", "--profile-mode", "host_stream"]) == 0
    assert capsys.readouterr().out.startswith("engine ready in ")
    eng = got["engine"]
    assert (got["host"], got["port"], got["warmup_qlen"]) == \
        ("127.0.0.1", 0, None)
    assert eng.device.type == "cpu" and eng.config.top == 3
    assert eng.mode == "host_stream" and eng.long_from == 256
    assert got["db"].n_seqs == 80
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["serve", "-d", str(fasta_db / "db")]) == 2
    assert "CUDA is not available" in capsys.readouterr().err


def _oswt_equal(a, b):
    """Two .oswt artifacts, read by oswald_tpu.io.load_db: equal array by
    array."""
    from oswald_tpu.io import load_db as jax_load
    x, y = jax_load(str(a)), jax_load(str(b))
    assert (x.n_seqs, x.n_residues) == (y.n_seqs, y.n_residues)
    assert list(x.titles) == list(y.titles)
    assert x.bin_lengths == y.bin_lengths
    np.testing.assert_array_equal(x.lengths, y.lengths)
    for L in x.bin_lengths:
        for k in ("seq", "len", "id"):
            np.testing.assert_array_equal(np.asarray(x.bins[L][k]),
                                          np.asarray(y.bins[L][k]))


@pytest.mark.parametrize("flags", [[], ["--streaming"], ["--to-oswald"],
                                   ["--streaming", "--to-oswald"]])
def test_preprocess_verb_matches_jax_cli(fasta_db, tmp_path, capsys, flags):
    """`preprocess` writes the .oswt (and with --to-oswald the
    .desc/.info/.seq triple) that `python -m oswald_tpu.cli preprocess`
    writes from the same FASTA."""
    fa = str(fasta_db / "db.fasta")
    assert main(["preprocess", "-i", fa, "-o", str(tmp_path / "p"),
                 *flags]) == 0
    assert jax_main(["preprocess", "-i", fa, "-o", str(tmp_path / "j"),
                     *flags]) == 0
    out = capsys.readouterr().out
    assert "oswald-tpu-torch preprocess" in out
    _oswt_equal(tmp_path / "p", tmp_path / "j")
    if "--to-oswald" in flags:
        for ext in (".desc", ".info", ".seq"):
            assert (tmp_path / f"p{ext}").read_bytes() == \
                (tmp_path / f"j{ext}").read_bytes()


def test_preprocess_from_oswald_matches_jax_cli(fasta_db, tmp_path):
    """--from-oswald imports the triple as the JAX CLI does, and the round
    trip through --to-oswald gives the database back."""
    fa = str(fasta_db / "db.fasta")
    assert jax_main(["preprocess", "-i", fa, "-o", str(tmp_path / "src"),
                     "--to-oswald"]) == 0
    src = str(tmp_path / "src")
    assert main(["preprocess", "-i", src, "-o", str(tmp_path / "p"),
                 "--from-oswald"]) == 0
    assert jax_main(["preprocess", "-i", src, "-o", str(tmp_path / "j"),
                     "--from-oswald"]) == 0
    _oswt_equal(tmp_path / "p", tmp_path / "j")
    _oswt_equal(tmp_path / "p", tmp_path / "src")


def test_preprocess_compressed_and_bad_input(fasta_db, tmp_path, capsys):
    import gzip
    gz = tmp_path / "db.fasta.gz"
    gz.write_bytes(gzip.compress((fasta_db / "db.fasta").read_bytes()))
    assert main(["preprocess", "-i", str(gz), "-o", str(tmp_path / "g")]) \
        == 0
    _oswt_equal(tmp_path / "g", fasta_db / "db")
    bad = tmp_path / "bad.fasta"
    bad.write_bytes(b"no headers here\n")
    for flags in ([], ["--streaming"]):
        assert main(["preprocess", "-i", str(bad), "-o",
                     str(tmp_path / "b"), *flags]) == 2
        assert "oswald-tpu-torch: error:" in capsys.readouterr().err
    assert main(["preprocess", "-i", str(tmp_path / "none"), "-o",
                 str(tmp_path / "n"), "--from-oswald"]) == 2
