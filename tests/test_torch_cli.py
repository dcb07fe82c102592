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

import numpy as np
import pytest
import torch

from oswald_tpu.alphabet import ALPHABET
from oswald_tpu.cli import main as jax_main
from oswald_tpu_torch.cli import main

from conftest import random_protein


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain scorer's tensors are small: one thread is fastest, and the
    test workers do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("flags,name", [
    (["--align"], "--align"),
    (["--tab"], "--tab"),
    (["-H"], "-H/--histogram"),
    (["--trace", "tr"], "--trace"),
    (["--distributed"], "--distributed"),
    (["--devices", "2"], "--devices > 1"),
])
def test_unported_flags_exit_2(fasta_db, capsys, flags, name):
    assert main(["search", "-q", str(fasta_db / "q.fasta"),
                 "-d", str(fasta_db / "db"), "--device", "cpu",
                 *flags]) == 2
    err = capsys.readouterr().err
    assert err.startswith(f"oswald-tpu-torch: error: {name} is not yet "
                          "ported")


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
