"""oswald_tpu_torch stands alone: it must never load jax (the machine with
the GPU has none, and jax there could take device memory the port needs)
nor any module of oswald_tpu (the port keeps its own copy of what it needs
from that package)."""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = """
import sys
import numpy as np
import torch
import oswald_tpu_torch
from oswald_tpu_torch.engine import SearchEngine, SearchConfig, planner
from oswald_tpu_torch.io import to_device, pack_sequences, save_db, load_db
from oswald_tpu_torch.io import synth
from oswald_tpu_torch.io.device_db import to_host_stream
from oswald_tpu_torch.kernels import sw_groups, sw_groups_packed, build
from oswald_tpu_torch.kernels import sw_lab
from oswald_tpu_torch.cli import main
from oswald_tpu_torch import lab, stats
from oswald_tpu_torch.utils import Metrics, gcups, hostmem
from oswald_tpu_torch import serve, tune
from oswald_tpu_torch.engine import align
from oswald_tpu_torch.utils import compile_cache
rng = np.random.default_rng(0)
lengths = rng.integers(5, 60, size=200)
db = pack_sequences(rng.integers(0, 23, size=int(lengths.sum())).astype(
    np.int8), lengths, [f"s{i}" for i in range(200)])
engine = SearchEngine(db, SearchConfig(top=3, batch_query_pack_rows=64),
                      device="cpu")
res = engine.search(oswald_tpu_torch.encode("MKVLATGHW"))
assert len(res.scores) == 3 and res.evalues is not None
queries = [rng.integers(0, 23, size=n).astype(np.int8)
           for n in (9, 30, 100)]
many = engine.search_many(queries)
assert [r.batch_n for r in many] == [3, 3, 3]
assert engine.metrics.count("search_batch") == 1
assert len(engine.search_stream(queries)) == 3
hs = SearchEngine(db, SearchConfig(top=3, profile_mode="host_stream",
                                   host_stream_slice_mb=1,
                                   batch_query_pack_rows=64), device="cpu")
assert hs.mode == "host_stream"
assert [list(r.scores) for r in hs.search_many(queries)] == \
    [list(r.scores) for r in many]
auto = SearchEngine(db, SearchConfig(top=3, hbm_budget_bytes=1 << 16),
                    device="cpu")
assert auto.mode == "host_stream"
assert planner.plan_profile_mode(db).mode == "precompute"
st = engine.state
q3 = torch.tensor([1, 2, 3], dtype=torch.int32)
for v in sw_lab.VARIANTS:
    got = sw_lab.sw_groups_lab(st.residues, st.groups, q3,
                               engine.submat_dev, 10, 2, v)
    assert got.shape == (st.groups.shape[0], 8, 128)
service = serve.SearchService(db, engine)
out = service.search({"query": "MKVLATGHWCE", "align": True})
service.close()
assert out["results"][0]["hits"][0]["alignment"]["q_aln"]
import tempfile
from oswald_tpu_torch.dist import DistributedSearchEngine, bootstrap, shutdown
from oswald_tpu_torch.io import write_fasta, native
from oswald_tpu_torch.io.stream import preprocess_db_streaming
tmp = tempfile.mkdtemp()
assert bootstrap(f"file://{tmp}/store", 1, 0) == (0, 1)
dist = DistributedSearchEngine(db, SearchConfig(top=3), device="cpu")
assert list(dist.search(oswald_tpu_torch.encode("MKVLATGHW")).scores) == \
    list(res.scores)
shutdown()
write_fasta(tmp + "/in.fa", [f"s{i}" for i in range(50)], queries * 17)
assert main(["preprocess", "-i", tmp + "/in.fa", "-o", tmp + "/o",
             "--to-oswald"]) == 0
assert preprocess_db_streaming(tmp + "/in.fa", tmp + "/s").n_seqs == 50
assert native.available()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "oswald_tpu" or m.startswith("oswald_tpu."))
print("loaded:", bad[:5])
"""


def test_port_never_imports_jax(tmp_path):
    """CPU searches in every mode (resident, host_stream, auto through the
    planner), a batch, every lab variant, a served search with alignments,
    a distributed search at world size 1 and a preprocess (in-core with
    --to-oswald and streaming, the native library built) in a fresh
    interpreter load neither jax nor oswald_tpu."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               XDG_CACHE_HOME=str(tmp_path / "xdg"))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("loaded: []"), out.stdout


def _port_sources():
    files = sorted((REPO / "oswald_tpu_torch").rglob("*.py"))
    assert files
    return files + [REPO / "chip_smoke.py"]


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    for path in _port_sources():
        assert not pat.search(path.read_text()), path


def test_no_oswald_tpu_import_in_port_sources():
    pat = re.compile(r"^\s*(import\s+oswald_tpu(\s|\.|,|$)"
                     r"|from\s+oswald_tpu[\s.])", re.M)
    assert pat.search("from oswald_tpu.io import db")
    assert pat.search("    import oswald_tpu")
    assert not pat.search("from oswald_tpu_torch.io import db")
    for path in _port_sources():
        assert not pat.search(path.read_text()), path
