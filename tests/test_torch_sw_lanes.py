"""oswald_tpu_torch.kernels.sw_lanes against the JAX package.

The plain PyTorch scorer (`sw_groups_ref`, what `sw_groups` runs on a CPU
tensor) is held to the JAX bin scan `_search_bin_impl` over the Pallas
kernel in interpret mode, and to the numpy oracle; the packed scorer
(`sw_groups_packed_ref`) to the JAX packed bin scan
`_search_bin_stream_pack_impl` with uniform segments (`q_segs`) and with a
`mixed_pack_plan` layout (`seg_map`).  Tolerance: exact int32.  The CUDA
kernels themselves are checked on a card by tests/test_torch_gpu.py and, at
full size, by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oswald_tpu.alphabet import DUMMY
from oswald_tpu.core import sw_score_numpy
from oswald_tpu.engine.search import (_search_bin_impl,
                                      _search_bin_stream_pack_impl)
from oswald_tpu.engine.search import mixed_pack_plan as jax_mixed_pack_plan
from oswald_tpu.kernels import build_profile
from oswald_tpu.submat import MATRIX_NAMES, get_submat
from oswald_tpu_torch.engine.search import plan_segments
from oswald_tpu_torch.kernels import build, sw_lanes
from oswald_tpu_torch.kernels.sw_lanes import (sw_groups, sw_groups_packed,
                                               sw_groups_packed_ref,
                                               sw_groups_ref, sw_lanes_ref)

from conftest import random_protein


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain scorer's tensors are small: one thread is fastest, and the
    test workers do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_bin(rng, G, L):
    """int8[G, L, 8, 128] packed residues: random lengths 0..L per lane
    (some lanes empty), DUMMY after each subject's end."""
    res = rng.integers(0, 23, size=(G, L, 8, 128)).astype(np.int8)
    lens = rng.integers(0, L + 1, size=(G, 1, 8, 128))
    return np.where(np.arange(L)[None, :, None, None] < lens, res,
                    np.int8(DUMMY)).astype(np.int8)


def _jax_bin_scores(seq, query, sm, og, eg):
    """int32[G, 8, 128] from the JAX bin scan (sw_chunk in interpret mode,
    profiles from build_profile, noadj as the engine runs it)."""
    G, L = seq.shape[:2]
    m = len(query)
    q_pad = np.full(-(-m // 8) * 8, DUMMY, np.int32)
    q_pad[:m] = query
    C = L // 128
    prof = jnp.stack([build_profile(jnp.asarray(seq[:, c * 128:(c + 1) *
                                                    128]), sm)
                      for c in range(C)]) if C else \
        jnp.zeros((0, G, 24, 1024, 128), jnp.int8)
    tail = build_profile(jnp.asarray(seq[:, C * 128:]), sm) \
        if L % 128 else None
    return np.asarray(_search_bin_impl(
        jnp.asarray(q_pad), jnp.asarray([og, eg], jnp.int32), prof, 8,
        True, prof_tail=tail, noadj=True))


def _torch_args(bins, query, sm):
    """Flatten [(seq [G, L, 8, 128]), ...] into sw_groups' inputs."""
    cols, table, c0 = [], [], 0
    for seq in bins:
        G, L = seq.shape[:2]
        cols.append(seq.reshape(G * L, 8, 128))
        table += [(c0 + g * L, L) for g in range(G)]
        c0 += G * L
    return (torch.from_numpy(np.concatenate(cols)),
            torch.tensor(table, dtype=torch.int32),
            torch.from_numpy(np.asarray(query, np.int32)),
            torch.from_numpy(np.asarray(sm, np.int32)))


# every tail width (32, 96, 160 = 128 + 32, 224 = 128 + 96), query lengths
# 1, 9, 33 and 65 (one row, a partial strip, several strips), one or two
# groups, and three scoring settings, each L and m twice
BIN_CASES = [
    (32, 1, 1, "blosum62", 10, 2),
    (32, 65, 2, "pam30", 7, 1),
    (96, 9, 2, "blosum62", 0, 0),
    (96, 33, 1, "blosum62", 10, 2),
    (160, 33, 1, "pam30", 7, 1),
    (160, 1, 2, "blosum62", 0, 0),
    (224, 65, 2, "blosum62", 10, 2),
    (224, 9, 2, "pam30", 7, 1),
]


@pytest.mark.parametrize("L,m,G,matrix,og,eg", BIN_CASES)
def test_sw_groups_ref_matches_jax_bin(L, m, G, matrix, og, eg):
    rng = np.random.default_rng(L * 100 + m)
    seq = _random_bin(rng, G, L)
    query = random_protein(rng, m)
    sm = get_submat(matrix)
    want = _jax_bin_scores(seq, query, sm, og, eg)
    got = sw_groups_ref(*_torch_args([seq], query, sm), og, eg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


def test_sw_groups_cpu_runs_plain_version_over_mixed_bins():
    """A table mixing groups of several lengths: sw_groups on CPU tensors
    is the plain version (no launch counted), and each group scores as it
    does alone."""
    rng = np.random.default_rng(7)
    bins = [_random_bin(rng, G, L) for G, L in ((2, 32), (1, 96), (1, 32))]
    query = random_protein(rng, 20)
    sm = get_submat("blosum62")
    before = sw_lanes.launches
    got = sw_groups(*_torch_args(bins, query, sm), 10, 2)
    assert sw_lanes.launches == before
    alone = [sw_groups_ref(*_torch_args([b], query, sm), 10, 2)
             for b in bins]
    np.testing.assert_array_equal(got.numpy(),
                                  torch.cat(alone).numpy())


def test_sw_lanes_ref_matches_numpy_oracle():
    """50 random pairs under random matrices and gap penalties."""
    rng = np.random.default_rng(11)
    for _ in range(50):
        sm = get_submat(MATRIX_NAMES[int(rng.integers(len(MATRIX_NAMES)))])
        og, eg = int(rng.integers(0, 16)), int(rng.integers(0, 5))
        q = random_protein(rng, int(rng.integers(1, 40)))
        s = random_protein(rng, int(rng.integers(1, 60)))
        got = sw_lanes_ref(torch.from_numpy(s.astype(np.int64))[:, None],
                           torch.from_numpy(q.astype(np.int32)),
                           torch.from_numpy(sm.astype(np.int32)), og, eg)
        assert int(got[0]) == sw_score_numpy(q, s, sm, og, eg), (og, eg)


def _good_args():
    rng = np.random.default_rng(3)
    return list(_torch_args([_random_bin(rng, 1, 32)],
                            random_protein(rng, 5), get_submat("blosum62")))


@pytest.mark.parametrize("pos,bad,match", [
    (0, lambda t: t.to(torch.int32), "residues must be torch.int8"),
    (0, lambda t: t.reshape(-1, 128, 8).transpose(1, 2), "contiguous"),
    (0, lambda t: t.reshape(-1, 1024), r"\[C, 8, 128\]"),
    (1, lambda t: t.to(torch.int64), "groups must be torch.int32"),
    (1, lambda t: t.reshape(-1), r"\[G, 2\]"),
    (2, lambda t: t[:0], "non-empty"),
    (3, lambda t: t[:23].contiguous(), r"\[24, 24\]"),
])
def test_sw_groups_rejects_bad_inputs(pos, bad, match):
    args = _good_args()
    args[pos] = bad(args[pos])
    with pytest.raises(ValueError, match=match):
        sw_groups(*args, 10, 2)


def test_sw_groups_ref_rejects_group_outside_buffer():
    args = _good_args()
    args[1] = torch.tensor([[10, 32]], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        sw_groups(*args, 10, 2)


def test_library_path_keyed_on_source(tmp_path, monkeypatch):
    """The built library's name changes with its source, so an edit
    rebuilds; it lands under build/oswald_tpu_torch/."""
    assert build.BUILD_DIR.parts[-2:] == ("build", "oswald_tpu_torch")
    real = build.library_path("sw_groups")
    (tmp_path / "k.cu").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k")
    assert first == build.library_path("k")
    (tmp_path / "k.cu").write_text("// two\n")
    assert build.library_path("k") != first
    assert build.library_path("k").parent == build.BUILD_DIR
    assert real.parent == build.BUILD_DIR and real != first


U_ROWS = 8


def _jax_packed_scores(seq, q_packed, q_segs, sm, og, eg, seg_map=None,
                       used=None):
    """int32[q_segs, G, 8, 128] from the JAX packed bin scan (sw_chunk with
    q_segs / seg_map in interpret mode, profiles built chunk by chunk)."""
    G, L = seq.shape[:2]
    C = L // 128
    chunks = jnp.asarray(np.ascontiguousarray(np.swapaxes(
        seq[:, :C * 128].reshape(G, C, 128, 8, 128), 0, 1)))
    tail = jnp.asarray(seq[:, C * 128:]) if L % 128 else None
    nb = None if used is None or used == len(seg_map) else \
        jnp.asarray(used, jnp.int32)
    return np.asarray(_search_bin_stream_pack_impl(
        jnp.asarray(q_packed), jnp.asarray([og, eg], jnp.int32),
        jnp.asarray(sm), chunks, q_segs, U_ROWS, True, seq_tail=tail,
        noadj=True, seg_map=None if seg_map is None else
        jnp.asarray(seg_map), nb=nb))


def _uniform_layout(rng, qlens, seg_rows):
    """q_segs equal segments of seg_rows rows, each query DUMMY-padded."""
    qp = np.full(len(qlens) * seg_rows, DUMMY, np.int32)
    for s, n in enumerate(qlens):
        qp[s * seg_rows: s * seg_rows + n] = random_protein(rng, n)
    segs = np.array([(s * seg_rows, n) for s, n in enumerate(qlens)],
                    np.int32)
    return qp, segs


# every tail width (32, 64, 96), one-chunk bins and multi-chunk bins
# (L >= 256: the carried diagonal is zeroed at segment starts between
# chunks), uniform q_segs layouts (K1c) and mixed_pack_plan layouts with
# filler blocks and used_blocks < R (K1d), three scoring settings
PACKED_CASES = [
    (32, 1, "uniform", "blosum62", 10, 2),
    (96, 2, "mixed", "pam30", 7, 1),
    (160, 1, "uniform", "blosum62", 0, 0),
    (224, 1, "mixed", "blosum62", 10, 2),
    (320, 1, "uniform", "pam30", 7, 1),
    (320, 1, "mixed", "blosum62", 10, 2),
    (64, 2, "mixed", "blosum62", 0, 0),
    (288, 1, "uniform", "blosum62", 10, 2),
]


@pytest.mark.parametrize("L,G,layout,matrix,og,eg", PACKED_CASES)
def test_sw_groups_packed_ref_matches_jax_bin(L, G, layout, matrix, og, eg):
    rng = np.random.default_rng(L * 10 + G + len(matrix))
    seq = _random_bin(rng, G, L)
    sm = get_submat(matrix)
    if layout == "uniform":
        qlens = [16, 9, 1, 13]
        qp, segs = _uniform_layout(rng, qlens, 16)
        want = _jax_packed_scores(seq, qp, len(qlens), sm, og, eg)
    else:
        queries = [random_protein(rng, n) for n in (30, 12, 41, 7)]
        (idxs, qp, seg_map, used), = jax_mixed_pack_plan(
            128, U_ROWS, queries, max_segs=8)[0]
        assert used < len(seg_map)           # trailing filler blocks
        segs = plan_segments(idxs, seg_map, used, U_ROWS, queries)
        want = _jax_packed_scores(seq, qp, 8, sm, og, eg, seg_map,
                                  used)[:len(idxs)]
    res, table, _, smt = _torch_args([seq], qp[:1], sm)
    got = sw_groups_packed_ref(res, table, torch.from_numpy(qp),
                               torch.from_numpy(segs), smt, og, eg)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (len(segs), G, 8, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    # a segment taken with its DUMMY padding rows scores the same
    if layout == "uniform":
        padded = torch.tensor([(s * 16, 16) for s in range(len(segs))],
                              dtype=torch.int32)
        again = sw_groups_packed_ref(res, table, torch.from_numpy(qp),
                                     padded, smt, og, eg)
        np.testing.assert_array_equal(again.numpy(), want)


def test_sw_groups_packed_cpu_runs_plain_version():
    """sw_groups_packed on CPU tensors is the plain version (no launch
    counted), and every segment scores as sw_groups scores it alone."""
    rng = np.random.default_rng(17)
    bins = [_random_bin(rng, G, L) for G, L in ((2, 32), (1, 96))]
    qp, segs = _uniform_layout(rng, [20, 5, 11], 24)
    res, table, _, sm = _torch_args(bins, qp[:1], get_submat("blosum62"))
    before = (sw_lanes.launches, sw_lanes.launches_packed)
    got = sw_groups_packed(res, table, torch.from_numpy(qp),
                           torch.from_numpy(segs), sm, 10, 2)
    assert (sw_lanes.launches, sw_lanes.launches_packed) == before
    for s, (r0, n) in enumerate(segs.tolist()):
        alone = sw_groups(res, table, torch.from_numpy(qp[r0:r0 + n]), sm,
                          10, 2)
        np.testing.assert_array_equal(got[s].numpy(), alone.numpy())


@pytest.mark.parametrize("segs,match", [
    (torch.tensor([[0, 5]], dtype=torch.int64), "segs must be torch.int32"),
    (torch.tensor([0, 5], dtype=torch.int32), r"\[S, 2\]"),
    (torch.zeros((0, 2), dtype=torch.int32), r"\[S, 2\]"),
    (torch.tensor([[3, 5]], dtype=torch.int32), "outside"),
    (torch.tensor([[0, 0]], dtype=torch.int32), "outside"),
    (torch.tensor([[-1, 2]], dtype=torch.int32), "outside"),
])
def test_sw_groups_packed_rejects_bad_segments(segs, match):
    args = _good_args()                      # a query of 5 rows
    with pytest.raises(ValueError, match=match):
        sw_groups_packed(args[0], args[1], args[2], segs, args[3], 10, 2)
