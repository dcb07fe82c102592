"""oswald_tpu_torch.kernels.sw_lanes against the JAX package.

The plain PyTorch scorer (`sw_groups_ref`, what `sw_groups` runs on a CPU
tensor) is held to the JAX bin scan `_search_bin_impl` over the Pallas
kernel in interpret mode, and to the numpy oracle; the packed scorer
(`sw_groups_packed_ref`) to the JAX packed bin scan
`_search_bin_stream_pack_impl` with uniform segments (`q_segs`) and with a
`mixed_pack_plan` layout (`seg_map`).  The plain versions that carry out the
kernels' own decomposition (`sw_groups_tiled_ref`,
`sw_groups_packed_tiled_ref`: work items, strips dealt to sets, column
tiles, the H/F hand-over) are held to both, and the work table to its
contract.  Tolerance: exact int32.  The CUDA
kernels themselves are checked on a card by tests/test_torch_gpu.py and, at
full size, by chip_smoke.py.
"""

import functools

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
from oswald_tpu_torch.io import pack_sequences
from oswald_tpu_torch.io.device_db import to_device, to_host_stream
from oswald_tpu_torch.kernels.sw_lanes import (CARD_BLOCKS, LONG_FROM,
                                               MAX_CLUSTER, ROWS_PER_GROUP,
                                               SETS, SLABS_PER_GROUP,
                                               SPLIT_FROM,
                                               STRIP_ROWS, TILE_COLS,
                                               sw_groups, sw_groups_packed,
                                               sw_groups_packed_ref,
                                               sw_groups_packed_tiled_ref,
                                               sw_groups_ref,
                                               sw_groups_tiled_ref,
                                               sw_lanes_ref, work_table,
                                               WorkTable)

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


@functools.lru_cache(maxsize=None)
def _bin_case(L, m, G, matrix, og, eg):
    """(seq, query, sm, the JAX bin scan's scores) of one BIN_CASES entry;
    the scan runs once per case and process."""
    rng = np.random.default_rng(L * 100 + m)
    seq = _random_bin(rng, G, L)
    query = random_protein(rng, m)
    sm = get_submat(matrix)
    return seq, query, sm, _jax_bin_scores(seq, query, sm, og, eg)


@pytest.mark.parametrize("L,m,G,matrix,og,eg", BIN_CASES)
def test_sw_groups_ref_matches_jax_bin(L, m, G, matrix, og, eg):
    seq, query, sm, want = _bin_case(L, m, G, matrix, og, eg)
    got = sw_groups_ref(*_torch_args([seq], query, sm), og, eg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


# the tile width the kernels use (it divides every L here) and two that
# divide none; every group as rows, every group as pipelined slabs
@pytest.mark.parametrize("tile_cols,long_from", [
    (TILE_COLS, 1 << 30), (TILE_COLS, 1), (5, 1), (7, 1 << 30)])
@pytest.mark.parametrize("L,m,G,matrix,og,eg", BIN_CASES)
def test_sw_groups_tiled_ref_matches_jax_bin(L, m, G, matrix, og, eg,
                                             tile_cols, long_from):
    seq, query, sm, want = _bin_case(L, m, G, matrix, og, eg)
    args = _torch_args([seq[:1]], query, sm)          # one group is enough
    got = sw_groups_tiled_ref(*args, og, eg, work=work_table(args[1],
                                                             long_from),
                              tile_cols=tile_cols)
    np.testing.assert_array_equal(got.numpy(), want[:1])
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, 8, 128)


ROUNDS = 4 * STRIP_ROWS * SETS       # strips for four rounds of every set


# a table that mixes rows and slabs (long_from 40), all slabs, all rows;
# query lengths of one row, a partial strip, several strips, and four
# rounds of the pipeline plus a partial strip; lengths below a tile, below
# the pipeline's fill, and no multiple of the tile
@pytest.mark.parametrize("m,long_from,tile_cols,matrix,og,eg", [
    (1, 40, TILE_COLS, "blosum62", 10, 2),
    (9, 1, TILE_COLS, "pam30", 7, 1),
    (65, 40, TILE_COLS, "blosum62", 0, 0),
    (65, 1, 3, "blosum62", 10, 2),
    (ROUNDS + 3, 40, TILE_COLS, "blosum62", 10, 2),
    (ROUNDS, 1, TILE_COLS, "pam30", 7, 1),
    (ROUNDS + 3, 1 << 30, 16, "blosum62", 0, 0),
])
def test_sw_groups_tiled_ref_matches_plain_version(m, long_from, tile_cols,
                                                   matrix, og, eg):
    rng = np.random.default_rng(m * 7 + tile_cols)
    bins = [_random_bin(rng, G, L) for G, L in ((1, 5), (1, 44), (1, 27))]
    args = _torch_args(bins, random_protein(rng, m), get_submat(matrix))
    want = sw_groups_ref(*args, og, eg)
    got = sw_groups_tiled_ref(*args, og, eg,
                              work=work_table(args[1], long_from),
                              tile_cols=tile_cols)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # the order of the items does not matter to the scores (a split slab's
    # run of blocks moves whole)
    work = WorkTable(_reversed_runs(work_table(args[1], long_from)), args[1])
    again = sw_groups_tiled_ref(*args, og, eg, work=work,
                                tile_cols=tile_cols)
    np.testing.assert_array_equal(again.numpy(), want.numpy())


def _reversed_runs(work):
    """The items of `work` with its aligned runs of `cluster` blocks in
    the opposite order."""
    K = work.cluster
    return work.items.reshape(-1, K, 2).flip(0).reshape(-1, 2).contiguous()


def _table_from_lengths(lengths):
    c0, rows = 0, []
    for L in lengths:
        rows.append((c0, L))
        c0 += L
    return np.array(rows, np.int32).reshape(-1, 2)


def _check_work_table(table, long_from):
    """The contract of work_table on int[G, 2] `table`: the items, and the
    WorkTable's cluster size and split slabs."""
    table_w = work_table(table, long_from)
    work = table_w.items
    assert work.dtype == torch.int32 and work.shape[1] == 2
    fills = ROWS_PER_GROUP * len(table) >= sw_lanes.card_blocks()
    cut = long_from if long_from is not None else LONG_FROM if fills else 0
    lengths = np.asarray(table).reshape(-1, 2)[:, 1].tolist()
    # the balanced share: every item's cost over the card's blocks; the
    # slabs above it are split over K blocks, the least power of two up to
    # MAX_CLUSTER that brings the longest to the share
    cost_of = {}
    for g, L in enumerate(lengths):
        for p in (range(ROWS_PER_GROUP, SPLIT_FROM) if L >= cut
                  else range(ROWS_PER_GROUP)):
            cost_of[(g, p)] = L * (1 if p >= ROWS_PER_GROUP else SETS)
    share = sum(cost_of.values()) / sw_lanes.card_blocks()
    heavy = {gp for gp, c in cost_of.items()
             if gp[1] >= ROWS_PER_GROUP and c > share}
    K = 1
    if heavy:
        top = max(cost_of[gp] for gp in heavy)
        K = 2
        while K < MAX_CLUSTER and top / K > share:
            K *= 2
    assert table_w.cluster == K and table_w.split_slabs == len(heavy)
    items = [tuple(x) for x in work.tolist()]
    assert len(items) % K == 0
    # split slabs first, each on an aligned run of K blocks of ranks 0..K-1,
    # heaviest first; then every other (group, part) once
    runs = [items[i:i + K] for i in range(0, K * len(heavy), K)]
    for run in runs:
        g, p = run[0]
        assert [q for _, q in run] == [p + r * SLABS_PER_GROUP
                                       for r in range(K)]
        assert {h for h, _ in run} == {g} and SPLIT_FROM <= p < \
            SPLIT_FROM + SLABS_PER_GROUP
    split = [(run[0][0], run[0][1] - SPLIT_FROM + ROWS_PER_GROUP)
             for run in runs]
    rest = items[K * len(heavy):]
    assert all(p < SPLIT_FROM for _, p in rest)
    # every (group, part) exactly once
    assert sorted(split + rest) == sorted(cost_of) and \
        set(split) == heavy
    for order in (split, rest):
        cost = [cost_of[gp] for gp in order]
        # descending cost, equal costs in (group, part) order
        assert cost == sorted(cost, reverse=True)
        for (a, ca), (b, cb) in zip(zip(order, cost),
                                    zip(order[1:], cost[1:])):
            assert ca > cb or a < b
    # with nothing split the table is the one-block roles', item for item,
    # and the plain launch of a split table is that table with each split
    # slab at its run's place
    plain = [tuple(x) for x in table_w.plain().items.tolist()]
    assert table_w.plain().cluster == 1 and (K > 1 or
                                             table_w.plain() is table_w)
    assert plain == split + rest
    return work


@pytest.mark.parametrize("lengths,long_from", [
    ([32, 32, 64, 96, 96, 1056, 2048, 5504], LONG_FROM),
    ([32, 32, 64, 96, 96, 1056, 2048, 5504], 64),
    ([5504, 32, 1024, 32, 1023], LONG_FROM),         # not sorted by length
    ([5504, 32, 1024, 32, 1023], None),              # small: all pipelined
    # enough rows to fill the card: only the long groups are pipelined
    ([32] * 40 + [96] * 20 + [1024, 1500, 5504], None),
    ([256, 64, 256, 64], 256),                       # 4 L = L' ties
    ([96], None), ([96], 1), ([0, 32], 1),
    ([], None),
])
def test_work_table_contract(lengths, long_from):
    table = _table_from_lengths(lengths)
    work = _check_work_table(table, long_from)
    # a tensor gives the same table, on its device
    groups = torch.from_numpy(table)
    again = work_table(groups, long_from)
    assert again.items.device.type == "cpu" and \
        torch.equal(again.items, work) and len(again) == len(work)
    # bound to that tensor; the default table is kept on it until it is
    # written
    assert again.is_for(groups) and not again.is_for(groups.clone())
    assert (work_table(groups) is work_table(groups)) and \
        (long_from is None or work_table(groups, long_from) is not again)
    if len(lengths):
        kept = work_table(groups)
        groups[0, 1] += 1
        assert not kept.is_for(groups) and work_table(groups) is not kept
    # a sub-table has its own order, over its own group indices
    if len(lengths) > 2:
        _check_work_table(table[1:-1], long_from)


def test_work_table_of_device_state_and_host_stream_slices():
    """to_device keeps the whole database's table beside its groups, and
    every host_stream slice the table of its own groups (indices local to
    the slice)."""
    rng = np.random.default_rng(5)
    lengths = rng.integers(1, 40, size=70000)
    lengths[:3] = LONG_FROM + 20
    db = pack_sequences(random_protein(rng, int(lengths.sum())), lengths,
                        [f"s{i}" for i in range(len(lengths))])
    st = to_device(db, "cpu")
    assert ROWS_PER_GROUP * st.groups.shape[0] >= CARD_BLOCKS
    assert st.work.is_for(st.groups) and work_table(st.groups) is st.work
    assert torch.equal(st.work.items,
                       _check_work_table(st.groups.numpy(), None))
    # the one long group's 32 slabs, each once: far above this small
    # database's balanced share, so split
    assert int((st.work.plain().items[:, 1] >= ROWS_PER_GROUP).sum()) == \
        SLABS_PER_GROUP
    assert st.work.split_slabs == SLABS_PER_GROUP and st.work.cluster > 1
    hs = to_host_stream(db, "cpu", 1)
    assert len(hs.slices) > 1
    for sl in hs.slices:
        assert sl.work.is_for(sl.groups)
        assert torch.equal(sl.work.items,
                           _check_work_table(sl.groups.numpy(), None))
        assert int(sl.work.items[:, 0].max()) == sl.groups.shape[0] - 1


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


@pytest.mark.parametrize("dummy_score", [0, 3])
def test_cpu_branch_skips_padding_lanes(dummy_score):
    """Lanes of DUMMY alone (a group's padding) among real ones: with the
    shipped matrices DUMMY scores 0, and the CPU branch skips them and
    scores them 0; under a matrix where DUMMY scores 3 it computes them.
    Either way every lane equals the numpy oracle and sw_lanes_ref, and
    sw_groups on CPU tensors equals sw_groups_ref."""
    rng = np.random.default_rng(12)
    sm = get_submat("pam30").astype(np.int32)
    sm[DUMMY, :] = sm[:, DUMMY] = dummy_score
    L, m = 40, 33
    cols = np.full((L, 9), DUMMY, np.int64)
    for lane in (0, 3, 4, 8):
        n = int(rng.integers(1, L + 1))
        cols[:n, lane] = random_protein(rng, n)
    q = random_protein(rng, m)
    args = (torch.from_numpy(q.astype(np.int32)), torch.from_numpy(sm), 7,
            1)
    want = [sw_score_numpy(q, cols[:, k], sm, 7, 1) for k in range(9)]
    assert sw_lanes._sw_lanes_live(torch.from_numpy(cols),
                                   *args).tolist() == want
    assert sw_lanes_ref(torch.from_numpy(cols), *args).tolist() == want
    assert any(want[k] for k in (1, 2, 5, 6, 7)) == (dummy_score != 0)
    group = _random_bin(rng, 2, L)
    group[1, :, 4:] = DUMMY
    tab = _torch_args([group], q, sm)
    np.testing.assert_array_equal(sw_groups(*tab, 7, 1).numpy(),
                                  sw_groups_ref(*tab, 7, 1).numpy())


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


def _other_items(items, edit):
    out = items.clone()
    edit(out)
    return out


@pytest.mark.parametrize("bad,match", [
    # the bare items are no table
    (lambda w, g: w.items, "must be the WorkTable"),
    # a table of another group table of the same size, as a slice of a
    # streamed database or a sub-table would be
    (lambda w, g: work_table(g.clone()), "another group table"),
    (lambda w, g: work_table(g + 0, 1), "another group table"),
    # items that are no launch order of the groups: refused when the table
    # is made, before anything can index with them
    (lambda w, g: WorkTable(w.items.to(torch.int64), g), r"int32\[N, 2\]"),
    (lambda w, g: WorkTable(w.items.reshape(-1), g), r"int32\[N, 2\]"),
    (lambda w, g: WorkTable(w.items[:-1].contiguous(), g),
     "no launch order of these 1 groups"),
    (lambda w, g: WorkTable(torch.cat([w.items, w.items]), g),
     "no launch order of these 1 groups"),
    (lambda w, g: WorkTable(_other_items(
        w.items, lambda t: t[0].copy_(t[1])), g),
     "no launch order of these 1 groups"),
    (lambda w, g: WorkTable(_other_items(
        w.items, lambda t: t[:, 0].fill_(1)), g),
     "no launch order of these 1 groups"),
    (lambda w, g: WorkTable(_other_items(
        w.items, lambda t: t[:, 1].add_(1)), g),
     "no launch order of these 1 groups"),
])
def test_sw_groups_rejects_bad_work_table(bad, match):
    """A launch order reaches the kernel only with the group table it was
    built for, and only if it names every part of every group once: on any
    device and before any launch."""
    args = _good_args()
    for long_from in (1, 1 << 30):
        work = work_table(args[1], long_from)
        sw_groups(*args, 10, 2, work=work)
        with pytest.raises(ValueError, match=match):
            sw_groups(*args, 10, 2, work=bad(work, args[1]))


def test_work_table_refused_once_groups_are_written():
    args = _good_args()
    work = work_table(args[1])
    sw_groups(*args, 10, 2, work=work)
    args[1][0, 1] -= 1
    with pytest.raises(ValueError, match="written since"):
        sw_groups(*args, 10, 2, work=work)
    sw_groups(*args, 10, 2)             # the wrapper's own table is rebuilt


def test_sw_groups_ref_rejects_group_outside_buffer():
    args = _good_args()
    args[1] = torch.tensor([[10, 32]], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        sw_groups(*args, 10, 2)


def test_library_path_keyed_on_source(tmp_path, monkeypatch):
    """The built library's name changes with its source, so an edit
    rebuilds; it lands under the kernel cache directory enabled
    (utils.compile_cache), and its name does not depend on that directory."""
    from oswald_tpu_torch.utils import compile_cache
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    cache = tmp_path / "cache"
    assert compile_cache.enable_compile_cache(str(cache), quiet=True) == \
        str(cache)
    assert build.build_dir() == cache
    real = build.library_path("sw_groups")
    src = tmp_path / "src"
    src.mkdir()
    (src / "k.cu").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", src)
    first = build.library_path("k")
    assert first == build.library_path("k")
    (src / "k.cu").write_text("// two\n")
    assert build.library_path("k") != first
    assert build.library_path("k").parent == cache
    assert real.parent == cache and real != first
    name = build.library_path("k").name
    compile_cache.enable_compile_cache(str(tmp_path / "other"), quiet=True)
    assert build.library_path("k") == tmp_path / "other" / name


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


@functools.lru_cache(maxsize=None)
def _packed_case(L, G, layout, matrix, og, eg):
    """(seq, sm, q_packed, segs, the JAX packed bin scan's scores) of one
    PACKED_CASES entry; the scan runs once per case and process."""
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
    return seq, sm, qp, segs, want


@pytest.mark.parametrize("L,G,layout,matrix,og,eg", PACKED_CASES)
def test_sw_groups_packed_ref_matches_jax_bin(L, G, layout, matrix, og, eg):
    seq, sm, qp, segs, want = _packed_case(L, G, layout, matrix, og, eg)
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


# uniform segments (one of a single row, none longer than a strip) and a
# mixed plan's unequal ones (7 rows: shorter than a strip; 41: three
# strips), as rows and as pipelined slabs
@pytest.mark.parametrize("long_from,tile_cols", [(1 << 30, TILE_COLS),
                                                 (1, 6)])
@pytest.mark.parametrize("L,G,layout,matrix,og,eg", PACKED_CASES)
def test_sw_groups_packed_tiled_ref_matches_jax_bin(L, G, layout, matrix, og,
                                                    eg, long_from, tile_cols):
    seq, sm, qp, segs, want = _packed_case(L, G, layout, matrix, og, eg)
    res, table, _, smt = _torch_args([seq[:1]], qp[:1], sm)
    got = sw_groups_packed_tiled_ref(
        res, table, torch.from_numpy(qp), torch.from_numpy(segs), smt, og,
        eg, work=work_table(table, long_from), tile_cols=tile_cols)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (len(segs), 1, 8, 128)
    np.testing.assert_array_equal(got.numpy(), want[:, :1])


@pytest.mark.parametrize("qlens,long_from", [
    ([ROUNDS + 5, 3, STRIP_ROWS, 40], 30),     # many rounds, then short ones
    ([1, 1, 1, 1, 1, 70], 1),                  # every strip starts a segment
    ([STRIP_ROWS * SETS] * 3, 1),              # segments end with a round
    ([20, 33], 1 << 30),
])
def test_sw_groups_packed_tiled_ref_matches_plain_version(qlens, long_from):
    """Unequal segments back to back: the strips of all segments are dealt
    to the sets in one sequence, whatever the segment boundaries."""
    rng = np.random.default_rng(len(qlens) + qlens[0])
    bins = [_random_bin(rng, G, L) for G, L in ((1, 36), (1, 11))]
    q = random_protein(rng, sum(qlens)).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(qlens)[:-1]])
    segs = torch.tensor(list(zip(starts.tolist(), qlens)), dtype=torch.int32)
    res, table, qt, sm = _torch_args(bins, q, get_submat("blosum62"))
    want = sw_groups_packed_ref(res, table, qt, segs, sm, 10, 2)
    got = sw_groups_packed_tiled_ref(res, table, qt, segs, sm, 10, 2,
                                     work=work_table(table, long_from))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# Split slabs: the slabs of the longest groups swept by the 4 K warps of a
# cluster of K blocks.  On a card of 32 K block slots a lone group's slabs
# are split over K (the share of its 32 slabs is L * 32 / (32 K)); a giant
# among short groups by the card's own share.
SPLIT_KS = (2, 4, 8)


def _card_for(monkeypatch, K):
    """Plan work tables for a card on which a lone group splits over K."""
    monkeypatch.setattr(sw_lanes, "card_blocks", lambda: SLABS_PER_GROUP * K)


# strips 5, 3 and 1 (m 65, 33, 9): past the first block's sets at K = 2,
# and fewer strips than sets at every K
@pytest.mark.parametrize("K", SPLIT_KS)
@pytest.mark.parametrize("L,m,G,matrix,og,eg", [
    BIN_CASES[1], BIN_CASES[3], BIN_CASES[7]])
def test_split_tiled_ref_matches_jax_bin(L, m, G, matrix, og, eg, K,
                                        monkeypatch):
    seq, query, sm, want = _bin_case(L, m, G, matrix, og, eg)
    args = _torch_args([seq[:1]], query, sm)
    _card_for(monkeypatch, K)
    work = work_table(args[1], 1)
    assert work.cluster == K and work.split_slabs == SLABS_PER_GROUP
    got = sw_groups_tiled_ref(*args, og, eg, work=work)
    np.testing.assert_array_equal(got.numpy(), want[:1])


# short groups of 32 columns (rows) beside a 64-column giant (slabs), as
# many as make the card's share split the giant over K blocks
GIANT_AMONG_SHORT = {2: 20, 4: 10, 8: 2}


@pytest.mark.parametrize("K", SPLIT_KS)
def test_split_tiled_ref_giant_among_short_groups(K):
    """The giant's strips cross every block of its cluster and wrap to
    set 0 through the scratch rows: 4 K + 2 strips."""
    rng = np.random.default_rng(40 + K)
    bins = [_random_bin(rng, GIANT_AMONG_SHORT[K], 32),
            _random_bin(rng, 1, 64)]
    m = STRIP_ROWS * SETS * K + 2 * STRIP_ROWS - 5
    args = _torch_args(bins, random_protein(rng, m), get_submat("blosum62"))
    work = work_table(args[1], 40)
    assert work.cluster == K and work.split_slabs == SLABS_PER_GROUP
    assert len(work) == ROWS_PER_GROUP * GIANT_AMONG_SHORT[K] + \
        SLABS_PER_GROUP * K
    want = sw_groups_ref(*args, 10, 2)
    got = sw_groups_tiled_ref(*args, 10, 2, work=work)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("K", SPLIT_KS)
@pytest.mark.parametrize("L,G,layout,matrix,og,eg", [
    PACKED_CASES[1], PACKED_CASES[3], PACKED_CASES[4]])
def test_split_packed_tiled_ref_matches_jax_bin(L, G, layout, matrix, og, eg,
                                                K, monkeypatch):
    seq, sm, qp, segs, want = _packed_case(L, G, layout, matrix, og, eg)
    res, table, _, smt = _torch_args([seq[:1]], qp[:1], sm)
    _card_for(monkeypatch, K)
    work = work_table(table, 1)
    assert work.cluster == K
    got = sw_groups_packed_tiled_ref(
        res, table, torch.from_numpy(qp), torch.from_numpy(segs), smt, og,
        eg, work=work)
    np.testing.assert_array_equal(got.numpy(), want[:, :1])


@pytest.mark.parametrize("K,qlens", [
    # segments whose strips start inside a block and cross to the next
    (2, [STRIP_ROWS * 9 + 5, 3, STRIP_ROWS, 40]),
    (4, [1, 1, 1, 1, 1, 300]),
    (4, [STRIP_ROWS * SETS * 4] * 2),          # each ends with a block
    # more than a round of 32 sets, then short ones
    (8, [STRIP_ROWS * 33, 7, 20]),
    (8, [33]),                                 # fewer strips than sets
])
def test_split_packed_tiled_ref_matches_plain_version(K, qlens, monkeypatch):
    """The strips of all segments are dealt to the 4 K sets of a split
    slab in one sequence, across the blocks of its cluster."""
    rng = np.random.default_rng(K * 100 + len(qlens))
    res, table, qt, sm = _torch_args(
        [_random_bin(rng, 1, 36)], random_protein(rng, sum(qlens)),
        get_submat("blosum62"))
    starts = np.concatenate([[0], np.cumsum(qlens)[:-1]])
    segs = torch.tensor(list(zip(starts.tolist(), qlens)), dtype=torch.int32)
    _card_for(monkeypatch, K)
    work = work_table(table, 1)
    assert work.cluster == K
    want = sw_groups_packed_ref(res, table, qt, segs, sm, 10, 2)
    got = sw_groups_packed_tiled_ref(res, table, qt, segs, sm, 10, 2,
                                     work=work)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("lengths,long_from,blocks", [
    # on a card of `blocks` slots, a lone group splits over K = blocks / 32,
    # and two over half that
    ([100], 1, 64), ([100], 1, 128), ([100], 1, 256), ([100], 1, 4096),
    ([100, 100], 1, 256),
    # a giant among groups that fill the card: only its slabs split
    ([32] * 70 + [35232], None, None),
    ([32] * 40 + [96] * 20 + [1024, 1500, 5504, 35232], None, None),
    # two heavy lengths: both split, over the K of the longer
    ([32] * 80 + [20000, 35232], None, None),
    # small tables: every slab above the share splits
    ([5504, 32, 1024, 32, 1023], None, None),
    # nothing above the share: one block slot, or an even spread
    ([100, 5504], 1, 1), ([64] * 100, None, None),
])
def test_split_work_table_contract(lengths, long_from, blocks, monkeypatch):
    if blocks is not None:
        monkeypatch.setattr(sw_lanes, "card_blocks", lambda: blocks)
    table = _table_from_lengths(lengths)
    work = _check_work_table(table, long_from)
    again = work_table(torch.from_numpy(table), long_from)
    assert torch.equal(again.items, work)


def _release_like_lengths(rng, n_groups, giant):
    """Group lengths of a length-sorted database: a lognormal body and,
    unless `giant` is 0, one last group of that many columns."""
    body = np.sort(np.clip(rng.lognormal(np.log(300), 0.6, n_groups), 32,
                           5504)).astype(np.int64)
    body = -(-body // 32) * 32
    return body.tolist() + ([giant] if giant else [])


def test_work_table_without_giants_is_the_one_block_order():
    """A database capped where the card's share lies above its longest
    slab splits nothing: its table is the one-block roles' launch order,
    item for item, and the same database with a release's giant group splits that group
    alone, over 4 blocks, leaving the other items in that order."""
    rng = np.random.default_rng(2013)
    lengths = _release_like_lengths(rng, 528, 0)
    table = _table_from_lengths(lengths)
    work = work_table(table)
    L = np.asarray(lengths, np.int64)
    is_long = L >= LONG_FROM
    n_parts = np.where(is_long, SLABS_PER_GROUP, ROWS_PER_GROUP)
    g = np.repeat(np.arange(len(L)), n_parts)
    part = np.concatenate([np.arange(n) + (ROWS_PER_GROUP if lg else 0)
                           for n, lg in zip(n_parts, is_long)])
    cost = np.where(is_long, L, SETS * L)[g]
    order = np.argsort(-cost, kind="stable")
    one_block = np.stack([g[order], part[order]], axis=1)
    assert work.cluster == 1 and work.split_slabs == 0 and \
        work.plain() is work
    np.testing.assert_array_equal(work.items.numpy(), one_block)
    giant = _table_from_lengths(lengths + [35232])
    split = work_table(giant)
    assert split.cluster == 4 and split.split_slabs == SLABS_PER_GROUP
    rest = split.items.numpy()[SLABS_PER_GROUP * 4:]
    np.testing.assert_array_equal(rest, one_block)
    _check_work_table(giant, None)


def _split_items(monkeypatch, K=4):
    """The items of a lone group split over K, and its table."""
    _card_for(monkeypatch, K)
    table = torch.from_numpy(_table_from_lengths([100]))
    work = work_table(table, 1)
    assert work.cluster == K
    return work.items, table


def _swap(t, i, j):
    t[[i, j]] = t[[j, i]]


@pytest.mark.parametrize("edit", [
    # a run that starts off the cluster's alignment
    lambda t: torch.cat([t[1:], t[:1]]),
    # two blocks of a run in each other's place
    lambda t: (_swap(t, 1, 2), t)[1],
    # a run with a block of another slab
    lambda t: (_swap(t, 3, 4), t)[1],
    # a run one block short, and one of its blocks twice
    lambda t: t[:-1],
    lambda t: torch.cat([t[:-1], t[-2:-1]]),
    # one block of a split slab alone (a cluster of 1)
    lambda t: torch.cat([t[:1], t[4:].reshape(-1, 4, 2)[:, 0]]),
    # ranks 0..15: beyond the portable cluster
    lambda t: torch.cat([t.reshape(-1, 4, 2) + torch.tensor(
        [0, 4 * r * SLABS_PER_GROUP], dtype=torch.int32) for r in range(4)],
        dim=1).reshape(-1, 2),
    # a split slab and the same slab as one block
    lambda t: torch.cat([t, torch.tensor([[0, ROWS_PER_GROUP]] * 4,
                                         dtype=torch.int32)]),
])
def test_split_work_table_refused(edit, monkeypatch):
    """Items whose split slabs are not one aligned run of the cluster's
    blocks, ranks 0..K-1 in order, each slab once, are refused before any
    launch."""
    items, table = _split_items(monkeypatch)
    WorkTable(items, table)
    bad = edit(items.clone()).contiguous()
    with pytest.raises(ValueError, match="no launch order of these 1 groups"):
        WorkTable(bad, table)


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
