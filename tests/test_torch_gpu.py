"""oswald_tpu_torch on a CUDA card: the sw_groups, sw_groups_packed and
sw_groups_lab kernels against their plain versions, and the CUDA engine,
resident and host_stream, against the CPU engine (tolerance: exact); the
engine's warmup (both kernel libraries built once into the enabled kernel
directory), a SearchService over the card's engine, and tune at a tiny
size.

Every test is marked `gpu` and skips without a card.  The file imports
neither jax, nor oswald_tpu, nor the test conftest (which imports jax), so
on a machine with a card and no jax it runs as

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from oswald_tpu_torch.alphabet import DUMMY
from oswald_tpu_torch.engine import SearchConfig, SearchEngine
from oswald_tpu_torch.engine.search import mixed_pack_plan, plan_segments
from oswald_tpu_torch.io import pack_sequences
from oswald_tpu_torch.kernels import sw_lab, sw_lanes
from oswald_tpu_torch.kernels.sw_lab import (BUILT, VARIANTS, sw_groups_lab,
                                             sw_groups_lab_tiled_ref)
from oswald_tpu_torch.kernels.sw_lanes import (LONG_FROM, SETS, STRIP_ROWS,
                                               TILE_COLS, sw_groups,
                                               sw_groups_packed,
                                               sw_groups_packed_ref,
                                               sw_groups_ref, work_table,
                                               WorkTable)
from oswald_tpu_torch.submat import get_submat

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _protein(rng, n):
    return rng.integers(0, 23, size=n).astype(np.int8)


def _inputs(rng, shapes, m, matrix, device):
    """sw_groups' inputs for random bins of (G, L) groups."""
    cols, table, c0 = [], [], 0
    for G, L in shapes:
        res = rng.integers(0, 23, size=(G * L, 8, 128)).astype(np.int8)
        lens = rng.integers(0, L + 1, size=(G, 1, 8, 128))
        pos = np.arange(L)[None, :, None, None]
        res = np.where((pos < lens).reshape(G * L, 8, 128), res,
                       np.int8(DUMMY)).astype(np.int8)
        cols.append(res)
        table += [(c0 + g * L, L) for g in range(G)]
        c0 += G * L
    return [torch.from_numpy(np.concatenate(cols)).to(device),
            torch.tensor(table, dtype=torch.int32, device=device),
            torch.from_numpy(_protein(rng, m).astype(np.int32)).to(device),
            torch.as_tensor(get_submat(matrix), dtype=torch.int32,
                            device=device)]


@pytest.mark.parametrize("m,matrix,og,eg", [
    (1, "blosum62", 10, 2), (9, "pam30", 7, 1), (65, "blosum62", 0, 0),
    (513, "blosum62", 11, 1), (600, "blosum62", 10, 2),
    # queries that would not fit shared memory: the rows stay in global
    (8192, "blosum62", 10, 2), (9000, "blosum62", 10, 2),
    (13000, "pam30", 7, 1), (16384, "pam30", 7, 1),
])
def test_kernel_matches_plain_version(cuda, m, matrix, og, eg):
    rng = np.random.default_rng(m)
    args = _inputs(rng, [(2, 32), (1, 224), (1, 96)], m, matrix, cuda)
    before = sw_lanes.launches
    got = sw_groups(*args, og, eg)
    torch.cuda.synchronize()
    assert sw_lanes.launches == before + 1
    want = sw_groups_ref(*args, og, eg)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def test_kernel_with_engine_scratch_and_subtable(cuda):
    """One group out of many, with a caller's scratch buffer."""
    rng = np.random.default_rng(1)
    res, table, q, sm = _inputs(rng, [(3, 64), (2, 160)], 40, "blosum62",
                                cuda)
    scratch = torch.empty((2,) + tuple(res.shape), dtype=torch.int32,
                          device=cuda)
    one = table[3:4].contiguous()
    got = sw_groups(res, one, q, sm, 10, 2, scratch)
    want = sw_groups_ref(res, one, q, sm, 10, 2)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def _misaligned_scratch(res, device):
    """A scratch of the right shape and type whose rows start 4 bytes past
    a 16-byte boundary: the sweep's 16-byte copies cannot address it."""
    flat = torch.empty(2 * res.numel() + 1, dtype=torch.int32, device=device)
    return flat[1:].view((2,) + tuple(res.shape))


def test_refused_launch_raises(cuda):
    """A scratch the kernel's 16-byte copies cannot address is refused at
    the launch; the wrapper raises instead of returning unwritten scores."""
    rng = np.random.default_rng(2)
    args = _inputs(rng, [(1, 32)], 60, "blosum62", cuda)
    before = sw_lanes.launches
    with pytest.raises(RuntimeError, match="sw_groups kernel launch failed"):
        sw_groups(*args, 10, 2, _misaligned_scratch(args[0], cuda))
    assert sw_lanes.launches == before
    # a query of 60,000 rows is no reason to refuse: the rows are read
    # from global memory strip by strip
    args = _inputs(rng, [(1, 32)], 60000, "blosum62", cuda)
    got = sw_groups(*args, 10, 2)
    assert sw_lanes.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  sw_groups_ref(*args, 10, 2).cpu().numpy())


# (G, L) tables that mix both roles: rows of short groups, pipelined slabs
# of long ones; lengths that are no multiple of the tile, shorter than a
# tile, and shorter than the pipeline's fill
MIXED_ROLES = [(2, 32), (1, LONG_FROM + 37), (1, 96), (1, LONG_FROM)]
ODD_LENGTHS = [(1, 5), (2, 32), (1, TILE_COLS * SETS - 3), (1, 224), (1, 97)]


@pytest.mark.parametrize("shapes,long_from,m,matrix,og,eg", [
    (MIXED_ROLES, LONG_FROM, 65, "blosum62", 10, 2),
    # a query of many rounds of the pipeline on a long group
    (MIXED_ROLES, LONG_FROM, 4 * STRIP_ROWS * SETS + 9, "pam30", 7, 1),
    (MIXED_ROLES, LONG_FROM, 1, "blosum62", 0, 0),
    # every group pipelined, whatever its length
    (ODD_LENGTHS, 1, 9, "blosum62", 10, 2),
    (ODD_LENGTHS, 1, 6 * STRIP_ROWS * SETS, "blosum62", 11, 1),
    (ODD_LENGTHS, 40, STRIP_ROWS * SETS + 1, "pam30", 7, 1),
    # no group pipelined
    (MIXED_ROLES, 1 << 30, 100, "blosum62", 10, 2),
])
def test_kernel_roles_match_plain_version(cuda, shapes, long_from, m, matrix,
                                          og, eg):
    rng = np.random.default_rng(m + len(shapes))
    args = _inputs(rng, shapes, m, matrix, cuda)
    work = work_table(args[1], long_from)
    got = sw_groups(*args, og, eg, work=work)
    torch.cuda.synchronize()
    want = sw_groups_ref(*args, og, eg)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    # the same launch again, with a caller's scratch full of old values
    scratch = torch.full((2,) + tuple(args[0].shape), 12345,
                         dtype=torch.int32, device=cuda)
    again = sw_groups(*args, og, eg, scratch, work)
    np.testing.assert_array_equal(again.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("long_from", [LONG_FROM, None, 1 << 30])
def test_packed_kernel_roles_match_plain_version(cuda, long_from):
    """Segments of one row, less than a strip, several strips and many
    rounds of the pipeline, on both roles, with a caller's scratch and a
    sub-table of the groups."""
    rng = np.random.default_rng(31)
    res, table, _, sm = _inputs(rng, MIXED_ROLES + [(1, 61)], 1, "blosum62",
                                cuda)
    qlens = [1, 7, 16, 300, 33, 2 * STRIP_ROWS * SETS]
    q = torch.from_numpy(_protein(rng, sum(qlens)).astype(np.int32)).to(cuda)
    starts = np.concatenate([[0], np.cumsum(qlens)[:-1]])
    segs = torch.tensor(list(zip(starts.tolist(), qlens)), dtype=torch.int32,
                        device=cuda)
    scratch = torch.full((2,) + tuple(res.shape), -7, dtype=torch.int32,
                         device=cuda)
    for sub in (table, table[1:4].contiguous(), table[2:3].contiguous()):
        work = work_table(sub, long_from)
        got = sw_groups_packed(res, sub, q, segs, sm, 10, 2, scratch, work)
        torch.cuda.synchronize()
        want = sw_groups_packed_ref(res, sub, q, segs, sm, 10, 2)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
        if long_from is None:
            # the wrapper's own table is the default one: a table this
            # small is pipelined whole
            own = sw_groups_packed(res, sub, q, segs, sm, 10, 2, scratch)
            np.testing.assert_array_equal(own.cpu().numpy(),
                                          want.cpu().numpy())


def test_pipelined_hand_over_is_stable(cuda):
    """The waits between the warps of a pipelined item are the one thing no
    CPU test reaches, and a fault in them shows in one lane, sometimes: the
    same launches, with segments that start inside a round and groups
    longer and shorter than the pipeline's fill, give the plain version's
    scores thirty times in a row."""
    rng = np.random.default_rng(33)
    res, table, q, sm = _inputs(rng, [(3, 40), (2, 330), (3, 9)], 700,
                                "blosum62", cuda)
    qlens = [1, 17, 3, 200, 16, 16, 31, 2, 300, 5, 64, 45]
    starts = np.concatenate([[0], np.cumsum(qlens)[:-1]])
    segs = torch.tensor(list(zip(starts.tolist(), qlens)), dtype=torch.int32,
                        device=cuda)
    work = work_table(table, 1)
    want = sw_groups_ref(res, table, q, sm, 10, 2)
    want_p = sw_groups_packed_ref(res, table, q, segs, sm, 10, 2)
    scratch = torch.empty((2,) + tuple(res.shape), dtype=torch.int32,
                          device=cuda)
    for _ in range(30):
        got = sw_groups(res, table, q, sm, 10, 2, scratch, work)
        got_p = sw_groups_packed(res, table, q, segs, sm, 10, 2, scratch,
                                 work)
        assert torch.equal(got, want)
        assert torch.equal(got_p, want_p)


# A giant among short groups, as the release database's last group is among
# its 528 others: 80 groups of 96 columns (rows) and one of 2048 (slabs),
# whose slabs the card's share splits over clusters of 4 blocks
GIANT_SHAPES = [(80, 96), (1, 2048)]


def _giant_inputs(rng, m, matrix="blosum62"):
    args = _inputs(rng, GIANT_SHAPES, m, matrix, torch.device("cuda"))
    work = work_table(args[1], LONG_FROM)
    assert work.cluster == 4 and work.split_slabs == 32
    return args, work


@pytest.mark.parametrize("m,matrix,og,eg", [
    (5478, "blosum62", 10, 2), (144, "pam30", 9, 1)])
def test_split_kernel_matches_plain_version(cuda, m, matrix, og, eg):
    """The giant's slabs swept by clusters: equal to the plain version and
    to the same launch with nothing split, one cluster launch counted."""
    rng = np.random.default_rng(m)
    args, work = _giant_inputs(rng, m, matrix)
    before = (sw_lanes.cluster_launches, sw_lanes.split_slabs)
    got = sw_groups(*args, og, eg, work=work)
    torch.cuda.synchronize()
    assert (sw_lanes.cluster_launches, sw_lanes.split_slabs) == \
        (before[0] + 1, before[1] + 32)
    want = sw_groups_ref(*args, og, eg)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    plain = sw_groups(*args, og, eg, work=work.plain())
    assert sw_lanes.cluster_launches == before[0] + 1
    assert torch.equal(plain, got)


def test_split_packed_kernel_matches_plain_version(cuda):
    """A packed batch whose strips cross the blocks of the giant's
    clusters and wrap to set 0, with a caller's scratch of old values."""
    rng = np.random.default_rng(35)
    (res, table, _, sm), work = _giant_inputs(rng, 1)
    qlens = [1, 7, 16, 300, 33, 2 * STRIP_ROWS * SETS * 4, 5, 700]
    q = torch.from_numpy(_protein(rng, sum(qlens)).astype(np.int32)).to(cuda)
    starts = np.concatenate([[0], np.cumsum(qlens)[:-1]])
    segs = torch.tensor(list(zip(starts.tolist(), qlens)), dtype=torch.int32,
                        device=cuda)
    scratch = torch.full((2,) + tuple(res.shape), -7, dtype=torch.int32,
                         device=cuda)
    got = sw_groups_packed(res, table, q, segs, sm, 10, 2, scratch, work)
    want = sw_groups_packed_ref(res, table, q, segs, sm, 10, 2)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    plain = sw_groups_packed(res, table, q, segs, sm, 10, 2, scratch,
                             work.plain())
    assert torch.equal(plain, got)


@pytest.mark.parametrize("K", [2, 4, 8])
def test_split_hand_over_is_stable(cuda, K, monkeypatch):
    """The waits between the blocks of a cluster, like those between the
    warps of a block, fail in one lane, sometimes: thirty split launches of
    each kernel in a row, on a caller's scratch, equal the plain version,
    and so does the plain launch of the same table."""
    rng = np.random.default_rng(36 + K)
    res, table, q, sm = _inputs(rng, [(3, 40), (2, 330), (3, 9)], 700,
                                "blosum62", cuda)
    qlens = [1, 17, 3, 200, 16, 16, 31, 2, 300, 5, 64, 45]
    starts = np.concatenate([[0], np.cumsum(qlens)[:-1]])
    segs = torch.tensor(list(zip(starts.tolist(), qlens)), dtype=torch.int32,
                        device=cuda)
    # a card of as many block slots as split the 330-column slabs over K
    monkeypatch.setattr(sw_lanes, "card_blocks", lambda: 32 * 807 * K // 330)
    work = work_table(table, 1)
    assert work.cluster == K and work.split_slabs == 64
    want = sw_groups_ref(res, table, q, sm, 10, 2)
    want_p = sw_groups_packed_ref(res, table, q, segs, sm, 10, 2)
    scratch = torch.empty((2,) + tuple(res.shape), dtype=torch.int32,
                          device=cuda)
    for table_w in [work] * 30 + [work.plain()]:
        got = sw_groups(res, table, q, sm, 10, 2, scratch, table_w)
        got_p = sw_groups_packed(res, table, q, segs, sm, 10, 2, scratch,
                                 table_w)
        assert torch.equal(got, want)
        assert torch.equal(got_p, want_p)


def test_refused_split_launch_raises(cuda):
    """A split table's launch refused by the entry point (a scratch its
    copies cannot address) raises, and counts no launch."""
    rng = np.random.default_rng(37)
    args, work = _giant_inputs(rng, 60)
    before = (sw_lanes.launches, sw_lanes.cluster_launches)
    with pytest.raises(RuntimeError, match="sw_groups kernel launch failed"):
        sw_groups(*args, 10, 2, _misaligned_scratch(args[0], cuda), work)
    assert (sw_lanes.launches, sw_lanes.cluster_launches) == before


def test_cuda_host_stream_slice_with_giant_group(cuda):
    """A host_stream slice that holds a giant group splits its slabs, as
    the resident table does; every launch equals the resident engine's."""
    rng = np.random.default_rng(38)
    lengths = rng.integers(1, 120, size=30000)
    lengths[::1000] = 3000                   # one group of 30 giants
    seqs = [_protein(rng, int(n)) for n in lengths]
    db = pack_sequences(np.concatenate(seqs), lengths,
                        [f"s{i}" for i in range(len(seqs))])
    cfg = dict(top=9, batch_query_pack_rows=256)
    res = SearchEngine(db, SearchConfig(**cfg))
    hs = SearchEngine(db, SearchConfig(profile_mode="host_stream",
                                       host_stream_slice_mb=1, **cfg))
    assert res.state.work.cluster > 1
    giant = [sl for sl in hs._hs_slices if sl.work.split_slabs]
    assert len(hs._hs_slices) > 1 and giant
    queries = [_protein(rng, k) for k in (30, 300, 12, 1000)]
    for q in queries:
        before = sw_lanes.cluster_launches
        np.testing.assert_array_equal(hs.score_all(q).cpu().numpy(),
                                      res.score_all(q).cpu().numpy())
        assert sw_lanes.cluster_launches >= before + len(giant) + 1
    for a, b in zip(res.search_many(queries), hs.search_many(queries)):
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.seq_ids, b.seq_ids)


def test_max_active_clusters_hold_the_card(cuda):
    """The card holds clusters of every split size of both kernels."""
    for name in ("sw_groups", "sw_groups_packed"):
        for K in (2, 4, 8):
            assert sw_lanes.max_active_clusters(K, name) >= 1


def test_bad_work_table_rejected(cuda):
    rng = np.random.default_rng(32)
    args = _inputs(rng, [(1, 32)], 5, "blosum62", cuda)
    work = work_table(args[1])
    assert work.items.device == args[1].device
    with pytest.raises(ValueError, match="must be the WorkTable"):
        sw_groups(*args, 10, 2, work=work.items)
    with pytest.raises(ValueError, match="another group table"):
        sw_groups(*args, 10, 2, work=work_table(args[1].cpu()))
    with pytest.raises(ValueError, match="another group table"):
        sw_groups(*args, 10, 2, work=work_table(args[1].clone()))
    with pytest.raises(ValueError, match=r"int32\[N, 2\] on cuda"):
        WorkTable(work.items.cpu(), args[1])
    with pytest.raises(ValueError, match="no launch order of these 1 groups"):
        WorkTable(work.items[:-1].contiguous(), args[1])


def test_mixed_devices_rejected(cuda):
    rng = np.random.default_rng(3)
    args = _inputs(rng, [(1, 32)], 5, "blosum62", cuda)
    args[2] = args[2].cpu()
    with pytest.raises(ValueError, match="query is on cpu"):
        sw_groups(*args, 10, 2)


def test_cuda_engine_matches_cpu_engine(cuda):
    rng = np.random.default_rng(4)
    lengths = rng.integers(1, 400, size=2600)
    lengths[::700] = LONG_FROM + 100         # a bin of pipelined groups
    seqs = [_protein(rng, int(n)) for n in lengths]
    db = pack_sequences(np.concatenate(seqs), lengths,
                        [f"s{i}" for i in range(len(seqs))], bin_cost=1)
    cfg = SearchConfig(top=15, matrix="pam30", open_gap=7, extend_gap=1)
    cpu = SearchEngine(db, cfg, device="cpu")
    gpu = SearchEngine(db, cfg)
    assert gpu.device.type == "cuda"
    for qlen in (0, 1, 33, 250):
        q = _protein(rng, qlen)
        np.testing.assert_array_equal(cpu.score_all(q).numpy(),
                                      gpu.score_all(q).cpu().numpy())
        before = sw_lanes.launches
        a, b = cpu.search(q), gpu.search(q)
        assert sw_lanes.launches == before + 1
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.seq_ids, b.seq_ids)
        assert a.titles == b.titles
        if a.evalues is not None:
            # same int32 scores; the float32 moments are summed in another
            # order on the card
            np.testing.assert_allclose(np.log(b.evalues), np.log(a.evalues),
                                       rtol=1e-5, atol=1e-4)


def _packed_inputs(rng, shapes, qlens, matrix, device, pack_rows=1024, u=8):
    """(args of sw_groups_packed for every bin of the packing plan of
    random queries of `qlens`, or for one uniform layout when pack_rows is
    None)."""
    res, table, _, sm = _inputs(rng, shapes, 1, matrix, device)
    queries = [_protein(rng, n).astype(np.int32) for n in qlens]
    if pack_rows is None:
        m = qlens[0]
        layouts = [(np.concatenate(queries),
                    np.array([(i * m, m) for i in range(len(qlens))],
                             np.int32))]
    else:
        bins, rest = mixed_pack_plan(pack_rows, u, queries)
        assert not rest
        layouts = [(qp, plan_segments(idxs, smap, used, u, queries))
                   for idxs, qp, smap, used in bins]
    return [(res, table, torch.from_numpy(qp).to(device),
             torch.from_numpy(segs).to(device), sm)
            for qp, segs in layouts]


@pytest.mark.parametrize("qlens,pack_rows,matrix,og,eg", [
    ([65] * 8, None, "blosum62", 10, 2),               # uniform segments
    ([1, 16, 17, 32, 5], None, "pam30", 7, 1),         # ragged, packed tight
    ([100, 173, 254, 399, 311, 47, 128, 222], 1024, "blosum62", 10, 2),
    ([30, 0, 12, 64, 7], 256, "blosum62", 0, 0),       # an empty query
    ([5000, 4000, 3200, 900], 16384, "pam30", 7, 1),   # > 48 KB shared
])
def test_packed_kernel_matches_plain_version(cuda, qlens, pack_rows, matrix,
                                             og, eg):
    rng = np.random.default_rng(len(qlens) * 1000 + qlens[0])
    if pack_rows is None and len(set(qlens)) > 1:
        # segments of unequal length back to back in one q_packed
        res, table, _, sm = _inputs(rng, [(2, 32), (1, 224), (1, 96)], 1,
                                    matrix, cuda)
        q = _protein(rng, sum(qlens)).astype(np.int32)
        starts = np.concatenate([[0], np.cumsum(qlens)[:-1]])
        calls = [(res, table, torch.from_numpy(q).to(cuda),
                  torch.tensor(list(zip(starts.tolist(), qlens)),
                               dtype=torch.int32, device=cuda), sm)]
    else:
        calls = _packed_inputs(rng, [(2, 32), (1, 224), (1, 96)], qlens,
                               matrix, cuda, pack_rows)
    for res, table, qp, segs, sm in calls:
        before = sw_lanes.launches_packed
        got = sw_groups_packed(res, table, qp, segs, sm, og, eg)
        torch.cuda.synchronize()
        assert sw_lanes.launches_packed == before + 1
        assert tuple(got.shape) == (segs.shape[0], table.shape[0], 8, 128)
        want = sw_groups_packed_ref(res, table, qp, segs, sm, og, eg)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def test_packed_kernel_equals_single_query_kernel(cuda):
    """Each segment's scores are those of sw_groups on that query alone,
    with the engine's scratch shared by all segments."""
    rng = np.random.default_rng(11)
    (res, table, qp, segs, sm), = _packed_inputs(
        rng, [(3, 64), (2, 160)], [40, 90, 17], "blosum62", cuda)
    scratch = torch.empty((2,) + tuple(res.shape), dtype=torch.int32,
                          device=cuda)
    got = sw_groups_packed(res, table, qp, segs, sm, 10, 2, scratch)
    for s, (r0, n) in enumerate(segs.tolist()):
        alone = sw_groups(res, table, qp[r0:r0 + n].contiguous(), sm, 10, 2,
                          scratch)
        np.testing.assert_array_equal(got[s].cpu().numpy(),
                                      alone.cpu().numpy())


def test_refused_packed_launch_raises(cuda):
    """A scratch the kernel's 16-byte copies cannot address is refused at
    the launch; the wrapper raises and counts no launch.  60,000 packed
    rows are no reason to refuse."""
    rng = np.random.default_rng(12)
    res, table, _, sm = _inputs(rng, [(1, 32)], 1, "blosum62", cuda)
    qp = torch.from_numpy(_protein(rng, 60000).astype(np.int32)).to(cuda)
    segs = torch.tensor([[0, 30000], [30000, 30000]], dtype=torch.int32,
                        device=cuda)
    before = sw_lanes.launches_packed
    with pytest.raises(RuntimeError,
                       match="sw_groups_packed kernel launch failed"):
        sw_groups_packed(res, table, qp, segs, sm, 10, 2,
                         _misaligned_scratch(res, cuda))
    assert sw_lanes.launches_packed == before
    got = sw_groups_packed(res, table, qp, segs, sm, 10, 2)
    assert sw_lanes.launches_packed == before + 1
    want = sw_groups_packed_ref(res, table, qp, segs, sm, 10, 2)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def test_packed_mixed_devices_rejected(cuda):
    rng = np.random.default_rng(13)
    (res, table, qp, segs, sm), = _packed_inputs(
        rng, [(1, 32)], [9, 20], "blosum62", cuda)
    with pytest.raises(ValueError, match="segs is on cpu"):
        sw_groups_packed(res, table, qp, segs.cpu(), sm, 10, 2)


def test_cuda_search_many_matches_cpu(cuda):
    """Packed bins, a leftover query over the pack budget, batch=False and
    search_stream: the CUDA engine's results are the CPU engine's."""
    rng = np.random.default_rng(14)
    lengths = rng.integers(1, 400, size=2600)
    lengths[::900] = LONG_FROM + 50          # a bin of pipelined groups
    seqs = [_protein(rng, int(n)) for n in lengths]
    db = pack_sequences(np.concatenate(seqs), lengths,
                        [f"s{i}" for i in range(len(seqs))], bin_cost=1)
    cfg = SearchConfig(top=9, batch_query_pack_rows=256,
                       stream_readback_window=3)
    cpu = SearchEngine(db, cfg, device="cpu")
    gpu = SearchEngine(db, cfg)
    queries = [_protein(rng, n) for n in (30, 100, 0, 300, 64, 12, 200)]
    bins, rest = mixed_pack_plan(256, cfg.u_rows, queries)
    assert bins and rest
    want = cpu.search_many(queries)
    sw_lanes.launches = sw_lanes.launches_packed = 0
    got = gpu.search_many(queries)
    assert (sw_lanes.launches_packed, sw_lanes.launches) == \
        (len(bins), len(rest))
    runs = [got, gpu.search_many(queries, batch=False),
            gpu.search_stream(queries)]
    assert sw_lanes.launches == len(rest) + 2 * len(queries)
    for run in runs:
        for a, b in zip(want, run):
            np.testing.assert_array_equal(a.scores, b.scores)
            np.testing.assert_array_equal(a.seq_ids, b.seq_ids)
            assert a.titles == b.titles
            assert (a.evalues is None) == (b.evalues is None)
            if a.evalues is not None:
                np.testing.assert_allclose(np.log(b.evalues),
                                           np.log(a.evalues), rtol=1e-5,
                                           atol=1e-4)
    assert all(r.batch_n == len(queries) for r in got)


# the tiled plain version walks every column of every item in Python: a
# small table that still mixes rows (short groups) and slabs (from 40 on)
SMALL_ROLES = [(1, 5), (2, 32), (1, TILE_COLS * SETS - 3), (1, 45)]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_lab_kernel_matches_plain_versions(cuda, variant):
    """Every built (strip rows, placement) of the variant: the kernel equals
    sw_groups over tables that mix both roles (query lengths of one row, a
    partial strip and many rounds of the pipeline) and its own tiled plain
    version on a small mixed table."""
    for rows, ahead in sorted((u, a) for v, u, a in BUILT if v == variant):
        for shapes, long_from, m, matrix, og, eg in (
                (MIXED_ROLES, LONG_FROM, 1, "blosum62", 0, 0),
                (MIXED_ROLES, LONG_FROM, 65, "blosum62", 10, 2),
                (MIXED_ROLES, LONG_FROM, 4 * rows * SETS + 9, "pam30", 7, 1),
                (SMALL_ROLES, 40, 33, "blosum62", 11, 1)):
            rng = np.random.default_rng(m + rows)
            args = _inputs(rng, shapes, m, matrix, cuda)
            work = work_table(args[1], long_from)
            before = sw_lab.launches_lab
            got = sw_groups_lab(*args, og, eg, variant, None, ahead, work,
                                rows)
            torch.cuda.synchronize()
            assert sw_lab.launches_lab == before + 1
            want = sw_groups(*args, og, eg, work=work)
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          want.cpu().numpy())
            if shapes is SMALL_ROLES:
                host = [a.cpu() for a in args]
                tiled = sw_groups_lab_tiled_ref(
                    *host, og, eg, variant, work=work_table(host[1], 40),
                    strip_rows=rows)
                np.testing.assert_array_equal(got.cpu().numpy(),
                                              tiled.numpy())


def test_lab_kernel_long_query_and_scratch(cuda):
    """Queries beyond 48 KB of shared memory (the rows stay in global
    memory, strip by strip), with a caller's scratch: every built kernel
    equals sw_groups."""
    rng = np.random.default_rng(21)
    for shapes, m, matrix in (([(1, 64), (1, 160)], 13000, "pam30"),
                              ([(1, 32)], 60000, "blosum62")):
        res, table, q, sm = _inputs(rng, shapes, m, matrix, cuda)
        scratch = torch.empty((2,) + tuple(res.shape), dtype=torch.int32,
                              device=cuda)
        want = sw_groups(res, table, q, sm, 7, 1, scratch)
        for variant, rows, ahead in sorted(BUILT):
            got = sw_groups_lab(res, table, q, sm, 7, 1, variant, scratch,
                                ahead, strip_rows=rows)
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          want.cpu().numpy())


def test_lab_unknown_variant_and_refused_launch_raise(cuda):
    """An unknown variant and a kernel that is not built raise before any
    launch; a scratch the 16-byte copies cannot address is refused at the
    launch, and the wrapper raises and counts no launch."""
    rng = np.random.default_rng(22)
    args = _inputs(rng, [(1, 32)], 5, "blosum62", cuda)
    before = sw_lab.launches_lab
    with pytest.raises(ValueError, match="unknown variant"):
        sw_groups_lab(*args, 10, 2, "fast")
    with pytest.raises(ValueError, match="ks@8 is not built"):
        sw_groups_lab(*args, 10, 2, "ks", strip_rows=8)
    with pytest.raises(RuntimeError,
                       match="sw_groups_lab kernel launch failed"):
        sw_groups_lab(*args, 10, 2, "ks",
                      _misaligned_scratch(args[0], cuda))
    assert sw_lab.launches_lab == before


def _same_evalues(a, b):
    """float64 moments on the host against float32 ones on the card."""
    assert (a.evalues is None) == (b.evalues is None)
    if a.evalues is not None:
        np.testing.assert_allclose(b.evalues, a.evalues, rtol=1e-4)


@pytest.mark.parametrize("overlap", [True, False])
def test_cuda_host_stream_matches_resident(cuda, overlap):
    """host_stream on the card: several slices, a multi-span slice, one
    launch per slice and launch of the call; the full score surface, single
    searches, a batch with a leftover and a stream equal the resident
    engine's, several times in a row (buffers are reused)."""
    rng = np.random.default_rng(23)
    lengths = rng.integers(1, 300, size=19000)
    lengths[::6000] = LONG_FROM + 10         # a bin of pipelined groups
    seqs = [_protein(rng, int(n)) for n in lengths]
    db = pack_sequences(np.concatenate(seqs), lengths,
                        [f"s{i}" for i in range(len(seqs))])
    cfg = dict(top=9, batch_query_pack_rows=256)
    res = SearchEngine(db, SearchConfig(**cfg))
    hs = SearchEngine(db, SearchConfig(profile_mode="host_stream",
                                       host_stream_slice_mb=1,
                                       host_stream_overlap=overlap, **cfg))
    assert hs.mode == "host_stream" and hs.state is None
    n = len(hs._hs_slices)
    assert n > 2 and any(len(s.spans) > 1 for s in hs._hs_slices)
    np.testing.assert_array_equal(hs.ids_flat, res.ids_flat)
    queries = [_protein(rng, k) for k in (30, 100, 0, 300, 64, 12, 200)]
    for q in queries[:4] * 2:
        want = res.score_all(q)
        sw_lanes.launches = 0
        np.testing.assert_array_equal(hs.score_all(q).cpu().numpy(),
                                      want.cpu().numpy())
        assert sw_lanes.launches == n
        a, b = res.search(q), hs.search(q)
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.seq_ids, b.seq_ids)
        assert a.titles == b.titles
        _same_evalues(a, b)
    bins, rest = mixed_pack_plan(256, 8, queries)
    assert bins and rest
    want = res.search_many(queries)
    sw_lanes.launches = sw_lanes.launches_packed = 0
    got = hs.search_many(queries)
    assert (sw_lanes.launches_packed, sw_lanes.launches) == \
        (n * len(bins), n * len(rest))
    for run in (got, hs.search_many(queries), hs.search_stream(queries)):
        for a, b in zip(want, run):
            np.testing.assert_array_equal(a.scores, b.scores)
            np.testing.assert_array_equal(a.seq_ids, b.seq_ids)
            _same_evalues(a, b)
    assert all(r.batch_n == len(queries) for r in got)


def test_cuda_auto_mode_plans_from_the_card(cuda, capsys):
    rng = np.random.default_rng(24)
    lengths = rng.integers(1, 200, size=3000)
    db = pack_sequences(_protein(rng, int(lengths.sum())), lengths,
                        [f"s{i}" for i in range(len(lengths))])
    assert SearchEngine(db, SearchConfig()).mode == "precompute"
    assert "profile_mode=precompute" in capsys.readouterr().err
    eng = SearchEngine(db, SearchConfig(hbm_budget_bytes=1 << 20,
                                        host_stream_slice_mb=1))
    assert eng.mode == "host_stream"
    assert "profile_mode=host_stream" in capsys.readouterr().err
    q = _protein(rng, 40)
    want = SearchEngine(db, SearchConfig(profile_mode="stream")).search(q)
    got = eng.search(q)
    np.testing.assert_array_equal(want.scores, got.scores)
    np.testing.assert_array_equal(want.seq_ids, got.seq_ids)


def _small_db(rng, n=3000):
    lengths = rng.integers(1, 300, size=n)
    seqs = [_protein(rng, int(k)) for k in lengths]
    return pack_sequences(np.concatenate(seqs), lengths,
                          [f"s{i}" for i in range(n)]), seqs


def test_warmup_loads_engine_libraries_once(cuda, tmp_path, monkeypatch):
    """warmup builds and loads both engine kernels into the enabled
    directory; a second warmup in the same process builds nothing."""
    from oswald_tpu_torch.kernels import build
    from oswald_tpu_torch.utils import compile_cache
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    compile_cache.enable_compile_cache(str(tmp_path / "kernels"), quiet=True)
    db, _ = _small_db(np.random.default_rng(30))
    eng = SearchEngine(db, SearchConfig())
    build.build_logs.clear()
    before = (sw_lanes.launches, sw_lanes.launches_packed)
    lines = []
    assert eng.warmup(64, log=lines.append) == ["sw_groups",
                                                 "sw_groups_packed"]
    assert {"sw_groups", "sw_groups_packed"} <= set(build.build_logs)
    assert sw_lanes.launches > before[0]
    assert sw_lanes.launches_packed == before[1] + 1
    for name in ("sw_groups", "sw_groups_packed"):
        assert build.library_path(name).parent == tmp_path / "kernels"
        assert build.library_path(name).exists()
    assert len(lines) >= 3 and eng.metrics.count("warmup") == 1
    build.build_logs.clear()
    eng.warmup(64)
    assert not build.build_logs


def test_service_over_cuda_engine_matches_search_many(cuda):
    from oswald_tpu_torch.alphabet import decode
    from oswald_tpu_torch.serve import SearchService
    rng = np.random.default_rng(31)
    db, seqs = _small_db(rng)
    eng = SearchEngine(db, SearchConfig(top=5))
    service = SearchService(db, eng)
    try:
        queries = [seqs[3], seqs[70][:40], _protein(rng, 120)]
        out = service.search({"queries": [decode(q) for q in queries],
                              "titles": ["a", "b", "c"]})
    finally:
        service.close()
    want = eng.search_many(queries, ["a", "b", "c"])
    assert [r["query"] for r in out["results"]] == ["a", "b", "c"]
    for got, w in zip(out["results"], want):
        assert [h["score"] for h in got["hits"]] == w.scores.tolist()
        assert [h["id"] for h in got["hits"]] == w.seq_ids.tolist()
        assert [h["title"] for h in got["hits"]] == w.titles
    assert service.info()["backend"] == "cuda"
    assert service.n_dispatches == 1


def test_autotune_tiny_keeps_shipped_geometry(cuda):
    from oswald_tpu_torch.kernels import build
    from oswald_tpu_torch.tune import autotune
    shipped = build.BLOCKS_PER_SM
    out = autotune(m=16, groups=66, chunks=2, iters=1)
    assert build.BLOCKS_PER_SM == shipped
    assert out["device"] == torch.cuda.get_device_name(0)
    assert all("error" not in r for r in out["results"]), out["results"]
    assert {"blocks_per_sm": 4, "long_from": LONG_FROM} in [
        {k: r[k] for k in ("blocks_per_sm", "long_from")}
        for r in out["results"]]
    assert out["gcells"] > 0
