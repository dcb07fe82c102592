"""Inter-sequence Smith-Waterman over packed database groups.

`sw_groups` is the port of `oswald_tpu/kernels/sw_lanes.py::sw_chunk`
chained over every column chunk of every bin: for every lane of every group
it returns the int32 score-only affine-gap Smith-Waterman score of the
query against that lane's subject, in one call.  On a CUDA tensor it
launches the hand-written kernel `csrc/sw_groups.cu` (design notes there);
on a CPU tensor it computes what `sw_groups_ref`, the plain PyTorch version
with the same signature, computes, over the lanes that hold a residue only
(`_sw_lanes_live`).

Inputs (all on one device, contiguous):
  residues  int8[C, 8, 128]     packed columns of every group, back to back
  groups    int32[G, 2]         (first column, L) of each group
  query     int32[m], m >= 1    codes 0..23 (checked by the caller)
  submat    int32[24, 24]
  scratch   int32[2, C, 8, 128] kernel scratch (CUDA only; allocated per
                                call when None)
Gap cost is open_gap + k * extend_gap.  Returns int32[G, 8, 128].

`work` (optional, both functions) is the launch's `WorkTable` from
`work_table(groups)`: the items (group, part) in launch order, bound to the
`groups` tensor they were built for; any other pairing is refused.  Without
it the wrapper takes `work_table(groups)`, which is built once for a tensor
and kept on it.  The plain versions ignore it.

`sw_groups_packed` is the port of `sw_chunk` with `q_segs > 1` and with
`seg_map`: several independent queries packed along the rows and scored in
one call.  It takes `q_packed int32[m_tot]` (the packed rows) and
`segs int32[S, 2]` ((first row, row count) of each query in `q_packed`, on
the same device) in place of `query`, and returns int32[S, G, 8, 128].  On
a CUDA tensor it launches `csrc/sw_groups_packed.cu`; on a CPU tensor it
runs the CPU branch of `sw_groups` on each segment, as
`sw_groups_packed_ref` runs `sw_groups_ref`.

`sw_groups_tiled_ref` and `sw_groups_packed_tiled_ref` are plain PyTorch too,
but carry out the kernels' own decomposition (`csrc/sw_tile.cuh`): the items
of the work table in order, strips of STRIP_ROWS rows dealt to the sets of an
item, column tiles of TILE_COLS, H and F handed from strip to strip and tile
to tile, the sets' maxima merged at the end.  They exist so that the algebra
of the hand-over is tested where there is no card.
"""

import weakref

import numpy as np
import torch

from oswald_tpu_torch.alphabet import DUMMY
from oswald_tpu_torch.kernels import build

GROUP_SHAPE = (8, 128)
ALPHA_SIZE = 24
# the kernels' geometry (csrc/sw_cell.cuh, csrc/sw_tile.cuh)
STRIP_ROWS = 16       # U: query rows of one strip
TILE_COLS = 8         # T: columns of one staged tile
SETS = 4              # W: warps of a block; sets of a long item's pipeline
ROWS_PER_GROUP = GROUP_SHAPE[0]
SLABS_PER_GROUP = ROWS_PER_GROUP * SETS     # 32-lane slabs of a group
# groups of at least this many columns are dealt out as 32-lane slabs whose
# strips the four warps pipeline (the long role); shorter ones as 128-lane
# rows.  Measured over a SwissProt-sized database (NVIDIA H100 80GB HBM3,
# 700.00 W; `python -m oswald_tpu_torch.lab --long-from ...`): sw_groups at
# 512 rows takes 38.63 / 39.02 / 40.11 ms from 512 / 1024 / 2048 columns on,
# sw_groups_packed at 2 x 512 rows 80.51 / 80.09 / 81.16 ms, at 8 x 65 rows
# 49.17 / 48.50 / 48.35 ms: flat.  An earlier build of the same design took
# 55.0 ms from 1024 on, 54.8 from 4096 on (packed 2 x 512: 101.0 against
# 121.3) and 76.9 ms with no group pipelined (packed: 190.8).
LONG_FROM = 1024


def card_blocks() -> int:
    """The blocks an H100 holds at once: 132 SMs times the blocks per SM
    the kernels are built for (`build.BLOCKS_PER_SM`, read now: a tuner or
    a flag may change it before the first library loads)."""
    return 132 * build.BLOCKS_PER_SM


def __getattr__(name):
    # CARD_BLOCKS is card_blocks() at the time it is read
    if name == "CARD_BLOCKS":
        return card_blocks()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def fill_long_from(n_groups: int, long_from: int = LONG_FROM) -> int:
    """The long-role threshold for a table of n_groups: `long_from` when
    its rows fill the card (card_blocks() row items or more), else 0.  A
    table of fewer row items leaves the card partly idle, so all of its
    groups are pipelined: four times the blocks, each with a quarter of the
    critical path."""
    return long_from if ROWS_PER_GROUP * n_groups >= card_blocks() else 0


# kernel launches made by sw_groups in this process (the wrapper adds one
# per launch and nowhere else; callers reset it to count a run's launches)
launches = 0
# the same for sw_groups_packed
launches_packed = 0


def _check(residues, groups, query, submat, scratch, segs=None, work=None):
    dev = residues.device
    named = {"residues": (residues, torch.int8),
             "groups": (groups, torch.int32),
             "query": (query, torch.int32),
             "submat": (submat, torch.int32)}
    if scratch is not None:
        named["scratch"] = (scratch, torch.int32)
    if segs is not None:
        named["segs"] = (segs, torch.int32)
    for name, (t, dtype) in named.items():
        if t.device != dev:
            raise ValueError(f"sw_groups: {name} is on {t.device}, "
                             f"residues on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"sw_groups: {name} must be {dtype}, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"sw_groups: {name} must be contiguous")
    if segs is not None and (segs.dim() != 2 or segs.shape[1] != 2 or
                             segs.shape[0] < 1):
        raise ValueError(f"sw_groups: segs must be [S, 2] with S >= 1, got "
                         f"{tuple(segs.shape)}")
    if residues.dim() != 3 or tuple(residues.shape[1:]) != GROUP_SHAPE:
        raise ValueError(f"sw_groups: residues must be [C, 8, 128], got "
                         f"{tuple(residues.shape)}")
    if groups.dim() != 2 or groups.shape[1] != 2:
        raise ValueError(f"sw_groups: groups must be [G, 2], got "
                         f"{tuple(groups.shape)}")
    if query.dim() != 1 or query.numel() < 1:
        raise ValueError(f"sw_groups: query must be 1-D and non-empty, got "
                         f"{tuple(query.shape)}")
    if tuple(submat.shape) != (ALPHA_SIZE, ALPHA_SIZE):
        raise ValueError(f"sw_groups: submat must be [24, 24], got "
                         f"{tuple(submat.shape)}")
    if work is not None:
        if not isinstance(work, WorkTable):
            raise ValueError(f"sw_groups: work must be the WorkTable of "
                             f"work_table(groups), got {type(work).__name__}")
        if not work.is_for(groups):
            raise ValueError("sw_groups: work was built for another group "
                             "table, or groups was written since")
    if scratch is not None and tuple(scratch.shape) != (2,) + tuple(
            residues.shape):
        raise ValueError(f"sw_groups: scratch must be [2, C, 8, 128], got "
                         f"{tuple(scratch.shape)}")


class WorkTable:
    """The launch order of one group table, bound to it.

    `items` is int32[N, 2] on the groups' device: (group, part) in launch
    order.  A group dealt out as rows has the 8 parts 0..7, a pipelined one
    the 32 parts 8..39.  The kernels index the group table and the scores
    with these items unchecked, so the constructor holds them to the table
    (every group exactly once, in one role; this copies `items` to the host)
    and `is_for` lets only that `groups` tensor, unwritten since, launch
    with them."""

    def __init__(self, items, groups):
        n = groups.shape[0]
        if items.dtype != torch.int32 or items.dim() != 2 or \
                items.shape[1] != 2 or not items.is_contiguous() or \
                items.device != groups.device:
            raise ValueError(f"sw_groups: work items must be contiguous "
                             f"int32[N, 2] on {groups.device}, got "
                             f"{items.dtype}{list(items.shape)} on "
                             f"{items.device}")
        it = items.cpu().numpy()
        it = it[np.lexsort((it[:, 1], it[:, 0]))]
        ok = len(it) == 0 and n == 0
        if len(it) and 0 <= it[0, 0] and it[-1, 0] < n:
            counts = np.bincount(it[:, 0], minlength=n)
            piped = counts == SLABS_PER_GROUP
            first = np.cumsum(counts) - counts
            want = np.arange(len(it)) - np.repeat(first, counts) + \
                np.repeat(np.where(piped, ROWS_PER_GROUP, 0), counts)
            ok = bool(((counts == ROWS_PER_GROUP) | piped).all()) and \
                np.array_equal(it[:, 1], want)
        if not ok:
            raise ValueError(f"sw_groups: work items are no launch order of "
                             f"these {n} groups: every group needs its parts "
                             f"0..7 or 8..39 exactly once")
        self.items = items
        self._groups = weakref.ref(groups)
        self._version = groups._version

    def __len__(self):
        return self.items.shape[0]

    def is_for(self, groups) -> bool:
        return self._groups() is groups and self._version == groups._version


def work_table(groups, long_from: int = None, host=None) -> WorkTable:
    """The launch order of a group table: a WorkTable whose items (group,
    part) are sorted by descending cost, equal costs in (group, part) order.

    A group of fewer than `long_from` columns gives 8 items, part = its
    128-lane row 0..7, each of cost 4 L; a longer one 32 items, part = 8 +
    its 32-lane slab 0..31, each of cost L (four warps share the strips of
    one slab).  By default `long_from` is `fill_long_from(G)`: LONG_FROM for
    a table whose rows fill the card and 0 for a smaller one, so a single
    group, or a small slice of a streamed database, is pipelined whatever
    its length.  The cost of an item is its block's
    critical path in columns per strip, the same for every query, so one
    table serves both kernels and every launch on `groups`.

    groups: int32[G, 2] (first column, L), a tensor (an array becomes a CPU
    tensor); the items go to its device.  The table is built on the host,
    from `host` (an array or CPU tensor equal to `groups`) where the caller
    has one, else from a copy of `groups`, which synchronises a CUDA device.
    The default table (`long_from` None) is kept on the tensor and returned
    again until the tensor is written."""
    if not isinstance(groups, torch.Tensor):
        groups = torch.from_numpy(np.ascontiguousarray(groups, np.int32))
    kept = getattr(groups, "_sw_work_table", None)
    if long_from is None and kept is not None and kept.is_for(groups):
        return kept
    table = np.asarray(host if host is not None else groups.cpu())
    L = table.reshape(-1, 2)[:, 1].astype(np.int64)
    default = long_from is None
    if default:
        long_from = fill_long_from(len(L))
    is_long = L >= long_from
    n_parts = np.where(is_long, SLABS_PER_GROUP, ROWS_PER_GROUP)
    g = np.repeat(np.arange(len(L)), n_parts)
    first = np.cumsum(n_parts) - n_parts
    part = np.arange(len(g)) - np.repeat(first, n_parts) + \
        np.where(is_long, ROWS_PER_GROUP, 0)[g]
    cost = np.where(is_long, L, SETS * L)[g]
    order = np.argsort(-cost, kind="stable")
    items = np.stack([g[order], part[order]], axis=1).astype(np.int32)
    work = WorkTable(torch.from_numpy(items).to(groups.device), groups)
    if default:
        groups._sw_work_table = work
    return work


def _launch(name, residues, groups, rows, segs, submat, open_gap,
            extend_gap, scratch, work, extra=()):
    """Launch kernel `name` on tensors that passed _check, with the ints
    `extra` after the stream.  Returns (int32[S, G, 8, 128], whether a
    kernel was launched: an empty table launches nothing)."""
    dev = residues.device
    if dev.type != "cuda":
        raise ValueError(f"sw_groups: no kernel for device {dev}")
    n = groups.shape[0]
    n_segs = 1 if segs is None else segs.shape[0]
    # zeroed: the sets of a long item merge their maxima into it
    out = torch.zeros((n_segs, n) + GROUP_SHAPE, dtype=torch.int32,
                      device=dev)
    if n == 0:
        return out, False
    if work is None:
        work = work_table(groups)
    if scratch is None:
        scratch = torch.empty((2,) + tuple(residues.shape),
                              dtype=torch.int32, device=dev)
    lib = build.load(name)
    query_args = (rows.data_ptr(), rows.numel()) if segs is None else \
        (rows.data_ptr(), rows.numel(), segs.data_ptr(), n_segs)
    with torch.cuda.device(dev):
        err = getattr(lib, f"{name}_launch")(
            residues.data_ptr(), groups.data_ptr(), n, work.items.data_ptr(),
            len(work), *query_args, submat.data_ptr(), int(open_gap),
            int(extend_gap), scratch[0].data_ptr(), scratch[1].data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream, *extra)
    build.check(lib, name, err)
    return out, True


def sw_groups(residues, groups, query, submat, open_gap: int,
              extend_gap: int, scratch=None, work=None):
    """Scores of `query` against every lane of every group (see module)."""
    global launches
    _check(residues, groups, query, submat, scratch, work=work)
    if residues.device.type == "cpu":
        return score_groups_by_length(
            residues, groups, lambda cols: _sw_lanes_live(
                cols, query, submat, open_gap, extend_gap))
    out, launched = _launch("sw_groups", residues, groups, query, None,
                            submat, open_gap, extend_gap, scratch, work)
    launches += launched
    return out[0]


def sw_groups_packed(residues, groups, q_packed, segs, submat,
                     open_gap: int, extend_gap: int, scratch=None,
                     work=None):
    """Scores of every segment of `q_packed` against every lane of every
    group (see module): int32[S, G, 8, 128]."""
    global launches_packed
    _check(residues, groups, q_packed, submat, scratch, segs, work)
    if residues.device.type == "cpu":
        return torch.stack([sw_groups(residues, groups, q_packed[r0:r0 + n],
                                      submat, open_gap, extend_gap)
                            for r0, n in _segments(q_packed, segs)])
    out, launched = _launch("sw_groups_packed", residues, groups,
                            q_packed, segs, submat, open_gap, extend_gap,
                            scratch, work)
    launches_packed += launched
    return out


def sw_lanes_ref(cols, query, submat, open_gap: int, extend_gap: int):
    """Plain PyTorch scores of `query` against many subjects at once.

    cols: int[L, lanes] subject residues column by column (DUMMY-padded);
    returns int32[lanes].  A loop over the L columns, vectorised over
    [lanes, m], with the classical Gotoh E update:
      E    = max(H_prev - oe, E_prev - e)
      cur' = max(0, diag + s, E)
      F[i] = max_{k<i}(cur'[k] - oe - (i-1-k) e)
           = max_{k<i}(cur'[k] - oe + (k+1) e) - i e   (one cummax; oe >= e)
      H    = max(cur', F)
    and the score the maximum of cur' (F never exceeds an earlier cur' of
    its column).
    """
    dev = cols.device
    lanes = cols.shape[1]
    q = query.to(device=dev, dtype=torch.long)
    m = q.numel()
    prof = submat.to(device=dev, dtype=torch.int32)[q].T.contiguous()
    oe, e = int(open_gap) + int(extend_gap), int(extend_gap)
    rows = torch.arange(m, device=dev, dtype=torch.int32)
    bias = (rows + 1) * e - oe
    drop = rows * e
    # F at row 0 has no cell above it: any value <= 0 is inert
    floor = torch.full((lanes, 1), -oe, dtype=torch.int32, device=dev)
    zero = torch.zeros((lanes, 1), dtype=torch.int32, device=dev)
    H = torch.zeros((lanes, m), dtype=torch.int32, device=dev)
    E = torch.zeros_like(H)
    best = torch.zeros(lanes, dtype=torch.int32, device=dev)
    cols = cols.to(torch.long)
    for j in range(cols.shape[0]):
        diag = torch.cat([zero, H[:, :-1]], dim=1)
        E = torch.maximum(H - oe, E - e)
        cur = torch.maximum((diag + prof[cols[j]]).clamp_min(0), E)
        run = torch.cummax(cur + bias, dim=1).values
        F = torch.cat([floor, run[:, :-1]], dim=1) - drop
        H = torch.maximum(cur, F)
        best = torch.maximum(best, cur.amax(dim=1))
    return best


def _sw_lanes_live(cols, query, submat, open_gap: int, extend_gap: int):
    """`sw_lanes_ref` over the lanes that hold a residue.  A lane of DUMMY
    alone (a group's padding) scores 0 where DUMMY scores 0 against every
    query residue and neither gap cost is negative: no cell of it can rise
    above 0.  The CPU branch of the wrappers scores so, and a small
    database costs its real lanes only; `sw_lanes_ref`, the plain version
    the kernels are held to, stays one path."""
    sm = submat.to(device=cols.device, dtype=torch.int32)
    q = query.to(device=cols.device, dtype=torch.long)
    if min(open_gap + extend_gap, extend_gap) >= 0 and \
            not sm[q, DUMMY].any():
        live = (cols != DUMMY).any(dim=0)
        if not live.all():
            best = torch.zeros(cols.shape[1], dtype=torch.int32,
                               device=cols.device)
            if live.any():
                best[live] = sw_lanes_ref(cols[:, live], query, submat,
                                          open_gap, extend_gap)
            return best
    return sw_lanes_ref(cols, query, submat, open_gap, extend_gap)


def score_groups_by_length(residues, groups, score_cols):
    """int32[G, 8, 128] scores of every group of the table, from
    `score_cols(cols)`, which maps int8[L, lanes] subject columns to
    int32[lanes] scores.  Groups of equal L run as one batch of lanes."""
    dev = residues.device
    n = groups.shape[0]
    out = torch.zeros((n,) + GROUP_SHAPE, dtype=torch.int32, device=dev)
    by_len = {}
    for g, (c0, L) in enumerate(groups.tolist()):
        if c0 < 0 or L < 0 or c0 + L > residues.shape[0]:
            raise ValueError(f"sw_groups: group {g} (column {c0}, length "
                             f"{L}) lies outside the {residues.shape[0]} "
                             f"residue columns")
        by_len.setdefault(L, []).append((g, c0))
    lanes = GROUP_SHAPE[0] * GROUP_SHAPE[1]
    for L, items in by_len.items():
        if L == 0:
            continue
        idx = torch.tensor([g for g, _ in items], device=dev)
        c0 = torch.tensor([c for _, c in items], device=dev)
        cols = c0[:, None] + torch.arange(L, device=dev)        # [n, L]
        sub = residues[cols].reshape(len(items), L, lanes)
        sub = sub.permute(1, 0, 2).reshape(L, len(items) * lanes)
        out[idx] = score_cols(sub).reshape((len(items),) + GROUP_SHAPE)
    return out


def sw_groups_ref(residues, groups, query, submat, open_gap: int,
                  extend_gap: int, scratch=None):
    """Plain PyTorch version of `sw_groups`; `scratch` is ignored."""
    _check(residues, groups, query, submat, scratch)
    return score_groups_by_length(
        residues, groups,
        lambda cols: sw_lanes_ref(cols, query, submat, open_gap, extend_gap))


def sw_groups_packed_ref(residues, groups, q_packed, segs, submat,
                         open_gap: int, extend_gap: int, scratch=None):
    """Plain PyTorch version of `sw_groups_packed`: `sw_groups_ref` on each
    segment's rows in turn; `scratch` is ignored."""
    _check(residues, groups, q_packed, submat, scratch, segs)
    return torch.stack([sw_groups_ref(residues, groups, q_packed[r0:r0 + n],
                                      submat, open_gap, extend_gap)
                        for r0, n in _segments(q_packed, segs)])


def _segments(q_packed, segs):
    """(first row, row count) of each segment, each checked to lie inside
    `q_packed`."""
    out = segs.tolist()
    for s, (r0, n) in enumerate(out):
        if r0 < 0 or n < 1 or r0 + n > q_packed.numel():
            raise ValueError(f"sw_groups: segment {s} (row {r0}, {n} rows) "
                             f"lies outside the {q_packed.numel()} packed "
                             f"rows")
    return out


def _engine_step(diag, s, ee, f_in, oe, e, bias):
    """One column of a strip, every row at once, as the engine kernels
    compute it.  diag, s, ee: int32[lanes, U] (H[.][j - 1] shifted down a
    row, the scores, E[.][j]); f_in: int32[lanes], F entering the first row;
    bias: (1..U) * e.  Returns (H, E[.][j + 1], the F leaving the last row,
    the values the score is taken over).  cur' = max(diag + s, 0, E),
    H = max(cur', F), E' = max(E - e, cur' - oe), F down the rows as a
    running maximum: with a[u] = F[u] + u e, F[u] = max(F[u - 1] - e,
    c[u - 1]) is a running maximum of {f_in, c[u - 1] + u e}."""
    cp = torch.maximum((diag + s).clamp_min(0), ee)
    c = cp - oe
    run = torch.cummax(torch.cat([f_in[:, None], c + bias], dim=1),
                       dim=1).values
    F = run[:, :-1] - (bias - e)
    return torch.maximum(cp, F), torch.maximum(ee - e, c), \
        run[:, -1] - bias[-1], cp


def _strip_columns(cols, prof, h_in, f_in, oe, e, state, step=_engine_step):
    """One strip over the columns of one tile.  cols: long[n, lanes]; prof:
    int32[24, U] scores of the strip's rows; h_in, f_in: int32[n, lanes], H
    of the row above the strip and F entering it; state: [hl, ee, hprev,
    best] carried from the tile before, updated in place.  Returns (H of the
    strip's last row, F leaving it), each int32[n, lanes].  `step` is the
    column update (see _engine_step)."""
    hl, ee, hprev, best = state
    bias = torch.arange(1, prof.shape[1] + 1, dtype=torch.int32) * e
    h_out, f_out = [], []
    for j in range(cols.shape[0]):
        diag = torch.cat([hprev[:, None], hl[:, :-1]], dim=1)
        hl, ee, f, over = step(diag, prof[cols[j]], ee, f_in[j], oe, e, bias)
        best = torch.maximum(best, over.amax(dim=1))
        hprev = h_in[j]
        h_out.append(hl[:, -1])
        f_out.append(f)
    state[:] = [hl, ee, hprev, best]
    return torch.stack(h_out), torch.stack(f_out)


def _tiled_ref(residues, groups, q_packed, segs, submat, open_gap, extend_gap,
               work, strip_rows, tile_cols, step):
    """int32[S, G, 8, 128] by the kernels' decomposition (see module), with
    strips of `strip_rows` rows, tiles of `tile_cols` columns and the column
    update `step` (see _engine_step).  CPU tensors that passed _check."""
    if work is None:
        work = work_table(groups)
    U, T = int(strip_rows), int(tile_cols)
    oe, e = int(open_gap) + int(extend_gap), int(extend_gap)
    n_segs, n_groups = segs.shape[0], groups.shape[0]
    lanes_g = GROUP_SHAPE[0] * GROUP_SHAPE[1]
    slab = lanes_g // SLABS_PER_GROUP
    out = torch.zeros((n_segs, n_groups, lanes_g), dtype=torch.int32)
    # score rows of the matrix, with a row of zeros for a strip's padding
    sm = torch.cat([submat.to(torch.int32),
                    torch.zeros((1, ALPHA_SIZE), dtype=torch.int32)])
    q = q_packed.to(torch.long)
    table, seg_list = groups.tolist(), segs.tolist()
    for g, part in work.items.tolist():
        c0, L = table[g]
        if part < ROWS_PER_GROUP:
            lo, n_lanes, sets = part * SETS * slab, SETS * slab, 1
        else:
            lo, n_lanes, sets = (part - ROWS_PER_GROUP) * slab, slab, SETS
        cols = residues[c0:c0 + L].reshape(L, lanes_g)[:, lo:lo + n_lanes]
        cols = cols.to(torch.long)
        zero = torch.zeros(n_lanes, dtype=torch.int32)
        # the hand-over rows: the ring or the scratch, column by column
        hrow = torch.zeros((L, n_lanes), dtype=torch.int32)
        frow = torch.zeros_like(hrow)
        k = 0                                    # strips so far, all segments
        for s, (r0, n) in enumerate(seg_list):
            r0 = min(max(r0, 0), q.numel())
            n = min(max(n, 0), q.numel() - r0)
            best = [zero] * sets                 # one maximum per set
            n_strips = -(-n // U)
            for t in range(n_strips):
                rows = q[r0 + t * U: r0 + min(n, (t + 1) * U)]
                rows = torch.cat([rows, torch.full((U - len(rows),),
                                                   ALPHA_SIZE)])
                prof = sm[rows].T.contiguous()               # [24, U]
                state = [torch.zeros((n_lanes, U), dtype=torch.int32),
                         torch.zeros((n_lanes, U), dtype=torch.int32),
                         zero, best[k % sets]]
                first, last = t == 0, t == n_strips - 1
                for j0 in range(0, L, T):
                    j1 = min(j0 + T, L)
                    h_in = torch.zeros_like(hrow[j0:j1]) if first else \
                        hrow[j0:j1].clone()
                    f_in = torch.zeros_like(h_in) if first else \
                        frow[j0:j1].clone()
                    h_out, f_out = _strip_columns(cols[j0:j1], prof, h_in,
                                                  f_in, oe, e, state, step)
                    if not last:
                        hrow[j0:j1], frow[j0:j1] = h_out, f_out
                best[k % sets] = state[3]
                k += 1
            merged = torch.stack(best).amax(dim=0)
            out[s, g, lo:lo + n_lanes] = torch.maximum(
                out[s, g, lo:lo + n_lanes], merged)
    return out.reshape((n_segs, n_groups) + GROUP_SHAPE)


def sw_groups_packed_tiled_ref(residues, groups, q_packed, segs, submat,
                               open_gap: int, extend_gap: int, scratch=None,
                               work=None, tile_cols: int = TILE_COLS):
    """Plain PyTorch version of `sw_groups_packed` by the kernel's own
    decomposition (see module); `scratch` is ignored.  CPU tensors."""
    _check(residues, groups, q_packed, submat, scratch, segs, work)
    return _tiled_ref(residues, groups, q_packed, segs, submat, open_gap,
                      extend_gap, work, STRIP_ROWS, tile_cols, _engine_step)


def sw_groups_tiled_ref(residues, groups, query, submat, open_gap: int,
                        extend_gap: int, scratch=None, work=None,
                        tile_cols: int = TILE_COLS):
    """Plain PyTorch version of `sw_groups` by the kernel's own
    decomposition: `sw_groups_packed_tiled_ref` with one segment."""
    segs = torch.tensor([[0, query.numel()]], dtype=torch.int32)
    return sw_groups_packed_tiled_ref(residues, groups, query, segs, submat,
                                      open_gap, extend_gap, scratch, work,
                                      tile_cols)[0]
