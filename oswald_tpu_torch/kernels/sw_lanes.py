"""Inter-sequence Smith-Waterman over packed database groups.

`sw_groups` is the port of `oswald_tpu/kernels/sw_lanes.py::sw_chunk`
chained over every column chunk of every bin: for every lane of every group
it returns the int32 score-only affine-gap Smith-Waterman score of the
query against that lane's subject, in one call.  On a CUDA tensor it
launches the hand-written kernel `csrc/sw_groups.cu` (design notes there);
on a CPU tensor it runs `sw_groups_ref`, the plain PyTorch version with the
same signature.

Inputs (all on one device, contiguous):
  residues  int8[C, 8, 128]     packed columns of every group, back to back
  groups    int32[G, 2]         (first column, L) of each group
  query     int32[m], m >= 1    codes 0..23 (checked by the caller)
  submat    int32[24, 24]
  scratch   int32[2, C, 8, 128] kernel scratch (CUDA only; allocated per
                                call when None)
Gap cost is open_gap + k * extend_gap.  Returns int32[G, 8, 128].

`sw_groups_packed` is the port of `sw_chunk` with `q_segs > 1` and with
`seg_map`: several independent queries packed along the rows and scored in
one call.  It takes `q_packed int32[m_tot]` (the packed rows) and
`segs int32[S, 2]` ((first row, row count) of each query in `q_packed`, on
the same device) in place of `query`, and returns int32[S, G, 8, 128].  On
a CUDA tensor it launches `csrc/sw_groups_packed.cu`; on a CPU tensor it
runs `sw_groups_packed_ref`.
"""

import torch

from oswald_tpu_torch.kernels import build

GROUP_SHAPE = (8, 128)
ALPHA_SIZE = 24

# kernel launches made by sw_groups in this process (the wrapper adds one
# per launch and nowhere else; callers reset it to count a run's launches)
launches = 0
# the same for sw_groups_packed
launches_packed = 0


def _check(residues, groups, query, submat, scratch, segs=None):
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
    if scratch is not None and tuple(scratch.shape) != (2,) + tuple(
            residues.shape):
        raise ValueError(f"sw_groups: scratch must be [2, C, 8, 128], got "
                         f"{tuple(scratch.shape)}")


def sw_groups(residues, groups, query, submat, open_gap: int,
              extend_gap: int, scratch=None):
    """Scores of `query` against every lane of every group (see module)."""
    global launches
    _check(residues, groups, query, submat, scratch)
    if residues.device.type == "cpu":
        return sw_groups_ref(residues, groups, query, submat, open_gap,
                             extend_gap, scratch)
    if residues.device.type != "cuda":
        raise ValueError(f"sw_groups: no kernel for device "
                         f"{residues.device}")
    dev = residues.device
    n = groups.shape[0]
    out = torch.empty((n,) + GROUP_SHAPE, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    if scratch is None:
        scratch = torch.empty((2,) + tuple(residues.shape),
                              dtype=torch.int32, device=dev)
    lib = build.load("sw_groups")
    with torch.cuda.device(dev):
        err = lib.sw_groups_launch(
            residues.data_ptr(), groups.data_ptr(), n, query.data_ptr(),
            query.numel(), submat.data_ptr(), int(open_gap),
            int(extend_gap), scratch[0].data_ptr(), scratch[1].data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, "sw_groups", err)
    launches += 1
    return out


def sw_groups_packed(residues, groups, q_packed, segs, submat,
                     open_gap: int, extend_gap: int, scratch=None):
    """Scores of every segment of `q_packed` against every lane of every
    group (see module): int32[S, G, 8, 128]."""
    global launches_packed
    _check(residues, groups, q_packed, submat, scratch, segs)
    if residues.device.type == "cpu":
        return sw_groups_packed_ref(residues, groups, q_packed, segs, submat,
                                    open_gap, extend_gap, scratch)
    if residues.device.type != "cuda":
        raise ValueError(f"sw_groups: no kernel for device "
                         f"{residues.device}")
    dev = residues.device
    n, n_segs = groups.shape[0], segs.shape[0]
    out = torch.empty((n_segs, n) + GROUP_SHAPE, dtype=torch.int32,
                      device=dev)
    if n == 0:
        return out
    if scratch is None:
        scratch = torch.empty((2,) + tuple(residues.shape),
                              dtype=torch.int32, device=dev)
    lib = build.load("sw_groups_packed")
    with torch.cuda.device(dev):
        err = lib.sw_groups_packed_launch(
            residues.data_ptr(), groups.data_ptr(), n, q_packed.data_ptr(),
            q_packed.numel(), segs.data_ptr(), n_segs, submat.data_ptr(),
            int(open_gap), int(extend_gap), scratch[0].data_ptr(),
            scratch[1].data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, "sw_groups_packed", err)
    launches_packed += 1
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
    out = []
    for s, (r0, n) in enumerate(segs.tolist()):
        if r0 < 0 or n < 1 or r0 + n > q_packed.numel():
            raise ValueError(f"sw_groups: segment {s} (row {r0}, {n} rows) "
                             f"lies outside the {q_packed.numel()} packed "
                             f"rows")
        out.append(sw_groups_ref(residues, groups, q_packed[r0:r0 + n],
                                 submat, open_gap, extend_gap))
    return torch.stack(out)
