"""The kernel lab: `sw_groups` with the column body chosen by `variant`.

`sw_groups_lab` is the port of `scripts/kernel_lab.py::sw_chunk_lab` chained
over a bin (its `_scan_bin`): the int32 score of the query against every
lane of every group, which every variant must give equal to `sw_groups`'.
The kernel (`csrc/sw_groups_lab.cu`) is the engine's tiled sweep
(`csrc/sw_tile.cuh`) with three choices where the engine has constants:
- the column body: exact rewrites of one recurrence that order the work
  inside a column of U query rows differently (`csrc/sw_cell_lab.cuh`
  describes each): `base` (the engine's own one-chain body), `fscan`,
  `pmax`, `noadj`, `ks`, `pre`, and `dpx` (`noadj` in Hopper's fused
  add-max instructions);
- `strip_rows`, the strip height U: the JAX lab's `u_rows`.  Its
  `group_block` and `col_unroll` set the TPU's schedule (grid blocks of
  groups, unrolled column loops) and have no counterpart on this card;
- `load_ahead`: a column's shared-memory reads (residue, H, F) one column
  ahead of its chain, or where they are used.
`base` with the reads ahead at U = 16 is `sw_groups` itself.  BUILT lists
the (variant, strip_rows, load_ahead) triples the kernel library holds; the
wrapper refuses any other, on every device.  On a CUDA tensor the wrapper
launches the kernel; on a CPU tensor it runs `sw_groups_lab_ref`, plain
PyTorch that carries out the same variant's algebra on tensors.  Inputs,
`work` and output are those of `sw_groups`; a table that splits slabs over
clusters launches here as its `plain()` table, each split slab one block.
"""

import re

import torch

from oswald_tpu_torch.kernels.sw_lanes import (STRIP_ROWS, TILE_COLS,
                                               _check, _engine_step,
                                               _launch, _tiled_ref,
                                               score_groups_by_length,
                                               sw_groups_ref, sw_lanes_ref,
                                               work_table)

# variant name -> the kernel's template argument (sw::LabVariant)
VARIANTS = {"base": 0, "fscan": 1, "pmax": 2, "noadj": 3, "ks": 4, "pre": 5,
            "dpx": 6}
# (variant, strip rows, loads ahead) instantiated in csrc/sw_groups_lab.cu:
# every body in both placements at the engine's U, and the two bodies in the
# fused forms, reads ahead, at half and twice that height
BUILT = frozenset([(v, STRIP_ROWS, a) for v in VARIANTS
                   for a in (False, True)] +
                  [(v, u, True) for v in ("base", "dpx") for u in (8, 32)])
AHEAD = "+ahead"     # suffix of a label with its loads ahead

# kernel launches made by sw_groups_lab in this process (the wrapper adds one
# per launch and nowhere else)
launches_lab = 0


def _variant_index(variant) -> int:
    if variant not in VARIANTS:
        raise ValueError(f"sw_groups_lab: unknown variant {variant!r}; "
                         f"choose from {', '.join(VARIANTS)}")
    return VARIANTS[variant]


def label(variant: str, strip_rows: int = STRIP_ROWS,
          load_ahead: bool = False) -> str:
    """The name of one built kernel, as `lab`, `chip_smoke.py` and
    `ptxas_report` print it: "base@16+ahead"."""
    return f"{variant}@{strip_rows}" + (AHEAD if load_ahead else "")


def sw_groups_lab(residues, groups, query, submat, open_gap: int,
                  extend_gap: int, variant: str, scratch=None,
                  load_ahead: bool = False, work=None,
                  strip_rows: int = STRIP_ROWS):
    """Scores of `query` against every lane of every group, computed by the
    column body `variant` over strips of `strip_rows` rows (see module):
    int32[G, 8, 128]."""
    global launches_lab
    v = _variant_index(variant)
    _check(residues, groups, query, submat, scratch, work=work)
    if (variant, strip_rows, bool(load_ahead)) not in BUILT:
        built = ", ".join(sorted(label(*b) for b in BUILT))
        raise ValueError(f"sw_groups_lab: "
                         f"{label(variant, strip_rows, load_ahead)} is not "
                         f"built; built: {built}")
    if residues.device.type == "cpu":
        return sw_groups_lab_ref(residues, groups, query, submat, open_gap,
                                 extend_gap, variant, scratch, strip_rows)
    # the lab launches plain grids: split slabs go as one block each
    work = (work if work is not None else work_table(groups)).plain()
    out, launched = _launch("sw_groups_lab", residues, groups, query, None,
                            submat, open_gap, extend_gap, scratch, work,
                            (v, int(bool(load_ahead)), int(strip_rows)))
    launches_lab += launched
    return out[0]


def _f_scan(f_in, c, e):
    """F of every row of a strip by the serial scan, two operations a row:
    F[0] = f_in, F[u] = max(F[u - 1] - e, c[u - 1]).  c is [lanes, U];
    returns (F [lanes, U], the F leaving the last row)."""
    fs = [f_in]
    for u in range(1, c.shape[1]):
        fs.append(torch.maximum(fs[-1] - e, c[:, u - 1]))
    return torch.stack(fs, dim=1), torch.maximum(fs[-1] - e, c[:, -1])


def _f_kogge_stone(f_in, c, bias):
    """The same F by a Kogge-Stone prefix maximum: with a[u] = F[u] + u e
    the scan is a running maximum of {f_in, c[u - 1] + u e}, taken in
    log2(U + 1) steps of shifted maxima."""
    n = c.shape[1] + 1
    a = torch.cat([f_in[:, None], c + bias], dim=1)
    off = 1
    while off < n:
        a = torch.cat([a[:, :off],
                       torch.maximum(a[:, off:], a[:, :-off])], dim=1)
        off *= 2
    F = torch.cat([a[:, :1], a[:, 1:-1] - bias[:-1]], dim=1)
    return F, a[:, -1] - bias[-1]


def _lab_step(variant):
    """The column update of lab variant `variant` != base, in the form of
    sw_lanes._engine_step: every row's cur' = max(diag + s, 0, E) at once;
    F by the serial scan (fscan, pmax, noadj, pre, dpx) or by Kogge-Stone
    (ks); H = max(cur', F); the score over H (fscan, ks, pre) or over cur'
    (pmax, noadj, dpx); E' = max(E - e, H - oe), or from cur' for noadj and
    dpx."""
    ks = variant == "ks"
    over_cp = variant in ("pmax", "noadj", "dpx")
    e_from_cp = variant in ("noadj", "dpx")

    def step(diag, s, ee, f_in, oe, e, bias):
        cp = torch.maximum((diag + s).clamp_min(0), ee)
        c = cp - oe
        F, f_out = _f_kogge_stone(f_in, c, bias) if ks else \
            _f_scan(f_in, c, e)
        H = torch.maximum(cp, F)
        ee = torch.maximum(ee - e, c if e_from_cp else H - oe)
        return H, ee, f_out, cp if over_cp else H
    return step


def sw_lanes_lab_ref(cols, query, submat, open_gap: int, extend_gap: int,
                     variant: str, strip_rows: int = STRIP_ROWS):
    """Plain PyTorch scores of `query` against many subjects at once, by the
    algebra of one lab variant.

    cols: int[L, lanes] subject residues column by column (DUMMY-padded);
    returns int32[lanes].  As the JAX lab does it: strips of `strip_rows`
    (any U >= 1) query rows (the last padded with rows that score 0), a
    loop over the columns inside each strip, H of the strip's last row and
    the F leaving it handed to the next strip, each column by the variant's
    update (_lab_step).  `pre` gathers column j + 1's scores before column
    j's update.  `base` and `dpx` have the shipping recurrence:
    sw_lanes_ref, whatever the strip height.
    """
    _variant_index(variant)
    if variant in ("base", "dpx"):
        return sw_lanes_ref(cols, query, submat, open_gap, extend_gap)
    U = int(strip_rows)
    if U < 1:
        raise ValueError(f"sw_groups_lab: strip_rows must be >= 1, got {U}")
    dev = cols.device
    n_cols, lanes = cols.shape
    q = query.to(device=dev, dtype=torch.long)
    m = q.numel()
    m_pad = -(-m // U) * U
    # prof[r, i]: score of query row i against residue r; padding rows 0
    prof = torch.zeros((submat.shape[0], m_pad), dtype=torch.int32,
                       device=dev)
    prof[:, :m] = submat.to(device=dev, dtype=torch.int32)[q].T
    oe, e = int(open_gap) + int(extend_gap), int(extend_gap)
    bias = (torch.arange(U, device=dev, dtype=torch.int32) + 1) * e
    step = _lab_step(variant)
    zero = torch.zeros(lanes, dtype=torch.int32, device=dev)
    cols = cols.to(torch.long)
    hrow, frow = [zero] * n_cols, [zero] * n_cols
    best = zero
    for i0 in range(0, m_pad, U):
        p = prof[:, i0:i0 + U]                               # [24, U]
        hl = torch.zeros((lanes, U), dtype=torch.int32, device=dev)
        ee = torch.zeros_like(hl)
        hprev = zero
        s_next = p[cols[0]] if variant == "pre" and n_cols else None
        for j in range(n_cols):
            if variant == "pre":
                s = s_next
                s_next = p[cols[min(j + 1, n_cols - 1)]]
            else:
                s = p[cols[j]]                               # [lanes, U]
            diag = torch.cat([hprev[:, None], hl[:, :-1]], dim=1)
            hl, ee, f_out, over = step(diag, s, ee, frow[j], oe, e, bias)
            best = torch.maximum(best, over.amax(dim=1))
            hprev = hrow[j]
            hrow[j], frow[j] = hl[:, -1], f_out
    return best


def sw_groups_lab_ref(residues, groups, query, submat, open_gap: int,
                      extend_gap: int, variant: str, scratch=None,
                      strip_rows: int = STRIP_ROWS):
    """Plain PyTorch version of `sw_groups_lab` (sw_lanes_lab_ref over the
    groups); `scratch` is ignored."""
    _variant_index(variant)
    _check(residues, groups, query, submat, scratch)
    if variant in ("base", "dpx"):
        return sw_groups_ref(residues, groups, query, submat, open_gap,
                             extend_gap)
    return score_groups_by_length(
        residues, groups,
        lambda cols: sw_lanes_lab_ref(cols, query, submat, open_gap,
                                      extend_gap, variant, strip_rows))


def sw_groups_lab_tiled_ref(residues, groups, query, submat, open_gap: int,
                            extend_gap: int, variant: str, scratch=None,
                            work=None, strip_rows: int = STRIP_ROWS,
                            tile_cols: int = TILE_COLS):
    """Plain PyTorch version of `sw_groups_lab` by the kernel's own
    decomposition (sw_lanes.sw_groups_tiled_ref's: work items, strips of
    `strip_rows` rows dealt to the sets of an item, tiles of `tile_cols`
    columns, the hand-over), each column by the variant's update: the
    engine's for `base`, _lab_step's for the others (`pre` reads its scores
    a column early in the kernel; on tensors that is fscan's update).
    `scratch` is ignored.  CPU tensors."""
    _variant_index(variant)
    _check(residues, groups, query, submat, scratch, work=work)
    segs = torch.tensor([[0, query.numel()]], dtype=torch.int32)
    step = _engine_step if variant == "base" else _lab_step(variant)
    return _tiled_ref(residues, groups, query, segs, submat, open_gap,
                      extend_gap, work, strip_rows, tile_cols, step)[0]


def kernel_label(mangled: str):
    """The label (see `label`) of a mangled sw_groups_lab_kernel<U, V,
    kAhead> symbol; None for another symbol."""
    hit = re.search(r"sw_groups_lab_kernelILi(\d+)ELi(\d+)ELb([01])E",
                    mangled)
    if not hit:
        return None
    names = {i: v for v, i in VARIANTS.items()}
    return label(names.get(int(hit.group(2)), "?"), int(hit.group(1)),
                 hit.group(3) == "1")


def ptxas_report(log):
    """{kernel_label: "N registers, S bytes spill stores, T bytes spill
    loads"} from the `-Xptxas -v` output of the lab library's build (None
    or an empty log gives {})."""
    out, current = {}, None
    for line in (log or "").splitlines():
        if "Compiling entry function" in line:
            current = kernel_label(line)
            if current is not None:
                out[current] = ""
        elif current is not None:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            if spill:
                out[current] += (f", {spill.group(1)} bytes spill stores, "
                                 f"{spill.group(2)} bytes spill loads")
            if regs:
                out[current] = f"{regs.group(1)} registers" + out[current]
    return out
