"""The kernel lab: `sw_groups` with the column body chosen by `variant`.

`sw_groups_lab` is the port of `scripts/kernel_lab.py::sw_chunk_lab` chained
over a bin (its `_scan_bin`): the int32 score of the query against every
lane of every group, which every variant must give equal to `sw_groups`'.
The variants are exact rewrites of one recurrence that order the work inside
a column of U = 16 query rows differently (`csrc/sw_cell_lab.cuh` describes
each): `base` (`sweep_strip`, the one-chain body), `fscan`, `pmax`, `noadj`,
`ks`, `pre`, and `dpx` (Hopper's fused add-max instructions written out).  Beside the body,
`load_ahead` chooses where the kernel places a column's three global loads
(residue, H, F): where they are used, or one column ahead of the chain; the
plain version has no such choice.  On a CUDA tensor the wrapper launches
`csrc/sw_groups_lab.cu`; on a CPU tensor it runs `sw_groups_lab_ref`, plain
PyTorch that carries out the same variant's algebra on tensors.  Inputs and
output are those of `sw_groups`.
"""

import re

import torch

from oswald_tpu_torch.kernels import build
from oswald_tpu_torch.kernels.sw_lanes import (GROUP_SHAPE, _check,
                                               score_groups_by_length,
                                               sw_groups_ref, sw_lanes_ref)

# variant name -> the kernel's template argument (sw::LabVariant)
VARIANTS = {"base": 0, "fscan": 1, "pmax": 2, "noadj": 3, "ks": 4, "pre": 5,
            "dpx": 6}
# U: query rows of one strip, in the kernel (sw::kStripRows) and in the plain
# version
STRIP_ROWS = 16

# kernel launches made by sw_groups_lab in this process (the wrapper adds one
# per launch and nowhere else)
launches_lab = 0


def _variant_index(variant) -> int:
    if variant not in VARIANTS:
        raise ValueError(f"sw_groups_lab: unknown variant {variant!r}; "
                         f"choose from {', '.join(VARIANTS)}")
    return VARIANTS[variant]


def sw_groups_lab(residues, groups, query, submat, open_gap: int,
                  extend_gap: int, variant: str, scratch=None,
                  load_ahead: bool = False):
    """Scores of `query` against every lane of every group, computed by the
    column body `variant` (see module): int32[G, 8, 128]."""
    global launches_lab
    v = _variant_index(variant)
    _check(residues, groups, query, submat, scratch)
    if residues.device.type == "cpu":
        return sw_groups_lab_ref(residues, groups, query, submat, open_gap,
                                 extend_gap, variant, scratch)
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
    lib = build.load("sw_groups_lab")
    with torch.cuda.device(dev):
        err = lib.sw_groups_lab_launch(
            residues.data_ptr(), groups.data_ptr(), n, query.data_ptr(),
            query.numel(), submat.data_ptr(), int(open_gap),
            int(extend_gap), scratch[0].data_ptr(), scratch[1].data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream, v,
            int(bool(load_ahead)))
    build.check(lib, "sw_groups_lab", err)
    launches_lab += 1
    return out


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


def sw_lanes_lab_ref(cols, query, submat, open_gap: int, extend_gap: int,
                     variant: str):
    """Plain PyTorch scores of `query` against many subjects at once, by the
    algebra of one lab variant.

    cols: int[L, lanes] subject residues column by column (DUMMY-padded);
    returns int32[lanes].  As the kernel does it: strips of STRIP_ROWS query
    rows (the last padded with rows that score 0), a loop over the columns
    inside each strip, H of the strip's last row and the F leaving it handed
    to the next strip.  Per column: every row's cur' = max(diag + s, 0, E)
    at once; F by the serial scan (fscan, pmax, noadj, pre) or by
    Kogge-Stone (ks); H = max(cur', F); the score over H (fscan, ks, pre) or
    over cur' (pmax, noadj); E' = max(E - e, H - oe), or from cur' for
    noadj.  `pre` gathers column j + 1's scores before column j's update.
    `base` and `dpx` have the shipping recurrence: sw_lanes_ref.
    """
    _variant_index(variant)
    if variant in ("base", "dpx"):
        return sw_lanes_ref(cols, query, submat, open_gap, extend_gap)
    dev = cols.device
    n_cols, lanes = cols.shape
    U = STRIP_ROWS
    q = query.to(device=dev, dtype=torch.long)
    m = q.numel()
    m_pad = -(-m // U) * U
    # prof[r, i]: score of query row i against residue r; padding rows 0
    prof = torch.zeros((submat.shape[0], m_pad), dtype=torch.int32,
                       device=dev)
    prof[:, :m] = submat.to(device=dev, dtype=torch.int32)[q].T
    oe, e = int(open_gap) + int(extend_gap), int(extend_gap)
    bias = (torch.arange(U, device=dev, dtype=torch.int32) + 1) * e
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
            hup, f_in = hrow[j], frow[j]
            diag = torch.cat([hprev[:, None], hl[:, :-1]], dim=1)
            cp = torch.maximum((diag + s).clamp_min(0), ee)
            c = cp - oe
            F, f_out = _f_kogge_stone(f_in, c, bias) if variant == "ks" \
                else _f_scan(f_in, c, e)
            H = torch.maximum(cp, F)
            over = cp if variant in ("pmax", "noadj") else H
            best = torch.maximum(best, over.amax(dim=1))
            ee = torch.maximum(ee - e, c if variant == "noadj" else H - oe)
            hrow[j], frow[j] = H[:, -1], f_out
            hprev, hl = hup, H
    return best


def sw_groups_lab_ref(residues, groups, query, submat, open_gap: int,
                      extend_gap: int, variant: str, scratch=None):
    """Plain PyTorch version of `sw_groups_lab`; `scratch` is ignored."""
    _variant_index(variant)
    _check(residues, groups, query, submat, scratch)
    if variant in ("base", "dpx"):
        return sw_groups_ref(residues, groups, query, submat, open_gap,
                             extend_gap)
    return score_groups_by_length(
        residues, groups,
        lambda cols: sw_lanes_lab_ref(cols, query, submat, open_gap,
                                      extend_gap, variant))


AHEAD = "+ahead"     # suffix of a variant's name with its loads ahead


def kernel_label(mangled: str):
    """The variant name, with AHEAD appended for the load-ahead
    instantiation, of a mangled sw_groups_lab_kernel<V, kAhead> symbol;
    None for another symbol."""
    hit = re.search(r"sw_groups_lab_kernelILi(\d+)ELb([01])E", mangled)
    if not hit:
        return None
    names = {i: v for v, i in VARIANTS.items()}
    return names.get(int(hit.group(1)), "?") + \
        (AHEAD if hit.group(2) == "1" else "")


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
