"""Reference Smith-Waterman scorers (the correctness oracle): the port's own
copy of oswald_tpu.core.oracle.

Score-only, affine-gap, local alignment with the reference recurrence:

    H[i,j] = max(0, H[i-1,j-1] + S(a_i, b_j), E[i,j], F[i,j])
    E[i,j] = max(H[i,j-1] - (open+extend), E[i,j-1] - extend)   # gap in query
    F[i,j] = max(H[i-1,j] - (open+extend), F[i-1,j] - extend)   # gap in db seq
    score  = max over all cells of H

All arithmetic is exact int32.

Two implementations:

- `sw_score_numpy`: scalar O(m*n) loop; trivially auditable ground truth for
  tiny inputs in tests (a copy of the reference's).
- `sw_score_diag` / `sw_score_diag_batch`: an anti-diagonal wavefront in
  plain PyTorch, batched over subjects.  Each step computes one anti-diagonal
  d = i + j of every subject as [B, m] vectors, on the device of its inputs.
  It shares no code and no formulation with the kernels (`kernels/`), which
  sweep column by column; that is what lets utils.parity certify them.
"""

import numpy as np
import torch

from oswald_tpu_torch.alphabet import DUMMY, ALPHA_SIZE


def sw_score_numpy(a, b, submat, open_gap: int = 10, extend_gap: int = 2) -> int:
    """Scalar-loop oracle. a, b: int code arrays; submat: [24,24] ints."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    sm = np.asarray(submat, dtype=np.int64)
    oe, e = open_gap + extend_gap, extend_gap
    m, n = len(a), len(b)
    H = np.zeros(n + 1, dtype=np.int64)   # H[i-1, :] row buffer
    E = np.zeros(n + 1, dtype=np.int64)
    F = np.zeros(n + 1, dtype=np.int64)   # F carried down column j
    best = 0
    for i in range(m):
        diag = 0                           # H[i-1, j-1]
        h_left = 0                         # H[i, j-1]
        e_run = 0                          # E[i, j]
        for j in range(n):
            E_ij = max(h_left - oe, e_run - e)
            F[j] = max(H[j] - oe, F[j] - e)
            h = max(0, diag + sm[a[i], b[j]], E_ij, F[j])
            best = max(best, h)
            diag = H[j]
            H[j] = h
            h_left = h
            e_run = E_ij
    return int(best)


def sw_score_diag_batch(a, bs, n_bs, submat, open_gap=10, extend_gap=2):
    """Anti-diagonal wavefront scores of one query against a batch of
    subjects, on the device of `bs` (the CPU for a numpy array).

    a:    int[m]     encoded query (may contain DUMMY padding rows; dummy
                     scores 0 so padding never raises the max)
    bs:   int[B, n]  encoded subjects, padded with DUMMY
    n_bs: int[B]     true subject lengths (cells with j >= n_b are masked)
    Returns int32[B] local alignment scores.

    Steps over the m + n - 1 diagonals d = i + j; each step updates [B, m]
    vectors indexed by i, with j = d - i, as the reference's lax.scan does
    (one vmapped lane per subject there, one row here).
    """
    bs = torch.as_tensor(bs, dtype=torch.int32)
    dev = bs.device
    a = torch.as_tensor(a, dtype=torch.int32).to(dev)
    n_bs = torch.as_tensor(n_bs, dtype=torch.int32).to(dev)
    sm = torch.as_tensor(submat, dtype=torch.int32).to(dev).reshape(-1)
    oe = int(open_gap) + int(extend_gap)
    eg = int(extend_gap)
    B, n = bs.shape
    m = a.shape[0]

    # the window for diagonal d is a slice of the reversed subject padded
    # with m DUMMY on both sides: b[j] = bp[j + m] = br[n + m - 1 - d + i]
    pad = torch.full((B, m), DUMMY, dtype=torch.int64, device=dev)
    br = torch.cat([pad, bs.to(torch.int64), pad], dim=1).flip(1)

    i_vec = torch.arange(m, dtype=torch.int32, device=dev)
    row_gather = a.to(torch.int64) * ALPHA_SIZE    # submat row offsets per i
    last = n_bs[:, None]
    zero_col = torch.zeros((B, 1), dtype=torch.int32, device=dev)

    def down(x):
        """Row i takes row i-1's value; row 0 takes 0."""
        return torch.cat([zero_col, x[:, :-1]], dim=1)

    h_d1 = torch.zeros((B, m), dtype=torch.int32, device=dev)
    h_d2, e_d1, f_d1 = h_d1, h_d1, h_d1
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    for d in range(m + n - 1):
        start = n + m - 1 - d
        s = sm[row_gather + br[:, start:start + m]]
        # E[i, j] from (i, j-1): previous diagonal, same i
        e_new = torch.maximum(h_d1 - oe, e_d1 - eg)
        # F[i, j] from (i-1, j): previous diagonal, row i-1
        f_new = torch.maximum(down(h_d1) - oe, down(f_d1) - eg)
        # H from (i-1, j-1): two diagonals back, row i-1
        h_new = torch.maximum(torch.clamp_min(down(h_d2) + s, 0),
                              torch.maximum(e_new, f_new))
        # 0 <= j < n_b, with j = d - i
        valid = (i_vec <= d) & (i_vec > d - last)
        h_new = torch.where(valid, h_new, 0)
        e_new = torch.where(valid, e_new, 0)
        f_new = torch.where(valid, f_new, 0)
        best = torch.maximum(best, h_new.amax(dim=1))
        h_d2, h_d1, e_d1, f_d1 = h_d1, h_new, e_new, f_new
    return best


def sw_score_diag(a, b, n_b, submat, open_gap=10, extend_gap=2):
    """`sw_score_diag_batch` of one subject b int[n] of true length n_b:
    the int32 local alignment score as a 0-d tensor."""
    b = torch.as_tensor(b, dtype=torch.int32)
    return sw_score_diag_batch(a, b[None], torch.as_tensor(n_b).reshape(1),
                               submat, open_gap, extend_gap)[0]
