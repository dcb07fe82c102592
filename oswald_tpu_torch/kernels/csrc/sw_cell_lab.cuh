// Lab bodies of the strip sweep: the column update of sw::sweep_strip
// (sw_cell.cuh) written in the forms that oswald_tpu's kernel lab compares
// (scripts/kernel_lab.py::_kernel_lab), plus one of the card's own.  Every
// body is an exact rewrite of the same recurrence, so every variant returns
// the scores of sw_groups; only the order of the work inside one column of
// U rows differs:
//
//   fscan  all U cur' first, then the serial F scan (2 operations per row),
//          then H = max(cur', F) and the classical E' = max(E - e, H - oe);
//          the score is taken over H
//   pmax   fscan with the score taken over cur' (F never exceeds an earlier
//          cur' of its column)
//   noadj  pmax with E' = max(E - e, cur' - oe): the algebra of sweep_strip,
//          written as three passes instead of one chain
//   ks     fscan with F from a Kogge-Stone prefix maximum over U + 1 values
//          biased by (u + 1) * e, log2 depth instead of a serial scan
//   pre    fscan with column j + 1's U score words read from shared memory
//          before column j's chain (its residue is loaded two columns ahead)
//   dpx    noadj with Hopper's fused add-max and three-way max instructions
//          written out (__viaddmax_s32_relu, __viaddmax_s32, __vimax3_s32)
//
// `base` is sw::sweep_strip itself and has no body here.  Beside the body, a
// launch chooses where the three loads of a column sit (sweep_strip_lab's
// kAhead), the placement that sw_cell.cuh found to decide a 2x swing.

#pragma once

#include "sw_cell.cuh"

namespace sw {

enum LabVariant {
  kBase = 0, kFscan = 1, kPmax = 2, kNoadj = 3, kKs = 4, kPre = 5, kDpx = 6,
  kLabVariants = 7
};

// Kogge-Stone running maximum over a[0..N), in place: steps of offset OFF,
// 2 OFF, ... while below N, each a compile-time unrolled pass, so the values
// stay in registers.
template <int N, int OFF>
__device__ __forceinline__ void ks_scan(int32_t (&a)[N]) {
  if constexpr (OFF < N) {
#pragma unroll
    for (int u = N - 1; u >= OFF; --u) a[u] = max(a[u], a[u - OFF]);
    ks_scan<N, OFF * 2>(a);
  }
}

// One column of a strip.  s[u] is the score of row u against this column's
// residue, hprev H[i0 - 1][j - 1], f the F entering the strip's first row;
// hl/ee carry H[.][j - 1] and E[.][j] in and H[.][j] and E[.][j + 1] out.
// Returns the F leaving the strip's last row.
template <int U, int V>
__device__ __forceinline__ int32_t lab_column(
    const int32_t (&s)[U], int32_t hprev, int32_t f, int32_t (&hl)[U],
    int32_t (&ee)[U], int oe, int e, int32_t& best) {
  int32_t cp[U], c[U], fv[U];
  // pass 1: the F-independent candidate of every row
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int32_t diag = u == 0 ? hprev : hl[u - 1];
    if constexpr (V == kDpx)
      cp[u] = __viaddmax_s32_relu(diag, s[u], ee[u]);
    else
      cp[u] = max(max(diag + s[u], 0), ee[u]);
    c[u] = cp[u] - oe;
  }
  // pass 2: F down the column, from the c[u] alone
  int32_t f_out;
  if constexpr (V == kKs) {
    int32_t a[U + 1];             // a[u] = F[u] + u * e, a running maximum
    a[0] = f;
#pragma unroll
    for (int u = 1; u <= U; ++u) a[u] = c[u - 1] + u * e;
    ks_scan<U + 1, 1>(a);
    fv[0] = a[0];
#pragma unroll
    for (int u = 1; u < U; ++u) fv[u] = a[u] - u * e;
    f_out = a[U] - U * e;
  } else {
    fv[0] = f;
#pragma unroll
    for (int u = 1; u < U; ++u) {
      if constexpr (V == kDpx)
        fv[u] = __viaddmax_s32(fv[u - 1], -e, c[u - 1]);
      else
        fv[u] = max(fv[u - 1] - e, c[u - 1]);
    }
    if constexpr (V == kDpx)
      f_out = __viaddmax_s32(fv[U - 1], -e, c[U - 1]);
    else
      f_out = max(fv[U - 1] - e, c[U - 1]);
  }
  // pass 3: H, the running maximum and E of every row
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int32_t h = max(cp[u], fv[u]);
    if constexpr (V == kDpx) {
      if (u % 2 == 1) best = __vimax3_s32(best, cp[u - 1], cp[u]);
      else if (u == U - 1) best = max(best, cp[u]);
      ee[u] = __viaddmax_s32(ee[u], -e, c[u]);
    } else if constexpr (V == kNoadj) {
      best = max(best, cp[u]);
      ee[u] = max(ee[u] - e, c[u]);
    } else {
      best = max(best, V == kPmax ? cp[u] : h);
      ee[u] = max(ee[u] - e, h - oe);
    }
    hl[u] = h;
  }
  return f_out;
}

// sweep_strip with the column body of variant V; arguments and the scratch
// protocol are sweep_strip's.  kAhead is sweep_strip's kPrefetch for every
// body: the residue, H and F of column j + 1 are loaded before column j's
// chain instead of where they are used, so the lab can tell what a body
// costs from what the placement of its loads costs.
template <int U, int V, bool kAhead>
__device__ __forceinline__ int32_t sweep_strip_lab(
    const int8_t* __restrict__ res, int32_t* __restrict__ hr,
    int32_t* __restrict__ fr, int L, const int32_t (&qo)[U],
    const int32_t* sm, int oe, int e, bool first, bool last, int32_t best) {
  if constexpr (V == kBase) {
    return sweep_strip<U, kAhead>(res, hr, fr, L, qo, sm, oe, e, first, last,
                                  best);
  } else {
    if (L <= 0) return best;
    int32_t hl[U], ee[U], s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      hl[u] = 0;                  // H[i0 + u][j - 1]
      ee[u] = 0;                  // E[i0 + u][j]
    }
    int32_t hprev = 0;            // H[i0 - 1][j - 1]
    // loaded ahead: the residue of column j + 1 (pre: and its scores, with
    // the residue of column j + 2), H[i0 - 1][j + 1] and F[i0][j + 1]
    int r_next = 0;
    int32_t hup_next = 0, f_next = 0;
    if constexpr (V == kPre) {
      const int r0 = res[0];
#pragma unroll
      for (int u = 0; u < U; ++u) s[u] = sm[qo[u] + r0];
      r_next = res[(size_t)min(1, L - 1) * kGroupLanes];
    } else if constexpr (kAhead) {
      r_next = res[0];
    }
    if constexpr (kAhead) {
      if (!first) {
        hup_next = hr[0];
        f_next = fr[0];
      }
    }
    for (int j = 0; j < L; ++j) {
      const size_t p = (size_t)j * kGroupLanes;
      const size_t pn = (size_t)min(j + 1, L - 1) * kGroupLanes;
      int32_t hup, f;             // H[i0 - 1][j], F[i0][j]
      if constexpr (kAhead) {
        hup = hup_next;
        f = f_next;
        if (!first) {
          hup_next = hr[pn];
          f_next = fr[pn];
        }
      } else {
        hup = first ? 0 : hr[p];
        f = first ? 0 : fr[p];
      }
      int32_t f_out;
      if constexpr (V == kPre) {
        // column j + 1's scores and column j + 2's residue are on their way
        // before column j's chain starts
        int32_t s_next[U];
        const int r1 = r_next;
        r_next = res[(size_t)min(j + 2, L - 1) * kGroupLanes];
#pragma unroll
        for (int u = 0; u < U; ++u) s_next[u] = sm[qo[u] + r1];
        f_out = lab_column<U, kFscan>(s, hprev, f, hl, ee, oe, e, best);
#pragma unroll
        for (int u = 0; u < U; ++u) s[u] = s_next[u];
      } else {
        int r;
        if constexpr (kAhead) {
          r = r_next;
          r_next = res[pn];
        } else {
          r = res[p];
        }
#pragma unroll
        for (int u = 0; u < U; ++u) s[u] = sm[qo[u] + r];
        f_out = lab_column<U, V>(s, hprev, f, hl, ee, oe, e, best);
      }
      if (!last) {
        hr[p] = hl[U - 1];
        fr[p] = f_out;
      }
      hprev = hup;
    }
    return best;
  }
}

}  // namespace sw
