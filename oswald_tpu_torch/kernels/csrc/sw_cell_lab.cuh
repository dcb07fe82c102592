// Lab bodies of the tiled sweep (sw_tile.cuh): the column update written in
// the forms that oswald_tpu's kernel lab compares
// (scripts/kernel_lab.py::_kernel_lab), plus one of the card's own.  Every
// body is an exact rewrite of the same recurrence, so every variant returns
// the scores of sw_groups; only the order of the work inside one column of
// U rows differs:
//
//   base   the engine's own body (sw::EngineColumn): one chain in Hopper's
//          fused forms, so `base` with the reads ahead at U = 16 is sw_groups
//   fscan  all U cur' first, then the serial F scan (2 operations per row),
//          then H = max(cur', F) and the classical E' = max(E - e, H - oe);
//          the score is taken over H
//   pmax   fscan with the score taken over cur' (F never exceeds an earlier
//          cur' of its column)
//   noadj  pmax with E' = max(E - e, cur' - oe): the engine's algebra,
//          written as three passes instead of one chain
//   ks     fscan with F from a Kogge-Stone prefix maximum over U + 1 values
//          biased by (u + 1) * e, log2 depth instead of a serial scan
//   pre    fscan with column j + 1's U / 4 profile words read before column
//          j's chain (within a tile: the next tile's residues may not have
//          landed, so a tile's first column is read at its head)
//   dpx    noadj with Hopper's fused add-max and three-way max instructions
//          written out (__viaddmax_s32_relu, __viaddmax_s32, __vimax3_s32)
//
// Beside the body, a launch chooses the strip height U and where a column's
// shared-memory reads (residue, H, F) sit: where they are used, or one column
// ahead of the chain (sweep_tiles' kAhead).

#pragma once

#include <type_traits>

#include "sw_tile.cuh"

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

// The column body of lab variant V != kBase for sweep_tiles: the scores of
// the column from the strip's profile, then lab_column.  `pre` carries the
// scores of the column to come in s.
template <int U, int V>
struct LabColumn {
  static constexpr bool kNext = V == kPre;
  int32_t s[U];
  __device__ __forceinline__ void head(const int32_t* prof, int r) {
    if constexpr (V == kPre) load_scores<U>(prof, r, s);
  }
  __device__ __forceinline__ int32_t operator()(
      const int32_t* prof, int r, int rn, int32_t diag, int32_t f,
      int32_t (&hl)[U], int32_t (&ee)[U], int oe, int e, int32_t& best) {
    if constexpr (V == kPre) {
      int32_t s_next[U];
      load_scores<U>(prof, rn, s_next);
      f = lab_column<U, kFscan>(s, diag, f, hl, ee, oe, e, best);
#pragma unroll
      for (int u = 0; u < U; ++u) s[u] = s_next[u];
      return f;
    } else {
      int32_t sc[U];
      load_scores<U>(prof, r, sc);
      return lab_column<U, V>(sc, diag, f, hl, ee, oe, e, best);
    }
  }
};

// The body of variant V: the engine's own for kBase.
template <int U, int V>
using LabBody = std::conditional_t<V == kBase, EngineColumn<U>,
                                   LabColumn<U, V>>;

}  // namespace sw
