// The Smith-Waterman recurrence, the constants of the database layout and the
// shared-memory matrix, common to every kernel of the port, and sweep_strip:
// the sweep of one query strip by one thread per subject over all L columns,
// reading the strip's inputs from global memory column by column.  The engine
// kernels (sw_groups.cu, sw_groups_packed.cu) sweep by tiles out of shared
// memory instead (sw_tile.cuh); sweep_strip stays as the `base` body of the
// kernel lab (sw_groups_lab.cu), which compares column bodies on the
// one-thread-per-subject geometry.
//
// Recurrence (the "fscan" form of oswald_tpu's sw_chunk; gap cost
// open + k * extend, oe = open + extend, e = extend):
//   cur' = max(diag + s, 0, E)
//   H    = max(cur', F)
//   F'   = max(F - e, cur' - oe)          (down the column)
//   E'   = max(E - e, cur' - oe)          (along the row; the "noadj" update,
//                                          exact for every matrix and gap
//                                          pair, see oswald_tpu's noadj_ok)
//   score = max over all cells of cur'
// The plain PyTorch versions (sw_lanes.sw_lanes_ref) use the classical
// E' = max(E - e, H - oe), so comparing a kernel with its plain version also
// checks that the updates agree.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sw {

constexpr int kGroupLanes = 1024;   // subjects per group ([8, 128])
constexpr int kRowLanes = 128;      // subjects per block
constexpr int kRowsPerGroup = kGroupLanes / kRowLanes;
constexpr int kAlpha = 24;          // residue codes 0..23
constexpr int kZeroRow = kAlpha;    // shared matrix row of zeros (padding)
constexpr int kMatrixWords = (kAlpha + 1) * kAlpha;
constexpr int kStripRows = 16;      // U: query rows held in registers

// Copies the 24x24 matrix into shared memory and appends the zero row.
__device__ __forceinline__ void load_matrix(int32_t* sm,
                                            const int32_t* __restrict__ submat) {
  for (int i = threadIdx.x; i < kMatrixWords; i += kRowLanes)
    sm[i] = i < kAlpha * kAlpha ? submat[i] : 0;
}

// One thread sweeps U query rows (matrix row offsets qo[0..U)) over the L
// columns of its subject.  res, hr and fr point at the thread's lane of
// column 0; consecutive columns are kGroupLanes entries apart.  Unless
// `first`, H of the row above the strip and F entering it are read from
// hr/fr; unless `last`, H of the strip's last row and F leaving it are
// written back to the same places for the next strip.  Returns the maximum
// of `best` and every cur' of the strip.
//
// With kPrefetch the three loads of column j + 1 (residue, H, F) are started
// before the cells of column j are computed, so their round trip to memory
// runs under that work (the last column loads itself again).  Without it
// they are loaded where they are used.  Measured over a SwissProt-sized
// database at 512 query rows (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md):
// 141.11 ms in place and 149.14 ms ahead for this body, while bodies that
// separate the lookups from the chain run 2-4 times slower in place: where
// nvcc puts three dependent global loads decides the time, which is why the
// engine kernels no longer load from global memory inside the column loop.
template <int U, bool kPrefetch>
__device__ __forceinline__ int32_t sweep_strip(
    const int8_t* __restrict__ res, int32_t* __restrict__ hr,
    int32_t* __restrict__ fr, int L, const int32_t (&qo)[U],
    const int32_t* sm, int oe, int e, bool first, bool last, int32_t best) {
  int32_t hl[U], ee[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    hl[u] = 0;                    // H[i0 + u][j - 1]
    ee[u] = 0;                    // E[i0 + u][j]
  }
  int32_t hprev = 0;              // H[i0 - 1][j - 1]
  int r_next = 0;
  int32_t hup_next = 0, f_next = 0;
  if constexpr (kPrefetch) {
    r_next = res[0];
    if (!first) {
      hup_next = hr[0];
      f_next = fr[0];
    }
  }
  for (int j = 0; j < L; ++j) {
    const size_t p = (size_t)j * kGroupLanes;
    int r;
    int32_t hup, f;               // H[i0 - 1][j], F[i0][j]
    if constexpr (kPrefetch) {
      const size_t pn = (size_t)min(j + 1, L - 1) * kGroupLanes;
      r = r_next;
      hup = hup_next;
      f = f_next;
      r_next = res[pn];
      if (!first) {
        hup_next = hr[pn];
        f_next = fr[pn];
      }
    } else {
      r = res[p];
      hup = first ? 0 : hr[p];
      f = first ? 0 : fr[p];
    }
    int32_t diag = hprev;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int32_t cp = max(max(diag + sm[qo[u] + r], 0), ee[u]);
      const int32_t c = cp - oe;
      best = max(best, cp);
      diag = hl[u];
      hl[u] = max(cp, f);
      ee[u] = max(ee[u] - e, c);
      f = max(f - e, c);
    }
    if (!last) {
      hr[p] = hl[U - 1];
      fr[p] = f;
    }
    hprev = hup;
  }
  return best;
}

}  // namespace sw
