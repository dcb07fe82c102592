// The Smith-Waterman recurrence, the constants of the database layout and the
// shared-memory matrix, common to every kernel of the port.  The sweep that
// carries the recurrence over strips and column tiles is sw_tile.cuh's.
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
constexpr int kStripRows = 16;      // U of the engine kernels: rows of a strip

// Copies the 24x24 matrix into shared memory and appends the zero row.
__device__ __forceinline__ void load_matrix(int32_t* sm,
                                            const int32_t* __restrict__ submat) {
  for (int i = threadIdx.x; i < kMatrixWords; i += kRowLanes)
    sm[i] = i < kAlpha * kAlpha ? submat[i] : 0;
}

}  // namespace sw
