// Score-only affine-gap Smith-Waterman over packed database groups, one
// subject per thread, for Hopper (sm_90a).
//
// Replaces oswald_tpu/kernels/sw_lanes.py::sw_chunk (the Pallas kernel)
// chained over all column chunks of every bin: one launch scores the query
// against every group of the database.
//
// Layout.  The database is one flat int8 buffer of columns; a group is L
// consecutive columns of 1024 residues ([L, 8, 128]: lane = sublane * 128 +
// lane-in-row), and the group table holds (first column, L) per group.  A
// block of 128 threads takes one 128-lane row of one group, and thread t
// scores subject (row, t) alone, so the read of column j is 128 contiguous
// bytes and no thread waits on another.
//
// Recurrence: the cell update and the sweep of one strip are in sw_cell.cuh,
// shared with sw_groups_packed.cu.
//
// Row strips.  The query is swept in strips of U rows.  A thread keeps H and
// E of its U rows in registers and walks all L columns of its subject; H of
// the strip's last row and F below it go to a global scratch row of L
// entries per subject (the same lane-contiguous layout as the residues),
// which the next strip reads back.  Nothing is carried between blocks.
//
// Shared memory holds the substitution matrix (plus a zero row for the
// padding rows of the last strip) and the query as matrix row offsets, so
// a lookup is one shared load: the row offset is the same for the whole
// warp and the 24 entries of a row sit in distinct banks.  The query is
// padded only to a multiple of U, with rows that score 0 and cannot move
// the maximum.
//
// What bounds it on an H100: integer max-plus ALU work, about 10 operations
// per cell plus the shared-memory lookup (about 16 instructions per cell
// once nvcc has fused add-max pairs into VIADDMNMX), and per column of a
// strip one global-load round trip (residue, H and F) with scratch traffic
// of 16 / U bytes per cell.  U = 16 ran 5.2x faster than U = 8 over a
// SwissProt-sized database, with identical scores (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md).  The DPX intrinsics (__viaddmax_s32, __vimax3_s32)
// written out and prefetching the next column are measured by the lab
// variants `dpx` and `pre` of sw_groups_lab.cu, with the column's loads in
// place and a column ahead (PERF.md has their times).  Left for later work:
// launching the longest groups first so the last wave does not wait on them.

#include "sw_cell.cuh"

namespace {

using namespace sw;

template <int U>
__global__ void __launch_bounds__(kRowLanes)
sw_groups_kernel(const int8_t* __restrict__ db,
                 const int32_t* __restrict__ groups,
                 const int32_t* __restrict__ query, int m,
                 const int32_t* __restrict__ submat, int oe, int e,
                 int32_t* __restrict__ hrow, int32_t* __restrict__ frow,
                 int32_t* __restrict__ scores) {
  extern __shared__ int32_t smem[];
  int32_t* sm = smem;                                // [25, 24]
  int32_t* qoff = smem + kMatrixWords;               // [m_pad]
  const int m_pad = (m + U - 1) / U * U;
  load_matrix(sm, submat);
  for (int i = threadIdx.x; i < m_pad; i += kRowLanes)
    qoff[i] = (i < m ? query[i] : kZeroRow) * kAlpha;
  __syncthreads();

  const int g = blockIdx.x / kRowsPerGroup;
  const int row = blockIdx.x % kRowsPerGroup;
  const size_t base = (size_t)groups[2 * g] * kGroupLanes +
                      (size_t)row * kRowLanes + threadIdx.x;
  const int L = groups[2 * g + 1];

  int32_t best = 0;
  for (int i0 = 0; i0 < m_pad; i0 += U) {
    int32_t qo[U];
#pragma unroll
    for (int u = 0; u < U; ++u) qo[u] = qoff[i0 + u];
    // loads stay where they are used: prefetching them ran 5% slower here
    best = sweep_strip<U, false>(db + base, hrow + base, frow + base, L, qo,
                                 sm, oe, e, i0 == 0, i0 + U >= m_pad, best);
  }
  scores[(size_t)g * kGroupLanes + (size_t)row * kRowLanes + threadIdx.x] =
      best;
}

}  // namespace

// Scores query[0:m] against every group; scores is int32[n_groups, 8, 128].
// hrow and frow are int32 scratch of the residue buffer's size.  Launches
// on `stream` without synchronising and returns cudaGetLastError().
extern "C" int sw_groups_launch(const void* db, const void* groups,
                                int n_groups, const void* query, int m,
                                const void* submat, int open_gap,
                                int extend_gap, void* hrow, void* frow,
                                void* scores, void* stream) {
  constexpr int U = kStripRows;
  if (n_groups <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();   // drop a refused call's error from before
  const int m_pad = (m + U - 1) / U * U;
  const size_t shmem = ((size_t)kMatrixWords + m_pad) * sizeof(int32_t);
  if (shmem > 48 * 1024) {
    // a query too long for the card's shared memory is refused here
    const cudaError_t err = cudaFuncSetAttribute(
        sw_groups_kernel<U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (err != cudaSuccess) {
      (void)cudaGetLastError();
      return (int)err;
    }
  }
  sw_groups_kernel<U><<<n_groups * kRowsPerGroup, kRowLanes, shmem,
                        (cudaStream_t)stream>>>(
      (const int8_t*)db, (const int32_t*)groups, (const int32_t*)query, m,
      (const int32_t*)submat, open_gap + extend_gap, extend_gap,
      (int32_t*)hrow, (int32_t*)frow, (int32_t*)scores);
  return (int)cudaGetLastError();
}

extern "C" const char* sw_groups_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
