// Score-only affine-gap Smith-Waterman of several packed queries over packed
// database groups in one launch, one subject per thread, for Hopper (sm_90a).
//
// Replaces oswald_tpu/kernels/sw_lanes.py::sw_chunk with q_segs > 1 (uniform
// segments) and with seg_map (unequal segments), chained over all column
// chunks of every bin: the Pallas kernel scores q_segs independent queries
// packed along its row axis, resetting the H-row/F state and the score slab
// at each segment start.  Here a segment is a (first row, row count) pair
// into the packed query, so one kernel serves both layouts, and a query is
// taken at its true length: the DUMMY rows that pad a segment to the row
// quantum, and the filler blocks behind the last segment, score 0 against
// everything and need no rows of their own.
//
// Layout and strips are those of sw_groups.cu (a block of 128 threads per
// 128-lane row of a group, U-row strips in registers, H/F rows between
// strips in a global scratch); the cell update is shared through
// sw_cell.cuh.  What is new:
//
// - Segments run one after another inside the thread.  A segment's first
//   strip starts from H = F = 0 above it (no scratch read) and a fresh
//   maximum; its last strip writes the maximum to scores[s, g, lane] and
//   skips the scratch write.  A strip never straddles two segments: rows
//   past a segment's end use the matrix's zero row.  Because a thread's
//   segments run in order and a thread reads only what it wrote, the one
//   scratch of 8 B per padded residue serves every segment.  (A grid with
//   the segment in blockIdx.y would need one scratch per resident segment.)
// - Shared memory holds the matrix and all m_tot packed rows as matrix row
//   offsets; above 48 KB the launch asks for the larger limit and fails with
//   the runtime's error where the card cannot give it.
//
// - The strip sweep prefetches the next column's loads (sw_cell.cuh says
//   why this kernel does and sw_groups does not).
//
// What bounds it on an H100: as sw_groups, integer max-plus work (about 10
// operations per cell), with the residue column read once per strip.  One
// thread now does every segment's work on its subject, so the longest groups
// finish last by the sum of the query lengths, not by one (PERF.md has the
// measured tail).

#include "sw_cell.cuh"

namespace {

using namespace sw;

template <int U>
__global__ void __launch_bounds__(kRowLanes)
sw_groups_packed_kernel(const int8_t* __restrict__ db,
                        const int32_t* __restrict__ groups, int n_groups,
                        const int32_t* __restrict__ q_packed, int m_tot,
                        const int32_t* __restrict__ segs, int n_segs,
                        const int32_t* __restrict__ submat, int oe, int e,
                        int32_t* __restrict__ hrow,
                        int32_t* __restrict__ frow,
                        int32_t* __restrict__ scores) {
  extern __shared__ int32_t smem[];
  int32_t* sm = smem;                                // [25, 24]
  int32_t* qoff = smem + kMatrixWords;               // [m_tot]
  load_matrix(sm, submat);
  for (int i = threadIdx.x; i < m_tot; i += kRowLanes)
    qoff[i] = q_packed[i] * kAlpha;
  __syncthreads();

  const int g = blockIdx.x / kRowsPerGroup;
  const int row = blockIdx.x % kRowsPerGroup;
  const size_t lane = (size_t)row * kRowLanes + threadIdx.x;
  const size_t base = (size_t)groups[2 * g] * kGroupLanes + lane;
  const int L = groups[2 * g + 1];

  for (int s = 0; s < n_segs; ++s) {
    // a segment outside the packed rows is cut to what lies inside
    const int r0 = min(max(segs[2 * s], 0), m_tot);
    const int n = min(max(segs[2 * s + 1], 0), m_tot - r0);
    int32_t best = 0;
    for (int i0 = 0; i0 < n; i0 += U) {
      int32_t qo[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        qo[u] = i0 + u < n ? qoff[r0 + i0 + u] : kZeroRow * kAlpha;
      best = sweep_strip<U, true>(db + base, hrow + base, frow + base, L, qo,
                                  sm, oe, e, i0 == 0, i0 + U >= n, best);
    }
    scores[((size_t)s * n_groups + g) * kGroupLanes + lane] = best;
  }
}

}  // namespace

// Scores every segment (first row, row count) of q_packed[0:m_tot] against
// every group; scores is int32[n_segs, n_groups, 8, 128].  hrow and frow are
// int32 scratch of the residue buffer's size.  Launches on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" int sw_groups_packed_launch(const void* db, const void* groups,
                                       int n_groups, const void* q_packed,
                                       int m_tot, const void* segs,
                                       int n_segs, const void* submat,
                                       int open_gap, int extend_gap,
                                       void* hrow, void* frow, void* scores,
                                       void* stream) {
  constexpr int U = kStripRows;
  if (n_groups <= 0 || m_tot <= 0 || n_segs <= 0)
    return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();   // drop a refused call's error from before
  const size_t shmem = ((size_t)kMatrixWords + m_tot) * sizeof(int32_t);
  if (shmem > 48 * 1024) {
    // packed rows too many for the card's shared memory are refused here
    const cudaError_t err = cudaFuncSetAttribute(
        sw_groups_packed_kernel<U>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) {
      (void)cudaGetLastError();
      return (int)err;
    }
  }
  sw_groups_packed_kernel<U><<<n_groups * kRowsPerGroup, kRowLanes, shmem,
                               (cudaStream_t)stream>>>(
      (const int8_t*)db, (const int32_t*)groups, n_groups,
      (const int32_t*)q_packed, m_tot, (const int32_t*)segs, n_segs,
      (const int32_t*)submat, open_gap + extend_gap, extend_gap,
      (int32_t*)hrow, (int32_t*)frow, (int32_t*)scores);
  return (int)cudaGetLastError();
}

extern "C" const char* sw_groups_packed_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
