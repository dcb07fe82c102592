// The kernel lab of the port: sw_groups with the column body chosen by
// `variant`, for Hopper (sm_90a).
//
// Replaces scripts/kernel_lab.py::sw_chunk_lab (the Pallas lab kernel) chained
// over a bin as its _scan_bin chains it: one launch scores the query against
// every group of the table and returns the int32 per-lane scores, which every
// variant must give equal to sw_groups'.  The database layout, the scratch
// and the shared matrix are those of sw_groups.cu; the geometry is the lab's
// own, one thread per subject for the whole sweep (one block of 128 threads
// per 128-lane row of a group in table order, strips of
// U = 16 query rows in registers, every strip in turn over all L columns, H
// and F rows between strips in a global scratch, the query as row offsets in
// shared memory); only the column body differs, one template instantiation
// per variant (sw_cell_lab.cuh lists them) and placement of the column's
// loads.  `base` is sw::sweep_strip<16, kAhead> (sw_cell.cuh).
//
// What bounds the work on an H100 is what bounds sw_groups: the INT32 pipe, at
// best 5.5 fused instructions per cell of the recurrence whatever body carries
// it out (only the dpx body uses the fused forms).  The
// lab exists to measure what the order of that work inside a column is worth:
// a shorter dependent chain (fscan, ks), fewer operations (pmax, noadj, dpx),
// score words loaded ahead of the chain (pre), and the column's three global
// loads started one column ahead (load_ahead).

#include "sw_cell_lab.cuh"

namespace {

using namespace sw;

template <int V, bool kAhead>
__global__ void __launch_bounds__(kRowLanes)
sw_groups_lab_kernel(const int8_t* __restrict__ db,
                     const int32_t* __restrict__ groups,
                     const int32_t* __restrict__ query, int m,
                     const int32_t* __restrict__ submat, int oe, int e,
                     int32_t* __restrict__ hrow, int32_t* __restrict__ frow,
                     int32_t* __restrict__ scores) {
  constexpr int U = kStripRows;
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
    best = sweep_strip_lab<U, V, kAhead>(db + base, hrow + base, frow + base,
                                         L, qo, sm, oe, e, i0 == 0,
                                         i0 + U >= m_pad, best);
  }
  scores[(size_t)g * kGroupLanes + (size_t)row * kRowLanes + threadIdx.x] =
      best;
}

template <int V, bool kAhead>
int launch(const void* db, const void* groups, int n_groups,
           const void* query, int m, const void* submat, int open_gap,
           int extend_gap, void* hrow, void* frow, void* scores,
           void* stream) {
  constexpr int U = kStripRows;
  const int m_pad = (m + U - 1) / U * U;
  const size_t shmem = ((size_t)kMatrixWords + m_pad) * sizeof(int32_t);
  if (shmem > 48 * 1024) {
    // a query too long for the card's shared memory is refused here
    const cudaError_t err = cudaFuncSetAttribute(
        sw_groups_lab_kernel<V, kAhead>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) {
      (void)cudaGetLastError();
      return (int)err;
    }
  }
  sw_groups_lab_kernel<V, kAhead>
      <<<n_groups * kRowsPerGroup, kRowLanes, shmem, (cudaStream_t)stream>>>(
      (const int8_t*)db, (const int32_t*)groups, (const int32_t*)query, m,
      (const int32_t*)submat, open_gap + extend_gap, extend_gap,
      (int32_t*)hrow, (int32_t*)frow, (int32_t*)scores);
  return (int)cudaGetLastError();
}

}  // namespace

// sw_groups_launch (sw_groups.cu) with the column body of `variant`
// (sw::LabVariant: 0 base, 1 fscan, 2 pmax, 3 noadj, 4 ks, 5 pre, 6 dpx) and,
// with load_ahead != 0, each column's loads started one column ahead.
// Launches on `stream` without synchronising and returns cudaGetLastError().
extern "C" int sw_groups_lab_launch(const void* db, const void* groups,
                                    int n_groups, const void* query, int m,
                                    const void* submat, int open_gap,
                                    int extend_gap, void* hrow, void* frow,
                                    void* scores, void* stream, int variant,
                                    int load_ahead) {
  if (n_groups <= 0 || m <= 0 || variant < 0 || variant >= kLabVariants)
    return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();   // drop a refused call's error from before
#define SW_LAB_CASE(V)                                                       \
  case V:                                                                    \
    return load_ahead                                                        \
               ? launch<V, true>(db, groups, n_groups, query, m, submat,     \
                                 open_gap, extend_gap, hrow, frow, scores,   \
                                 stream)                                     \
               : launch<V, false>(db, groups, n_groups, query, m, submat,    \
                                  open_gap, extend_gap, hrow, frow, scores,  \
                                  stream)
  switch (variant) {
    SW_LAB_CASE(kBase);
    SW_LAB_CASE(kFscan);
    SW_LAB_CASE(kPmax);
    SW_LAB_CASE(kNoadj);
    SW_LAB_CASE(kKs);
    SW_LAB_CASE(kPre);
    SW_LAB_CASE(kDpx);
  }
#undef SW_LAB_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sw_groups_lab_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
