// Score-only affine-gap Smith-Waterman of several packed queries over packed
// database groups in one launch, for Hopper (sm_90a).
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
// Layout, work items, roles and the tiled sweep are those of sw_groups.cu
// (sw_tile.cuh).  What is new:
//
// - Segments run one after another inside the block.  A segment's first
//   strip starts from H = F = 0 above it (nothing read) and a fresh maximum;
//   its last strip hands nothing on, and the maximum goes to
//   scores[s, g, lane].  A strip never straddles two segments: rows past a
//   segment's end use the matrix's zero row.  The one scratch of 8 B per
//   padded residue serves every segment, because a position is read only by
//   the strip below the one that wrote it.
// - In the long role the strips of all segments form one sequence dealt to
//   the four sets in turn (the 4 K sets of a cluster for a split slab), so
//   the pipeline stays full across segment boundaries and a 32-segment
//   launch on a long group has no more fill than a one-segment launch.
// - The packed rows stay in global memory, whatever their number.
//
// What bounds it on an H100: as sw_groups, integer instructions (5.5 fused
// instructions per cell), with the residue column read once per strip from L2.
// PERF.md has the measured times beside the bound.

#include "sw_tile.cuh"

namespace {

using namespace sw;

struct Segments {
  const int32_t* segs;
  int m_tot;
  // a segment outside the packed rows is cut to what lies inside
  __device__ void operator()(int s, int& r0, int& n) const {
    r0 = min(max(__ldg(segs + 2 * s), 0), m_tot);
    n = min(max(__ldg(segs + 2 * s + 1), 0), m_tot - r0);
  }
};

template <int U>
__global__ void __launch_bounds__(kRowLanes, kBlocksPerSm)
sw_groups_packed_kernel(const int8_t* __restrict__ db,
                        const int32_t* __restrict__ groups, int n_groups,
                        const int32_t* __restrict__ work,
                        const int32_t* __restrict__ q_packed, int m_tot,
                        const int32_t* __restrict__ segs, int n_segs,
                        const int32_t* __restrict__ submat, int oe, int e,
                        int32_t* __restrict__ hrow,
                        int32_t* __restrict__ frow,
                        int32_t* __restrict__ scores) {
  __shared__ BlockShared<U> S;
  init_block(S, submat);
  score_item<U, EngineColumn<U>, true>(
      S, db, groups, n_groups, work, q_packed, n_segs, Segments{segs, m_tot},
      oe, e, hrow, frow, scores);
}

}  // namespace

// Scores every segment (first row, row count) of q_packed[0:m_tot] against
// every group; scores is int32[n_segs, n_groups, 8, 128], zeroed by the
// caller.  work and cluster are those of sw_groups_launch (sw_groups.cu).
// hrow and frow are int32 scratch of the residue buffer's size; they and db
// must be 16-byte aligned.  Launches on `stream` without synchronising and
// returns the launch's error.
extern "C" int sw_groups_packed_launch(const void* db, const void* groups,
                                       int n_groups, const void* work,
                                       int n_items, const void* q_packed,
                                       int m_tot, const void* segs,
                                       int n_segs, const void* submat,
                                       int open_gap, int extend_gap,
                                       void* hrow, void* frow, void* scores,
                                       void* stream, int cluster) {
  if (n_groups <= 0 || n_items <= 0 || m_tot <= 0 || n_segs <= 0 ||
      cluster < 1 || cluster > kMaxCluster || n_items % cluster != 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(db) || !aligned16(hrow) || !aligned16(frow))
    return (int)cudaErrorMisalignedAddress;
  (void)cudaGetLastError();   // drop a refused call's error from before
  return launch_items(
      sw_groups_packed_kernel<kStripRows>, n_items, cluster, stream,
      (const int8_t*)db, (const int32_t*)groups, n_groups,
      (const int32_t*)work, (const int32_t*)q_packed, m_tot,
      (const int32_t*)segs, n_segs, (const int32_t*)submat,
      open_gap + extend_gap, extend_gap, (int32_t*)hrow, (int32_t*)frow,
      (int32_t*)scores);
}

// The clusters of `cluster` blocks of the kernel the card holds at once, or
// minus the CUDA error.
extern "C" int sw_groups_packed_max_active_clusters(int cluster) {
  return max_active_clusters(sw_groups_packed_kernel<kStripRows>, cluster);
}

extern "C" const char* sw_groups_packed_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
