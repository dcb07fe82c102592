// Score-only affine-gap Smith-Waterman over packed database groups for
// Hopper (sm_90a): one query against every group of the database in one
// launch.
//
// Replaces oswald_tpu/kernels/sw_lanes.py::sw_chunk (the Pallas kernel)
// chained over all column chunks of every bin.
//
// Layout.  The database is one flat int8 buffer of columns; a group is L
// consecutive columns of 1024 residues ([L, 8, 128]: lane = sublane * 128 +
// lane-in-row), and the group table holds (first column, L) per group.  One
// thread scores one subject at a time, a warp 32 neighbouring subjects, so a
// column of a warp is 32 contiguous bytes.
//
// Design (sw_tile.cuh has the sweep and the order its barriers enforce):
// - a work table sorted by descending cost gives every block its item, so
//   the longest groups start first instead of last;
// - a short group's item is a 128-lane row, its four warps each sweeping
//   every strip of U = 16 query rows over their own 32 subjects; a long
//   group's item is 32 subjects, and the four warps are sets of a pipeline
//   that take the strips in turn, H and F crossing from set to set through
//   rings in shared memory, so a long subject's critical path is a quarter
//   of its strips and only a quarter of them touch the global scratch;
// - the slabs of the longest subjects, whose critical path would exceed the
//   launch's balanced share even so (the giants of a Swiss-Prot release,
//   35,213 residues, against a median of ~270), are split: the 4 K warps of
//   a cluster of K blocks are the sets, H and F crossing from block to block
//   through distributed shared memory, so the critical path is a (4 K)-th
//   of the strips.  Such a launch is a cluster launch; one whose work table
//   splits nothing launches as a plain grid;
// - residues and the H/F rows read back from the scratch reach shared memory
//   by cp.async a tile of 8 columns ahead, so the column loop reads shared
//   memory and registers only;
// - the query stays in global memory: a strip reads its 16 row codes once,
//   to build the strip's 24 x 16 score profile, and shared memory (27 KB,
//   static) does not grow with the query.
//
// What bounds it on an H100: integer instructions.  The ten additions and
// maxima of a cell fuse into 5.5 instructions (add-max with a floor of 0,
// add-max, one three-way max for two cells), issued at most 128 lanes an SM
// and clock; the bytes (each residue once, each score once) are a
// thousandth of that.  Tensor cores are not used: wgmma has no max-plus
// product.  PERF.md has the measured times beside the bound.

#include "sw_tile.cuh"

namespace {

using namespace sw;

template <int U>
__global__ void __launch_bounds__(kRowLanes, kBlocksPerSm)
sw_groups_kernel(const int8_t* __restrict__ db,
                 const int32_t* __restrict__ groups, int n_groups,
                 const int32_t* __restrict__ work,
                 const int32_t* __restrict__ query, int m,
                 const int32_t* __restrict__ submat, int oe, int e,
                 int32_t* __restrict__ hrow, int32_t* __restrict__ frow,
                 int32_t* __restrict__ scores) {
  __shared__ BlockShared<U> S;
  init_block(S, submat);
  score_item<U, EngineColumn<U>, true>(S, db, groups, n_groups, work, query,
                                       1, OneSegment{m}, oe, e, hrow, frow,
                                       scores);
}

}  // namespace

// Scores query[0:m] against every group; scores is int32[n_groups, 8, 128],
// zeroed by the caller.  work is int32[n_items, 2], the (group, part) entry
// of each block in launch order (sw_lanes.work_table), laid out in aligned
// runs of `cluster` blocks when it splits slabs (cluster > 1: a cluster
// launch), else cluster is 1.  hrow and frow are int32 scratch of the residue
// buffer's size; they and db must be 16-byte aligned.  Launches on `stream`
// without synchronising and returns the launch's error.
extern "C" int sw_groups_launch(const void* db, const void* groups,
                                int n_groups, const void* work, int n_items,
                                const void* query, int m, const void* submat,
                                int open_gap, int extend_gap, void* hrow,
                                void* frow, void* scores, void* stream,
                                int cluster) {
  if (n_groups <= 0 || n_items <= 0 || m <= 0 || cluster < 1 ||
      cluster > kMaxCluster || n_items % cluster != 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(db) || !aligned16(hrow) || !aligned16(frow))
    return (int)cudaErrorMisalignedAddress;
  (void)cudaGetLastError();   // drop a refused call's error from before
  return launch_items(
      sw_groups_kernel<kStripRows>, n_items, cluster, stream,
      (const int8_t*)db, (const int32_t*)groups, n_groups,
      (const int32_t*)work, (const int32_t*)query, m, (const int32_t*)submat,
      open_gap + extend_gap, extend_gap, (int32_t*)hrow, (int32_t*)frow,
      (int32_t*)scores);
}

// The clusters of `cluster` blocks of the kernel the card holds at once, or
// minus the CUDA error.
extern "C" int sw_groups_max_active_clusters(int cluster) {
  return max_active_clusters(sw_groups_kernel<kStripRows>, cluster);
}

extern "C" const char* sw_groups_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
