// The kernel lab of the port: sw_groups with the column body chosen by
// `variant` and the strip height by `rows`, for Hopper (sm_90a).
//
// Replaces scripts/kernel_lab.py::sw_chunk_lab (the Pallas lab kernel) chained
// over a bin as its _scan_bin chains it: one launch scores the query against
// every group of the table and returns the int32 per-lane scores, which every
// variant must give equal to sw_groups'.  The JAX lab's u_rows is `rows` here;
// its group_block and col_unroll set the TPU's schedule and have no
// counterpart.
//
// The kernel is sw_groups_kernel (sw_groups.cu) with three template arguments
// where the engine has constants: the strip height U, the column body
// (sw_cell_lab.cuh) and the placement of a column's shared-memory reads
// (kAhead).  Everything else is the engine's sweep (sw_tile.cuh): the work
// table, rows and pipelined slabs, staged tiles, the per-strip score profile,
// the launch bounds, the query in global memory (any length launches), and
// the branches of split slabs, which the lab never takes: it launches a
// plain grid over a table's plain version (sw_lab.py).  So the lab measures
// bodies on the sweep the engine ships, and `base` with the reads ahead at
// U = 16 is sw_groups itself.
//
// What bounds the work on an H100 is what bounds sw_groups: integer
// instructions, at best 5.5 fused ones per cell of the recurrence whatever
// body carries it out (only `base` and `dpx` use the fused forms).  The lab
// exists to measure what the order of that work inside a column is worth: a
// shorter dependent chain (fscan, ks), fewer operations (pmax, noadj, dpx),
// score words read ahead of the chain (pre), the column's reads one column
// ahead (load_ahead), and the strip height (the per-column and per-strip
// overhead against registers).

#include "sw_cell_lab.cuh"

namespace {

using namespace sw;

template <int U, int V, bool kAhead>
__global__ void __launch_bounds__(kRowLanes, kBlocksPerSm)
sw_groups_lab_kernel(const int8_t* __restrict__ db,
                     const int32_t* __restrict__ groups, int n_groups,
                     const int32_t* __restrict__ work,
                     const int32_t* __restrict__ query, int m,
                     const int32_t* __restrict__ submat, int oe, int e,
                     int32_t* __restrict__ hrow, int32_t* __restrict__ frow,
                     int32_t* __restrict__ scores) {
  __shared__ BlockShared<U> S;
  init_block(S, submat);
  score_item<U, LabBody<U, V>, kAhead>(S, db, groups, n_groups, work, query,
                                       1, OneSegment{m}, oe, e, hrow, frow,
                                       scores);
}

template <int U, int V, bool kAhead>
int launch(const void* db, const void* groups, int n_groups, const void* work,
           int n_items, const void* query, int m, const void* submat,
           int open_gap, int extend_gap, void* hrow, void* frow, void* scores,
           void* stream) {
  sw_groups_lab_kernel<U, V, kAhead>
      <<<n_items, kRowLanes, 0, (cudaStream_t)stream>>>(
      (const int8_t*)db, (const int32_t*)groups, n_groups,
      (const int32_t*)work, (const int32_t*)query, m, (const int32_t*)submat,
      open_gap + extend_gap, extend_gap, (int32_t*)hrow, (int32_t*)frow,
      (int32_t*)scores);
  return (int)cudaGetLastError();
}

}  // namespace

// sw_groups_launch (sw_groups.cu) with the column body of `variant`
// (sw::LabVariant: 0 base, 1 fscan, 2 pmax, 3 noadj, 4 ks, 5 pre, 6 dpx),
// strips of `rows` query rows and, with load_ahead != 0, each column's reads
// one column ahead.  Built: every variant at 16 rows in both placements;
// base and dpx at 8 and 32 rows with the reads ahead.  Any other choice is
// refused with cudaErrorInvalidValue, as are the inputs sw_groups_launch
// refuses.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int sw_groups_lab_launch(const void* db, const void* groups,
                                    int n_groups, const void* work,
                                    int n_items, const void* query, int m,
                                    const void* submat, int open_gap,
                                    int extend_gap, void* hrow, void* frow,
                                    void* scores, void* stream, int variant,
                                    int load_ahead, int rows) {
  if (n_groups <= 0 || n_items <= 0 || m <= 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(db) || !aligned16(hrow) || !aligned16(frow))
    return (int)cudaErrorMisalignedAddress;
  (void)cudaGetLastError();   // drop a refused call's error from before
#define SW_LAB_LAUNCH(U, V, A)                                                \
  launch<U, V, A>(db, groups, n_groups, work, n_items, query, m, submat,      \
                  open_gap, extend_gap, hrow, frow, scores, stream)
#define SW_LAB_CASE(V)                                                        \
  case V:                                                                     \
    return load_ahead ? SW_LAB_LAUNCH(16, V, true) : SW_LAB_LAUNCH(16, V, false)
  if (rows == 16) {
    switch (variant) {
      SW_LAB_CASE(kBase);
      SW_LAB_CASE(kFscan);
      SW_LAB_CASE(kPmax);
      SW_LAB_CASE(kNoadj);
      SW_LAB_CASE(kKs);
      SW_LAB_CASE(kPre);
      SW_LAB_CASE(kDpx);
    }
  } else if (load_ahead && (variant == kBase || variant == kDpx)) {
    const bool dpx = variant == kDpx;
    if (rows == 8)
      return dpx ? SW_LAB_LAUNCH(8, kDpx, true) : SW_LAB_LAUNCH(8, kBase, true);
    if (rows == 32)
      return dpx ? SW_LAB_LAUNCH(32, kDpx, true)
                 : SW_LAB_LAUNCH(32, kBase, true);
  }
#undef SW_LAB_CASE
#undef SW_LAB_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sw_groups_lab_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
