// The sweep of the two engine kernels (sw_groups.cu, sw_groups_packed.cu):
// strips of U query rows over column tiles of T columns, one warp per strip,
// every operand of the column loop in shared memory or registers.
//
// Work items.  A launch is a list of items sorted by descending cost
// (sw_lanes.work_table), one block of kSets warps per entry, taken by
// blockIdx, so the longest subjects start first and the short ones fill the
// card behind them.  An item is (group, part):
//
//   part < 8    short role: the 128-lane row `part` of the group.  Warp q owns
//               lanes 32 q .. 32 q + 31 and sweeps every strip of every
//               segment in turn.
//   8 .. 39     long role: the 32 lanes of slab part - 8 of the group (row
//               slab / 4, quarter slab % 4).  The kSets warps of the block are
//               sets of a pipeline over those 32 subjects: the strips of all
//               segments, numbered k = 0, 1, ... in order, go to set k % kSets.
//               The critical path of a subject falls from every strip in turn
//               to a kSets-th of them plus a fill of kSets - 1 tiles.
//   >= 40       split slab: the long role over the K blocks of a thread-block
//               cluster, part = 40 + 32 r + slab in the entry of the cluster's
//               block r.  Warp w of block r is set kSets r + w of a pipeline
//               of kSets K sets, and strip k goes to set k % (kSets K): the
//               critical path falls to a (kSets K)-th of the strips.  The
//               work table gives a slab this role when its critical path
//               would exceed the launch's balanced share, which only the
//               groups of the longest subjects do (sw_lanes.work_table), and
//               puts the K entries of a split slab on one cluster-aligned
//               run of blocks; a launch with split slabs is a cluster launch
//               of K blocks a cluster, in which every other item takes one
//               block and ignores its peers.
//
// Hand-over.  A strip passes H of its last row and the F leaving it, column
// by column, to the strip below.  Every warp has an input ring of kSlots
// tiles in shared memory, [slot][H or F][column][lane].  It is filled
//   - by the warp itself with cp.async (16-byte, L2 only) from the global
//     scratch rows, one tile ahead of the sweep, when the strip above was
//     swept by the same warp (short role) or by the last set in the round
//     before (set 0 of the long role);
//   - by set w - 1 storing straight into set w's ring (long role), a full and
//     an empty mbarrier per slot ordering the two warps;
//   - across the blocks of a split slab, by the last warp of block r storing
//     into the ring of warp 0 of block r + 1 over distributed shared memory
//     (a generic pointer from mapa).  Each of its lanes arrives on that
//     ring's full barrier in block r + 1 (release at cluster scope: each
//     lane publishes its own stores), and warp 0 of block r + 1 arrives,
//     once it has read a slot, on the `sent` barrier of block r, where the
//     last warp waits before it stores into that slot again (both waits
//     acquire at cluster scope).  mbarriers are waited on in their own
//     block only, so the empty side of that ring lives in the sender's.
// The residues of a tile are staged the same way (one 16-byte cp.async per
// lane), so the column loop never waits on global memory.  The output of a
// strip goes to the next set's ring, or with plain stores (which nothing
// waits on) to the scratch rows.
//
// Order on the scratch rows (why reuse in place is safe).  Position (column
// j, lane) is written by strip s and read by strip s + 1 only.  In the short
// role both are the same warp: strip s + 1 starts its first cp.async after the
// last store of strip s and a __syncwarp.  In the long role set 0 and the
// last set each publish, after every tile, the number of tiles they have
// finished (`progress`), the last set behind a __threadfence.  Set 0 starts
// the cp.async of tile c of its strip k only when the last set has finished
// tile c of strip k - 1, and the last set stores tile c of its strip
// k + sets - 1 only when set 0 has finished tile c of strip k: a segment
// that starts between the two cuts the chain of hand-overs that would
// otherwise keep the last set behind set 0.  A split slab's two counters
// live in the shared memory of block 0, which holds set 0; the last set, in
// block K - 1, writes and reads them over distributed shared memory (relaxed
// at cluster scope, the fences at GPU scope as before).
//
// No block waits on a block outside its cluster: every wait is between warps
// of one block (mbarriers and counters in shared memory) or, in a split slab,
// between the blocks of one cluster, which the card schedules together, so
// a block never waits on one that has not started.  The blocks of a split
// slab meet at a cluster barrier once their barriers are initialised, before
// the first hand-over, and again before they exit, so that no block leaves
// while a peer may still store into its shared memory.  Tensor cores are not
// used: wgmma has no max-plus product.
//
// The sweep is a template over the strip height U, the column body and the
// placement of a column's shared-memory reads.  The engine kernels take
// U = kStripRows, EngineColumn and the reads one column ahead; the kernel lab
// (sw_groups_lab.cu) takes other bodies and placements on the same sweep,
// split slabs included, and launches plain grids only.

#pragma once

#include "sw_cell.cuh"

namespace sw {

constexpr int kTileCols = 8;        // T: columns of one staged tile
constexpr int kSets = 4;            // W: warps of a block, sets of the pipeline
constexpr int kWarpLanes = 32;
constexpr int kSlots = 2;           // tiles of an input ring
constexpr int kQuarters = kRowLanes / kWarpLanes;
constexpr int kSlabsPerGroup = kRowsPerGroup * kQuarters;  // 32-lane slabs
constexpr int kSplitFrom = kRowsPerGroup + kSlabsPerGroup;  // first split part
constexpr int kMaxCluster = 8;      // blocks of a split slab (portable size)
// Blocks an SM must hold, which caps the registers of a thread.  The build
// sets it (kernels/build.py: BLOCKS_PER_SM, which also sizes the card for the
// work table), so the value stands in one place.
// Measured on the final sweep over a SwissProt-sized database (NVIDIA H100
// 80GB HBM3, 700.00 W; `python -m oswald_tpu_torch.lab --blocks-per-sm
// 4,3,5,4`; sw_groups at m = 512 / sw_groups_packed at 2 x 512 / at 8 x 65
// rows): 3 blocks, 94 and 128 registers: 39.37 / 80.07 / 48.20 ms; 4 blocks,
// 120 and 128 registers: 39.65 / 80.43 / 48.45 ms (again: 39.65 / 80.47 /
// 48.46); 5 blocks, 87 and 93 registers: 40.47 / 78.65 / 47.04 ms; no build
// spills.  Flat within 3%: the sweep is bound by the integer pipe, not by
// latency, so more resident warps buy nothing.  4 is shipped: it is what
// both kernels' registers hold in fact (at 3, sw_groups' 94 registers hold 5
// and the packed kernel's 128 hold 4), so the launch bounds, the registers
// and sw_lanes.CARD_BLOCKS describe the same kernel.  (An
// earlier body, with matrix lookups in the column loop, took 55.0 / 47.8 /
// 45.8 / 46.1 ms at 6 / 5 / 4 / 3 blocks and spilled at 6.)
#ifndef SW_BLOCKS_PER_SM
#error "SW_BLOCKS_PER_SM is not set: build through oswald_tpu_torch/kernels/build.py"
#endif
constexpr int kBlocksPerSm = SW_BLOCKS_PER_SM;

static_assert(kSets * kWarpLanes == kRowLanes, "a block is one 128-lane row");
static_assert(kTileCols * kWarpLanes * 4 / 16 % kWarpLanes == 0,
              "the 16-byte chunks of an H tile divide among the lanes");
static_assert(2 * kTileCols <= kWarpLanes,
              "the 16-byte chunks of a residue tile fit one per lane");

template <int U>
struct __align__(16) WarpShared {
  int32_t hf[kSlots][2][kTileCols][kWarpLanes];   // input ring: H, F
  int8_t res[2][kTileCols][kWarpLanes];           // staged residues
  // the strip's scores: [rows u / 4][residue][row u % 4], so the U scores
  // of a residue are U / 4 16-byte words
  int32_t prof[U / 4][kAlpha][4];
  unsigned long long full[kSlots], empty[kSlots]; // mbarriers of the ring
};

template <int U>
struct __align__(16) BlockShared {
  int32_t sm[kMatrixWords];         // 24 x 24 matrix and a row of zeros
  WarpShared<U> warp[kSets];
  // split slab: warp 0 of the next block has read a slot of its ring (the
  // last warp of this block waits here before it fills the slot again)
  unsigned long long sent[kSlots];
  int progress[2];                  // tiles finished by set 0, by the last set
};

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   shared_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   shared_addr(bar))
               : "memory");
}

// Returns when the phase of parity `parity` has completed (at once for
// parity 1 on a barrier no phase of which has completed).
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          int parity) {
  const uint32_t addr = shared_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// mbar_wait on a barrier of this block that a peer block of the cluster
// arrives on: acquires what the peer released before its arrival.
__device__ __forceinline__ void mbar_wait_cluster(unsigned long long* bar,
                                                  int parity) {
  const uint32_t addr = shared_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// This block's rank in its cluster, and the cluster's blocks (1 outside a
// cluster launch).
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return (int)n;
}

// Every thread of the cluster: what each wrote before is visible to all
// after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The generic address of *p in the shared memory of block `rank` of the
// cluster.
template <class T>
__device__ __forceinline__ T* peer_ptr(T* p, int rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(out)
               : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<T*>(out);
}

// Arrive on the barrier of block `rank` of the cluster at the place of *bar
// in this block, releasing this thread's earlier stores at cluster scope.
__device__ __forceinline__ void mbar_arrive_peer(unsigned long long* bar,
                                                 int rank) {
  asm volatile(
      "{\n"
      ".reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n"
      "}\n" ::"r"(shared_addr(bar)),
      "r"(rank)
      : "memory");
}

// A counter of `progress`, in this block or a peer's, at cluster scope.
__device__ __forceinline__ int load_count(const int* p) {
  int v;
  asm volatile("ld.relaxed.cluster.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_count(int* p, int v) {
  asm volatile("st.relaxed.cluster.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Once per block, before the first sweep: the matrix, the barriers (one
// arrival each: lane 0 of the warp that filled or drained the slot; warp 0's
// ring is filled only from the block before in a split slab, whose last
// warp arrives with every lane) and the counter.
template <int U>
__device__ __forceinline__ void init_block(BlockShared<U>& S,
                                           const int32_t* __restrict__ submat) {
  load_matrix(S.sm, submat);
  if (threadIdx.x < kSets) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&S.warp[threadIdx.x].full[s],
                threadIdx.x == 0 ? kWarpLanes : 1);
      mbar_init(&S.warp[threadIdx.x].empty[s], 1);
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) mbar_init(&S.sent[s], 1);
    S.progress[0] = S.progress[1] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// What a warp carries from strip to strip of one item.
struct WarpState {
  int set;          // this warp's set (0 in the short role)
  int sets;         // sets of the pipeline (1 in the short role)
  int n_in;         // tiles taken from the input ring so far
  int n_out;        // tiles stored into the next set's ring so far
  int n_done;       // tiles swept so far
};

// The U scores of residue r from a strip's profile: U / 4 16-byte words.
template <int U>
__device__ __forceinline__ void load_scores(const int32_t* prof, int r,
                                            int32_t (&sc)[U]) {
  const int4* pr = reinterpret_cast<const int4*>(prof) + r;
#pragma unroll
  for (int k = 0; k < U / 4; ++k) {
    const int4 v = pr[k * kAlpha];
    sc[4 * k] = v.x;
    sc[4 * k + 1] = v.y;
    sc[4 * k + 2] = v.z;
    sc[4 * k + 3] = v.w;
  }
}

// The column body of the engine kernels: one column of U rows as one chain.
// A body is called once per column with the strip's profile, the column's
// residue r (and, where kNext, the next column's residue rn of the same
// tile), H[i0 - 1][j - 1] as diag, the F entering the strip's first row, and
// hl/ee carrying H[.][j - 1] and E[.][j] in and H[.][j] and E[.][j + 1] out;
// it returns the F leaving the last row and folds every cur' into best.
// head() is called at the head of every tile with the residue of its first
// column.
//
// The sweep is bound by integer instructions (PERF.md), so the chain is written
// for few integer instructions: the cell update of sw_cell.cuh in Hopper's
// fused add-max and three-way max forms, and the U scores of a column as
// U / 4 16-byte loads from the strip's profile (24 residues x U rows, built
// in shared memory at the head of the strip) instead of U address sums and
// U loads from the matrix.  Measured over a SwissProt-sized database at
// m = 512 (NVIDIA H100 80GB HBM3, 700.00 W): 46.1 ms with lookups in the
// matrix, 41.3 ms with the profile, 39.4 ms with the three-way max as well.
template <int U>
struct EngineColumn {
  static constexpr bool kNext = false;
  __device__ __forceinline__ void head(const int32_t*, int) {}
  __device__ __forceinline__ int32_t operator()(
      const int32_t* prof, int r, int, int32_t diag, int32_t f,
      int32_t (&hl)[U], int32_t (&ee)[U], int oe, int e, int32_t& best) {
    int32_t sc[U];                  // scores of the U rows against r
    load_scores<U>(prof, r, sc);
    int32_t cp_even = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int32_t cp = __viaddmax_s32_relu(diag, sc[u], ee[u]);
      const int32_t cc = cp - oe;
      if (u % 2 == 0)
        cp_even = cp;
      else
        best = __vimax3_s32(best, cp_even, cp);
      diag = hl[u];
      hl[u] = max(cp, f);
      ee[u] = __viaddmax_s32(ee[u], -e, cc);
      f = __viaddmax_s32(f, -e, cc);
    }
    return f;
  }
};

// One warp sweeps one strip of U rows over the L columns of its 32 subjects
// with column body Body (EngineColumn<U> in the engine kernels).
// qrow points at the strip's first row code, of which nrow (or more) are
// left in the segment; rows past them score 0.  res, hrow and frow point at
// lane 0 of the slab in column 0; consecutive columns are kGroupLanes
// entries apart.
// Unless `first`, H above the strip and F entering it come through the input
// ring; unless `last`, H of the strip's last row and F leaving it go to the
// next set's ring or to hrow/frow.  Returns the maximum of `best` and every
// cur' of the strip.
// With kAhead the residue, H and F of column j + 1 leave shared memory
// before column j's chain; without it they are read where they are used.
// The pipeline may span the blocks of a cluster (split slab): set
// kSets r + w is warp w of block r, and the counters are block 0's.
template <int U, class Body, bool kAhead>
__device__ __forceinline__ int32_t sweep_tiles(
    BlockShared<U>& S, WarpState& st, const int8_t* __restrict__ res,
    int32_t* __restrict__ hrow, int32_t* __restrict__ frow, int L,
    const int32_t* __restrict__ qrow, int nrow, int oe, int e, bool first,
    bool last, int32_t best) {
  static_assert(U % 4 == 0, "the profile holds U rows as 16-byte words");
  constexpr int T = kTileCols;
  const int lane = threadIdx.x % kWarpLanes;
  const int n_tiles = (L + T - 1) / T;
  // every warp has its own ring; in the long role warp w is set w
  const int warp = threadIdx.x / kWarpLanes;
  WarpShared<U>& in = S.warp[warp];
  const bool from_ring = !first && st.set > 0;
  const bool from_scratch = !first && st.set == 0;
  const bool to_ring = !last && st.set + 1 < st.sets;
  const bool to_scratch = !last && st.set + 1 == st.sets;
  // split slab: into warp 0's ring of the next block, out of the last
  // warp of the block before
  const bool to_peer = to_ring && warp + 1 == kSets;
  const bool from_peer = from_ring && warp == 0;
  // this block's rank in a split slab, and the item's counters, taken
  // where they are used (what is held across the sweep costs the packed
  // kernel registers, which it has none to spare of)
  auto rank = [&]() { return st.set / kSets; };
  auto progress = [&]() -> int* {
    return rank() > 0 ? peer_ptr(S.progress, 0) : S.progress;
  };
  // which counter of `progress` this warp publishes: set 0 and the last
  // set of a pipeline do
  const int publishes = st.sets == 1 ? -1 : st.set == 0 ? 0 :
                        st.set + 1 == st.sets ? 1 : -1;
  // set 0 of a pipeline reads what the last set wrote a round ago: tile c
  // may be fetched once the last set has finished `gate + c` tiles
  const bool gated = from_scratch && st.sets > 1;
  const int gate = st.n_done - n_tiles + 1;
  // the last set overwrites what set 0 read in the same round: tile c may
  // be stored once set 0 has finished `st.n_done + c + 1` tiles
  const bool held = to_scratch && st.sets > 1;
  const int hold = st.n_done + 1;
  const int32_t* sm = S.sm;
  const int32_t* prof = &in.prof[0][0][0];

  auto fetch = [&](int c) {
    const int cols = min(T, L - c * T);
    if (gated) {
      while (load_count(&progress()[1]) < gate + c) __nanosleep(32);
      __threadfence();
    }
    // residues: 16-byte chunk lane % 2 of column lane / 2
    if (lane < 2 * T && lane / 2 < cols)
      cp_async16(&in.res[c & 1][lane / 2][(lane % 2) * 16],
                 res + (size_t)(c * T + lane / 2) * kGroupLanes +
                     (lane % 2) * 16);
    if (from_scratch) {
#pragma unroll
      for (int i = 0; i < T * 8 / kWarpLanes; ++i) {
        // H and F: 16-byte chunk q % 8 of column q / 8
        const int q = i * kWarpLanes + lane;
        if (q / 8 < cols) {
          const size_t g = (size_t)(c * T + q / 8) * kGroupLanes + (q % 8) * 4;
          cp_async16(&in.hf[c & 1][0][q / 8][(q % 8) * 4], hrow + g);
          cp_async16(&in.hf[c & 1][1][q / 8][(q % 8) * 4], frow + g);
        }
      }
    }
    cp_async_commit();
  };

  int32_t hl[U], ee[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    hl[u] = 0;                      // H[i0 + u][j - 1]
    ee[u] = 0;                      // E[i0 + u][j]
  }
  int32_t hprev = 0;                // H[i0 - 1][j - 1]
  Body body;
  __syncwarp();                     // the strip before is stored and read
  if (n_tiles > 0) fetch(0);
  // the profile; the first __syncwarp of the tile loop publishes it
  for (int i = lane; i < U * kAlpha; i += kWarpLanes) {
    const int k = i / (4 * kAlpha), r = i / 4 % kAlpha, u = k * 4 + i % 4;
    (&in.prof[0][0][0])[i] =
        sm[(u < nrow ? __ldg(qrow + u) : kZeroRow) * kAlpha + r];
  }
  for (int c = 0; c < n_tiles; ++c) {
    cp_async_wait_all();
    __syncwarp();                   // tile c has landed; tile c - 1 is read
    if (c + 1 < n_tiles) fetch(c + 1);
    const int cols = min(T, L - c * T);
    // where this tile's H and F come from and go to
    int slot = c & 1;
    if (from_ring) {
      slot = st.n_in % kSlots;
      if (from_peer)
        mbar_wait_cluster(&in.full[slot], (st.n_in / kSlots) & 1);
      else
        mbar_wait(&in.full[slot], (st.n_in / kSlots) & 1);
    }
    const int32_t* in_h = &in.hf[slot][0][0][lane];
    const int32_t* in_f = &in.hf[slot][1][0][lane];
    int32_t* out_h = hrow + (size_t)c * T * kGroupLanes + lane;
    int32_t* out_f = frow + (size_t)c * T * kGroupLanes + lane;
    int out_step = kGroupLanes;
    int out_slot = 0;
    if (to_ring) {
      out_slot = st.n_out % kSlots;
      const int parity = ((st.n_out / kSlots) & 1) ^ 1;
      WarpShared<U>* next;
      if (to_peer) {
        next = peer_ptr(&S.warp[0], rank() + 1);
        mbar_wait_cluster(&S.sent[out_slot], parity);
      } else {
        next = &S.warp[warp + 1];
        mbar_wait(&next->empty[out_slot], parity);
      }
      out_h = &next->hf[out_slot][0][0][lane];
      out_f = &next->hf[out_slot][1][0][lane];
      out_step = kWarpLanes;
    }
    if (held) {
      while (load_count(&progress()[0]) < hold + c) __nanosleep(32);
    }
    const int8_t* rs = &in.res[c & 1][0][lane];
    if constexpr (kAhead) {
      // column j + 1's operands leave shared memory before column j's chain
      int r_next = rs[0];
      int32_t hup_next = first ? 0 : in_h[0];
      int32_t f_next = first ? 0 : in_f[0];
      body.head(prof, r_next);
      for (int j = 0; j < cols; ++j) {
        const int r = r_next;
        const int32_t hup = hup_next;   // H[i0 - 1][j]
        int32_t f = f_next;             // F[i0][j]
        const int jn = min(j + 1, cols - 1) * kWarpLanes;
        r_next = rs[jn];
        if (!first) {
          hup_next = in_h[jn];
          f_next = in_f[jn];
        }
        f = body(prof, r, r_next, hprev, f, hl, ee, oe, e, best);
        if (!last) {
          out_h[j * out_step] = hl[U - 1];
          out_f[j * out_step] = f;
        }
        hprev = hup;
      }
    } else {
      body.head(prof, rs[0]);
      for (int j = 0; j < cols; ++j) {
        const int r = rs[j * kWarpLanes];
        const int32_t hup = first ? 0 : in_h[j * kWarpLanes];
        int32_t f = first ? 0 : in_f[j * kWarpLanes];
        const int rn = Body::kNext ? rs[min(j + 1, cols - 1) * kWarpLanes] : 0;
        f = body(prof, r, rn, hprev, f, hl, ee, oe, e, best);
        if (!last) {
          out_h[j * out_step] = hl[U - 1];
          out_f[j * out_step] = f;
        }
        hprev = hup;
      }
    }
    ++st.n_done;
    if (from_ring || to_ring || publishes >= 0) {
      // the two slots again, from the counts: held across the column loop
      // they cost the packed kernel a spilled register
      const int in_slot = st.n_in % kSlots, to_slot = st.n_out % kSlots;
      __syncwarp();                 // every lane has read and stored
      // each lane releases its own stores into the next block's ring
      if (to_peer) mbar_arrive_peer(&S.warp[0].full[to_slot], rank() + 1);
      if (lane == 0) {
        if (from_peer)
          mbar_arrive_peer(&S.sent[in_slot], rank() - 1);
        else if (from_ring)
          mbar_arrive(&in.empty[in_slot]);
        if (to_ring && !to_peer)
          mbar_arrive(&S.warp[warp + 1].full[to_slot]);
        if (publishes >= 0) {
          if (to_scratch) __threadfence();
          store_count(&progress()[publishes], st.n_done);
        }
      }
    }
    if (from_ring) ++st.n_in;
    if (to_ring) ++st.n_out;
  }
  return best;
}

// The segments of a one-query launch: the query's m rows.
struct OneSegment {
  int m;
  __device__ void operator()(int, int& r0, int& n) const {
    r0 = 0;
    n = m;
  }
};

// One block scores one work item for every segment (the blocks of a
// cluster together score a split slab).  `seg(s, r0, n)` gives
// segment s as (first row, row count) into q; scores is int32[n_segs,
// n_groups, 8, 128], zeroed before the launch (the sets of the long role
// merge their maxima with atomicMax).
template <int U, class Body, bool kAhead, class Seg>
__device__ __forceinline__ void score_item(
    BlockShared<U>& S, const int8_t* __restrict__ db,
    const int32_t* __restrict__ groups, int n_groups,
    const int32_t* __restrict__ work, const int32_t* __restrict__ q,
    int n_segs, Seg seg, int oe, int e, int32_t* __restrict__ hrow,
    int32_t* __restrict__ frow, int32_t* __restrict__ scores) {
  const int warp = threadIdx.x / kWarpLanes;
  const int lane = threadIdx.x % kWarpLanes;
  const int g = work[2 * blockIdx.x];
  const int part = work[2 * blockIdx.x + 1];
  const bool pipelined = part >= kRowsPerGroup;
  // a split slab's blocks are the cluster's, in rank order
  const bool split = part >= kSplitFrom;
  const int rank = split ? cluster_rank() : 0;
  const int blocks = split ? cluster_blocks() : 1;
  const int slab = !pipelined ? part * kQuarters + warp
                              : (part - kRowsPerGroup) % kSlabsPerGroup;
  WarpState st = {pipelined ? rank * kSets + warp : 0,
                  pipelined ? blocks * kSets : 1, 0, 0, 0};
  if (split) cluster_sync();        // every block's barriers are ready
  const size_t lane0 = (size_t)slab * kWarpLanes;
  const size_t base = (size_t)groups[2 * g] * kGroupLanes + lane0;
  const int L = groups[2 * g + 1];

  int k0 = 0;                       // strips before this segment, mod sets
  for (int s = 0; s < n_segs; ++s) {
    int r0, n;
    seg(s, r0, n);
    const int n_strips = (n + U - 1) / U;
    int32_t best = 0;
    for (int t = (st.set - k0 + st.sets) % st.sets; t < n_strips;
         t += st.sets) {
      best = sweep_tiles<U, Body, kAhead>(S, st, db + base, hrow + base,
                                          frow + base, L, q + r0 + t * U,
                                          n - t * U, oe, e, t == 0,
                                          t == n_strips - 1, best);
    }
    k0 = (k0 + n_strips) % st.sets;
    int32_t* out = scores + ((size_t)s * n_groups + g) * kGroupLanes + lane0 +
                   lane;
    if (!pipelined)
      *out = best;
    else if (best > 0)
      atomicMax(out, best);
  }
  // no peer stores here any more (only a split slab's pipeline has more
  // sets than a block has warps)
  if (st.sets > kSets) cluster_sync();
}

// Launches `kernel` over n_items blocks of kRowLanes threads on `stream`: a
// plain launch for cluster == 1, else a launch of clusters of `cluster`
// blocks (a work table with split slabs).  Returns the launch's error.
template <class... Params, class... Args>
inline int launch_items(void (*kernel)(Params...), int n_items, int cluster,
                        void* stream, Args... args) {
  if (cluster == 1) {
    kernel<<<n_items, kRowLanes, 0, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_items);
  cfg.blockDim = dim3(kRowLanes);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The clusters of `cluster` blocks of `kernel` the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
template <class... Params>
inline int max_active_clusters(void (*kernel)(Params...), int cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 1024);
  cfg.blockDim = dim3(kRowLanes);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// True where the 16-byte copies of the sweep can address the buffer.
inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace sw
