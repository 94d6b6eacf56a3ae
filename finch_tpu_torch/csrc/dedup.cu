// Weighted dedup kernels for Hopper (sm_90a): tier D and tier D2.
//
// Replace the Pallas TPU kernels finch_tpu/ops/pallas_extract.py
// `_dedup_kernel` (tier D) and `_dedup_slab_kernel` (tier D2). The Python
// wrappers, the contract and the plain PyTorch versions are in
// finch_tpu_torch/ops/dedup.py. Both kernels run the same accumulator step
// per column (one of CHUNK_W=2048), carried over the batch in order:
//
//   new rows: tier D, one chunk's 32 lanes of the column: a survivor (not
//     padding, hash <= *thresh) is v + 1 with weight 1, any other lane
//     u64::MAX; tier D2, 32 rows of the extract kernel's slab (4 chunks of
//     8), every real entry with weight 1.
//   step: sort the 96 accumulator rows and the 32 new rows by value; every
//     run of equal real values collapses into its first row, which takes
//     the run's total weight, and the run's other rows become u64::MAX
//     holes in place; ovf |= a real head at row >= 96, or a head weight
//     >= 2^(64 - wshift) when that field is under 32 bits; keep rows 0..95.
//   output: cand[r, col] = row r after the last step, a real row written
//     value + ((weight - 1) << wshift), holes and pads u64::MAX.
//
// The row of a head is therefore the number of rows whose value is smaller:
// (accumulator heads below it) + (new rows below it), duplicates included.
// Both kernels compute that directly instead of sorting 128 rows.
//
// What bounds it on the H100: bytes. Tier D reads 16 B per lane (value and
// hash planes), tier D2 8 B per slab entry, once, and both write 1.5 MB of
// cand: 10 us for tier D at the engines' 2M-lane batch, 1.7 us for D2. But
// each column's steps form a sequential chain, one warp per column (2048
// warps, about 15 per SM), so the designs keep two things off that chain:
// device memory, and whatever work of a step does not depend on the
// accumulator.
//
//   One accumulator step for both tiers (DupColumn). The column's m
//     compacted heads, ascending, sit in its warp's shared memory with
//     their weights and, after a step with new values, their rows. Only the
//     last step's rows reach the output, and a step drops a head only at
//     row 96 or beyond, so consecutive steps whose real values, added to
//     the held heads, number at most 96 are merged into one pass. A pass
//     finds each new value's copies and its place among the held heads (a
//     4-way search of the compacted heads), then each head's row, weight
//     and compacted index: by a loop over the new values when they are
//     few, else from the new values sorted across the warp and a search
//     across the lanes; one scatter compacts the heads.
//   dedup_slab_warp (tier D2), grid CHUNK_W / 8: the block streams its 8
//     columns' slab rows through a shared-memory ring with cp.async
//     (warp.cuh), 8 steps a stage, one block barrier a stage.
//   dedup_lanes_warp (tier D), grid CHUNK_W / 8: the four planes stream
//     through a shared-memory ring with 16-byte cp.async, 4 chunks a
//     stage and 3 stages in flight (no registers held); each thread turns
//     the unit it copied into new rows (threshold test, + 1) as soon as
//     it lands, so the block meets once per stage. Two kinds of work leave
//     the chain: a stage whose steps are dense (every lane survives on a
//     cold batch) is sorted across the lanes before the chain walks it,
//     its steps interleaved so that their shuffles overlap, and the
//     passes take the values sorted; and a dense step whose values are all
//     copies of held heads, the usual step of a duplicate burst, only adds
//     their copies to the heads' weights (shared-memory atomics), which is
//     all the function does there when no row can reach 96 and the step is
//     not the last.

// Plain C interface for ctypes; the launchers return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "warp.cuh"

namespace {

constexpr int COLH = 32;
constexpr int ROWS_OUT = 8;
constexpr int DUP_ACC_H = 96;
constexpr int DUP_GROUP = 4;
constexpr int NEW = 32;  // new rows per step, one per lane
constexpr int ACC_SLOTS = DUP_ACC_H / 32;  // heads per lane
constexpr int SORT_MIN = 12;  // passes over more values sort them
constexpr int THREADS = BLOCK;
// tier D's stages: chunks a stage, ring slots
constexpr int RAW_STEPS = 4;
constexpr int RAW_SLOTS = 4;

static_assert(DUP_GROUP * ROWS_OUT == NEW && NEW == STEP_ROWS,
              "a D2 step merges 32 slab rows");
static_assert(COLH == NEW, "a D step merges one chunk's 32 lanes");
static_assert(DUP_ACC_H % 32 == 0, "accumulator rows come in warp rounds");
static_assert(RAW_STEPS * COLH * WARPS == 4 * BLOCK && WARPS == 8,
              "a tier-D stage is one 4-lane unit a thread");

__device__ __forceinline__ uint32_t weight_limit(int wshift) {
  const int wbits = 64 - wshift;
  return wbits < 32 ? (1u << wbits) : 0xFFFFFFFFu;
}

// The shared memory of a block's 8 accumulators.
struct DupHeads {
  uint64_t hv[WARPS][DUP_ACC_H];  // heads, compacted and ascending
  uint32_t hw[WARPS][DUP_ACC_H];  // their weights
  uint8_t hr[WARPS][DUP_ACC_H];   // their rows after the last pass
  uint64_t pv[WARPS][NEW];        // values waiting for a merged pass
};

// One column's accumulator, carried by its warp: the lanes call every
// member together. The m compacted heads, ascending, are heads[0, m) with
// weights hw[0, m); their rows in the last step's layout are hr[i] if that
// step had new values (`moved`), else i.
//
// Steps are merged into passes. While the held heads plus the real new
// values of consecutive steps number at most 96 (and fit one 32-lane
// pass), no row of those steps can reach 96, so no head drops and the
// steps leave exactly the heads, weights and flag of one pass over all
// their values: such values wait in pv[0, np). A step that could overflow
// runs alone, after the waiting values, as does the last step, the only
// one whose rows reach the output. A dense step whose values are all
// copies of held heads, under the same bound, only adds to their weights
// (add_hits).
struct DupColumn {
  uint64_t* heads;
  uint32_t* hw;
  uint8_t* hr;
  uint64_t* pv;
  int lane;
  unsigned below_me;
  uint32_t wlimit;
  int m = 0;               // heads, the same in every lane
  int np = 0;              // values waiting in pv, the same in every lane
  bool pv_sorted = false;  // pv holds one step's values, ascending
  bool moved = false;      // the last step had new values: rows in hr
  bool hits = false;       // the last dense pass held only copies of heads
  bool ovf = false;

  __device__ DupColumn(DupHeads& s, int warp, int lane_, uint32_t wlimit_)
      : heads(s.hv[warp]), hw(s.hw[warp]), hr(s.hr[warp]), pv(s.pv[warp]),
        lane(lane_), below_me((1u << lane_) - 1u), wlimit(wlimit_) {}

  // The number of heads below x: a 4-way search (spans 32, 8, 2: 3
  // independent probes a round), then one probe.
  __device__ int heads_below(uint64_t x) const {
    int lt = 0;
#pragma unroll
    for (int span = 32; span > 0; span >>= 2) {
      if (span > m) continue;  // the same in every lane
      int up = 0;
#pragma unroll
      for (int q = 1; q <= 3; ++q) {
        const int probe = lt + q * span;
        const uint64_t h = heads[(probe <= m ? probe : 1) - 1];
        up += probe <= m && h < x;
      }
      lt += up * span;
    }
    if (lt < m && heads[lt] < x) ++lt;  // the last span, 1
    return lt;
  }

  // One pass: merge this lane's value x (u64::MAX = none) into the heads,
  // as one step of the function does. `ascending`: the values are sorted
  // across the lanes already, the real ones first. The counts below are
  // found by a loop over the real values when they are few, else from the
  // values sorted across the warp.
  __device__ void pass(uint64_t x, bool ascending) {
    const bool real = x != U64_MAX;
    const unsigned reals = __ballot_sync(FULL, real);
    const int n = __popc(reals);
    const bool sorted = n > SORT_MIN;  // the same in every lane
    const int slots = (m + 31) >> 5;   // head slots in use, in every lane
    uint64_t a[ACC_SLOTS];
    uint32_t w[ACC_SLOTS];
#pragma unroll
    for (int j = 0; j < ACC_SLOTS; ++j) {
      const int i = j * 32 + lane;
      const bool live = j < slots && i < m;
      a[j] = live ? heads[i] : U64_MAX;
      w[j] = live ? hw[i] : 0u;
    }
    // first: x is the first copy of its value; copies: how many there are
    bool first;
    uint32_t copies;
    if (sorted) {
      if (!ascending) x = warp_sort(x, lane);  // the n real values first
      const uint64_t prev = __shfl_up_sync(FULL, x, 1);
      first = lane < n && (lane == 0 || prev != x);
      const unsigned later = __ballot_sync(FULL, first) & ~((2u << lane) - 1u);
      copies = first ? uint32_t((later ? __ffs(later) - 1 : n) - lane) : 0u;
    } else {
      const unsigned same = __match_any_sync(FULL, x);
      first = real && (same & below_me) == 0;
      copies = uint32_t(__popc(same));
    }
    const int lt_acc = heads_below(x);
    const bool in_acc = lt_acc < m && heads[lt_acc < m ? lt_acc : 0] == x;
    if (sorted) hits = __all_sync(FULL, x == U64_MAX || in_acc);
    const unsigned fresh_heads = __ballot_sync(FULL, first && !in_acc);
    int below[ACC_SLOTS] = {};  // new rows below head j
    int eqs[ACC_SLOTS] = {};    // new rows equal to head j
    int fresh[ACC_SLOTS] = {};  // new run heads below head j
    int lt_new = 0, fresh_new = 0;  // the same for x
    if (sorted) {
      lt_new = lane;  // a first copy's rank among the new values
      fresh_new = __popc(fresh_heads & below_me);
      // x < head i iff key <= 2i, x == head i iff key == 2i + 1; the keys
      // ascend across the lanes as the values do
      const int key = lane < n ? 2 * lt_acc + int(in_acc) : 0x7FFFFFFF;
#pragma unroll
      for (int j = 0; j < ACC_SLOTS; ++j) {
        if (j >= slots) break;
        const int i2 = 2 * (j * 32 + lane);
        int pos = 0;  // new values below head i: a search across the lanes
#pragma unroll
        for (int step = 32; step > 0; step >>= 1) {
          const int probe = pos + step;
          const int kp = __shfl_sync(FULL, key, (probe <= n ? probe : 1) - 1);
          if (probe <= n && kp <= i2) pos = probe;
        }
        const int at = pos < 32 ? pos : 31;
        const int kp = __shfl_sync(FULL, key, at);
        const uint32_t c = __shfl_sync(FULL, copies, at);
        below[j] = pos;
        eqs[j] = pos < n && kp == i2 + 1 ? int(c) : 0;
        fresh[j] = __popc(fresh_heads & (pos < 32 ? (1u << pos) - 1u : FULL));
      }
    } else {
      const bool hits = __any_sync(FULL, real && in_acc);  // heads gain
      for (unsigned rest = reals; rest; rest &= rest - 1) {
        const int src = __ffs(rest) - 1;
        const uint64_t y = __shfl_sync(FULL, x, src);
        const int novel = (fresh_heads >> src) & 1;
#pragma unroll
        for (int j = 0; j < ACC_SLOTS; ++j) {
          if (j >= slots) break;
          const int gt = y < a[j];
          below[j] += gt;
          if (hits) eqs[j] += y == a[j];
          fresh[j] += gt & novel;
        }
        const int lt = y < x;
        lt_new += lt;
        fresh_new += lt & novel;
      }
    }
    __syncwarp();  // every lane's search has read the heads
    // every head's row and weight; the kept heads go to their compacted
    // index: the number of heads below them
    int kept = 0;
#pragma unroll
    for (int j = 0; j < ACC_SLOTS; ++j) {
      if (j >= slots) break;
      const int i = j * 32 + lane;
      const bool live = i < m;
      const int r = i + below[j];
      const uint32_t wt = w[j] + uint32_t(eqs[j]);
      if (live && (r >= DUP_ACC_H || wt >= wlimit)) ovf = true;
      const bool keep = live && r < DUP_ACC_H;
      if (keep) {
        heads[i + fresh[j]] = a[j];
        hw[i + fresh[j]] = wt;
        hr[i + fresh[j]] = uint8_t(r);
      }
      kept += __popc(__ballot_sync(FULL, keep));
    }
    {
      const bool head = first && !in_acc;
      const int r = lt_acc + lt_new;
      if (head && (r >= DUP_ACC_H || copies >= wlimit)) ovf = true;
      const bool keep = head && r < DUP_ACC_H;
      if (keep) {
        heads[lt_acc + fresh_new] = x;
        hw[lt_acc + fresh_new] = copies;
        hr[lt_acc + fresh_new] = uint8_t(r);
      }
      kept += __popc(__ballot_sync(FULL, keep));
    }
    m = kept;
    moved = true;
    __syncwarp();
  }

  __device__ void flush() {  // one pass over the waiting values
    if (np == 0) return;
    __syncwarp();
    const uint64_t x = lane < np ? pv[lane] : U64_MAX;
    __syncwarp();
    np = 0;
    pass(x, pv_sorted);
  }

  // A step whose real values all equal held heads changes only their
  // weights when no row of it can reach 96 and it is not the last: add its
  // copies to them in place. Returns false, having changed nothing, when
  // some value is not a held head.
  __device__ bool add_hits(uint64_t x) {
    const bool real = x != U64_MAX;
    const int at = heads_below(x);
    const bool hit = at < m && heads[at < m ? at : 0] == x;
    if (!__all_sync(FULL, hit || !real)) return false;
    // the last copy to add sees the head's final weight
    if (real && atomicAdd(&hw[at], 1u) + 1u >= wlimit) ovf = true;
    __syncwarp();
    return true;
  }

  // One step of the function with this lane's new row x; `last` on the
  // batch's last step, `ascending` as for pass.
  __device__ void step(uint64_t x, bool last, bool ascending) {
    const bool real = x != U64_MAX;
    const unsigned reals = __ballot_sync(FULL, real);
    const int n = __popc(reals);
    if (!last) {
      if (n == 0) return;  // the sort only compacts the holes
      // a dense step after a dense pass of copies: likely copies again
      if (hits && n > SORT_MIN && m + np + n <= DUP_ACC_H) {
        if (add_hits(x)) return;
        hits = false;
      }
      if (np + n > NEW || m + np + n > DUP_ACC_H) flush();
      if (m + n > DUP_ACC_H) {  // a row of this step can reach 96: alone
        pass(x, ascending);
      } else if (n == NEW) {  // np is 0, and no later value fits beside it
        pass(x, ascending);
      } else {
        if (real) pv[np + __popc(reals & below_me)] = x;
        pv_sorted = np == 0 && ascending;
        np += n;
      }
      return;
    }
    flush();
    if (n == 0) {
      moved = false;
    } else {
      pass(x, ascending);
    }
  }

  // The last step's row layout, weights folded in, holes u64::MAX, into
  // column `warp` of the output tile; the flag into flags[0]. The caller
  // synchronises the block and stores the tile.
  __device__ void write(uint64_t (*out)[TILE_PAD], int warp, int wshift,
                        int32_t* __restrict__ flags) {
#pragma unroll
    for (int j = 0; j < ACC_SLOTS; ++j) out[j * 32 + lane][warp] = U64_MAX;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < ACC_SLOTS; ++j) {
      const int i = j * 32 + lane;
      if (i < m)
        out[moved ? int(hr[i]) : i][warp] =
            heads[i] + (uint64_t(hw[i] - 1u) << wshift);
    }
    if (__any_sync(FULL, ovf) && lane == 0) atomicOr(&flags[0], 1);
  }
};

__device__ __forceinline__ uint64_t survivor(uint32_t lo, uint32_t hi,
                                             uint32_t hlo, uint32_t hhi,
                                             uint64_t th) {
  const bool pad = lo == 0xFFFFFFFFu && hi == 0xFFFFFFFFu;
  const uint64_t h = (uint64_t(hhi) << 32) | hlo;
  return !pad && h <= th ? ((uint64_t(hi) << 32) | lo) + 1 : U64_MAX;
}

// Tier D's shared memory. The four planes stream through `raw`, RAW_SLOTS
// stages of RAW_STEPS chunks, RAW_SLOTS - 1 stages in flight: thread t
// copies unit t of each stage with 16-byte cp.async, lane row (t >> 1) & 31
// of chunk t >> 6 of the stage, columns col0 + 4 * (t & 1) .. + 3, and
// turns its own unit into new rows once it has landed (so no barrier comes
// between the copy and its use), into `rows` laid out as walk_stripe's ring
// (row j * 32 + r: lane row r of the stage's chunk j).
struct LaneRing {
  uint4 raw[RAW_SLOTS][4][BLOCK];
  uint64_t rows[2][RAW_STEPS * STEP_ROWS][WARPS];
  DupHeads acc;
};

__device__ __forceinline__ void issue_stage(
    LaneRing& ring, const uint32_t* __restrict__ vlo,
    const uint32_t* __restrict__ vhi, const uint32_t* __restrict__ hlo,
    const uint32_t* __restrict__ hhi, int64_t nchunks, int64_t col0,
    int64_t s) {
  const int t = threadIdx.x;
  const int64_t ch = s * RAW_STEPS + (t >> 6);
  if (ch >= nchunks) return;
  const int64_t i = (ch * COLH + ((t >> 1) & 31)) * CHUNK_W + col0 +
                    4 * (t & 1);
  uint4(*raw)[BLOCK] = ring.raw[s % RAW_SLOTS];
  cp_async16(&raw[0][t], vlo + i);
  cp_async16(&raw[1][t], vhi + i);
  cp_async16(&raw[2][t], hlo + i);
  cp_async16(&raw[3][t], hhi + i);
}

__device__ __forceinline__ void unit_rows(LaneRing& ring, uint64_t th,
                                          int64_t nchunks, int64_t s) {
  const int t = threadIdx.x;
  const int row = (t >> 6) * STEP_ROWS + ((t >> 1) & 31);
  const int c = 4 * (t & 1);
  const bool live = s * RAW_STEPS + (t >> 6) < nchunks;
  const uint4(*raw)[BLOCK] = ring.raw[s % RAW_SLOTS];
  const uint4 lo = raw[0][t], hi = raw[1][t], hl = raw[2][t], hh = raw[3][t];
  const uint32_t l4[4] = {lo.x, lo.y, lo.z, lo.w};
  const uint32_t h4[4] = {hi.x, hi.y, hi.z, hi.w};
  const uint32_t a4[4] = {hl.x, hl.y, hl.z, hl.w};
  const uint32_t b4[4] = {hh.x, hh.y, hh.z, hh.w};
  uint64_t(*rows)[WARPS] = ring.rows[s & 1];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    rows[row][swz(row, c + q)] =
        live ? survivor(l4[q], h4[q], a4[q], b4[q], th) : U64_MAX;
}

// Sort the first `steps` steps of this warp's column in `t` across the
// lanes, in place, when any of them holds more than SORT_MIN values.
// Returns the mask of the steps now ascending.
__device__ __forceinline__ unsigned sort_stage(uint64_t (*t)[WARPS],
                                               int steps, int warp,
                                               int lane) {
  uint64_t x[RAW_STEPS];
  bool dense = false;
#pragma unroll
  for (int j = 0; j < RAW_STEPS; ++j) {
    const int r = j * STEP_ROWS + lane;
    x[j] = j < steps ? t[r][swz(r, warp)] : U64_MAX;
    dense |= __popc(__ballot_sync(FULL, x[j] != U64_MAX)) > SORT_MIN;
  }
  if (!dense) return 0u;
  warp_sort_n(x, lane);
#pragma unroll
  for (int j = 0; j < RAW_STEPS; ++j) {
    const int r = j * STEP_ROWS + lane;
    if (j < steps) t[r][swz(r, warp)] = x[j];
  }
  __syncwarp();
  return (1u << steps) - 1u;
}

// Tier D: grid CHUNK_W / WARPS blocks, a LaneRing of dynamic shared memory
// each; warp w of block b owns column b * WARPS + w, each step merging one
// chunk's 32 lanes of it.
__global__ void __launch_bounds__(THREADS)
dedup_lanes_warp(const uint32_t* __restrict__ vlo,
                 const uint32_t* __restrict__ vhi,
                 const uint32_t* __restrict__ hlo,
                 const uint32_t* __restrict__ hhi,
                 const uint64_t* __restrict__ thresh, int64_t nchunks,
                 int wshift, uint64_t* __restrict__ cand,
                 int32_t* __restrict__ flags) {
  extern __shared__ uint4 lane_smem[];
  LaneRing& ring = *reinterpret_cast<LaneRing*>(lane_smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t col0 = int64_t(blockIdx.x) * WARPS;
  const uint64_t th = *thresh;
  DupColumn column(ring.acc, warp, lane, weight_limit(wshift));
  const int64_t nstages = (nchunks + RAW_STEPS - 1) / RAW_STEPS;
#pragma unroll
  for (int s = 0; s < RAW_SLOTS - 1; ++s) {
    if (s < nstages) issue_stage(ring, vlo, vhi, hlo, hhi, nchunks, col0, s);
    cp_async_commit();
  }
  for (int64_t s = 0; s < nstages; ++s) {
    cp_async_wait<RAW_SLOTS - 2>();  // this thread's unit of stage s landed
    unit_rows(ring, th, nchunks, s);
    // every unit of stage s is in rows[s & 1], and every warp has left
    // stage s - 1 (stage s + 1 writes the rows stage s - 1 read)
    __syncthreads();
    if (s + RAW_SLOTS - 1 < nstages)  // into this thread's own spent slot
      issue_stage(ring, vlo, vhi, hlo, hhi, nchunks, col0,
                  s + RAW_SLOTS - 1);
    cp_async_commit();
    uint64_t(*t)[WARPS] = ring.rows[s & 1];
    const int64_t left = nchunks - s * RAW_STEPS;
    const int steps = left < RAW_STEPS ? int(left) : RAW_STEPS;
    // a column whose dense steps are copies of its heads needs no sort
    const unsigned ascending =
        column.hits ? 0u : sort_stage(t, steps, warp, lane);
    for (int j = 0; j < steps; ++j) {
      const int r = j * STEP_ROWS + lane;
      column.step(t[r][swz(r, warp)], left == j + 1, (ascending >> j) & 1u);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: its memory becomes the output tile
  uint64_t(*out)[TILE_PAD] = reinterpret_cast<uint64_t(*)[TILE_PAD]>(ring.raw);
  column.write(out, warp, wshift, flags);
  __syncthreads();
  store_tile<DUP_ACC_H>(out, cand, col0);
}

// Tier D2: grid CHUNK_W / WARPS; warp w of block b owns column
// b * WARPS + w, each step merging slab rows [g * 32, g * 32 + 32).
__global__ void __launch_bounds__(THREADS)
dedup_slab_warp(const uint64_t* __restrict__ slab, int64_t ngroups,
                int wshift, uint64_t* __restrict__ cand,
                int32_t* __restrict__ flags) {
  __shared__ StripeRing ring;
  __shared__ DupHeads acc;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t col0 = int64_t(blockIdx.x) * WARPS;
  DupColumn column(acc, warp, lane, weight_limit(wshift));
  walk_stripe(ring, slab, ngroups * NEW, col0, [&](uint64_t x, bool last) {
    column.step(x, last, false);
  });
  uint64_t(*out)[TILE_PAD] = out_tile(ring);
  column.write(out, warp, wshift, flags);
  __syncthreads();
  store_tile<DUP_ACC_H>(out, cand, col0);
}

}  // namespace

extern "C" int finch_dedup(const void* vlo, const void* vhi,
                           const void* hash_lo, const void* hash_hi,
                           const void* thresh, long long nchunks, int wshift,
                           void* cand, void* flags, void* stream) {
  if (nchunks < 1 || wshift < 1 || wshift > 63)
    return int(cudaErrorInvalidValue);
  // the planes are read 16 bytes at a time
  if ((reinterpret_cast<uintptr_t>(vlo) | reinterpret_cast<uintptr_t>(vhi) |
       reinterpret_cast<uintptr_t>(hash_lo) |
       reinterpret_cast<uintptr_t>(hash_hi)) % 16)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return int(err);
  cudaError_t e = cudaFuncSetAttribute(
      dedup_lanes_warp, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(sizeof(LaneRing)));
  if (e != cudaSuccess) return int(e);
  dedup_lanes_warp<<<CHUNK_W / WARPS, THREADS, sizeof(LaneRing), s>>>(
      static_cast<const uint32_t*>(vlo), static_cast<const uint32_t*>(vhi),
      static_cast<const uint32_t*>(hash_lo),
      static_cast<const uint32_t*>(hash_hi),
      static_cast<const uint64_t*>(thresh), nchunks, wshift,
      static_cast<uint64_t*>(cand), static_cast<int32_t*>(flags));
  return int(cudaGetLastError());
}

extern "C" int finch_dedup_slab(const void* slab, long long nchunks,
                                int wshift, void* cand, void* flags,
                                void* stream) {
  if (nchunks < DUP_GROUP || nchunks % DUP_GROUP || wshift < 1 ||
      wshift > 63)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return int(err);
  dedup_slab_warp<<<CHUNK_W / WARPS, THREADS, 0, s>>>(
      static_cast<const uint64_t*>(slab), nchunks / DUP_GROUP, wshift,
      static_cast<uint64_t*>(cand), static_cast<int32_t*>(flags));
  return int(cudaGetLastError());
}
