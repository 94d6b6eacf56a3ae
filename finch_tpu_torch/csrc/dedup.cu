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
// What bounds it on the H100: bytes. The function reads 16 B per lane
// (tier D: value and hash planes) or 8 B per slab entry (tier D2) once and
// writes 1.5 MB of cand, a few microseconds at 2M lanes; but each column's
// steps form a sequential chain, one warp per column (2048 warps, about 15
// per SM), so the kernels are bound by that chain: its latency, and the
// instructions 15 warps issue per SM.
//
//   dedup_slab_warp (tier D2), grid CHUNK_W / 8: the chain is kept short.
//     The block streams its 8 columns' slab rows through a shared-memory
//     ring with cp.async (warp.cuh), so no step waits on device memory and
//     the block meets once per 8 steps. Consecutive steps that cannot drop
//     a head are merged into one pass (see the kernel), which turns the 8
//     steps of a sparse 2M-lane column into 2 or 3 passes. A pass finds
//     each new value's copies (a match) and its place among the held heads
//     (a 4-way search of the compacted heads in shared memory), then each
//     head's row, weight and compacted index: by a loop over the real new
//     values when they are few, else from the new values sorted across the
//     warp and a search across the lanes; one scatter compacts the heads.
//   dedup_planes (tier D), grid CHUNK_W / 8: each step's 32 x 8 lanes are
//     staged through shared memory behind a block barrier; the new values
//     are sorted across the warp with shuffles and each head finds its row
//     and total weight by binary search in the other list; the accumulator
//     lives compacted and in row layout in the warp's shared memory.

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
constexpr int ACC_SLOTS = DUP_ACC_H / 32;  // heads per lane, tier D2
constexpr int SORT_MIN = 12;  // D2 passes over more values sort them
constexpr int THREADS = BLOCK;

static_assert(DUP_GROUP * ROWS_OUT == NEW && NEW == STEP_ROWS,
              "a D2 step merges 32 slab rows");
static_assert(COLH == NEW, "a D step merges one chunk's 32 lanes");
static_assert(DUP_ACC_H % 32 == 0, "accumulator rows come in warp rounds");

// One column's accumulator, in its warp's shared memory.
struct Column {
  uint64_t acc_v[DUP_ACC_H];  // heads, compacted and ascending: [0, m)
  uint32_t acc_w[DUP_ACC_H];
  uint64_t row_v[DUP_ACC_H];  // the same heads at their rows, holes MAX
  uint32_t row_w[DUP_ACC_H];
  uint64_t news[NEW];         // this step's new values, ascending
};

// First index in a[0, n) whose value is >= x (or > x when `upper`).
__device__ __forceinline__ int bound(const uint64_t* a, int n, uint64_t x,
                                     bool upper) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool left = upper ? a[mid] <= x : a[mid] < x;
    if (left) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void place(Column& c, int row, uint64_t v,
                                      uint32_t w, uint32_t wlimit,
                                      bool& ovf) {
  if (row < DUP_ACC_H) {
    c.row_v[row] = v;
    c.row_w[row] = w;
  } else {
    ovf = true;  // a real head fell past the kept rows
  }
  if (w >= wlimit) ovf = true;  // its count does not fit the weight field
}

// One accumulator step of column `c` with this lane's new value x
// (u64::MAX = no value). `m` is the number of heads, the same in every
// lane. Returns this lane's overflow bit.
__device__ bool merge_step(Column& c, int& m, uint64_t x, int lane,
                           uint32_t wlimit) {
  const uint64_t s = warp_sort(x, lane);
  c.news[lane] = s;
  const bool real = s != U64_MAX;
  const uint64_t prev = __shfl_up_sync(FULL, s, 1);
  const bool head = real && (lane == 0 || prev != s);
  const unsigned heads = __ballot_sync(FULL, head);
  const int nreal = __popc(__ballot_sync(FULL, real));
#pragma unroll
  for (int r = lane; r < DUP_ACC_H; r += 32) {
    c.row_v[r] = U64_MAX;
    c.row_w[r] = 0;
  }
  __syncwarp();
  bool ovf = false;
  // accumulator heads: every new row below one moves it down a row, every
  // equal new row adds to its weight
  for (int i = lane; i < m; i += 32) {
    const uint64_t a = c.acc_v[i];
    const int below = bound(c.news, nreal, a, false);
    const int upto = bound(c.news, nreal, a, true);
    place(c, i + below, a, c.acc_w[i] + uint32_t(upto - below), wlimit, ovf);
  }
  // new values absent from the accumulator: the first copy (this lane)
  // lands below every smaller head and every smaller new row
  if (head) {
    const int lt = bound(c.acc_v, m, s, false);
    if (lt == m || c.acc_v[lt] != s) {
      const unsigned later = heads & ~((2u << lane) - 1u);
      const int run_end = later ? __ffs(later) - 1 : nreal;
      place(c, lt + lane, s, uint32_t(run_end - lane), wlimit, ovf);
    }
  }
  __syncwarp();
  // compact the row layout into the next step's head list
  int base = 0;
#pragma unroll
  for (int r = 0; r < DUP_ACC_H; r += 32) {
    const uint64_t v = c.row_v[r + lane];
    const uint32_t w = c.row_w[r + lane];
    const bool keep = v != U64_MAX;
    const unsigned bal = __ballot_sync(FULL, keep);
    if (keep) {
      const int idx = base + __popc(bal & ((1u << lane) - 1u));
      c.acc_v[idx] = v;
      c.acc_w[idx] = w;
    }
    base += __popc(bal);
  }
  m = base;
  __syncwarp();
  return ovf;
}

// After the last step: fold the weights into the row layout and write it.
__device__ void write_column(const Column& c, int64_t col, int wshift,
                             uint64_t* __restrict__ cand, int lane,
                             bool ovf, int32_t* __restrict__ flags) {
#pragma unroll
  for (int r = lane; r < DUP_ACC_H; r += 32) {
    const uint64_t v = c.row_v[r];
    cand[int64_t(r) * CHUNK_W + col] =
        v == U64_MAX ? U64_MAX
                     : v + (uint64_t(c.row_w[r] - 1u) << wshift);
  }
  if (__any_sync(FULL, ovf) && lane == 0) atomicOr(&flags[0], 1);
}

__device__ __forceinline__ uint32_t weight_limit(int wshift) {
  const int wbits = 64 - wshift;
  return wbits < 32 ? (1u << wbits) : 0xFFFFFFFFu;
}

// Tier D: grid CHUNK_W / WARPS blocks; warp w of block b owns column
// b * WARPS + w. Thread t stages lane (chunk, t / WARPS, b * WARPS + t %
// WARPS) of each chunk.
__global__ void __launch_bounds__(THREADS)
dedup_planes(const uint32_t* __restrict__ vlo,
             const uint32_t* __restrict__ vhi,
             const uint32_t* __restrict__ hlo,
             const uint32_t* __restrict__ hhi,
             const uint64_t* __restrict__ thresh, int64_t nchunks,
             int wshift, uint64_t* __restrict__ cand,
             int32_t* __restrict__ flags) {
  __shared__ uint64_t tile[2][NEW][WARPS];
  __shared__ Column cols[WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int srow = threadIdx.x / WARPS;
  const int scol = threadIdx.x % WARPS;
  const int64_t col0 = int64_t(blockIdx.x) * WARPS;
  const uint64_t th = *thresh;
  const uint32_t wlimit = weight_limit(wshift);
  Column& c = cols[warp];
  int m = 0;
  bool ovf = false;
  for (int64_t ch = 0; ch < nchunks; ++ch) {
    const int64_t i = (ch * COLH + srow) * CHUNK_W + col0 + scol;
    const uint32_t lo = vlo[i];
    const uint32_t hi = vhi[i];
    const uint64_t h = (uint64_t(hhi[i]) << 32) | hlo[i];
    const bool pad = lo == 0xFFFFFFFFu && hi == 0xFFFFFFFFu;
    const uint64_t v = (uint64_t(hi) << 32) | lo;
    tile[ch & 1][srow][scol] = (!pad && h <= th) ? v + 1 : U64_MAX;
    __syncthreads();
    ovf |= merge_step(c, m, tile[ch & 1][lane][warp], lane, wlimit);
  }
  write_column(c, col0 + warp, wshift, cand, lane, ovf, flags);
}

// Tier D2: grid CHUNK_W / WARPS; warp w of block b owns column
// b * WARPS + w, each step merging slab rows [g * 32, g * 32 + 32). The
// column's m compacted heads, ascending, are hv[w][0, m) with weights
// hw[w][0, m); their rows in the last step's layout are hr[w][i] if that
// step had new values, else i.
//
// Steps are merged into passes. While the held heads plus the real new
// values of consecutive steps number at most 96 (and fit one 32-lane
// pass), no row of those steps can reach 96, so no head drops and the
// steps leave exactly the heads, weights and flag of one pass over all
// their values: such values wait in pv[w][0, np). A step that could
// overflow runs alone, after the waiting values, as does the last step,
// the only one whose rows reach the output.
__global__ void __launch_bounds__(THREADS)
dedup_slab_warp(const uint64_t* __restrict__ slab, int64_t ngroups,
                int wshift, uint64_t* __restrict__ cand,
                int32_t* __restrict__ flags) {
  __shared__ StripeRing ring;
  __shared__ uint64_t hv[WARPS][DUP_ACC_H];
  __shared__ uint32_t hw[WARPS][DUP_ACC_H];
  __shared__ uint8_t hr[WARPS][DUP_ACC_H];
  __shared__ uint64_t pv[WARPS][NEW];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t col0 = int64_t(blockIdx.x) * WARPS;
  const uint32_t wlimit = weight_limit(wshift);
  const unsigned below_me = (1u << lane) - 1u;
  uint64_t* heads = hv[warp];
  int m = 0;           // heads, the same in every lane
  int np = 0;          // values waiting in pv, the same in every lane
  bool moved = false;  // the last step had new values: rows in hr
  bool ovf = false;

  // One pass: merge this lane's value x (u64::MAX = none) into the heads,
  // as one step of the function does. The counts below are found by a
  // loop over the real values when they are few, else from the values
  // sorted across the warp.
  auto pass = [&](uint64_t x) {
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
      w[j] = live ? hw[warp][i] : 0u;
    }
    // first: x is the first copy of its value; copies: how many there are
    bool first;
    uint32_t copies;
    if (sorted) {
      x = warp_sort(x, lane);  // the n real values first, ascending
      const uint64_t prev = __shfl_up_sync(FULL, x, 1);
      first = lane < n && (lane == 0 || prev != x);
      const unsigned later = __ballot_sync(FULL, first) & ~((2u << lane) - 1u);
      copies = first ? uint32_t((later ? __ffs(later) - 1 : n) - lane) : 0u;
    } else {
      const unsigned same = __match_any_sync(FULL, x);
      first = real && (same & below_me) == 0;
      copies = uint32_t(__popc(same));
    }
    // heads below x: a 4-way search (spans 32, 8, 2: 3 independent probes
    // a round), then one probe
    int lt_acc = 0;
#pragma unroll
    for (int span = 32; span > 0; span >>= 2) {
      if (span > m) continue;  // the same in every lane
      int up = 0;
#pragma unroll
      for (int q = 1; q <= 3; ++q) {
        const int probe = lt_acc + q * span;
        const uint64_t h = heads[(probe <= m ? probe : 1) - 1];
        up += probe <= m && h < x;
      }
      lt_acc += up * span;
    }
    if (lt_acc < m && heads[lt_acc] < x) ++lt_acc;  // the last span, 1
    const bool in_acc = lt_acc < m && heads[lt_acc < m ? lt_acc : 0] == x;
    const unsigned fresh_heads = __ballot_sync(FULL, first && !in_acc);
    int below[ACC_SLOTS] = {};  // new rows below head j
    int eqs[ACC_SLOTS] = {};    // new rows equal to head j
    int fresh[ACC_SLOTS] = {};  // new run heads below head j
    int lt_new = 0, fresh_new = 0;  // the same for x
    if (sorted) {
      lt_new = lane;  // a first copy's rank among the new values
      fresh_new = __popc(fresh_heads & below_me);
#pragma unroll
      for (int j = 0; j < ACC_SLOTS; ++j) {
        if (j >= slots) break;
        int pos = 0;  // new values below a[j]: a search across the lanes
#pragma unroll
        for (int step = 32; step > 0; step >>= 1) {
          const int probe = pos + step;
          const uint64_t v = __shfl_sync(FULL, x, (probe <= n ? probe : 1) - 1);
          if (probe <= n && v < a[j]) pos = probe;
        }
        const int at = pos < 32 ? pos : 31;
        const uint64_t v = __shfl_sync(FULL, x, at);
        const uint32_t c = __shfl_sync(FULL, copies, at);
        below[j] = pos;
        eqs[j] = pos < n && v == a[j] ? int(c) : 0;
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
        hw[warp][i + fresh[j]] = wt;
        hr[warp][i + fresh[j]] = uint8_t(r);
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
        hw[warp][lt_acc + fresh_new] = copies;
        hr[warp][lt_acc + fresh_new] = uint8_t(r);
      }
      kept += __popc(__ballot_sync(FULL, keep));
    }
    m = kept;
    moved = true;
    __syncwarp();
  };
  auto flush = [&]() {  // one pass over the waiting values
    if (np == 0) return;
    __syncwarp();
    const uint64_t x = lane < np ? pv[warp][lane] : U64_MAX;
    __syncwarp();
    np = 0;
    pass(x);
  };

  walk_stripe(ring, slab, ngroups * NEW, col0, [&](uint64_t x, bool last) {
    const bool real = x != U64_MAX;
    const unsigned reals = __ballot_sync(FULL, real);
    const int n = __popc(reals);
    if (!last) {
      if (n == 0) return;  // the sort only compacts the holes
      if (np + n > NEW || m + np + n > DUP_ACC_H) flush();
      if (m + n <= DUP_ACC_H) {  // no row of this step can reach 96
        if (real) pv[warp][np + __popc(reals & below_me)] = x;
        np += n;
      } else {
        pass(x);
      }
      return;
    }
    flush();
    if (n == 0) {
      moved = false;
    } else {
      pass(x);
    }
  });
  // the last step's row layout, weights folded in, holes u64::MAX
  uint64_t(*out)[TILE_PAD] = out_tile(ring);
#pragma unroll
  for (int j = 0; j < ACC_SLOTS; ++j) out[j * 32 + lane][warp] = U64_MAX;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < ACC_SLOTS; ++j) {
    const int i = j * 32 + lane;
    if (i < m)
      out[moved ? int(hr[warp][i]) : i][warp] =
          heads[i] + (uint64_t(hw[warp][i] - 1u) << wshift);
  }
  if (__any_sync(FULL, ovf) && lane == 0) atomicOr(&flags[0], 1);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return int(err);
  dedup_planes<<<CHUNK_W / WARPS, THREADS, 0, s>>>(
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
