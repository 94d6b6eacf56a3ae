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
// This file computes that directly instead of sorting 128 rows: the
// accumulator is kept compacted and ascending beside its row layout, the
// 32 new values are sorted across the warp with shuffles, and each head
// finds its row and its total weight by binary search in the other list.
//
// What bounds it on the H100: the function reads 16 B per lane (tier D:
// value and hash planes) or 8 B per slab entry (tier D2) once, so bytes
// bound it at tens of microseconds per 4M-lane batch, while the per-column
// chain of steps is sequential. One warp owns one column and walks its
// steps, so 2048 warps are in flight (about 15 per SM); a block of 8 warps
// stages each step's 32 rows x 8 columns through shared memory, so every
// global load is a full 32-byte sector of adjacent columns. The
// accumulator (compacted and row layout) lives in the warp's shared
// memory. Tuning (more columns per warp, fewer shared-memory round trips)
// is later work.
//
// Plain C interface for ctypes; the launchers return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int COLH = 32;
constexpr int ROWS_OUT = 8;
constexpr int CHUNK_W = 2048;
constexpr int DUP_ACC_H = 96;
constexpr int DUP_GROUP = 4;
constexpr int NEW = 32;  // new rows per step, one per lane
constexpr int WARPS = 8;  // columns per block
constexpr int THREADS = WARPS * 32;
constexpr uint64_t U64_MAX = ~0ull;
constexpr unsigned FULL = 0xffffffffu;

static_assert(DUP_GROUP * ROWS_OUT == NEW, "a D2 step merges 32 slab rows");
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

// Ascending bitonic sort of one value per lane across the warp.
__device__ __forceinline__ uint64_t warp_sort(uint64_t x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int d = size >> 1; d > 0; d >>= 1) {
      const uint64_t y = __shfl_xor_sync(FULL, x, d);
      const bool up = (lane & size) == 0;
      const bool low = (lane & d) == 0;
      const uint64_t mn = x < y ? x : y;
      const uint64_t mx = x < y ? y : x;
      x = (low == up) ? mn : mx;
    }
  }
  return x;
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

// Tier D2: as tier D, each step merging slab rows [g * 32, g * 32 + 32).
__global__ void __launch_bounds__(THREADS)
dedup_slab(const uint64_t* __restrict__ slab, int64_t ngroups, int wshift,
           uint64_t* __restrict__ cand, int32_t* __restrict__ flags) {
  __shared__ uint64_t tile[2][NEW][WARPS];
  __shared__ Column cols[WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int srow = threadIdx.x / WARPS;
  const int scol = threadIdx.x % WARPS;
  const int64_t col0 = int64_t(blockIdx.x) * WARPS;
  const uint32_t wlimit = weight_limit(wshift);
  Column& c = cols[warp];
  int m = 0;
  bool ovf = false;
  for (int64_t g = 0; g < ngroups; ++g) {
    tile[g & 1][srow][scol] = slab[(g * NEW + srow) * CHUNK_W + col0 + scol];
    __syncthreads();
    ovf |= merge_step(c, m, tile[g & 1][lane][warp], lane, wlimit);
  }
  write_column(c, col0 + warp, wshift, cand, lane, ovf, flags);
}

}  // namespace

extern "C" int finch_dedup(const void* vlo, const void* vhi,
                           const void* hash_lo, const void* hash_hi,
                           const void* thresh, long long nchunks, int wshift,
                           void* cand, void* flags, void* stream) {
  if (nchunks < 1 || wshift < 1 || wshift > 63)
    return int(cudaErrorInvalidValue);
  dedup_planes<<<CHUNK_W / WARPS, THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
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
  dedup_slab<<<CHUNK_W / WARPS, THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(slab), nchunks / DUP_GROUP, wshift,
      static_cast<uint64_t*>(cand), static_cast<int32_t*>(flags));
  return int(cudaGetLastError());
}
