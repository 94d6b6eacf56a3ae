// Fused extract kernel for Hopper (sm_90a): murmur3 + threshold prefilter +
// per-column selection + cross-chunk accumulator.
//
// Replaces the Pallas TPU kernel finch_tpu/ops/pallas_extract.py
// `_extract_kernel`, weighted=False and weighted=True. The Python wrapper,
// the contract and the plain PyTorch version are in
// finch_tpu_torch/ops/extract.py; this file computes exactly that contract:
//
//   lanes are (nchunks, COLH=32, CHUNK_W=2048); v = (hi << 32) | lo;
//   hash planes = murmur3_x64_128 h1 of the ASCII of packed = v >> 1;
//   survivor = not padding (both planes all-ones) and hash <= *thresh;
//   slab[chunk, 7 - r, col] = v + 1 of the r-th smallest survivor by
//     (v << 5) | row, u64::MAX when fewer; flags[0] (covf) |= more than 8;
//   cand[r, col] = the r-th smallest of the column's slab entries over all
//     chunks; flags[1] (aovf) |= more than 32 real entries.
//   weighted: cand[r, col] = the r-th smallest DISTINCT slab value x of the
//     column, written x + ((count - 1) << (2k + 2)); flags[1] |= more than
//     32 distinct values, or a kept count - 1 too wide for the weight field.
//
// What bounds it on the H100: about a dozen 64x64-bit multiplies plus the
// ASCII word assembly per lane against 16 bytes of lane traffic. At its
// fewest instructions the function is just memory-bound at k=21, but the
// per-base word assembly below doubles the integer instructions, so the
// INT32 issue rate is what limits this kernel. The design keeps every
// intermediate in registers: one thread owns one (chunk, column) and walks
// its 32 rows, so loads and hash-plane stores are coalesced along CHUNK_W
// and the 8-entry insertion list never leaves registers. GPU blocks run in
// no order, so the
// TPU's sequential cross-chunk accumulator becomes a second launch: one
// thread per column walks nchunks * 8 slab entries and keeps the 32
// smallest in a register insertion list (weighted: the 32 smallest distinct
// values, each with its count in a second register list).
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int COLH = 32;
constexpr int ROWS_OUT = 8;
constexpr int ROW_BITS = 5;
constexpr int CHUNK_W = 2048;
constexpr int ACC_H = 32;
constexpr int SELECT_THREADS = 128;  // columns per block, select launch
constexpr int MERGE_THREADS = 128;   // columns per block, merge launch
constexpr uint64_t U64_MAX = ~0ull;

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

// murmur3_x64_128 h1 over the K ASCII bases of a 2-bit packed k-mer (base 0
// in the most significant position; A=0 C=1 G=2 T=3), assembled straight
// into little-endian 64-bit words. Mirrors fn_murmur3_x64_128 over the
// bytes fn_murmur3_packed builds (native/src/finch_native.cpp).
template <int K>
__device__ __forceinline__ uint64_t murmur_packed(uint64_t packed,
                                                  uint64_t seed) {
  constexpr int NB = K / 16;
  constexpr int T = K & 15;
  constexpr int NW = 2 * ((K + 15) / 16);
  uint64_t words[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) words[w] = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const uint32_t code = uint32_t(packed >> (2 * (K - 1 - j))) & 3u;
    const uint64_t byte = (0x54474341u >> (code << 3)) & 0xFFu;
    words[j >> 3] |= byte << (8 * (j & 7));
  }
  const uint64_t c1 = 0x87c37b91114253d5ULL;
  const uint64_t c2 = 0x4cf5ad432745937fULL;
  uint64_t h1 = seed, h2 = seed;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    uint64_t k1 = words[2 * i], k2 = words[2 * i + 1];
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729ULL;
    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
    h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5ULL;
  }
  if constexpr (T > 8) {
    uint64_t k2 = words[2 * NB + 1];
    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
  }
  if constexpr (T > 0) {
    uint64_t k1 = words[2 * NB];
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
  }
  h1 ^= uint64_t(K);
  h2 ^= uint64_t(K);
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  return h1 + h2;
}

// Insert x into the ascending register list a[0..N) (dropping the largest).
template <int N>
__device__ __forceinline__ void insert_sorted(uint64_t (&a)[N], uint64_t x) {
  if (x >= a[N - 1]) return;
  a[N - 1] = x;
#pragma unroll
  for (int i = N - 1; i > 0; --i) {
    const uint64_t lo = a[i - 1], hi = a[i];
    a[i - 1] = lo < hi ? lo : hi;
    a[i] = lo < hi ? hi : lo;
  }
}

// Launch 1: grid (CHUNK_W / SELECT_THREADS, nchunks). Thread = (chunk, col).
template <int K>
__global__ void __launch_bounds__(SELECT_THREADS)
extract_select(const uint32_t* __restrict__ vlo,
               const uint32_t* __restrict__ vhi,
               const uint64_t* __restrict__ thresh, uint64_t seed,
               uint64_t* __restrict__ slab, uint32_t* __restrict__ hash_lo,
               uint32_t* __restrict__ hash_hi, int32_t* __restrict__ flags) {
  const int64_t col = int64_t(blockIdx.x) * SELECT_THREADS + threadIdx.x;
  const int64_t chunk = blockIdx.y;
  const uint64_t th = *thresh;
  uint64_t top[ROWS_OUT];
#pragma unroll
  for (int r = 0; r < ROWS_OUT; ++r) top[r] = U64_MAX;
  int kept = 0;
#pragma unroll 4
  for (int r = 0; r < COLH; ++r) {
    const int64_t lane = (chunk * COLH + r) * CHUNK_W + col;
    const uint32_t lo = vlo[lane];
    const uint32_t hi = vhi[lane];
    const uint64_t v = (uint64_t(hi) << 32) | lo;
    const uint64_t h = murmur_packed<K>(v >> 1, seed);
    hash_lo[lane] = uint32_t(h);
    hash_hi[lane] = uint32_t(h >> 32);
    const bool pad = (lo == 0xFFFFFFFFu) && (hi == 0xFFFFFFFFu);
    if (!pad && h <= th) {
      ++kept;
      insert_sorted(top, (v << ROW_BITS) | uint64_t(r));
    }
  }
  if (kept > ROWS_OUT) atomicOr(&flags[0], 1);
#pragma unroll
  for (int r = 0; r < ROWS_OUT; ++r) {
    const uint64_t t = top[r];
    slab[(chunk * ROWS_OUT + (ROWS_OUT - 1 - r)) * CHUNK_W + col] =
        t == U64_MAX ? U64_MAX : (t >> ROW_BITS) + 1;
  }
}

// Launch 2: grid CHUNK_W / MERGE_THREADS. Thread = column over all chunks.
__global__ void __launch_bounds__(MERGE_THREADS)
extract_merge(const uint64_t* __restrict__ slab, int64_t nchunks,
              uint64_t* __restrict__ cand, int32_t* __restrict__ flags) {
  const int64_t col = int64_t(blockIdx.x) * MERGE_THREADS + threadIdx.x;
  uint64_t acc[ACC_H];
#pragma unroll
  for (int r = 0; r < ACC_H; ++r) acc[r] = U64_MAX;
  int64_t real = 0;
  const int64_t rows = nchunks * ROWS_OUT;
  for (int64_t row = 0; row < rows; ++row) {
    const uint64_t x = slab[row * CHUNK_W + col];
    if (x == U64_MAX) continue;
    ++real;
    insert_sorted(acc, x);
  }
  if (real > ACC_H) atomicOr(&flags[1], 1);
#pragma unroll
  for (int r = 0; r < ACC_H; ++r) cand[int64_t(r) * CHUNK_W + col] = acc[r];
}

// Launch 2, weighted form: grid CHUNK_W / MERGE_THREADS, thread = column.
// A slab value already in the list adds one to its count; a new one is
// inserted with count 1. Once the list holds 32 values its largest only
// shrinks, so a value pushed out (or refused) never returns, and the kept
// values' counts are exact whatever the order of the slab rows.
__global__ void __launch_bounds__(MERGE_THREADS)
extract_merge_weighted(const uint64_t* __restrict__ slab, int64_t nchunks,
                       int wshift, uint64_t* __restrict__ cand,
                       int32_t* __restrict__ flags) {
  const int64_t col = int64_t(blockIdx.x) * MERGE_THREADS + threadIdx.x;
  uint64_t acc[ACC_H];
  uint32_t cnt[ACC_H];
#pragma unroll
  for (int r = 0; r < ACC_H; ++r) {
    acc[r] = U64_MAX;
    cnt[r] = 0;
  }
  bool ovf = false;
  const int64_t rows = nchunks * ROWS_OUT;
  for (int64_t row = 0; row < rows; ++row) {
    const uint64_t x = slab[row * CHUNK_W + col];
    if (x == U64_MAX) continue;
    if (x > acc[ACC_H - 1]) {  // the list is full of smaller values
      ovf = true;
      continue;
    }
    bool found = false;
#pragma unroll
    for (int r = 0; r < ACC_H; ++r) {
      const bool eq = acc[r] == x;
      cnt[r] += eq ? 1u : 0u;
      found |= eq;
    }
    if (found) continue;
    if (acc[ACC_H - 1] != U64_MAX) ovf = true;  // its largest drops out
    acc[ACC_H - 1] = x;
    cnt[ACC_H - 1] = 1;
#pragma unroll
    for (int r = ACC_H - 1; r > 0; --r) {
      const bool swap = acc[r] < acc[r - 1];
      const uint64_t lo = swap ? acc[r] : acc[r - 1];
      const uint64_t hi = swap ? acc[r - 1] : acc[r];
      const uint32_t clo = swap ? cnt[r] : cnt[r - 1];
      const uint32_t chi = swap ? cnt[r - 1] : cnt[r];
      acc[r - 1] = lo;
      acc[r] = hi;
      cnt[r - 1] = clo;
      cnt[r] = chi;
    }
  }
  const int wbits = 64 - wshift;
#pragma unroll
  for (int r = 0; r < ACC_H; ++r) {
    const bool real = acc[r] != U64_MAX;
    const uint32_t wm1 = real ? cnt[r] - 1u : 0u;
    if (real && wbits < 32 && (wm1 >> wbits) != 0) ovf = true;
    cand[int64_t(r) * CHUNK_W + col] =
        real ? acc[r] + (uint64_t(wm1) << wshift) : U64_MAX;
  }
  if (ovf) atomicOr(&flags[1], 1);
}

}  // namespace

#define FINCH_EXTRACT_CASE(K)                                               \
  case K:                                                                   \
    extract_select<K><<<grid, SELECT_THREADS, 0, s>>>(                      \
        vlo, vhi, th, seed, sl, hlo, hhi, fl);                              \
    break;

extern "C" int finch_extract(const void* vlo_p, const void* vhi_p,
                             const void* thresh_p, void* cand_p, void* slab_p,
                             void* hash_lo_p, void* hash_hi_p, void* flags_p,
                             long long nchunks, int k,
                             unsigned long long seed, int weighted,
                             void* stream) {
  const uint32_t* vlo = static_cast<const uint32_t*>(vlo_p);
  const uint32_t* vhi = static_cast<const uint32_t*>(vhi_p);
  const uint64_t* th = static_cast<const uint64_t*>(thresh_p);
  uint64_t* sl = static_cast<uint64_t*>(slab_p);
  uint32_t* hlo = static_cast<uint32_t*>(hash_lo_p);
  uint32_t* hhi = static_cast<uint32_t*>(hash_hi_p);
  int32_t* fl = static_cast<int32_t*>(flags_p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nchunks < 1 || nchunks > 65535) return int(cudaErrorInvalidValue);
  const dim3 grid(CHUNK_W / SELECT_THREADS, unsigned(nchunks));
  switch (k) {
    FINCH_EXTRACT_CASE(1) FINCH_EXTRACT_CASE(2) FINCH_EXTRACT_CASE(3)
    FINCH_EXTRACT_CASE(4) FINCH_EXTRACT_CASE(5) FINCH_EXTRACT_CASE(6)
    FINCH_EXTRACT_CASE(7) FINCH_EXTRACT_CASE(8) FINCH_EXTRACT_CASE(9)
    FINCH_EXTRACT_CASE(10) FINCH_EXTRACT_CASE(11) FINCH_EXTRACT_CASE(12)
    FINCH_EXTRACT_CASE(13) FINCH_EXTRACT_CASE(14) FINCH_EXTRACT_CASE(15)
    FINCH_EXTRACT_CASE(16) FINCH_EXTRACT_CASE(17) FINCH_EXTRACT_CASE(18)
    FINCH_EXTRACT_CASE(19) FINCH_EXTRACT_CASE(20) FINCH_EXTRACT_CASE(21)
    FINCH_EXTRACT_CASE(22) FINCH_EXTRACT_CASE(23) FINCH_EXTRACT_CASE(24)
    FINCH_EXTRACT_CASE(25) FINCH_EXTRACT_CASE(26) FINCH_EXTRACT_CASE(27)
    FINCH_EXTRACT_CASE(28)
    default:
      return int(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  if (weighted)
    extract_merge_weighted<<<CHUNK_W / MERGE_THREADS, MERGE_THREADS, 0, s>>>(
        sl, nchunks, 2 * k + 2, static_cast<uint64_t*>(cand_p), fl);
  else
    extract_merge<<<CHUNK_W / MERGE_THREADS, MERGE_THREADS, 0, s>>>(
        sl, nchunks, static_cast<uint64_t*>(cand_p), fl);
  return int(cudaGetLastError());
}
