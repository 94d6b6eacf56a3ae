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
// What bounds it on the H100: bytes. The function reads 8 B and writes
// 8 B of hash planes per lane, plus 2 B of slab; at its fewest integer
// instructions (about 115 per lane at k=21) it is memory-bound at every k
// (chip_smoke.py prices both bounds). The design follows that:
//
//   extract_select, grid (CHUNK_W / 128, nchunks): one thread owns one
//     (chunk, column), loads its 32 rows 8 at a time (loads coalesced along
//     CHUNK_W, 64 B in flight per thread), hashes them and keeps its 8
//     smallest survivors in a register insertion list, entered only by a
//     warp with a survivor (a vote, so that the list is a branch and not
//     predicated work in every lane); nothing but the slab and the hash
//     planes touches device memory. The ASCII words are
//     assembled 4 bases per byte permute: the k-mer is bit-reversed once,
//     so base j's code sits at bits 2j..2j+1 (its two bits swapped), each
//     16 bits of codes are spread into 8 selector nibbles, and two PRMTs
//     from the table "AGCT" (the swapped codes' letters) give 8 bytes.
//   extract_warp_merge, grid CHUNK_W / 8 (256 blocks of 8 warps): GPU
//     blocks run in no order, so the TPU's sequential cross-chunk
//     accumulator becomes a second launch over the slab, which the select
//     launch has just written into L2. One warp owns one column and keeps
//     its 32 smallest entries sorted across the lanes (one per lane). The
//     block streams its 8 columns' slab rows through a shared-memory ring
//     (warp.cuh), 32 rows per step; a step whose values are all at least
//     the running 32nd smallest (one ballot) is skipped, the usual case.
//     Up to INSERT_MAX entering values are inserted one at a time (a
//     broadcast and a one-lane shift each); more are sorted across the
//     warp, the half-cleaner min(run[l], new[31 - l]) keeps the 32
//     smallest as a bitonic sequence and a 5-stage bitonic merge sorts it
//     (the TPU kernel's own merge, pallas_extract.py:323-402).
//   extract_weighted_merge, grid CHUNK_W / 8, the weighted form: the same
//     walk, one warp per column, keeping the 32 smallest DISTINCT values
//     sorted across the lanes, each lane's with its count. A step's copies
//     collapse into one lead (__match_any_sync); a lead equal to a held
//     value adds its copies there. Up to INSERT_MAX leads are taken one
//     at a time (a hit test, or a broadcast and a one-lane shift); more
//     find their equals by a search across the lanes, and the rest are
//     sorted with their counts and merged as above.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "warp.cuh"

namespace {

constexpr int COLH = 32;
constexpr int ROWS_OUT = 8;
constexpr int ROW_BITS = 5;
constexpr int ACC_H = 32;
constexpr int SELECT_THREADS = 128;  // columns per block, select launch
constexpr int SELECT_BATCH = 8;      // rows loaded ahead, select launch
constexpr int INSERT_MAX = 6;  // entering values merged by insertion
// ASCII of the bit-swapped 2-bit codes 0..3 (A=0 C=1 G=2 T=3 swapped:
// 0 -> A, 1 -> G, 2 -> C, 3 -> T), little-endian
constexpr uint32_t SWAPPED_ACGT = 0x54434741u;

static_assert(ACC_H == STEP_ROWS, "the merge keeps one entry per lane");

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

// The 8 ASCII bytes of bases 8w..8w+7 from r = the bit-reversed k-mer
// (base j's swapped code at bits 2j..2j+1), zero past base K - 1.
template <int K>
__device__ __forceinline__ uint64_t ascii_word(uint64_t r, int w) {
  if (8 * w >= K) return 0;
  const uint32_t half = w & 2 ? uint32_t(r >> 32) : uint32_t(r);
  // the word's 16 code bits: bases 0-3 to byte 0, bases 4-7 to byte 2
  uint32_t x = __byte_perm(half, 0, w & 1 ? 0x4342 : 0x4140);
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;  // base i's code in selector nibble i
  const uint64_t word =
      __byte_perm(SWAPPED_ACGT, 0, x) |
      (uint64_t(__byte_perm(SWAPPED_ACGT, 0, x >> 16)) << 32);
  const int n = K - 8 * w;  // bases in this word
  return n >= 8 ? word : word & ((1ull << (8 * n)) - 1);
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
  const uint64_t r = __brevll(packed << (64 - 2 * K));
  uint64_t words[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) words[w] = ascii_word<K>(r, w);
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
  for (int r0 = 0; r0 < COLH; r0 += SELECT_BATCH) {
    uint32_t lo[SELECT_BATCH], hi[SELECT_BATCH];
#pragma unroll
    for (int i = 0; i < SELECT_BATCH; ++i) {
      const int64_t lane = (chunk * COLH + r0 + i) * CHUNK_W + col;
      lo[i] = vlo[lane];
      hi[i] = vhi[lane];
    }
#pragma unroll
    for (int i = 0; i < SELECT_BATCH; ++i) {
      const int64_t lane = (chunk * COLH + r0 + i) * CHUNK_W + col;
      const uint64_t v = (uint64_t(hi[i]) << 32) | lo[i];
      const uint64_t h = murmur_packed<K>(v >> 1, seed);
      hash_lo[lane] = uint32_t(h);
      hash_hi[lane] = uint32_t(h >> 32);
      const bool pad = (lo[i] == 0xFFFFFFFFu) && (hi[i] == 0xFFFFFFFFu);
      const bool keep = !pad && h <= th;
      // a branch, not predication: few lanes survive a warm threshold
      if (__ballot_sync(FULL, keep) != 0 && keep) {
        ++kept;
        insert_sorted(top, (v << ROW_BITS) | uint64_t(r0 + i));
      }
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

// Launch 2: grid CHUNK_W / WARPS, block WARPS warps; warp w of block b
// owns column b * WARPS + w and keeps its 32 smallest slab entries so far,
// ascending across the lanes.
__global__ void __launch_bounds__(BLOCK)
extract_warp_merge(const uint64_t* __restrict__ slab, int64_t nchunks,
                   uint64_t* __restrict__ cand, int32_t* __restrict__ flags) {
  __shared__ StripeRing ring;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t col0 = int64_t(blockIdx.x) * WARPS;
  uint64_t run = U64_MAX;   // the (lane)-th smallest so far
  uint64_t top = U64_MAX;   // the 32nd smallest so far, in every lane
  int64_t real = 0;
  walk_stripe(ring, slab, nchunks * ROWS_OUT, col0, [&](uint64_t x, bool) {
    real += __popc(__ballot_sync(FULL, x != U64_MAX));
    const unsigned enter = __ballot_sync(FULL, x < top);
    if (enter == 0) return;  // nothing enters: the usual step
    if (__popc(enter) <= INSERT_MAX) {
      // a few values: insert each, shifting the larger entries up a lane
      for (unsigned rest = enter; rest; rest &= rest - 1) {
        const uint64_t y = __shfl_sync(FULL, x, __ffs(rest) - 1);
        const uint64_t below = __shfl_up_sync(FULL, run, 1);
        if (run > y) run = (lane > 0 && below > y) ? below : y;
      }
    } else {
      const uint64_t s = warp_sort(x, lane);
      const uint64_t t = __shfl_sync(FULL, s, 31 - lane);
      run = t < run ? t : run;  // the 32 smallest of both, bitonic
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const uint64_t y = __shfl_xor_sync(FULL, run, d);
        const bool low = (lane & d) == 0;
        run = (low == (run < y)) ? run : y;
      }
    }
    top = __shfl_sync(FULL, run, 31);
  });
  if (lane == 0 && real > ACC_H) atomicOr(&flags[1], 1);
  uint64_t(*out)[TILE_PAD] = out_tile(ring);
  out[lane][warp] = run;
  __syncthreads();
  store_tile<ACC_H>(out, cand, col0);
}

// Launch 2, weighted form: grid CHUNK_W / WARPS, block WARPS warps; warp w
// of block b owns column b * WARPS + w and keeps its 32 smallest distinct
// slab values so far, ascending across the lanes, each lane's with its
// count. A slab value equal to a held one adds its copies to that count; a
// smaller new one is inserted with its copies and pushes the largest out.
// Once the list holds 32 values its largest only shrinks, so a value pushed
// out (or refused) never returns, and the kept values' counts are exact
// whatever the order of the slab rows. aovf: a real value pushed out or
// refused, that is more than 32 distinct values; or a kept count - 1 too
// wide for the weight field.
__global__ void __launch_bounds__(BLOCK)
extract_weighted_merge(const uint64_t* __restrict__ slab, int64_t nchunks,
                       int wshift, uint64_t* __restrict__ cand,
                       int32_t* __restrict__ flags) {
  __shared__ StripeRing ring;
  __shared__ uint32_t gain[WARPS][ACC_H];  // copies a held value gains
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below_me = (1u << lane) - 1u;
  const int64_t col0 = int64_t(blockIdx.x) * WARPS;
  uint64_t run = U64_MAX;  // the (lane)-th smallest distinct value so far
  uint32_t cnt = 0;        // its count
  uint64_t top = U64_MAX;  // the 32nd, in every lane
  bool ovf = false;
  walk_stripe(ring, slab, nchunks * ROWS_OUT, col0, [&](uint64_t x, bool) {
    const bool real = x != U64_MAX;
    if (real && x > top) ovf = true;  // the list is full of smaller values
    const bool in = real && x <= top;
    const unsigned enter = __ballot_sync(FULL, in);
    if (enter == 0) return;  // nothing enters: the usual step
    // the step's copies collapse into their lowest lane, the lead
    const unsigned same = __match_any_sync(FULL, in ? x : U64_MAX);
    const bool lead = in && (same & below_me) == 0;
    const uint32_t c = lead ? uint32_t(__popc(same)) : 0u;
    const unsigned leads = __ballot_sync(FULL, lead);
    if (__popc(leads) <= INSERT_MAX) {
      // a few values: each adds to its equal, or is inserted, shifting the
      // larger entries up a lane
      for (unsigned rest = leads; rest; rest &= rest - 1) {
        const int src = __ffs(rest) - 1;
        const uint64_t y = __shfl_sync(FULL, x, src);
        const uint32_t cy = __shfl_sync(FULL, c, src);
        if (__any_sync(FULL, run == y)) {
          if (run == y) cnt += cy;
          continue;
        }
        const uint64_t last = __shfl_sync(FULL, run, 31);
        if (last != U64_MAX) ovf = true;  // y or the largest drops out
        if (y > last) continue;           // refused
        const uint64_t below = __shfl_up_sync(FULL, run, 1);
        const uint32_t cbelow = __shfl_up_sync(FULL, cnt, 1);
        if (run > y) {
          const bool shift = lane > 0 && below > y;
          run = shift ? below : y;
          cnt = shift ? cbelow : cy;
        }
      }
    } else {
      // many: a lead equal to a held value (found by a search across the
      // lanes) adds its copies there; the others are sorted with their
      // copies and merged: the half-cleaner min(run[l], new[31 - l]) keeps
      // the 32 smallest as a bitonic sequence, a 5-stage bitonic merge
      // sorts it
      int pos = 0;  // held values below x
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        const uint64_t v = __shfl_sync(FULL, run, pos + step - 1);
        if (v < x) pos += step;
      }
      const uint64_t at = __shfl_sync(FULL, run, pos < 31 ? pos : 31);
      const bool hit = lead && at == x;
      gain[warp][lane] = 0;
      __syncwarp();
      if (hit) gain[warp][pos] = c;
      __syncwarp();
      cnt += gain[warp][lane];
      uint64_t key = lead && !hit ? x : U64_MAX;
      uint32_t kc = lead && !hit ? c : 0u;
      // ascending bitonic sort of (key, kc) across the warp
#pragma unroll
      for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
        for (int d = size >> 1; d > 0; d >>= 1) {
          const uint64_t y = __shfl_xor_sync(FULL, key, d);
          const uint32_t yc = __shfl_xor_sync(FULL, kc, d);
          const bool low = ((lane & size) == 0) == ((lane & d) == 0);
          if (low ? y < key : y > key) {
            key = y;
            kc = yc;
          }
        }
      }
      const uint64_t t = __shfl_sync(FULL, key, 31 - lane);
      const uint32_t tc = __shfl_sync(FULL, kc, 31 - lane);
      const uint64_t dropped = t < run ? run : t;
      if (dropped != U64_MAX) ovf = true;
      if (t < run) {
        run = t;
        cnt = tc;
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const uint64_t y = __shfl_xor_sync(FULL, run, d);
        const uint32_t yc = __shfl_xor_sync(FULL, cnt, d);
        const bool low = (lane & d) == 0;
        if (low ? y < run : y > run) {
          run = y;
          cnt = yc;
        }
      }
    }
    top = __shfl_sync(FULL, run, 31);
  });
  const bool real = run != U64_MAX;
  const uint32_t wm1 = real ? cnt - 1u : 0u;
  const int wbits = 64 - wshift;
  if (real && wbits < 32 && (wm1 >> wbits) != 0) ovf = true;
  if (__any_sync(FULL, ovf) && lane == 0) atomicOr(&flags[1], 1);
  uint64_t(*out)[TILE_PAD] = out_tile(ring);
  out[lane][warp] = real ? run + (uint64_t(wm1) << wshift) : U64_MAX;
  __syncthreads();
  store_tile<ACC_H>(out, cand, col0);
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
  cudaError_t err = cudaMemsetAsync(fl, 0, 2 * sizeof(int32_t), s);
  if (err != cudaSuccess) return int(err);
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
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  if (weighted)
    extract_weighted_merge<<<CHUNK_W / WARPS, BLOCK, 0, s>>>(
        sl, nchunks, 2 * k + 2, static_cast<uint64_t*>(cand_p), fl);
  else
    extract_warp_merge<<<CHUNK_W / WARPS, BLOCK, 0, s>>>(
        sl, nchunks, static_cast<uint64_t*>(cand_p), fl);
  return int(cudaGetLastError());
}
