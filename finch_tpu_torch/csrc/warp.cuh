// Device helpers shared by extract.cu and dedup.cu: the lane layout of a
// column stripe, warp-wide bitonic sorts, and the shared-memory ring that
// streams a block's column stripe in with cp.async.
//
// A "column stripe" is WARPS=8 adjacent columns of a row-major
// (rows, CHUNK_W) u64 array: the extract kernel's slab. One warp owns one
// column and walks its rows in steps of STEP_ROWS=32, one row per lane.
// The block copies its stripe into shared memory STAGE_STEPS steps at a
// time (every global load a whole 64-byte row segment of the 8 columns),
// STAGES-1 stages ahead of the steps, so no step waits on device memory;
// the block meets at one barrier per stage (one in all at the engines'
// 2M-lane batch, whose 8 steps are one stage), and the steps inside a
// stage are warp-private.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK_W = 2048;
constexpr uint64_t U64_MAX = ~0ull;
constexpr unsigned FULL = 0xffffffffu;

constexpr int WARPS = 8;            // columns per block, one warp each
constexpr int BLOCK = WARPS * 32;
constexpr int STEP_ROWS = 32;       // rows per step, one per lane
constexpr int STAGE_STEPS = 8;      // steps per ring stage
constexpr int STAGE_ROWS = STAGE_STEPS * STEP_ROWS;
constexpr int STAGES = 2;           // ring slots: STAGES-1 stages in flight
constexpr int TILE_PAD = WARPS + 1; // output tile row stride (bank spread)

// Row r of a stage holds the 8 columns' values in an XOR-swizzled order, so
// that the 16 lanes of a half-warp reading one column of 16 rows hit 16
// distinct bank pairs.
struct StripeRing {
  uint64_t t[STAGES][STAGE_ROWS][WARPS];
};

__device__ __forceinline__ int swz(int row, int col) {
  return col ^ ((row >> 1) & (WARPS - 1));
}

// Ascending bitonic sorts of N independent lists, one value of each per
// lane, across the warp. The N sorts run interleaved, so that their
// shuffles overlap.
template <int N>
__device__ __forceinline__ void warp_sort_n(uint64_t (&x)[N], int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int d = size >> 1; d > 0; d >>= 1) {
      const bool up = (lane & size) == 0;
      const bool low = (lane & d) == 0;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const uint64_t y = __shfl_xor_sync(FULL, x[i], d);
        const uint64_t mn = x[i] < y ? x[i] : y;
        const uint64_t mx = x[i] < y ? y : x[i];
        x[i] = (low == up) ? mn : mx;
      }
    }
  }
}

// Ascending bitonic sort of one value per lane across the warp.
__device__ __forceinline__ uint64_t warp_sort(uint64_t x, int lane) {
  uint64_t a[1] = {x};
  warp_sort_n(a, lane);
  return a[0];
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying stage `s` of the stripe (rows [s * STAGE_ROWS, +STAGE_ROWS)
// of columns [col0, col0 + WARPS)) into ring slot s % STAGES. Rows at or
// past `nrows` read as u64::MAX.
__device__ __forceinline__ void stage_issue(StripeRing& ring,
                                            const uint64_t* __restrict__ src,
                                            int64_t nrows, int64_t col0,
                                            int64_t s) {
  uint64_t(*dst)[WARPS] = ring.t[s % STAGES];
#pragma unroll
  for (int e = threadIdx.x; e < STAGE_ROWS * WARPS; e += BLOCK) {
    const int r = e / WARPS, c = e % WARPS;
    const int64_t row = s * STAGE_ROWS + r;
    if (row < nrows)
      cp_async8(&dst[r][swz(r, c)], src + row * CHUNK_W + col0 + c);
    else
      dst[r][swz(r, c)] = U64_MAX;
  }
}

// Walk the block's stripe of `src` (nrows rows, padded with u64::MAX to a
// whole step): warp w calls step(x, last) once per step with x = row
// (step * 32 + lane) of column col0 + w and last true on the last step.
// All lanes call it together. On return the ring is idle and the caller
// may reuse its memory (out_tile).
template <class Step>
__device__ __forceinline__ void walk_stripe(StripeRing& ring,
                                            const uint64_t* __restrict__ src,
                                            int64_t nrows, int64_t col0,
                                            Step&& step) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t nsteps = (nrows + STEP_ROWS - 1) / STEP_ROWS;
  const int64_t nstages = (nsteps + STAGE_STEPS - 1) / STAGE_STEPS;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nstages) stage_issue(ring, src, nrows, col0, s);
    cp_async_commit();
  }
  for (int64_t s = 0; s < nstages; ++s) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage s landed
    __syncthreads();  // everyone's have, and slot (s - 1) % STAGES is free
    if (s + STAGES - 1 < nstages)
      stage_issue(ring, src, nrows, col0, s + STAGES - 1);
    cp_async_commit();
    const uint64_t(*t)[WARPS] = ring.t[s % STAGES];
    const int64_t left = nsteps - s * STAGE_STEPS;
    const int steps = left < STAGE_STEPS ? int(left) : STAGE_STEPS;
    for (int j = 0; j < steps; ++j) {
      const int r = j * STEP_ROWS + lane;
      step(t[r][swz(r, warp)], left == j + 1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The ring's memory as an output tile out[r][w] (padded rows), once the
// walk has returned.
__device__ __forceinline__ uint64_t (*out_tile(StripeRing& ring))[TILE_PAD] {
  return reinterpret_cast<uint64_t(*)[TILE_PAD]>(&ring);
}

// Write rows [0, ROWS) of the block's columns from the shared tile
// out[r][w] to dst[r * CHUNK_W + col0 + w], one 64-byte row segment per
// 8 threads. The caller has synchronised the block after filling `out`.
template <int ROWS>
__device__ __forceinline__ void store_tile(const uint64_t (*out)[TILE_PAD],
                                           uint64_t* __restrict__ dst,
                                           int64_t col0) {
#pragma unroll
  for (int e = threadIdx.x; e < ROWS * WARPS; e += BLOCK) {
    const int r = e / WARPS, c = e % WARPS;
    dst[int64_t(r) * CHUNK_W + col0 + c] = out[r][c];
  }
}

}  // namespace
