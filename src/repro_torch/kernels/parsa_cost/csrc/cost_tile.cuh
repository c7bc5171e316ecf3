// The popcount cost tile shared by parsa_cost.cu and parsa_select.cu:
//
//     cost[u, i] = sum_w popc(nbr[u, w] & ~s[i, w]) = |N(u) \ S_i|
//
// over packed little-endian int32 words.  Words are read as unsigned: a
// word with bit 31 set is a negative int32 and is never compared by value.
//
// Design on Hopper: one CTA per (row u, group of kTileCols partitions).
// Its threads stride over the row's W words, each keeping kTileCols
// register accumulators, and the W edge needs no padding (the loop bound
// is W).  A zero word of N(u) adds nothing, so the thread skips the loads
// of the partition words under it: rows of N(u) are sparse (a
// text_like(100k, 65536) row holds ~20 of 2048 words), so most of the
// (K, W) partition block is never read.  The partials meet in a warp
// reduction (__reduce_add_sync) and one shared-memory pass.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace parsa {

constexpr int kTileCols = 16;      // partitions per CTA, one accumulator each
constexpr int kTileThreads = 128;  // threads per CTA, striding over words

__global__ void __launch_bounds__(kTileThreads)
cost_tile_kernel(const uint32_t* __restrict__ nbr,  // (U, W)
                 const uint32_t* __restrict__ s,    // (K, W)
                 int K, int W,
                 int32_t* __restrict__ out,         // out[u * su + i * si]
                 int64_t su, int64_t si) {
  const int64_t u = blockIdx.x;
  const int i0 = blockIdx.y * kTileCols;
  const int ncol = min(kTileCols, K - i0);
  const uint32_t* row = nbr + u * W;
  const uint32_t* sb = s + static_cast<int64_t>(i0) * W;
  int acc[kTileCols];
#pragma unroll
  for (int c = 0; c < kTileCols; ++c) acc[c] = 0;
  for (int w = threadIdx.x; w < W; w += kTileThreads) {
    const uint32_t n = row[w];
    if (n == 0u) continue;
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) {
      if (c < ncol) acc[c] += __popc(n & ~sb[static_cast<int64_t>(c) * W + w]);
    }
  }
  __shared__ int part[kTileThreads / 32][kTileCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kTileCols; ++c) {
    const int v = __reduce_add_sync(0xffffffffu, acc[c]);
    if (lane == 0) part[warp][c] = v;
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < ncol) {
    int t = 0;
#pragma unroll
    for (int q = 0; q < kTileThreads / 32; ++q) t += part[q][threadIdx.x];
    out[u * su + static_cast<int64_t>(i0 + threadIdx.x) * si] = t;
  }
}

// Launch the tile on `stream`; the caller guarantees U >= 1 and K >= 1.
inline int launch_cost_tile(const void* nbr, const void* s, int U, int K,
                            int W, void* out, int64_t su, int64_t si,
                            void* stream) {
  const dim3 grid(U, (K + kTileCols - 1) / kTileCols);
  cost_tile_kernel<<<grid, kTileThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(nbr), static_cast<const uint32_t*>(s), K,
      W, static_cast<int32_t*>(out), su, si);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace parsa
