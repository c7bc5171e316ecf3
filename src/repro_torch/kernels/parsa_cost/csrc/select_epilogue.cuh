// The exact select epilogue shared by parsa_select.cu and sketch_select.cu:
// reduce a transposed (K, B) int32 cost tile, in global or shared memory,
// with every thread of one CTA.
//
// Independent mode gives each column's (min, first argmin) over unretired
// rows.  Greedy mode visits the K slots strictly in order: slot j reads
// column order[j], takes the lexicographic min of (cost, row) over
// unretired rows (ties to the lowest row; retired rows read as BIG), and an
// active pick retires its row before slot j + 1, so an all-identical tile
// cascades to K distinct rows.  A disabled or empty slot gives (-1, BIG).
//
// The min is two __reduce_min_sync over an order-preserving key, so ties
// never depend on timing.  Each thread owns rows t, t + nt, ... and keeps
// their retired flags in one register bitmask, so B <= 32 * blockDim.x.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace parsa {

constexpr int kBig = 1 << 30;
constexpr unsigned kNone = 0xffffffffu;
constexpr int kMaxRowsPerThread = 32;

// int32 -> unsigned with the same order (negative values sort first).
__device__ __forceinline__ unsigned order_key(int v) {
  return static_cast<unsigned>(v) ^ 0x80000000u;
}

// Block-wide lexicographic min of (key, row); every thread gets the result.
// blockDim.x must be a multiple of 32.
__device__ __forceinline__ void block_min(unsigned& key, unsigned& row,
                                          unsigned* s_key, unsigned* s_row) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned m = __reduce_min_sync(0xffffffffu, key);
  const unsigned r = __reduce_min_sync(0xffffffffu, key == m ? row : kNone);
  if (lane == 0) {
    s_key[warp] = m;
    s_row[warp] = r;
  }
  __syncthreads();
  if (warp == 0) {
    const unsigned k2 = lane < nwarps ? s_key[lane] : kNone;
    const unsigned r2 = lane < nwarps ? s_row[lane] : kNone;
    const unsigned m2 = __reduce_min_sync(0xffffffffu, k2);
    const unsigned rr = __reduce_min_sync(0xffffffffu, k2 == m2 ? r2 : kNone);
    if (lane == 0) {
      s_key[32] = m2;
      s_row[32] = rr;
    }
  }
  __syncthreads();
  key = s_key[32];
  row = s_row[32];
}

// Every thread of the CTA calls this; only thread 0 writes the outputs.
__device__ __forceinline__ void select_epilogue(
    const int32_t* tile_t,                // (K, B) cost tile, transposed
    const uint8_t* __restrict__ retired,  // (B,) bool
    const int32_t* __restrict__ order,    // (K,) slot -> column, or null
    const uint8_t* __restrict__ enabled,  // (K,) bool, or null
    int B, int K, int greedy,
    int32_t* __restrict__ out_a,          // greedy: u_sel; else mins
    int32_t* __restrict__ out_b) {        // greedy: c_sel; else argmins
  __shared__ unsigned s_key[33];
  __shared__ unsigned s_row[33];
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  unsigned ret = 0;  // bit q: row t + q * nt is retired
  for (int q = 0; q < kMaxRowsPerThread; ++q) {
    const int r = t + q * nt;
    if (r < B && retired[r]) ret |= 1u << q;
  }
  for (int j = 0; j < K; ++j) {
    const int col = order ? order[j] : j;
    const int32_t* c = tile_t + static_cast<int64_t>(col) * B;
    unsigned key = kNone;
    unsigned row = kNone;
    for (int q = 0; q < kMaxRowsPerThread; ++q) {
      const int r = t + q * nt;
      if (r >= B) break;
      const unsigned kv = order_key(((ret >> q) & 1u) ? kBig : c[r]);
      if (kv < key) {  // strict: this thread's rows rise with q
        key = kv;
        row = r;
      }
    }
    block_min(key, row, s_key, s_row);
    const int m = static_cast<int>(key ^ 0x80000000u);
    if (greedy) {
      const bool act = (!enabled || enabled[j]) && m < kBig;
      if (act && static_cast<int>(row % nt) == t) ret |= 1u << (row / nt);
      if (t == 0) {
        out_a[j] = act ? static_cast<int>(row) : -1;
        out_b[j] = act ? m : kBig;
      }
    } else if (t == 0) {
      out_a[j] = m;
      out_b[j] = static_cast<int>(row);
    }
  }
}

}  // namespace parsa
