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
//
// select_epilogue_smem computes the same bits over a tile in the CTA's own
// shared memory whose retired rows read BIG (sketch_select.cu writes BIG
// there): one warp and, as a rule, one warp reduction a greedy slot, where
// select_epilogue runs the whole CTA through two block-wide barriers a
// slot.
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

// The exact epilogue over a (K, B) tile in this CTA's shared memory whose
// retired rows already read BIG (the producer of the tile wrote BIG
// there).  Every thread of the CTA calls it after the tile is complete.
// Any 1 <= B <= 32,768 and K >= 1.
//   greedy: ONE warp runs the K slots, lane l owning rows l, l + 32, ...
//     A slot's min is one min tree in registers and one warp reduction of
//     a packed key (min(cost, kSat) << 15 | row: the lexicographic order of
//     (cost, row) wherever the min cost is below kSat); only a saturated
//     min (every remaining cost >= kSat, or none left) takes the exact
//     two-reduction min of select_epilogue.  A pick retires its row by
//     writing BIG across the row of the tile.  A slot carries no block
//     barrier.
//   independent: the warps take the columns, an exact warp min each.
__device__ __forceinline__ void select_epilogue_smem(
    int32_t* tile_t,                      // (K, B) cost tile, transposed
    const int32_t* __restrict__ order,    // (K,) slot -> column, or null
    const uint8_t* __restrict__ enabled,  // (K,) bool, or null
    int B, int K, int greedy,
    int32_t* __restrict__ out_a,          // greedy: u_sel; else mins
    int32_t* __restrict__ out_b) {        // greedy: c_sel; else argmins
  constexpr int kUnroll = 8;              // independent shared loads in flight
  constexpr unsigned kSat = (1u << 17) - 1;  // packed cost field's maximum
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the exact lexicographic min of (cost, row) over one column, in every
  // lane of the warp
  auto exact_min = [&](const int32_t* c, unsigned& key, unsigned& row) {
    key = kNone;
    row = kNone;
    for (int r0 = lane; r0 < B; r0 += 32 * kUnroll) {
      unsigned kv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + 32 * u;
        kv[u] = r < B ? order_key(c[r]) : kNone;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (kv[u] < key) {  // strict: this lane's rows rise
          key = kv[u];
          row = r0 + 32 * u;
        }
      }
    }
    const unsigned m = __reduce_min_sync(0xffffffffu, key);
    row = __reduce_min_sync(0xffffffffu, key == m ? row : kNone);
    key = m;
  };
  if (!greedy) {
    for (int j = warp; j < K; j += blockDim.x >> 5) {
      unsigned key, row;
      exact_min(tile_t + static_cast<int64_t>(j) * B, key, row);
      if (lane == 0) {
        out_a[j] = static_cast<int>(key ^ 0x80000000u);
        out_b[j] = static_cast<int>(row);
      }
    }
    return;
  }
  if (warp != 0) return;
  for (int j0 = 0; j0 < K; j0 += 32) {
    // this chunk's slots: lane q holds slot j0 + q's column and gate, and
    // collects its outputs
    const int jq = j0 + lane;
    const int col_q = jq < K ? (order ? order[jq] : jq) : 0;
    const bool en_q = jq < K && (!enabled || enabled[jq]);
    int a_q = -1, b_q = kBig;
    const int n = min(32, K - j0);
    for (int q = 0; q < n; ++q) {
      const int col = __shfl_sync(0xffffffffu, col_q, q);
      const bool en = __shfl_sync(0xffffffffu, en_q, q);
      const int32_t* c = tile_t + static_cast<int64_t>(col) * B;
      unsigned pk = 0xffffffffu;
      for (int r0 = lane; r0 < B; r0 += 32 * kUnroll) {
        unsigned kv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int r = r0 + 32 * u;
          kv[u] = r < B ? min(static_cast<unsigned>(c[r]), kSat) << 15 |
                              static_cast<unsigned>(r)
                        : 0xffffffffu;
        }
#pragma unroll
        for (int w = kUnroll / 2; w > 0; w >>= 1)
#pragma unroll
          for (int u = 0; u < w; ++u) kv[u] = min(kv[u], kv[u + w]);
        pk = min(pk, kv[0]);
      }
      pk = __reduce_min_sync(0xffffffffu, pk);
      int cost, row;
      if ((pk >> 15) < kSat) {
        cost = static_cast<int>(pk >> 15);
        row = static_cast<int>(pk & 0x7fffu);
      } else {
        unsigned key, r;
        exact_min(c, key, r);
        cost = static_cast<int>(key ^ 0x80000000u);
        row = static_cast<int>(r);
      }
      const bool act = en && cost < kBig;
      if (act) {
        for (int cc = lane; cc < K; cc += 32)
          tile_t[static_cast<int64_t>(cc) * B + row] = kBig;
        __syncwarp();
      }
      if (lane == q) {
        a_q = act ? row : -1;
        b_q = act ? cost : kBig;
      }
    }
    if (lane < n) {
      out_a[jq] = a_q;
      out_b[jq] = b_q;
    }
  }
}

}  // namespace parsa
