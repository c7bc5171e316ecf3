// The exact select epilogues of the port's select kernels, over a
// transposed (K, B) int32 cost tile.
//
// Independent mode gives each column's (min, first argmin) over unretired
// rows.  Greedy mode visits the K slots strictly in order: slot j reads
// column order[j], takes the lexicographic min of (cost, row) over
// unretired rows (ties to the lowest row; retired rows read as BIG), and an
// active pick retires its row before slot j + 1, so an all-identical tile
// cascades to K distinct rows.  A disabled or empty slot gives (-1, BIG).
//
// select_epilogue (parsa_select.cu) runs both modes with every thread of
// one CTA over a tile in global or shared memory: the min is two
// __reduce_min_sync over an order-preserving key, so ties never depend on
// timing, and a slot costs two block-wide barriers.  Each thread owns rows
// t, t + nt, ... and keeps their retired flags in one register bitmask, so
// B <= 32 * blockDim.x.
//
// Over a tile in the CTA's own shared memory whose retired rows read BIG
// (sketch_select.cu, parsa_scan.cu): select_columns_smem gives the
// independent mode, a warp a column; select_epilogue_cand the greedy mode,
// with the slots' work in parallel: every warp ranks a slot's column into
// its kCand smallest keys at once, and one warp then resolves the slots
// over those candidates, all at once where they do not collide.
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

// The independent mode over a (K, B) tile in this CTA's shared memory
// whose retired rows already read BIG (the producer of the tile wrote BIG
// there): the warps take the columns, an exact warp min each, (min, first
// argmin) into (out_a, out_b).  Every thread of the CTA calls it after the
// tile is complete.  Any 1 <= B <= 32,768 and K >= 1.
__device__ __forceinline__ void select_columns_smem(
    const int32_t* tile_t,                // (K, B) cost tile, transposed
    int B, int K,
    int32_t* __restrict__ out_a,          // mins
    int32_t* __restrict__ out_b) {        // argmins
  constexpr int kUnroll = 8;              // independent shared loads in flight
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = warp; j < K; j += blockDim.x >> 5) {
    const int32_t* c = tile_t + static_cast<int64_t>(j) * B;
    unsigned key = kNone;
    unsigned row = kNone;
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
    if (lane == 0) {
      out_a[j] = static_cast<int>(m ^ 0x80000000u);
      out_b[j] = static_cast<int>(row);
    }
  }
}

// The packed (cost, row) key of select_epilogue_cand: the lexicographic
// order of (cost, row) wherever cost < kSatKey (row < 2^15).
constexpr unsigned kSatKey = (1u << 17) - 1;
// candidates kept a greedy slot by select_epilogue_cand
constexpr int kCand = 8;

__device__ __forceinline__ unsigned cand_key(int32_t cost, int row) {
  return min(static_cast<unsigned>(cost), kSatKey) << 15 |
         static_cast<unsigned>(row);
}

// The 4 smallest keys cand_key(c[r], r) above ``floor`` (all of them if
// ``all``) over this lane's rows r = lane, lane + 32, ... < B, ascending,
// kNone where there are fewer.
__device__ __forceinline__ void lane_top4(const int32_t* c, int B, int lane,
                                          bool all, unsigned floor,
                                          unsigned& h0, unsigned& h1,
                                          unsigned& h2, unsigned& h3) {
  h0 = h1 = h2 = h3 = kNone;
  for (int r = lane; r < B; r += 32) {
    unsigned kv = cand_key(c[r], r);
    if ((all || kv > floor) && kv < h3) {  // insert, keeping h sorted
      if (kv < h2) {
        h3 = h2;
        if (kv < h1) {
          h2 = h1;
          if (kv < h0) {
            h1 = h0;
            h0 = kv;
          } else {
            h1 = kv;
          }
        } else {
          h2 = kv;
        }
      } else {
        h3 = kv;
      }
    }
  }
}

// The greedy epilogue by candidates, over a (K, B) tile in this CTA's
// shared memory whose retired rows read BIG; every thread of the CTA calls
// it, and only warp 0 writes out_a (u_sel) and out_b (c_sel).  Any
// 1 <= B <= 32,768 and K >= 1; ``live`` counts the rows not retired.
//   1. Every warp takes slots j = warp, warp + nwarps, ... and writes
//      cand[j * T + t], t < T = min(K, kCand), the T smallest packed keys
//      cand_key(cost, row) of column order[j] in ascending order (kNone
//      past B rows).  A lane keeps the 4 smallest keys of its own rows in
//      registers; each of the T steps is one warp min, the lane that gave
//      the key shifting its list and rescanning its rows only when the list
//      runs out.
//   2. Warp 0 resolves the slots, lane l holding slot l (32 at a time),
//      each slot's pick being its first candidate whose row no earlier
//      slot of this round took (``taken``, B bytes of zeros at entry,
//      zeros again at exit): the greedy pick, since at most j rows are
//      taken before slot j and a retired row's key sorts after every live
//      one.  Every pending slot takes its first candidate not yet taken at
//      once; the pending slots below the first one that repeats an earlier
//      pending slot's row are final (no earlier slot can change their
//      pick), and the others try again with those rows taken.  A slot
//      whose candidates are all taken, or whose candidate's cost field is
//      saturated (a retired row, or a true cost of kSatKey or more), takes
//      the exact min of its column over the rows not taken, by the whole
//      warp, once it is the lowest pending slot.  Once as many rows are
//      taken as were live, the remaining slots pick nothing.
// So the slots cost a few warp steps where their picks do not collide,
// and one step a slot where they do, where a slot resolved alone costs a
// pass over its column and a warp reduction.
__device__ __forceinline__ void select_epilogue_cand(
    const int32_t* tile_t,                // (K, B) cost tile, transposed
    const int32_t* __restrict__ order,    // (K,) slot -> column, or null
    const uint8_t* __restrict__ enabled,  // (K,) bool, or null
    int B, int K,
    int live,                             // rows not retired
    unsigned* cand,                       // (K, min(K, kCand)) scratch
    uint8_t* taken,                       // (B,) zeros
    int32_t* out_a, int32_t* out_b) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int T = min(K, kCand);
  for (int j = warp; j < K; j += nwarps) {
    const int32_t* c = tile_t + static_cast<int64_t>(order ? order[j] : j) * B;
    unsigned h0, h1, h2, h3;  // this lane's next smallest keys
    lane_top4(c, B, lane, true, 0u, h0, h1, h2, h3);
    for (int t = 0; t < T; ++t) {
      const unsigned m = __reduce_min_sync(0xffffffffu, h0);
      if (lane == 0) cand[j * T + t] = m;
      if (m != kNone && h0 == m) {  // keys are distinct: one owner
        h0 = h1;
        h1 = h2;
        h2 = h3;
        h3 = kNone;
        if (h0 == kNone) lane_top4(c, B, lane, false, m, h0, h1, h2, h3);
      }
    }
  }
  __syncthreads();
  if (warp != 0) return;
  int left = live;  // rows neither retired nor taken
  for (int j0 = 0; j0 < K; j0 += 32) {
    // lane l holds slot j0 + l; a disabled slot is final at once
    const int j = j0 + lane;
    const unsigned* cj = cand + static_cast<int64_t>(j < K ? j : 0) * T;
    bool done = j >= K || (enabled && !enabled[j]);
    int t = 0;     // this slot's first candidate not yet known taken
    int row = -1;  // the pick, once final
    int cost = kBig;
    for (unsigned pending = __ballot_sync(0xffffffffu, !done); pending;
         pending = __ballot_sync(0xffffffffu, !done)) {
      if (left == 0) break;  // every live row is taken: no more picks
      // each pending slot's first candidate not taken (kNone if none)
      unsigned key = kNone;
      if (!done) {
        for (; t < T; ++t) {
          key = cj[t];
          if (key == kNone || !taken[key & 0x7fffu]) break;
        }
        if (t == T) key = kNone;
      }
      const bool fast = !done && (key >> 15) < kSatKey;
      const int trow = fast ? static_cast<int>(key & 0x7fffu) : -1 - lane;
      // a pending slot that repeats an earlier pending slot's row, or has
      // no exact candidate, stops the prefix of final slots
      const unsigned same = __match_any_sync(0xffffffffu, trow);
      const bool dup = fast && (same & ((1u << lane) - 1u)) != 0u;
      const unsigned stop = __ballot_sync(0xffffffffu, (!done && !fast) ||
                                                           dup);
      const int lowest = __ffs(pending) - 1;
      if (stop & (1u << lowest)) {
        // the lowest pending slot has no candidate left: the exact min of
        // its column over the rows not taken, by the whole warp
        const int jl = j0 + lowest;
        const int32_t* c =
            tile_t + static_cast<int64_t>(order ? order[jl] : jl) * B;
        unsigned ek = kNone, er = kNone;
        for (int r = lane; r < B; r += 32) {
          const unsigned kv = taken[r] ? kNone : order_key(c[r]);
          if (kv < ek) {  // strict: this lane's rows rise
            ek = kv;
            er = r;
          }
        }
        const unsigned em = __reduce_min_sync(0xffffffffu, ek);
        er = __reduce_min_sync(0xffffffffu, ek == em ? er : kNone);
        const int ec = static_cast<int>(em ^ 0x80000000u);
        const bool act = em != kNone && ec < kBig;
        if (lane == lowest) {
          done = true;
          if (act) {
            row = static_cast<int>(er);
            cost = ec;
            taken[row] = 1;
          }
        }
        left -= act;
      } else {
        // every pending slot below the first stop takes its candidate
        const unsigned below =
            stop ? (1u << (__ffs(stop) - 1)) - 1u : 0xffffffffu;
        const bool fin = !done && ((1u << lane) & below) != 0u;
        if (fin) {
          done = true;
          row = trow;
          cost = static_cast<int>(key >> 15);
          taken[row] = 1;
        }
        left -= __popc(__ballot_sync(0xffffffffu, fin));
      }
      __syncwarp();
    }
    if (j < K) {
      out_a[j] = row;
      out_b[j] = row >= 0 ? cost : kBig;
    }
  }
  __syncwarp();
  for (int j = lane; j < K; j += 32)  // taken is zeros again
    if (out_a[j] >= 0) taken[out_a[j]] = 0;
  __syncwarp();
}

}  // namespace parsa
