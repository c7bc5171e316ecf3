// The cost pass of one greedy round of the blocked partitioner, shared by
// sketch_select.cu (one round a launch) and parsa_scan.cu (every round of
// every block in one launch): the one round body of the repository.
//
// Input: each row of the block as its compact list of nonzero words, the
// form the scan keeps on the card (core/partition.py packs every row into
// at most ``cap`` (word index, word) pairs, padded with (0, 0)), and for
// the rare rows truncated past ``cap`` their full dense row of W words
// (sketch_select.cu) or their full list of nonzero words (parsa_scan.cu),
// walked as a listed row.
// The cost of an unretired row against partition i,
//     cost[u, i] = sum over the row's pairs (w, x) of popcount(x & ~s[i, w])
// reads the list and gathers k set words per nonzero pair; a truncated
// row is walked densely.  A retired row gathers nothing and stores BIG,
// which the epilogue (select_epilogue.cuh) reads as retired.
//
// Layout: a cluster of kCluster = 8 CTAs (sketch_select.cu runs
// kRoundThreads threads a CTA, parsa_scan.cu 512; the pass takes any
// multiple of 32).  CTA r computes the cost rows [r_begin, r_end).  A warp
// takes 32 / kLanes rows at a time, kLanes lanes a row: the lanes load the
// row's pairs together (48 / kLanes independent loads each, enough for
// cap <= 48 in one batch), then every
// nonzero pair gathers its k set words, independent loads that hit L2, and
// a shuffle reduction over the row's lanes gives each cost, which the
// row's lanes store a few columns each: two dependent round trips a row.
// A truncated row is walked by the whole warp over its dense words, in
// batches of kBatch independent loads, the set words under a zero row word
// never read.  Each cost is stored into ``tile``, transposed (k, B): the
// rank-0 CTA's shared tile, through distributed shared memory.
//
// The set words S are read with set_word(): parsa_scan writes S during its
// launch, so S is never read through the read-only (non-coherent) cache.
// Words are read as unsigned: a word with bit 31 set is a negative int32
// and is never compared by value.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "select_epilogue.cuh"

namespace parsa {

constexpr int kCluster = 8;        // CTAs per cluster (portable maximum)
constexpr int kRoundThreads = 1024;  // sketch_select's threads per CTA
constexpr int kCols = 16;          // partitions per pass, one accumulator each
constexpr int kListPairs = 48;     // pairs a listed row loads at once
constexpr int kBatch = 4;          // dense row-word loads per lane in flight

// One word of the server sets.  A volatile load is a strong load, served
// by L2, the point of coherence of the card: it sees every write another
// SM made before the cluster barrier that orders the two (never a stale
// line of this SM's L1 or of the read-only cache).
__device__ __forceinline__ uint32_t set_word(const uint32_t* p) {
  return *reinterpret_cast<const volatile uint32_t*>(p);
}

// What the cost pass needs to know of row u: whether it is retired, and
// for a row truncated past ``cap`` either its full dense row (``dense``)
// or its full list of nonzero words (``lw``, ``lv``, ``len``); null for a
// row that its (B, cap) list holds whole.
struct RowSrc {
  bool retired;
  const uint32_t* dense;
  const int32_t* lw = nullptr;
  const uint32_t* lv = nullptr;
  int len = 0;
};

// Every thread of the CTA calls this; row_fn(u) -> RowSrc for u in
// [r_begin, r_end).  Rows outside [0, B) are never touched.  kLanes lanes
// take a listed row (8 or 16): more lanes a row gather a row's set words in
// fewer dependent rounds, fewer take more rows a warp.
template <int kLanes, class RowFn>
__device__ __forceinline__ void round_cost_pass(
    int32_t* tile,                        // (K, B) rank 0's tile
    const int32_t* __restrict__ widx,     // (B, cap) word indices
    const uint32_t* __restrict__ vals,    // (B, cap) words
    int cap,
    const uint32_t* s,                    // (K, W) server sets
    int B, int K, int W, int r_begin, int r_end, RowFn row_fn) {
  constexpr int kRowsPerWarp = 32 / kLanes;
  constexpr int kEntries = kListPairs / kLanes;  // pairs a lane in flight
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int sub = lane % kLanes;   // this lane's place in its row's group
  const int grp = lane / kLanes;   // which of the warp's rows
  for (int i0 = 0; i0 < K; i0 += kCols) {
    const int ncol = min(kCols, K - i0);
    const uint32_t* sb = s + static_cast<int64_t>(i0) * W;
    // warp-uniform loop: kRowsPerWarp rows a pass
    for (int r0 = r_begin + warp * kRowsPerWarp; r0 < r_end;
         r0 += nwarps * kRowsPerWarp) {
      const int u = r0 + grp;
      const bool in = u < r_end;
      // the row's pairs, loaded together (kEntries each a lane)
      int wi[kEntries];
      uint32_t x[kEntries];
      const int64_t row0 = static_cast<int64_t>(in ? u : r_begin) * cap;
#pragma unroll
      for (int j = 0; j < kEntries; ++j) {
        const int e = sub + kLanes * j;
        x[j] = in && e < cap ? __ldg(vals + row0 + e) : 0u;
        wi[j] = in && e < cap ? __ldg(widx + row0 + e) : 0;
      }
      // a retired row's costs are never read: it stores BIG, which the
      // epilogue reads as retired
      const RowSrc src = in ? row_fn(u) : RowSrc{false, nullptr};
      const bool ret = src.retired;
      const bool tr = src.dense != nullptr && !ret;
      // the list walked: the row's own, or a truncated row's full one
      const bool full = src.lw != nullptr;
      const int32_t* lw = full ? src.lw : widx + row0;
      const uint32_t* lv = full ? src.lv : vals + row0;
      const int len = full ? src.len : cap;
      int acc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = 0;
      if (in && !ret && !tr) {
        for (int e0 = sub; e0 < len; e0 += kLanes * kEntries) {
          if (e0 != sub || full) {  // pairs not loaded above
#pragma unroll
            for (int j = 0; j < kEntries; ++j) {
              const int e = e0 + kLanes * j;
              x[j] = e < len ? __ldg(lv + e) : 0u;
              wi[j] = e < len ? __ldg(lw + e) : 0;
            }
          }
#pragma unroll
          for (int j = 0; j < kEntries; ++j) {
            if (x[j] == 0u) continue;  // padding (0, 0) counts nothing
            const uint32_t* col = sb + wi[j];
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              if (c < ncol) {
                acc[c] += __popc(x[j] &
                                 ~set_word(col + static_cast<int64_t>(c) * W));
              }
            }
          }
        }
      }
      // every lane of the row's group gets the sums; lane sub stores the
      // columns c = sub (mod kLanes)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
      }
      if (in && !tr) {
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (c % kLanes == sub && c < ncol)
            tile[(i0 + c) * B + u] = ret ? kBig : acc[c];
      }
      // truncated rows of this pass: the whole warp walks each dense row
      unsigned todo = __ballot_sync(0xffffffffu, tr && sub == 0);
      while (todo != 0u) {
        const int ut = r0 + (__ffs(todo) - 1) / kLanes;
        todo &= todo - 1u;
        const uint32_t* row = row_fn(ut).dense;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = 0;
        for (int w0 = lane; w0 < W; w0 += 32 * kBatch) {
          uint32_t n[kBatch];
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            const int w = w0 + 32 * b;
            n[b] = w < W ? __ldg(row + w) : 0u;
          }
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            if (n[b] == 0u) continue;
            const int w = w0 + 32 * b;
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              if (c < ncol) {
                acc[c] += __popc(n[b] &
                                 ~set_word(sb + static_cast<int64_t>(c) * W + w));
              }
            }
          }
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int v = __reduce_add_sync(0xffffffffu, acc[c]);
          if (lane == 0 && c < ncol) tile[(i0 + c) * B + ut] = v;
        }
      }
    }
  }
}

}  // namespace parsa
