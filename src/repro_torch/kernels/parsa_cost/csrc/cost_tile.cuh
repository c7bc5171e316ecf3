// The popcount cost tile shared by parsa_cost.cu and parsa_select.cu:
//
//     cost[u, i] = sum_w popc(nbr[u, w] & ~s[i, w]) = |N(u) \ S_i|
//
// over packed little-endian int32 words.  Words are read as unsigned: a
// word with bit 31 set is a negative int32 and is never compared by value.
//
// Bound on this card: bytes, the (U, W) block and the partition words
// under its nonzero words; a row costs one AND-NOT, one popcount and one
// add per (nonzero word, partition) pair.  What holds it back is latency:
// a row of the main graph holds ~20 nonzero words of 2,048, so the time is
// the chain of dependent trips to L2, not their bytes.  The design keeps
// that chain at two trips a row and fills the card:
//
//   * A warp takes a row; a CTA takes kRows rows (2, 4 or 8 by U, so that
//     U = 256 gives 128 CTAs, and U = 1,024 gives 256 row-major or 128
//     transposed).  The row is read in
//     chunks of 2,048 words, every load of a chunk issued before any is
//     used: 16 16-byte loads a lane where the row is 16-byte aligned (W % 4
//     == 0 and an aligned base, every shape the paths launch), else 64
//     4-byte loads a lane.
//   * Its nonzero words are found by ballots (one per four words a lane,
//     four more only where one of them is nonzero) and compacted into a
//     warp's list of (word index, word) pairs in shared memory.
//   * One gather pass then reads S under every listed word for ALL K
//     partitions: 32 / P lanes a partition over the list, P partitions a
//     pass (P = 32, or K rounded up to a power of two below that), the
//     lanes of a partition meeting in shuffles.  A lane's entries go out
//     in predicated batches of 8 loads, so a row of ~20 nonzero words
//     costs one or two trips a pass.  A row is read once for up to
//     kTileMaxGroup (1,024, ops.SELECT_MAX_K) partitions (the earlier grid
//     read it once per 16).  The loop over partition groups keeps each
//     warp's sums in shared memory, not registers, and the list stays
//     there across the groups of 32.  A larger K (only parsa_cost takes
//     one) reads the row again for each further 1,024 partitions, so the
//     shared memory stays that of K = 1,024.  A dense row (truncated
//     rows, random words, the all-ones complement masks) fills the list in
//     steps of at most 128 pairs and runs a gather pass each time it would
//     overflow, through the same code.
//   * The CTA's (kRows, K) sums are stored from shared memory: row-major
//     (U, K) as one contiguous run, or transposed (K, U) for
//     parsa_select_tile with consecutive u in each warp's stores (8 rows a
//     CTA: 32-byte runs, one L2 sector each).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace parsa {

constexpr int kTileVecs = 16;                // 16-byte loads a lane a chunk
constexpr int kTileWords = 4 * kTileVecs;    // words a lane a chunk
constexpr int kTileChunk = 32 * kTileWords;  // 2,048 words a chunk
constexpr int kTileListCap = 256;            // (word, value) pairs a warp
constexpr int kTileMaxRows = 8;              // rows (warps) a CTA
constexpr int kTileMaxGroup = 1024;          // partitions a pass of a row

// One gather pass over a warp's list: acc[i] += sum_j popc(v_j & ~s[i, w_j])
// for every partition i < K.  lpp lanes (a power of two) share a
// partition, 32 / lpp partitions a pass; a lane takes the pass's entries
// sub, sub + lpp, ... in predicated batches of kGatherBatch, each batch's
// loads issued before any is used (a loop of runtime length would leave
// its remainder to one dependent trip an entry).  Not inlined: the
// compaction loop below is unrolled 16 times.
constexpr int kGatherBatch = 8;

static __device__ __noinline__ void tile_gather(
    const uint2* list, int n, const uint32_t* __restrict__ s, int K, int W,
    int* acc, int lane, int lpp) {
  const int sub = lane & (lpp - 1);
  const int per_pass = 32 / lpp;
  for (int i0 = 0; i0 < K; i0 += per_pass) {
    const int i = i0 + lane / lpp;
    int a = 0;
    if (i < K) {
      const uint32_t* si = s + static_cast<int64_t>(i) * W;
      for (int j0 = sub; j0 < n; j0 += kGatherBatch * lpp) {
        uint32_t y[kGatherBatch], v[kGatherBatch];
#pragma unroll
        for (int b = 0; b < kGatherBatch; ++b) {
          const int j = j0 + b * lpp;
          const uint2 e = j < n ? list[j] : make_uint2(0u, 0u);
          y[b] = e.y;
          v[b] = j < n ? __ldg(si + e.x) : 0u;
        }
#pragma unroll
        for (int b = 0; b < kGatherBatch; ++b) a += __popc(y[b] & ~v[b]);
      }
    }
    for (int o = lpp >> 1; o > 0; o >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, o);
    if (sub == 0 && i < K) acc[i] += a;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(32 * kTileMaxRows)
cost_tile_kernel(const uint32_t* __restrict__ nbr,  // (U, W)
                 const uint32_t* __restrict__ s,    // (K, W)
                 int U, int K, int W,
                 int kp,                            // a row's stride in acc,
                                                    // > min(K, kTileMaxGroup)
                 int32_t* __restrict__ out,         // (U, K), or (K, U)
                 int transposed) {
  extern __shared__ __align__(16) unsigned char cost_smem[];
  const int rows = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* acc_all = reinterpret_cast<int*>(cost_smem);         // (rows, kp)
  uint2* list = reinterpret_cast<uint2*>(
      cost_smem + (rows * kp * 4 + 15) / 16 * 16) + warp * kTileListCap;
  int* acc = acc_all + warp * kp;
  const int64_t u0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int64_t u = u0 + warp;
  const int nrows = min(rows, U - static_cast<int>(u0));
  const unsigned below = (1u << lane) - 1u;

  for (int g0 = 0; g0 < K; g0 += kTileMaxGroup) {
    const int kg = min(K - g0, kTileMaxGroup);  // this group's partitions
    const uint32_t* sg = s + static_cast<int64_t>(g0) * W;
    for (int i = lane; i < kg; i += 32) acc[i] = 0;
    int lpp = 1;  // lanes a partition: 32 / (kg rounded up to a power of two)
    while (lpp < 32 && lpp * kg <= 16) lpp <<= 1;

    if (u < U) {
      const uint32_t* row = nbr + u * W;
      for (int c0 = 0; c0 < W; c0 += kTileChunk) {
        const int len = min(W - c0, kTileChunk);
        // every load of the chunk goes out before any is used
        uint32_t x[kTileWords];
        if (kVec) {
          const uint4* r4 = reinterpret_cast<const uint4*>(row + c0);
#pragma unroll
          for (int q = 0; q < kTileVecs; ++q) {
            const int v = lane + 32 * q;
            const uint4 t =
                4 * v < len ? __ldg(r4 + v) : make_uint4(0, 0, 0, 0);
            x[4 * q] = t.x;
            x[4 * q + 1] = t.y;
            x[4 * q + 2] = t.z;
            x[4 * q + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int t = 0; t < kTileWords; ++t) {
            const int w = lane + 32 * t;
            x[t] = w < len ? __ldg(row + c0 + w) : 0u;
          }
        }
        // compact the nonzero words into the warp's list, in steps of at
        // most 128 pairs; a pass empties the list before it could overflow
        int n = 0;
#pragma unroll
        for (int q = 0; q < kTileVecs; ++q) {
          const bool any = (x[4 * q] | x[4 * q + 1] | x[4 * q + 2] |
                            x[4 * q + 3]) != 0u;
          if (__ballot_sync(0xffffffffu, any) == 0u) continue;
          if (n > kTileListCap - 128) {
            __syncwarp();
            tile_gather(list, n, sg, kg, W, acc, lane, lpp);
            __syncwarp();
            n = 0;
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint32_t v = x[4 * q + c];
            const unsigned m = __ballot_sync(0xffffffffu, v != 0u);
            if (v != 0u) {
              const int w = kVec ? c0 + 4 * (lane + 32 * q) + c
                                 : c0 + lane + 32 * (4 * q + c);
              list[n + __popc(m & below)] =
                  make_uint2(static_cast<uint32_t>(w), v);
            }
            n += __popc(m);
          }
        }
        __syncwarp();
        tile_gather(list, n, sg, kg, W, acc, lane, lpp);
        __syncwarp();
      }
    }
    __syncthreads();
    const int total = nrows * kg;
    if (!transposed) {  // one run of kg words a row (all of it if K <= 1,024)
      int32_t* o = out + u0 * K + g0;
      for (int t = threadIdx.x; t < total; t += blockDim.x)
        o[static_cast<int64_t>(t / kg) * K + t % kg] =
            acc_all[(t / kg) * kp + t % kg];
    } else {
      for (int t = threadIdx.x; t < total; t += blockDim.x) {
        const int r = t % nrows;
        const int i = t / nrows;
        out[static_cast<int64_t>(g0 + i) * U + u0 + r] = acc_all[r * kp + i];
      }
    }
    __syncthreads();  // the stores have read acc before the next group's zeros
  }
}

template <bool kVec>
inline int launch_cost_tile_as(const uint32_t* nbr, const uint32_t* s, int U,
                               int K, int W, int32_t* out, int transposed,
                               cudaStream_t stream) {
  // 8 rows a CTA for the transposed store and for U >= 8 * 132 rows; fewer
  // below that, so that the grid still covers the card's 132 SMs
  const int rows = (transposed || U >= 8 * 132) ? 8 : (U >= 4 * 132 ? 4 : 2);
  // odd stride: a transposed read hits distinct banks
  const int kp = min(K, kTileMaxGroup) | 1;
  const int smem = (rows * kp * 4 + 15) / 16 * 16 + rows * kTileListCap * 8;
  static int opted_in = 48 * 1024;  // the default limit needs no opt-in
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        cost_tile_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = smem;
  }
  const int grid = (U + rows - 1) / rows;
  cost_tile_kernel<kVec><<<grid, 32 * rows, smem, stream>>>(
      nbr, s, U, K, W, kp, out, transposed);
  return static_cast<int>(cudaGetLastError());
}

// Launch the tile on `stream`, (U, K) row-major or (K, U) transposed; the
// caller guarantees U >= 1 and K >= 1.
inline int launch_cost_tile(const void* nbr, const void* s, int U, int K,
                            int W, void* out, int transposed, void* stream) {
  const auto* n = static_cast<const uint32_t*>(nbr);
  const auto* sv = static_cast<const uint32_t*>(s);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool aligned =
      W % 4 == 0 && reinterpret_cast<uintptr_t>(nbr) % 16 == 0;
  if (aligned)
    return launch_cost_tile_as<true>(n, sv, U, K, W, o, transposed, st);
  return launch_cost_tile_as<false>(n, sv, U, K, W, o, transposed, st);
}

}  // namespace parsa
