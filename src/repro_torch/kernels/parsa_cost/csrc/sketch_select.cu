// sketch_select: the fused cost + select of one greedy round at sketched
// widths, in ONE launch, with the (B, k) cost tile in shared memory only.
//
// Replaces the TPU kernel kernels/parsa_cost/select.py:sketch_select_kernel,
// which holds the whole (B, Ws) block, the (k, Ws) server sets and the
// (B, k) cost tile in VMEM for one gridless step, so the round is one pass
// and the tile never leaves the core.
//
// Design on Hopper: one thread-block cluster of kCluster = 8 CTAs (the
// portable cluster size).  CTA r computes the cost rows
// [r * rpc, (r + 1) * rpc), rpc = ceil(B / 8): one warp per row, its lanes
// striding over the Ws words in batches of kBatch independent loads, and
// the partition words under a zero N(u) word are never read (a sketched
// row holds ~10 nonzero words of 4,096).  Partials meet in a warp
// reduction, and lane 0 stores each cost straight into the rank-0 CTA's
// shared tile, transposed (k, B), through distributed shared memory.
// After cluster.sync() the rank-0 CTA runs the exact epilogue of
// select_epilogue.cuh (the one parsa_select.cu uses) over the tile in its
// own shared memory; the other CTAs exit.  Unlike parsa_select.cu, whose
// tile goes through L2 between a tile launch and a reduce launch, nothing
// of the tile reaches global memory.
//
// Shared memory: every CTA of the cluster is launched with B * k * 4 bytes
// of dynamic shared memory (only rank 0's holds the tile).  The caller
// keeps that within the opt-in limit (232,448 bytes a CTA on the H100; the
// wrapper's guard is ops.SKETCH_SELECT_MAX_TILE_BYTES) and B <= 32 * 1024
// for the epilogue's per-thread retired bitmask.
//
// Bound on this card: bytes, the (B, Ws) block and the (k, Ws) sets read
// once (~16.8 MB at B=1024, Ws=4096, k=16).  Eight SMs cannot pull that at
// the card's full rate, so the cost pass is limited by their load
// bandwidth; the block is re-read by every round of a block and stays in
// the 50 MB L2.  The epilogue is k block-wide reductions, latency-bound.
// Words are read as unsigned: a word with bit 31 set is a negative int32
// and is never compared by value.
#include <cooperative_groups.h>

#include "select_epilogue.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;    // CTAs per cluster (portable maximum)
constexpr int kThreads = 1024;  // threads per CTA: 32 rows per epilogue thread
constexpr int kCols = 16;      // partitions per pass, one accumulator each
constexpr int kBatch = 4;      // independent row-word loads per lane in flight

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
sketch_select_kernel(const uint32_t* __restrict__ nbr,    // (B, W)
                     const uint32_t* __restrict__ s,      // (K, W)
                     const uint8_t* __restrict__ retired,  // (B,) bool
                     const int32_t* __restrict__ order,    // (K,) or null
                     const uint8_t* __restrict__ enabled,  // (K,) or null
                     int B, int K, int W, int greedy,
                     int32_t* __restrict__ out_a,
                     int32_t* __restrict__ out_b) {
  extern __shared__ int32_t tile_smem[];  // (K, B), used on rank 0 only
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  int32_t* tile = cluster.map_shared_rank(tile_smem, 0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int rpc = (B + kCluster - 1) / kCluster;
  const int r_end = min(B, (rank + 1) * rpc);
  // every CTA of the cluster has started before any touches rank 0's tile
  cluster.sync();
  for (int i0 = 0; i0 < K; i0 += kCols) {
    const int ncol = min(kCols, K - i0);
    const uint32_t* sb = s + static_cast<int64_t>(i0) * W;
    for (int u = rank * rpc + warp; u < r_end; u += nwarps) {
      const uint32_t* row = nbr + static_cast<int64_t>(u) * W;
      int acc[kCols];
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
              acc[c] += __popc(n[b] & ~__ldg(sb + static_cast<int64_t>(c) * W
                                             + w));
            }
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int v = __reduce_add_sync(0xffffffffu, acc[c]);
        if (lane == 0 && c < ncol) tile[(i0 + c) * B + u] = v;
      }
    }
  }
  // the remote stores are complete and visible to rank 0
  cluster.sync();
  if (rank != 0) return;
  parsa::select_epilogue(tile_smem, retired, order, enabled, B, K, greedy,
                         out_a, out_b);
}

}  // namespace

// The caller guarantees 1 <= B <= 32 * 1024, K >= 1, W >= 1 and that
// B * K * 4 bytes fit a CTA's opt-in shared memory.
extern "C" int sketch_select(const void* nbr, const void* s,
                             const void* retired, const void* order,
                             const void* enabled, int B, int K, int W,
                             int greedy, void* out_a, void* out_b,
                             void* stream) {
  const int smem = B * K * static_cast<int>(sizeof(int32_t));
  static int opted_in = 48 * 1024;  // the default limit needs no opt-in
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        sketch_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = smem;
  }
  sketch_select_kernel<<<kCluster, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(nbr), static_cast<const uint32_t*>(s),
      static_cast<const uint8_t*>(retired),
      static_cast<const int32_t*>(order),
      static_cast<const uint8_t*>(enabled), B, K, W, greedy,
      static_cast<int32_t*>(out_a), static_cast<int32_t*>(out_b));
  return static_cast<int>(cudaGetLastError());
}
