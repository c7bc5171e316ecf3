// sketch_select: the fused cost + select of one greedy round at sketched
// widths, in ONE launch, with the (B, k) cost tile in shared memory only.
//
// Replaces the TPU kernel kernels/parsa_cost/select.py:sketch_select_kernel,
// which holds the whole (B, Ws) block, the (k, Ws) server sets and the
// (B, k) cost tile in VMEM for one gridless step, so the round is one pass
// and the tile never leaves the core.
//
// Input: each row of the block as its compact list of nonzero words, the
// form the scan already keeps on the card (core/partition.py packs every
// row into at most ``cap`` (word index, word) pairs, padded with (0, 0)),
// and a per-row flag for the rare rows truncated past ``cap``, whose full
// words are read from the dense (B, Ws) block instead.  A sketched row
// holds ~10 nonzero words of 4,096, so the cost
//     cost[u, i] = sum over the row's pairs (w, x) of popcount(x & ~s[i, w])
// reads the lists and gathers k set words per nonzero pair, where a walk
// over the dense row reads all Ws words to find them.
//
// Design on Hopper: one thread-block cluster of kCluster = 8 CTAs (the
// portable cluster size) runs the round body of select_round.cuh: CTA r
// computes the cost rows [r * rpc, (r + 1) * rpc), rpc = ceil(B / 8), from
// the lists, and stores each cost straight into the rank-0 CTA's shared
// tile, transposed (k, B), through distributed shared memory.  After
// cluster.sync() the rank-0 CTA runs the exact epilogue of
// select_epilogue.cuh over the tile in its own shared memory (greedy:
// select_epilogue_cand, the epilogue of parsa_scan.cu; independent:
// select_columns_smem; the bits of parsa_select.cu's select_epilogue); the
// other CTAs exit.  Nothing of the tile reaches global memory.
// parsa_scan.cu runs the same round body and greedy epilogue for every
// round of a scan in one launch.
//
// Shared memory: every CTA of the cluster is launched with the (k, B) int32
// tile, the greedy slots' candidates (k min(k, 8) keys) and the epilogue's
// taken flags (B bytes) (only rank 0's are used): ops.sketch_smem_bytes.
// The caller keeps that within the opt-in limit (232,448 bytes a CTA on the
// H100; the wrapper's guard is ops.SKETCH_SELECT_MAX_SMEM_BYTES) and
// B <= 32 * 1024 as parsa_select takes.
//
// Bound on this card: bytes.  The lists (8 * B * cap bytes) and the set
// words the nonzero pairs gather (4 * k each) read once: ~1.1 MB at B=1024,
// cap=48, k=16 and ~10 pairs a row, against the 16.8 MB of the dense
// (B, Ws) block and sets.  The cost pass is two dependent loads a row
// group, so the kernel is latency-bound; the greedy epilogue ranks each
// slot's column a warp a slot, then resolves the slots in one warp.
#include <cooperative_groups.h>

#include "select_round.cuh"

namespace cg = cooperative_groups;

namespace {

using parsa::kCluster;
using parsa::kRoundThreads;

__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kRoundThreads)
sketch_select_kernel(const uint32_t* __restrict__ nbr,    // (B, W) dense
                     const int32_t* __restrict__ widx,    // (B, cap) indices
                     const uint32_t* __restrict__ vals,   // (B, cap) words
                     const uint8_t* __restrict__ trunc,   // (B,) bool
                     int cap,
                     const uint32_t* s,                   // (K, W)
                     const uint8_t* __restrict__ retired,  // (B,) bool
                     const int32_t* __restrict__ order,    // (K,) or null
                     const uint8_t* __restrict__ enabled,  // (K,) or null
                     int B, int K, int W, int greedy,
                     int32_t* __restrict__ out_a,
                     int32_t* __restrict__ out_b) {
  extern __shared__ __align__(16) int32_t tile_smem[];  // (K, B), rank 0
  unsigned* cand = reinterpret_cast<unsigned*>(tile_smem + K * B);
  uint8_t* taken = reinterpret_cast<uint8_t*>(cand + K * min(K, parsa::kCand));
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  int32_t* tile = cluster.map_shared_rank(tile_smem, 0);
  const int rpc = (B + kCluster - 1) / kCluster;
  const int r_begin = rank * rpc;
  const int r_end = min(B, r_begin + rpc);
  // every CTA of the cluster has started before any touches rank 0's tile;
  // no memory needs ordering yet, so the barrier is relaxed (cluster.sync()
  // would fence all of the GPU's memory first)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  parsa::round_cost_pass<8>(
      tile, widx, vals, cap, s, B, K, W, r_begin, r_end, [&](int u) {
        return parsa::RowSrc{
            retired[u] != 0,
            trunc[u] != 0 ? nbr + static_cast<int64_t>(u) * W : nullptr};
      });
  // the remote stores are complete and visible to rank 0
  cluster.sync();
  if (rank != 0) return;
  if (!greedy) {
    parsa::select_columns_smem(tile_smem, B, K, out_a, out_b);
    return;
  }
  // the rows not retired, and the epilogue's taken flags zeroed
  int live = 0;
  for (int i0 = 0; i0 < B; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    if (i < B) taken[i] = 0;
    live += __syncthreads_count(i < B && retired[i] == 0);
  }
  parsa::select_epilogue_cand(tile_smem, order, enabled, B, K, live, cand,
                              taken, out_a, out_b);
}

}  // namespace

// The caller guarantees 1 <= B <= 32 * 1024, K >= 1, W >= 1, cap >= 1,
// 0 <= widx < W, and that ops.sketch_smem_bytes(B, K) fit a CTA's opt-in
// shared memory.
extern "C" int sketch_select(const void* nbr, const void* widx,
                             const void* vals, const void* trunc, int cap,
                             const void* s, const void* retired,
                             const void* order, const void* enabled, int B,
                             int K, int W, int greedy, void* out_a,
                             void* out_b, void* stream) {
  const int T = K < parsa::kCand ? K : parsa::kCand;
  const int smem = (4 * (K * B + K * T) + B + 15) / 16 * 16;
  static int opted_in = 48 * 1024;  // the default limit needs no opt-in
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        sketch_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = smem;
  }
  sketch_select_kernel<<<kCluster, kRoundThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(nbr), static_cast<const int32_t*>(widx),
      static_cast<const uint32_t*>(vals), static_cast<const uint8_t*>(trunc),
      cap, static_cast<const uint32_t*>(s),
      static_cast<const uint8_t*>(retired),
      static_cast<const int32_t*>(order),
      static_cast<const uint8_t*>(enabled), B, K, W, greedy,
      static_cast<int32_t*>(out_a), static_cast<int32_t*>(out_b));
  return static_cast<int>(cudaGetLastError());
}
