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
// portable cluster size).  CTA r computes the cost rows
// [r * rpc, (r + 1) * rpc), rpc = ceil(B / 8).  A warp takes 32 / kLanes
// rows at a time, kLanes lanes a row: the lanes load the row's flags and
// pairs together (kEntries independent loads each, enough for cap <= 48
// in one batch), then every nonzero pair gathers its k set words,
// independent loads that hit L2, and a shuffle reduction over the row's
// lanes gives each cost, which the row's lanes store a few columns each.
// A retired row gathers nothing and stores BIG, as the epilogue reads it:
// two dependent round trips a row.
// A truncated row is walked by the whole warp over its dense words, in
// batches of kBatch independent loads, the set words under a zero row word
// never read.  Each cost is stored straight into the rank-0 CTA's shared
// tile, transposed (k, B), through distributed shared memory.  After
// cluster.sync() the rank-0 CTA runs the exact epilogue of
// select_epilogue.cuh over the tile in its own shared memory
// (select_epilogue_smem: the bits of parsa_select.cu's select_epilogue,
// with one warp running the greedy slots instead of a block-wide reduction
// a slot); the other CTAs exit.  Nothing of the tile reaches global memory.
//
// Shared memory: every CTA of the cluster is launched with B * k * 4 bytes
// of dynamic shared memory (only rank 0's holds the tile).  The caller
// keeps that within the opt-in limit (232,448 bytes a CTA on the H100; the
// wrapper's guard is ops.SKETCH_SELECT_MAX_TILE_BYTES) and B <= 32 * 1024
// as parsa_select takes.
//
// Bound on this card: bytes.  The lists (8 * B * cap bytes) and the set
// words the nonzero pairs gather (4 * k each) read once: ~1.1 MB at B=1024,
// cap=48, k=16 and ~10 pairs a row, against the 16.8 MB of the dense
// (B, Ws) block and sets.  The cost pass is two dependent loads a row
// group, so the kernel is latency-bound; the epilogue is k block-wide
// reductions.  Words are read as unsigned: a word with bit 31 set is a
// negative int32 and is never compared by value.
#include <cooperative_groups.h>

#include "select_epilogue.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;      // CTAs per cluster (portable maximum)
constexpr int kThreads = 1024;   // threads per CTA: 32 rows per epilogue thread
constexpr int kCols = 16;        // partitions per pass, one accumulator each
constexpr int kLanes = 8;        // lanes per listed row
constexpr int kRowsPerWarp = 32 / kLanes;
constexpr int kEntries = 6;      // pairs per lane in flight: cap <= 48 at once
constexpr int kBatch = 4;        // dense row-word loads per lane in flight

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
sketch_select_kernel(const uint32_t* __restrict__ nbr,    // (B, W) dense
                     const int32_t* __restrict__ widx,    // (B, cap) indices
                     const uint32_t* __restrict__ vals,   // (B, cap) words
                     const uint8_t* __restrict__ trunc,   // (B,) bool
                     int cap,
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
  const int sub = lane % kLanes;   // this lane's place in its row's group
  const int grp = lane / kLanes;   // which of the warp's rows
  const int rpc = (B + kCluster - 1) / kCluster;
  const int r_begin = rank * rpc;
  const int r_end = min(B, r_begin + rpc);
  // every CTA of the cluster has started before any touches rank 0's tile;
  // no memory needs ordering yet, so the barrier is relaxed (cluster.sync()
  // would fence all of the GPU's memory first)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int i0 = 0; i0 < K; i0 += kCols) {
    const int ncol = min(kCols, K - i0);
    const uint32_t* sb = s + static_cast<int64_t>(i0) * W;
    // warp-uniform loop: kRowsPerWarp rows a pass
    for (int r0 = r_begin + warp * kRowsPerWarp; r0 < r_end;
         r0 += nwarps * kRowsPerWarp) {
      const int u = r0 + grp;
      const bool in = u < r_end;
      // the row's flags and its pairs, loaded together (kEntries each a lane)
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
      const bool ret = in && retired[u] != 0;
      const bool tr = in && trunc[u] != 0 && !ret;
      int acc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = 0;
      if (in && !ret && !tr) {
        for (int e0 = sub; e0 < cap; e0 += kLanes * kEntries) {
          if (e0 != sub) {  // pairs past the first kLanes * kEntries
#pragma unroll
            for (int j = 0; j < kEntries; ++j) {
              const int e = e0 + kLanes * j;
              x[j] = e < cap ? __ldg(vals + row0 + e) : 0u;
              wi[j] = e < cap ? __ldg(widx + row0 + e) : 0;
            }
          }
#pragma unroll
          for (int j = 0; j < kEntries; ++j) {
            if (x[j] == 0u) continue;  // padding (0, 0) counts nothing
            const uint32_t* col = sb + wi[j];
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              if (c < ncol) {
                acc[c] += __popc(x[j] & ~__ldg(col + static_cast<int64_t>(c)
                                                     * W));
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
            tile[(i0 + c) * B + u] = ret ? parsa::kBig : acc[c];
      }
      // truncated rows of this pass: the whole warp walks each dense row
      unsigned todo = __ballot_sync(0xffffffffu, tr && sub == 0);
      while (todo != 0u) {
        const int ut = r0 + (__ffs(todo) - 1) / kLanes;
        todo &= todo - 1u;
        const uint32_t* row = nbr + static_cast<int64_t>(ut) * W;
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
          if (lane == 0 && c < ncol) tile[(i0 + c) * B + ut] = v;
        }
      }
    }
  }
  // the remote stores are complete and visible to rank 0
  cluster.sync();
  if (rank != 0) return;
  parsa::select_epilogue_smem(tile_smem, order, enabled, B, K, greedy, out_a,
                              out_b);
}

}  // namespace

// The caller guarantees 1 <= B <= 32 * 1024, K >= 1, W >= 1, cap >= 1,
// 0 <= widx < W, and that B * K * 4 bytes fit a CTA's opt-in shared memory.
extern "C" int sketch_select(const void* nbr, const void* widx,
                             const void* vals, const void* trunc, int cap,
                             const void* s, const void* retired,
                             const void* order, const void* enabled, int B,
                             int K, int W, int greedy, void* out_a,
                             void* out_b, void* stream) {
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
      static_cast<const uint32_t*>(nbr), static_cast<const int32_t*>(widx),
      static_cast<const uint32_t*>(vals), static_cast<const uint8_t*>(trunc),
      cap, static_cast<const uint32_t*>(s),
      static_cast<const uint8_t*>(retired),
      static_cast<const int32_t*>(order),
      static_cast<const uint8_t*>(enabled), B, K, W, greedy,
      static_cast<int32_t*>(out_a), static_cast<int32_t*>(out_b));
  return static_cast<int>(cudaGetLastError());
}
