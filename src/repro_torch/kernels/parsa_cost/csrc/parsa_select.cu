// parsa_select: the fused cost + select of one greedy round of the blocked
// partitioner, as two launches.
//
// Replaces the TPU kernel kernels/parsa_cost/select.py:parsa_select_kernel,
// which accumulates the (B, k) cost tile in VMEM across a W grid and
// reduces it in the last grid step, so the tile never leaves the core.
//
// On Hopper the (B, k) int32 tile does not always fit one CTA (16 KiB at
// B=256, k=16, but 256 KiB at B=1024, k=64 against 227 KB of shared
// memory), and blocks run in no order, so nothing carries across a grid.
// So the tile goes through L2, unlike on the TPU:
//
//   1. parsa_select_tile: a grid over rows writes the cost tile transposed,
//      (k, B), to a scratch buffer that the wrapper allocates (4·B·k bytes,
//      stays in the 50 MB L2).  Same tile code as parsa_cost
//      (cost_tile.cuh): a warp a row, all k partitions in one gather pass,
//      the CTA's 8 rows staged in shared memory and stored as runs of
//      consecutive u.
//   2. parsa_select_reduce: one CTA reduces it with the exact epilogue of
//      select_epilogue.cuh (independent or greedy mode).
//
// Bound on this card: bytes (the (B, W) block words, ~2.1 MB at B=256,
// W=2048).  The reduction is latency-bound (k block-wide reductions, two
// __syncthreads each) and tiny; its retired bitmask per thread takes
// B <= 32 * 1024.  At sketched widths sketch_select.cu does the same round
// in one launch with the tile in shared memory.
#include "cost_tile.cuh"
#include "select_epilogue.cuh"

namespace {

__global__ void select_reduce_kernel(
    const int32_t* __restrict__ tile_t, const uint8_t* __restrict__ retired,
    const int32_t* __restrict__ order, const uint8_t* __restrict__ enabled,
    int B, int K, int greedy, int32_t* __restrict__ out_a,
    int32_t* __restrict__ out_b) {
  parsa::select_epilogue(tile_t, retired, order, enabled, B, K, greedy,
                         out_a, out_b);
}

}  // namespace

extern "C" int parsa_select_tile(const void* nbr, const void* s, int B,
                                 int K, int W, void* tile_t, void* stream) {
  return parsa::launch_cost_tile(nbr, s, B, K, W, tile_t, 1, stream);
}

// The caller guarantees 1 <= B <= 32 * 1024.
extern "C" int parsa_select_reduce(const void* tile_t, const void* retired,
                                   const void* order, const void* enabled,
                                   int B, int K, int greedy, void* out_a,
                                   void* out_b, void* stream) {
  int nt = (B + 31) / 32 * 32;
  if (nt > 1024) nt = 1024;
  select_reduce_kernel<<<1, nt, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tile_t),
      static_cast<const uint8_t*>(retired),
      static_cast<const int32_t*>(order),
      static_cast<const uint8_t*>(enabled), B, K, greedy,
      static_cast<int32_t*>(out_a), static_cast<int32_t*>(out_b));
  return static_cast<int>(cudaGetLastError());
}
