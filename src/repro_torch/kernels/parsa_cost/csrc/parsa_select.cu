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
//      stays in the 50 MB L2).  Same tile code as parsa_cost.
//   2. parsa_select_reduce: one CTA reduces it.  Independent mode gives
//      each column's (min, first argmin) over unretired rows.  Greedy mode
//      visits the k slots strictly in order: slot j reads column order[j],
//      takes the lexicographic min of (cost, row) over unretired rows (ties
//      to the lowest row; retired rows read as BIG), and an active pick
//      retires its row before slot j + 1, so an all-identical tile cascades
//      to k distinct rows.  A disabled or empty slot gives (-1, BIG).
//
// Bound on this card: bytes (the (B, W) block words, ~2.1 MB at B=256,
// W=2048).  The reduction is latency-bound (k block-wide reductions, two
// __syncthreads each) and tiny.  Each thread owns rows t, t + nt, ... and
// keeps their retired flags in one register bitmask, so B <= 32 * 1024.
#include "cost_tile.cuh"

namespace {

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

__global__ void select_reduce_kernel(
    const int32_t* __restrict__ tile_t,   // (K, B) cost tile, transposed
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

}  // namespace

extern "C" int parsa_select_tile(const void* nbr, const void* s, int B,
                                 int K, int W, void* tile_t, void* stream) {
  return parsa::launch_cost_tile(nbr, s, B, K, W, tile_t, 1, B, stream);
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
