// refine_sweep: Algorithm 2 over one V chunk of C = 32 * cw parameters,
// parameter by parameter, in order.
//
// Replaces the TPU kernel kernels/parsa_cost/select.py:refine_sweep_kernel,
// which expands the (k, cw) need words into a (k, C) int32 bit tile in VMEM
// and runs C sequential steps over it.
//
// For each parameter j: retract it from its old host (cost[cur] +=
// 1 - n_j + u_{cur,j}), pick the needing partition of least cost (ties to
// the lowest index; non-needers read as BIG), add n_j - 2 there.  A
// parameter nobody needs stays -1.
//
// Bound on this card: neither bytes nor operations (a chunk moves ~12 KB)
// but the chain of C dependent steps.  So the design keeps every step
// inside one warp, with no shared memory and no __syncthreads: lane l
// holds cost[l + 32 r] for r < KPL in registers (k <= 32 * KPL <= 1024).
// The bit tile is never materialised: per group of 32 parameters each lane
// loads its KPL words once and shifts bits out of registers.  n_j is a
// ballot popcount, the argmin two __reduce_min_sync over an
// order-preserving key, prev[] and parts[] move 32 at a time, coalesced.
// Chunks depend on each other through cost, so the host launches them in
// order on one stream.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;

template <int KPL>
__global__ void __launch_bounds__(32)
refine_sweep_kernel(const uint32_t* __restrict__ words,   // (k, cw)
                    const int32_t* __restrict__ prev,     // (32 * cw,)
                    const int32_t* __restrict__ cost_in,  // (k,)
                    int k, int cw,
                    int32_t* __restrict__ parts,          // (32 * cw,)
                    int32_t* __restrict__ cost_out) {     // (k,)
  const int lane = threadIdx.x;
  int cost[KPL];
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int i = lane + 32 * r;
    cost[r] = i < k ? cost_in[i] : 0;
  }
  for (int w = 0; w < cw; ++w) {
    uint32_t wd[KPL];
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      const int i = lane + 32 * r;
      wd[r] = i < k ? words[static_cast<int64_t>(i) * cw + w] : 0u;
    }
    const int my_prev = prev[32 * w + lane];
    int my_part = -1;
    for (int b = 0; b < 32; ++b) {
      int nj = 0;
#pragma unroll
      for (int r = 0; r < KPL; ++r) {
        nj += __popc(__ballot_sync(kFull, (wd[r] >> b) & 1u));
      }
      const int cur = __shfl_sync(kFull, my_prev, b);
      unsigned key = kNone;
      unsigned idx = kNone;
#pragma unroll
      for (int r = 0; r < KPL; ++r) {
        const int i = lane + 32 * r;
        const int bit = static_cast<int>((wd[r] >> b) & 1u);
        if (i == cur) cost[r] += 1 - nj + bit;  // retract from the old host
        if (i < k) {
          const unsigned kv =
              static_cast<unsigned>(bit ? cost[r] : kBig) ^ 0x80000000u;
          if (kv < key) {  // strict: this lane's indices rise with r
            key = kv;
            idx = i;
          }
        }
      }
      const unsigned m = __reduce_min_sync(kFull, key);
      const int xi =
          static_cast<int>(__reduce_min_sync(kFull, key == m ? idx : kNone));
      if (nj > 0) {
#pragma unroll
        for (int r = 0; r < KPL; ++r) {
          if (lane + 32 * r == xi) cost[r] += nj - 2;
        }
      }
      if (lane == b) my_part = nj > 0 ? xi : -1;
    }
    parts[32 * w + lane] = my_part;
  }
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int i = lane + 32 * r;
    if (i < k) cost_out[i] = cost[r];
  }
}

template <int KPL>
void launch(const void* words, const void* prev, const void* cost_in, int k,
            int cw, void* parts, void* cost_out, cudaStream_t stream) {
  refine_sweep_kernel<KPL><<<1, 32, 0, stream>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(prev),
      static_cast<const int32_t*>(cost_in), k, cw,
      static_cast<int32_t*>(parts), static_cast<int32_t*>(cost_out));
}

}  // namespace

// The caller guarantees 1 <= k <= 1024 and cw >= 1.
extern "C" int refine_sweep(const void* words, const void* prev,
                            const void* cost_in, int k, int cw, void* parts,
                            void* cost_out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kpl = (k + 31) / 32;
  if (kpl <= 1) {
    launch<1>(words, prev, cost_in, k, cw, parts, cost_out, st);
  } else if (kpl <= 2) {
    launch<2>(words, prev, cost_in, k, cw, parts, cost_out, st);
  } else if (kpl <= 4) {
    launch<4>(words, prev, cost_in, k, cw, parts, cost_out, st);
  } else if (kpl <= 8) {
    launch<8>(words, prev, cost_in, k, cw, parts, cost_out, st);
  } else if (kpl <= 16) {
    launch<16>(words, prev, cost_in, k, cw, parts, cost_out, st);
  } else if (kpl <= 32) {
    launch<32>(words, prev, cost_in, k, cw, parts, cost_out, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
