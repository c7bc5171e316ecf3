// union_delta: the wire ops of Algorithm 4 on packed int32 words, for n
// copies of the sets against one old copy, in one pass:
//
//     union      = old | OR_w new[w]                    (k, W)
//     delta[w]   = new[w] & ~old                        (n, k, W), optional
//     *count    += #{(w, p) : new[w][p] & ~old[p] != 0}  optional
//
// Replaces the TPU kernel kernels/parsa_cost/select.py:
// packed_union_delta_kernel, a (W / bw) Pallas grid writing new | old and
// new & ~old for one (k, W) pair.  That contract is the n = 1 call with
// delta.  The parallel_device scan calls it with n = workers, no delta and
// a count: the server OR-merge of every worker's stale-plus-local sets and
// the number of changed words the workers push, in one launch per merge.
// Every local copy starts from old and only ORs bits in, so old | OR_w
// new[w] equals the JAX all_gather + OR of the local sets.
//
// Bound on this card: bytes.  Each word position is read n + 1 times and
// written once or n + 1 times, with one OR and one AND-NOT per read.  The
// design is a grid-stride loop over the k * W word positions, neighbouring
// threads on neighbouring words (coalesced 128-byte lines), each reading
// old once and the n new words at its position.  The count is exact and
// independent of the order of blocks: each warp counts its nonzero delta
// words with __popc(__ballot_sync(...)), a block sums its warps in shared
// memory, and one integer atomicAdd per block adds that into *count.  The
// loop's trip count depends only on blockIdx, so every ballot has the whole
// warp.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 resident CTAs on each of 132 SMs

__global__ void __launch_bounds__(kThreads)
union_delta_kernel(const uint32_t* __restrict__ nw,   // (n, kw)
                   const uint32_t* __restrict__ old,  // (kw,)
                   int n, int64_t kw,
                   uint32_t* __restrict__ uni,        // (kw,)
                   uint32_t* __restrict__ delta,      // (n, kw) or null
                   unsigned long long* __restrict__ count) {  // or null
  __shared__ unsigned long long warp_sum[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  unsigned long long changed = 0;  // this warp's count, the same in each lane
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads; base < kw;
       base += stride) {
    const int64_t p = base + threadIdx.x;
    const bool in = p < kw;
    const uint32_t o = in ? old[p] : 0u;
    uint32_t u = o;
    for (int w = 0; w < n; ++w) {
      const uint32_t v = in ? nw[w * kw + p] : 0u;
      const uint32_t d = v & ~o;
      u |= v;
      if (delta != nullptr && in) delta[w * kw + p] = d;
      if (count != nullptr) changed += __popc(__ballot_sync(0xffffffffu, d != 0u));
    }
    if (in) uni[p] = u;
  }
  if (count == nullptr) return;
  if (lane == 0) warp_sum[warp] = changed;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t = 0;
#pragma unroll
    for (int q = 0; q < kThreads / 32; ++q) t += warp_sum[q];
    if (t != 0) atomicAdd(count, t);
  }
}

}  // namespace

// The caller guarantees n >= 0 and kw >= 1; count, when given, is one
// zero-or-more 64-bit counter that the launch adds to.
extern "C" int packed_union_delta(const void* nw, const void* old, int n,
                                  int64_t kw, void* uni, void* delta,
                                  void* count, void* stream) {
  const int64_t want = (kw + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  union_delta_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(nw), static_cast<const uint32_t*>(old), n,
      kw, static_cast<uint32_t*>(uni), static_cast<uint32_t*>(delta),
      static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}
