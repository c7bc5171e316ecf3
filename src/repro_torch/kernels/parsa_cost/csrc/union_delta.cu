// union_delta: the wire ops of Algorithm 4 on packed int32 words, for n
// copies of the sets against one old copy, in one pass:
//
//     union      = old | OR_w new[w]                    (k, W)
//     delta[w]   = new[w] & ~old                        (n, k, W), optional
//     *count    += #{(w, p) : new[w][p] & ~old[p] != 0}  optional
//
// and, for the server merge, the sizes and the write-back:
//
//     sz_out     = sz_old + sum_w (sz_local[w] - sz_old)  (k,) int32, wrapping
//     new[w]     = union,  sz_local[w] = sz_out         for every w, in place
//
// Replaces the TPU kernel kernels/parsa_cost/select.py:
// packed_union_delta_kernel, a (W / bw) Pallas grid writing new | old and
// new & ~old for one (k, W) pair.  That contract is the n = 1 call with
// delta.  The parallel_device scan calls it once a super-step with n =
// workers, a count, the sizes and the write-back: the whole server merge
// (the OR of every worker's stale-plus-local sets, the changed words the
// workers push, the size deltas, and the merged state copied back into
// every worker's copy) in one launch.  Every local copy starts from old and
// only ORs bits in, so old | OR_w new[w] equals the JAX all_gather + OR of
// the local sets.
//
// Bound on this card: bytes.  Each word position is read n + 1 times and
// written once plus n times (delta or write-back), with one OR and one
// AND-NOT per read.  The design is a grid-stride loop over the positions,
// a thread taking four neighbouring words by 16-byte loads where every
// pointer is 16-byte aligned and k * W % 4 == 0 (else one word by 4-byte
// loads).  A thread issues the loads of old and of up to 8 workers' words
// before it combines any, so the n + 1 loads of a position are one trip.
// The write-back is safe in place: each thread reads new[w] at its own
// positions before it writes them, and no other thread touches them; the
// sizes are one CTA's, each size read and written by one thread.  The count
// is exact and independent of the order of blocks: each warp sums its
// threads' nonzero delta words (__reduce_add_sync), a block sums its warps
// in shared memory, and one 64-bit atomicAdd per block adds that into
// *count.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident CTAs on each of 132 SMs
constexpr int kBatch = 8;             // workers' words loaded together

template <int VW>
struct Words {
  uint32_t w[VW];
};

template <int VW>
__device__ __forceinline__ Words<VW> load_words(const uint32_t* p) {
  Words<VW> r;
  if constexpr (VW == 4) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    r.w[0] = t.x;
    r.w[1] = t.y;
    r.w[2] = t.z;
    r.w[3] = t.w;
  } else {
    r.w[0] = *p;
  }
  return r;
}

template <int VW>
__device__ __forceinline__ void store_words(uint32_t* p, const Words<VW>& v) {
  if constexpr (VW == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  } else {
    *p = v.w[0];
  }
}

template <int VW>
__global__ void __launch_bounds__(kThreads)
union_delta_kernel(uint32_t* nw,                      // (n, kw); written back
                   const uint32_t* __restrict__ old,  // (kw,)
                   int n, int64_t kw,
                   uint32_t* __restrict__ uni,        // (kw,)
                   uint32_t* __restrict__ delta,      // (n, kw) or null
                   unsigned long long* __restrict__ count,  // or null
                   int32_t* sz_local,                 // (n, k) or null
                   const int32_t* __restrict__ sz_old,  // (k,)
                   int32_t* __restrict__ sz_out,      // (k,)
                   int k) {
  __shared__ unsigned long long warp_sum[kThreads / 32];
  const int64_t nvec = kw / VW;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  unsigned changed = 0;  // this thread's nonzero delta words
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       q < nvec; q += stride) {
    const int64_t p = q * VW;
    const Words<VW> o = load_words<VW>(old + p);
    Words<VW> u = o;
    for (int w0 = 0; w0 < n; w0 += kBatch) {
      Words<VW> v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (w0 + j < n) v[j] = load_words<VW>(nw + (w0 + j) * kw + p);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (w0 + j >= n) break;
        Words<VW> d;
#pragma unroll
        for (int c = 0; c < VW; ++c) {
          d.w[c] = v[j].w[c] & ~o.w[c];
          u.w[c] |= v[j].w[c];
          changed += d.w[c] != 0u;
        }
        if (delta != nullptr) store_words<VW>(delta + (w0 + j) * kw + p, d);
      }
    }
    store_words<VW>(uni + p, u);
    if (sz_out != nullptr)  // the server merge: write back into every copy
      for (int w = 0; w < n; ++w) store_words<VW>(nw + w * kw + p, u);
  }
  if (sz_out != nullptr && blockIdx.x == 0) {
    for (int i = threadIdx.x; i < k; i += kThreads) {
      // int32 with wrap-around, as the plain version's int32 sum
      const uint32_t base = static_cast<uint32_t>(sz_old[i]);
      uint32_t t = base;
      for (int w = 0; w < n; ++w)
        t += static_cast<uint32_t>(sz_local[static_cast<int64_t>(w) * k + i]) -
             base;
      sz_out[i] = static_cast<int32_t>(t);
      for (int w = 0; w < n; ++w)
        sz_local[static_cast<int64_t>(w) * k + i] = static_cast<int32_t>(t);
    }
  }
  if (count == nullptr) return;
  changed = __reduce_add_sync(0xffffffffu, changed);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = changed;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t = 0;
#pragma unroll
    for (int q = 0; q < kThreads / 32; ++q) t += warp_sum[q];
    if (t != 0) atomicAdd(count, t);
  }
}

template <int VW>
int launch(const void* nw, const void* old, int n, int64_t kw, void* uni,
           void* delta, void* count, void* sz_local,
           const void* sz_old, void* sz_out, int k, void* stream) {
  const int64_t want = (kw / VW + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(
      want < 1 ? 1 : (want < kMaxBlocks ? want : kMaxBlocks));
  union_delta_kernel<VW><<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(const_cast<void*>(nw)),
      static_cast<const uint32_t*>(old), n, kw, static_cast<uint32_t*>(uni),
      static_cast<uint32_t*>(delta), static_cast<unsigned long long*>(count),
      static_cast<int32_t*>(sz_local),
      static_cast<const int32_t*>(sz_old), static_cast<int32_t*>(sz_out), k);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// The caller guarantees n >= 0 and kw >= 0 (kw >= 1 without sizes); count,
// when given, is one zero-or-more 64-bit counter that the launch adds to;
// sz_out, when given, comes with sz_local (n, k) and sz_old (k,), and
// makes the call the server merge: the union is written back into nw[w]
// and sz_out into sz_local[w] for every w.  Without sz_out nw is only
// read.
extern "C" int packed_union_delta(const void* nw, const void* old, int n,
                                  int64_t kw, void* uni, void* delta,
                                  void* count, void* sz_local,
                                  const void* sz_old, void* sz_out, int k,
                                  void* stream) {
  const bool vec = kw % 4 == 0 && aligned16(nw) && aligned16(old) &&
                   aligned16(uni) && (delta == nullptr || aligned16(delta));
  if (vec)
    return launch<4>(nw, old, n, kw, uni, delta, count, sz_local, sz_old,
                     sz_out, k, stream);
  return launch<1>(nw, old, n, kw, uni, delta, count, sz_local, sz_old,
                   sz_out, k, stream);
}
