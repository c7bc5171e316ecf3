// refine_sweep: Algorithm 2 over V, every sweep of every chunk of
// C = 32 * cw parameters, parameter by parameter, in ONE launch.
//
// Replaces the TPU kernel kernels/parsa_cost/select.py:refine_sweep_kernel,
// which expands one chunk's (k, cw) need words into a (k, C) int32 bit tile
// in VMEM and runs C sequential steps over it; the JAX refine calls it once
// a chunk inside lax.scan (core/jax_refine.py:_refine_scan), carrying the
// cost vector from chunk to chunk and sweep to sweep.
//
// For each parameter j: retract it from its old host (cost[cur] +=
// 1 - n_j + u_{cur,j}), pick the needing partition of least cost (ties to
// the lowest index; non-needers read as BIG), add n_j - 2 there.  A
// parameter nobody needs stays -1.  Sweep s + 1 enters each parameter with
// the host sweep s gave it.
//
// Bound on this card: neither bytes nor operations (the main path's refine
// moves ~0.6 MB) but the chain of sweeps * n_chunks * C dependent steps.
// So the design keeps every step inside one warp, with no shared memory
// and no barrier: lane l holds cost[l + 32 r] for r < KPL in registers
// (k <= 32 * KPL <= 1024) for the whole launch, across chunks and sweeps.
// The bit tile is never materialised: a group of 32 parameters is KPL
// words a lane, shifted out of registers.  Per group, off the chain: the
// next group's words and entering hosts are loaded while this group's
// chain runs (register double-buffering), and every parameter's n_j (a
// ballot popcount) and entering host are computed at once and packed into
// one register, so a step reads them with one independent shuffle.  On the
// chain, with no branch: the retraction, one min over packed
// (cost << 10 | index) keys in registers, ONE __reduce_min_sync and the
// assignment.  The packed key is exact while every needer's cost lies in
// [0, kSat); each step notes in a register whether one did not, and a
// group where any did runs again from its entering costs with the exact
// two-reduction min over order-preserving keys (one vote a group).
// Parts are written 32 at a time, coalesced; the lane that wrote a
// parameter's host is the lane that reads it back in the next sweep.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;
constexpr int kSat = (1 << 22) - 1;  // packed cost field's maximum

// The 32 steps of one word group, parameter 32 g + b at step b, with the
// group's words ``wd`` and, per lane b, its parameter's n_j and entering
// host packed as n_j | (host + 1) << 16.  Returns lane b's new host.
// EXACT == false: the packed-key step, and ``wide`` set where a needer's
// cost left [0, kSat); EXACT == true: the exact step.
template <int KPL, bool EXACT>
__device__ __forceinline__ int group_steps(const uint32_t (&wd)[KPL],
                                           unsigned my_pack, int (&cost)[KPL],
                                           int lane, int k, bool& wide) {
  int my_part = -1;
#pragma unroll(KPL <= 4 ? 32 : 4)
  for (int b = 0; b < 32; ++b) {
    const unsigned pk = __shfl_sync(kFull, my_pack, b);
    const int nj = static_cast<int>(pk & 0xffffu);
    const int cur = static_cast<int>(pk >> 16) - 1;
    unsigned key = kNone, idx = kNone;
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      const int i = lane + 32 * r;
      const unsigned bit = (wd[r] >> b) & 1u;
      cost[r] += i == cur ? 1 - nj + static_cast<int>(bit) : 0;  // retract
      if (EXACT) {
        const unsigned kv =
            static_cast<unsigned>(bit ? cost[r] : kBig) ^ 0x80000000u;
        if (i < k && kv < key) {  // strict: this lane's indices rise
          key = kv;
          idx = i;
        }
      } else {
        const unsigned c = static_cast<unsigned>(cost[r]);
        wide |= bit && c >= static_cast<unsigned>(kSat);
        key = min(key, bit ? c << 10 | static_cast<unsigned>(i) : kNone);
      }
    }
    int xi;
    if (EXACT) {
      const unsigned m = __reduce_min_sync(kFull, key);
      xi = static_cast<int>(__reduce_min_sync(kFull, key == m ? idx : kNone));
    } else {
      // nobody needs the parameter: the key is kNone and nothing moves
      xi = static_cast<int>(__reduce_min_sync(kFull, key) & 1023u);
    }
    const int add = nj > 0 ? nj - 2 : 0;
#pragma unroll
    for (int r = 0; r < KPL; ++r) cost[r] += lane + 32 * r == xi ? add : 0;
    if (lane == b) my_part = nj > 0 ? xi : -1;
  }
  return my_part;
}

template <int KPL>
__global__ void __launch_bounds__(32)
refine_sweep_kernel(const uint32_t* __restrict__ words,  // (n_chunks, k, cw)
                    const int32_t* prev,     // (n_chunks * C,) entering
                    const int32_t* __restrict__ cost_in,  // (k,)
                    int k, int cw, int n_chunks, int sweeps,
                    int32_t* parts,          // (n_chunks * C,); may be prev
                    int32_t* __restrict__ cost_out) {     // (k,)
  const int lane = threadIdx.x;
  const int G = n_chunks * cw;        // word groups a sweep
  const int total = sweeps * G;
  int cost[KPL];
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int i = lane + 32 * r;
    cost[r] = i < k ? cost_in[i] : 0;
  }
  // group g of a sweep: chunk g / cw, word g % cw, parameters 32 g + lane
  auto load = [&](int g, uint32_t (&wd)[KPL], int& pv) {
    const int gs = g % G;
    const uint32_t* base =
        words + static_cast<int64_t>(gs / cw) * k * cw + gs % cw;
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      const int i = lane + 32 * r;
      wd[r] = i < k ? base[static_cast<int64_t>(i) * cw] : 0u;
    }
    // the first sweep enters from prev, later ones from the parts the
    // previous sweep wrote (this lane's own stores)
    pv = (g < G ? prev : parts)[32 * static_cast<int64_t>(gs) + lane];
  };
  uint32_t wd[KPL], nx[KPL];
  int my_prev, nx_prev = -1;
  load(0, wd, my_prev);
  for (int g = 0; g < total; ++g) {
    const int gs = g % G;
    if (g + 1 < total && G > 1) load(g + 1, nx, nx_prev);
    // per parameter 32 g + lane, off the chain: its needer count n_j and
    // entering host, packed as n_j | (host + 1) << 16
    unsigned my_pack = 0u;
#pragma unroll 8
    for (int b = 0; b < 32; ++b) {
      unsigned n = 0u;
#pragma unroll
      for (int r = 0; r < KPL; ++r)
        n += __popc(__ballot_sync(kFull, (wd[r] >> b) & 1u));
      if (lane == b) my_pack = n | static_cast<unsigned>(my_prev + 1) << 16;
    }
    // the group on packed keys; where a step met a cost the key cannot
    // hold, the group runs again from its entering costs on exact keys
    int entry[KPL];
#pragma unroll
    for (int r = 0; r < KPL; ++r) entry[r] = cost[r];
    bool wide = false;
    int my_part = group_steps<KPL, false>(wd, my_pack, cost, lane, k, wide);
    if (__any_sync(kFull, wide)) {
#pragma unroll
      for (int r = 0; r < KPL; ++r) cost[r] = entry[r];
      my_part = group_steps<KPL, true>(wd, my_pack, cost, lane, k, wide);
    }
    parts[32 * static_cast<int64_t>(gs) + lane] = my_part;
    if (g + 1 < total) {
      if (G > 1) {
#pragma unroll
        for (int r = 0; r < KPL; ++r) wd[r] = nx[r];
        my_prev = nx_prev;
      } else {
        my_prev = my_part;  // one group a sweep: the next sweep's entry
      }
    }
  }
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int i = lane + 32 * r;
    if (i < k) cost_out[i] = cost[r];
  }
}

template <int KPL>
void launch(const void* words, const void* prev, const void* cost_in, int k,
            int cw, int n_chunks, int sweeps, void* parts, void* cost_out,
            cudaStream_t stream) {
  refine_sweep_kernel<KPL><<<1, 32, 0, stream>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(prev),
      static_cast<const int32_t*>(cost_in), k, cw, n_chunks, sweeps,
      static_cast<int32_t*>(parts), static_cast<int32_t*>(cost_out));
}

}  // namespace

// The caller guarantees 1 <= k <= 1024, cw >= 1, n_chunks >= 1 and
// sweeps >= 1; prev and parts may be the same buffer.
extern "C" int refine_sweep(const void* words, const void* prev,
                            const void* cost_in, int k, int cw, int n_chunks,
                            int sweeps, void* parts, void* cost_out,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kpl = (k + 31) / 32;
  if (kpl <= 1) {
    launch<1>(words, prev, cost_in, k, cw, n_chunks, sweeps, parts, cost_out,
              st);
  } else if (kpl <= 2) {
    launch<2>(words, prev, cost_in, k, cw, n_chunks, sweeps, parts, cost_out,
              st);
  } else if (kpl <= 4) {
    launch<4>(words, prev, cost_in, k, cw, n_chunks, sweeps, parts, cost_out,
              st);
  } else if (kpl <= 8) {
    launch<8>(words, prev, cost_in, k, cw, n_chunks, sweeps, parts, cost_out,
              st);
  } else if (kpl <= 16) {
    launch<16>(words, prev, cost_in, k, cw, n_chunks, sweeps, parts,
               cost_out, st);
  } else if (kpl <= 32) {
    launch<32>(words, prev, cost_in, k, cw, n_chunks, sweeps, parts,
               cost_out, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
