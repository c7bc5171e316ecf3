// Forward flash attention for Hopper (sm_90a): online softmax over KV
// tiles, causal and sliding-window masks, GQA read by head index.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// (flash_attention_kernel, _kernel) and its wrapper ops.py:flash_attention.
// What it computes is that kernel's contract:
//   * query positions LEFT-aligned: row i of q sits at position i, key j
//     at position j (q_pos = q_start + iota in the TPU kernel), so a prompt
//     attends to a cache filled from slot 0 and slots past it are masked by
//     causality;
//   * scores q.k * 1/sqrt(D) in float32; masked scores take the finite
//     NEG_INF = -1e30 (a row whose first visited tile is fully masked gets
//     p = exp(0) there; the next admissible score clears it with
//     alpha = exp(-1e30 - m) = 0, where -inf would give NaN);
//   * running max m, denominator l and the output accumulator in float32,
//     output acc / max(l, 1e-30) in q's dtype;
//   * KV tiles that causality and the window leave out of a query tile are
//     never visited (the TPU kernel's `run` test).
// Keys past Skv (the ragged tail of the last tile) are excluded outright
// (score -inf, p = 0), so no length need be a multiple of the tile.
//
// Layout: q (B, Sq, H, D), k/v (B, Skv, KV, D) read through their strides
// (last dimension contiguous), query head h reads KV head h / (H / KV): no
// repeated or transposed copy is made.  o is a contiguous (B, Sq, H, D).
//
// Two routes, chosen by the wrapper from dtype and shape:
//   flash_mma<D>  bf16, D in {64, 128}: four warps, 16 query rows each,
//                 64-key tiles of K and V double-buffered in shared memory
//                 by cp.async; QK^T and PV on the tensor cores with
//                 mma.sync m16n8k16 (bf16 in, f32 accumulate), softmax in
//                 the log2 domain.  P is rounded to bf16 for the PV
//                 product, as FlashAttention-2 does; the TPU kernel keeps
//                 it f32.
//   flash_fma<T, DP>  float32 or bf16, any D <= 256: 256 threads, a 64 x 64
//                 score tile of FMAs on CUDA cores, everything f32.
// The path's shape (B=2, S=4096, H=40, KV=8, D=128, causal, bf16) does
// 2*B*H*S*(S+1)*D = 3.44e11 FLOP against about 201 MB of HBM traffic: it
// is bound by the tensor cores (347 us at 989 TFLOP/s), so the bf16 route
// is the mma one.  No wgmma, TMA or warp specialisation yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;  // query rows per CTA
constexpr int BK = 64;  // keys per tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Skv, H, KV, D, G;
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;  // element strides
  int causal, window;                          // window <= 0: none
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// [first, last) KV tiles that query rows [q0, q0 + BQ) may attend to
__device__ __forceinline__ void kv_tiles(const Params& p, int q0, int& first,
                                         int& last) {
  int kv_end = p.Skv;
  if (p.causal) kv_end = min(kv_end, q0 + BQ);
  int kv_begin = 0;
  if (p.window > 0) kv_begin = max(0, q0 - p.window + 1);
  first = kv_begin / BK;
  last = (kv_end + BK - 1) / BK;
}

// the masked score dot * scale of (query position qp, key position kp)
__device__ __forceinline__ float mask_score(const Params& p, float dot,
                                            float scale, int qp, int kp) {
  if (kp >= p.Skv) return -INFINITY;  // ragged tail: never counted
  float s = dot * scale;
  bool ok = (!p.causal || kp <= qp) && (p.window <= 0 || kp > qp - p.window);
  return ok ? s : NEG_INF;
}

// ------------------------------------------------------------ FMA route
// 256 threads as 16 x 16: thread (ty, tx) owns query rows ty*4 .. ty*4+3,
// score columns tx + 16c (c < 4) and output columns tx + 16c (c < DP/16).
// Row reductions stay inside a half-warp (shuffle xor 8, 4, 2, 1).
template <typename T, int DP>
__global__ void __launch_bounds__(256) flash_fma(Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][DP + 1]
  float* Ks = Qs + BQ * (DP + 1);      // [BK][DP + 1]
  float* Vs = Ks + BK * (DP + 1);      // [BK][DP]
  float* Ps = Vs + BK * DP;            // [BQ][BK + 1]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // long tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.G;
  const int D = p.D;
  const T* qg = static_cast<const T*>(p.q) + b * p.qb + h * p.qh;
  const T* kg = static_cast<const T*>(p.k) + b * p.kb + hk * p.kh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vb + hk * p.vh;

  for (int i = tid; i < BQ * DP; i += 256) {
    int r = i / DP, d = i % DP, row = q0 + r;
    Qs[r * (DP + 1) + d] =
        (row < p.Sq && d < D) ? to_f(qg[row * p.qs + d]) : 0.f;
  }

  constexpr int NC = DP / 16;
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int first, last;
  kv_tiles(p, q0, first, last);
  for (int kt = first; kt < last; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks, Vs, Ps are consumed
    for (int i = tid; i < BK * DP; i += 256) {
      int r = i / DP, d = i % DP, key = k0 + r;
      bool in = key < p.Skv && d < D;
      Ks[r * (DP + 1) + d] = in ? to_f(kg[key * p.ks + d]) : 0.f;
      Vs[r * DP + d] = in ? to_f(vg[key * p.vs + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * (DP + 1) + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * (DP + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = mask_score(p, s[i][c], p.scale, qp, k0 + tx + 16 * c);
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float e = expf(s[i][c] - m_new);
        Ps[(ty * 4 + i) * (BK + 1) + tx + 16 * c] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float vv = Vs[j * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  T* og = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = og + ((static_cast<long long>(b) * p.Sq + row) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      int d = tx + 16 * c;
      if (d < D) orow[d] = from_f<T>(acc[i][c] * inv);
    }
  }
}

// ------------------------------------------------------------ mma route
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in bits 0-15
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// bytes of shared memory of flash_mma<D>: two stages of a K and a V tile
constexpr int mma_smem_bytes(int D) { return 2 * 2 * BK * (D + 8) * 2; }

// 128 threads = 4 warps; warp w owns query rows q0 + 16w .. q0 + 16w + 15.
// Fragment layouts of m16n8k16 (lane = 4 * g + t): A a0 (row g, k 2t..2t+1),
// a1 (row g+8), a2 (k + 8), a3 (row g+8, k + 8); B b0 (k 2t..2t+1, col g),
// b1 (k + 8); C c0 c1 (row g, cols 2t, 2t+1), c2 c3 (row g+8).  The C
// fragments of two neighbouring 8-key score tiles are the A fragment of one
// 16-key step of PV, so P never leaves registers.
// K and V tiles, [key][d] with rows padded to D + 8 (conflict-free), are
// double-buffered in shared memory: cp.async brings tile j + 1 while tile j
// is computed.  The B fragments of PV come from V by ldmatrix.trans.
// Scores live in the log2 domain: s = dot * scale * log2(e) and p =
// exp2(s - m), which is exp(dot * scale - m') with one MUFU instruction;
// NEG_INF keeps its meaning there.  Only tiles that straddle the causal
// diagonal, the window's edge or Skv are masked element by element.
template <int D>
__global__ void __launch_bounds__(128) flash_mma(Params p) {
  constexpr int RS = D + 8;  // row stride of a tile, in bf16
  extern __shared__ __align__(16) uint16_t mma_smem[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  // stage s: K at tiles + s * 2 * BK * RS, V right after it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // long tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.G;
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.qb + h * p.qh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.kb + hk * p.kh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.vb + hk * p.vh;

  // issue the copies of KV tile kt into stage st (one commit group)
  auto load_tile = [&](int kt, int st) {
    __nv_bfloat16* ks = tiles + st * 2 * BK * RS;
    __nv_bfloat16* vs = ks + BK * RS;
    const int k0 = kt * BK;
    for (int i = tid; i < BK * (D / 8); i += 128) {
      const int r = i / (D / 8), c8 = (i % (D / 8)) * 8, key = k0 + r;
      const bool in = key < p.Skv;
      // out-of-range rows read nothing (src size 0) and are zero-filled
      cp_async16(ks + r * RS + c8, in ? kg + key * p.ks + c8 : kg, in ? 16 : 0);
      cp_async16(vs + r * RS + c8, in ? vg + key * p.vs + c8 : vg, in ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  int first, last;
  kv_tiles(p, q0, first, last);
  if (first < last) load_tile(first, 0);

  const int qw0 = q0 + warp * 16;                // this warp's first row
  const int r0 = qw0 + g, r1 = r0 + 8;           // this thread's two rows
  const float scale2 = p.scale * 1.4426950408889634f;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r0 < p.Sq ? ld32(qg + r0 * p.qs + c) : 0u;
    qa[kk][1] = r1 < p.Sq ? ld32(qg + r1 * p.qs + c) : 0u;
    qa[kk][2] = r0 < p.Sq ? ld32(qg + r0 * p.qs + c + 8) : 0u;
    qa[kk][3] = r1 < p.Sq ? ld32(qg + r1 * p.qs + c + 8) : 0u;
  }

  float oacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int kt = first; kt < last; ++kt) {
    const int k0 = kt * BK, st = (kt - first) & 1;
    if (kt + 1 < last) {
      load_tile(kt + 1, st ^ 1);  // its stage was consumed at kt - 1
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // tile kt has landed for every thread
    const __nv_bfloat16* Ks = tiles + st * 2 * BK * RS;
    const __nv_bfloat16* Vs = Ks + BK * RS;

    // S = Q K^T: 8 score tiles of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = Ks + (n * 8 + g) * RS + kk * 16 + 2 * t;
        mma_bf16(s[n], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

    const bool edge = k0 + BK > p.Skv || (p.causal && k0 + BK - 1 > qw0) ||
                      (p.window > 0 && k0 <= qw0 + 15 - p.window);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      if (edge) {  // warp-uniform
        const int kp = k0 + n * 8 + 2 * t;
        s[n][0] = mask_score(p, s[n][0], scale2, r0, kp);
        s[n][1] = mask_score(p, s[n][1], scale2, r0, kp + 1);
        s[n][2] = mask_score(p, s[n][2], scale2, r1, kp);
        s[n][3] = mask_score(p, s[n][3], scale2, r1, kp + 1);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale2;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      oacc[n][0] *= a0;
      oacc[n][1] *= a0;
      oacc[n][2] *= a1;
      oacc[n][3] *= a1;
    }

    // O += P V: 4 steps of 16 keys, P straight from the score fragments;
    // ldmatrix.trans of the 8 x 8 blocks (keys kk*16 + 0..7 | 8..15, d
    // n*8 .. n*8 + 7) gives b0 = V[2t..2t+1][g], b1 = V[8 + 2t..][g]
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vrow = Vs + (kk * 16 + (lane & 15)) * RS;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
            : "=r"(b0), "=r"(b1)
            : "r"(smem_addr(vrow + n * 8)));
        mma_bf16(oacc[n], pa, b0, b1);
      }
    }
    __syncthreads();  // every warp is done with stage st before it refills
  }

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          og + ((static_cast<long long>(b) * p.Sq + r0) * p.H + h) * D + c) =
          __floats2bfloat162_rn(oacc[n][0] * inv0, oacc[n][1] * inv0);
    if (r1 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          og + ((static_cast<long long>(b) * p.Sq + r1) * p.H + h) * D + c) =
          __floats2bfloat162_rn(oacc[n][2] * inv1, oacc[n][3] * inv1);
  }
}

template <int D>
cudaError_t launch_mma(const Params& p, dim3 grid, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_mma<D><<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_fma(const Params& p, dim3 grid, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * (DP + 1) + BK * (DP + 1) + BK * DP + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fma<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_fma<T, DP><<<grid, 256, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma_d(const Params& p, dim3 grid, cudaStream_t stream) {
  if (p.D <= 32) return launch_fma<T, 32>(p, grid, stream);
  if (p.D <= 64) return launch_fma<T, 64>(p, grid, stream);
  if (p.D <= 128) return launch_fma<T, 128>(p, grid, stream);
  return launch_fma<T, 256>(p, grid, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  use_mma: the tensor-core route (bf16,
// D in {64, 128}, 16-byte aligned bases, strides multiples of 8).  Strides
// are in elements.  Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Skv, int H, int KV, int D, long long qb, long long qs,
    long long qh, long long kb, long long ks, long long kh, long long vb,
    long long vs, long long vh, int causal, int window, int use_mma,
    void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0 || D <= 0 ||
      D > 256 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,  k,  v,  o,  B,  Sq, Skv, H,  KV,     D,      H / KV,
           qb, qs, qh, kb, ks, kh, vb,  vs, vh, causal, window,
           static_cast<float>(1.0 / sqrt(static_cast<double>(D)))};
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (use_mma) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (D == 64) {
      err = launch_mma<64>(p, grid, st);
    } else if (D == 128) {
      err = launch_mma<128>(p, grid, st);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (dtype == 0) {
    err = launch_fma_d<float>(p, grid, st);
  } else {
    err = launch_fma_d<__nv_bfloat16>(p, grid, st);
  }
  return static_cast<int>(err);
}
