// Forward flash attention for Hopper (sm_90a): online softmax over KV
// tiles, causal and sliding-window masks, GQA read by head index.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// (flash_attention_kernel, _kernel) and its wrapper ops.py:flash_attention.
// What it computes is that kernel's contract:
//   * query positions LEFT-aligned, shifted by the query offset q_offset
//     (0 by default): row i of q sits at position q_offset + i, key j at
//     position j (q_pos = q_start + iota in the TPU kernel, whose offset is
//     0), so a prompt attends to a cache filled from slot 0 and slots past
//     it are masked by causality, and a slice of the query rows that starts
//     at row r (context-parallel attention) passes q_offset = r and attends
//     every key as the whole prompt's rows r.. do;
//   * scores q.k * 1/sqrt(Dqk) in float32; masked scores take the finite
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
// Layout: q (B, Sq, H, Dqk), k (B, Skv, KV, Dqk), v (B, Skv, KV, Dv) with
// Dv <= Dqk, read through their strides (last dimension contiguous), query
// head h reads KV head h / (H / KV): no repeated or transposed copy is made.
// o is a contiguous (B, Sq, H, Dv).  Dv < Dqk is multi-head latent
// attention's prefill (DeepSeek-V2: q and k of 128 + 64 rotary columns, v
// of 128).
//
// Two routes, chosen by the wrapper from dtype and shape:
//   flash_wgmma<DQK, DV>  bf16, (Dqk, Dv) in {(64, 64), (128, 128),
//                 (192, 128)}: the Hopper route (TMA + wgmma,
//                 warp-specialised).  384 threads: a producer warpgroup
//                 whose one elected thread keeps TMA loads of 128-key K and
//                 V tiles in flight through a two-stage ring of mbarriers,
//                 and two consumer warpgroups of 64 query rows each (a
//                 128-row query tile a CTA) that run QK^T and PV on wgmma
//                 (bf16 in, f32 accumulate) and the softmax in the log2
//                 domain in registers.  P is rounded to bf16 for the PV
//                 product, as FlashAttention-2/3 do; the TPU kernel keeps
//                 it f32.  The tensor maps are 4-D over the strided
//                 (B, S, heads, D) views, encoded on the host for each call.
//   flash_fma<T, DP>  float32 or bf16, any Dv <= Dqk <= DP <= 256: 256
//                 threads, a 64 x 64 score tile of FMAs on CUDA cores,
//                 everything f32.
// The path's shape (B=2, S=4096, H=40, KV=8, D=128, causal, bf16) does
// 2*B*H*S*(S+1)*D = 3.44e11 FLOP against about 201 MB of HBM traffic: it
// is bound by the tensor cores (347 us at 989 TFLOP/s), and only wgmma
// reaches their full rate on Hopper (mma.sync does not).  What the route
// does about it: TMA moves the tiles with no load instructions or
// registers of the consumers; the ring lets the next tile land while this
// one is computed, with no block-wide barrier; setmaxnreg gives the
// consumers 240 registers for the S and O accumulators, and each CTA
// holds 160 KB of shared memory at D = 128 (one CTA an SM).  At (Dqk, Dv)
// = (192, 128) the score and output accumulators stay at 64 registers each,
// as at 128; QK^T takes 12 k-steps in place of 8, and a CTA holds 208 KB of
// tiles (48 KB of Q, two stages of 48 KB of K and 32 KB of V), where a V
// padded to 192 would need 240 KB of the 227 KB a block may have.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;  // query rows per CTA of the FMA route
constexpr int BK = 64;  // keys per tile of the FMA route

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Skv, H, KV, D, Dv, G;  // D: the q/k head dim, Dv: v's
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;  // element strides
  int causal, window;                          // window <= 0: none
  int qoff;                                    // position of query row 0
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

// [first, last) KV tiles of TK keys that query rows [q0, q0 + TQ), at
// positions q0 + qoff.., may attend to.  The wgmma route's producer and
// consumers both take their tile count from here: counted apart, they would
// disagree on the mbarrier phases and hang.
template <int TQ, int TK>
__device__ __forceinline__ void kv_tiles(const Params& p, int q0, int& first,
                                         int& last) {
  const int pos0 = q0 + p.qoff;
  int kv_end = p.Skv;
  if (p.causal) kv_end = min(kv_end, pos0 + TQ);
  int kv_begin = 0;
  if (p.window > 0) kv_begin = max(0, pos0 - p.window + 1);
  first = kv_begin / TK;
  last = max(first, (kv_end + TK - 1) / TK);
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
  float* Vs = Ks + BK * (DP + 1);      // [BK][DP], columns past Dv zero
  float* Ps = Vs + BK * DP;            // [BQ][BK + 1]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // long tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.G;
  const int D = p.D, Dv = p.Dv;
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
  kv_tiles<BQ, BK>(p, q0, first, last);
  for (int kt = first; kt < last; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks, Vs, Ps are consumed
    for (int i = tid; i < BK * DP; i += 256) {
      int r = i / DP, d = i % DP, key = k0 + r;
      bool in = key < p.Skv;
      Ks[r * (DP + 1) + d] = in && d < D ? to_f(kg[key * p.ks + d]) : 0.f;
      Vs[r * DP + d] = in && d < Dv ? to_f(vg[key * p.vs + d]) : 0.f;
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
      const int qp = q0 + ty * 4 + i + p.qoff;
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
    T* orow = og + ((static_cast<long long>(b) * p.Sq + row) * p.H + h) * Dv;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      int d = tx + 16 * c;
      if (d < Dv) orow[d] = from_f<T>(acc[i][c] * inv);
    }
  }
}

// ------------------------------------------------------------ wgmma route
__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in bits 0-15
  return *reinterpret_cast<uint32_t*>(&v);
}

// mbarriers (64-bit words in shared memory, addressed by shared address)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map into shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = SW128
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of wgmma operands across
// the fence / wait around them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

#define ACC8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 128, f32) (+)= A (64 x 16) . B (16 x 128), bf16, both from shared
// memory, K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24),
        ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N, f32) += A (64 x 16, bf16 registers) . B (16 x N, bf16 in
// shared memory, MN-major: the transpose flag set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24),
        ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC8

template <int D>
struct WgmmaPV;
template <>
struct WgmmaPV<64> {
  __device__ __forceinline__ static void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wgmma_rs_n64(d, a, db);
  }
};
template <>
struct WgmmaPV<128> {
  __device__ __forceinline__ static void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wgmma_rs_n128(d, a, db);
  }
};

constexpr int WG_BM = 128;     // query rows per CTA, 64 per consumer group
constexpr int WG_BN = 128;     // keys per tile
constexpr int WG_STAGES = 2;   // K/V ring depth
constexpr int WG_THREADS = 384;
constexpr int WG_PRODUCER_REGS = 24;
constexpr int WG_CONSUMER_REGS = 240;  // 128 * 24 + 256 * 240 <= 65,536

// Shared memory of flash_wgmma<DQK, DV>, from a 1024-byte aligned base: the
// Q tile, then WG_STAGES stages of a K and a V tile, then the barriers.  A
// tile is (its head dim) / 64 panels of (rows x 64) bf16, 128-byte rows in
// the 128-byte swizzle TMA writes and wgmma reads; a row of 128 spans two
// panels, of 192 three.
template <int DQK, int DV>
struct WgLayout {
  static_assert(DQK % 64 == 0 && DV % 64 == 0 && DV <= DQK && DV <= 128,
                "head dims of whole panels, Dv <= Dqk, Dv <= 128");
  static constexpr int kQKPanels = DQK / 64;
  static constexpr int kVPanels = DV / 64;
  static constexpr int kQPanel = WG_BM * 128;
  static constexpr int kKVPanel = WG_BN * 128;
  static constexpr int kQBytes = kQKPanels * kQPanel;
  static constexpr int kKBytes = kQKPanels * kKVPanel;  // one K tile
  static constexpr int kVBytes = kVPanels * kKVPanel;   // one V tile
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kBarOffset = kQBytes + WG_STAGES * kStageBytes;
  // Q; then per stage full_k, full_v, empty_k, empty_v
  static constexpr int kBars = 1 + 4 * WG_STAGES;
  static constexpr int kSmem = 1024 + kBarOffset + 8 * kBars;
  // the most dynamic shared memory a block may have on sm_90
  static_assert(kSmem <= 232448, "flash_wgmma tiles exceed 227 KB");
};

// named barriers 1 and 2: the two consumer warpgroups' turns at the wgmma
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// One CTA per (128-row query tile, head, batch): warpgroup 0 produces,
// warpgroups 1 and 2 consume, 64 query rows each.
//   producer: setmaxnreg.dec; one thread starts TMA loads of the Q tile
//     (once) and of each K and V tile into a WG_STAGES ring, each tile on
//     its own full barrier, after the consumers release the slot (K and V
//     have their own empty barriers);
//   consumers: setmaxnreg.inc; S = Q K^T by wgmma m64n128k16 (Q and K
//     K-major from shared memory), the online softmax in registers in the
//     log2 domain, P packed to bf16 in registers, O += P V by wgmma with A
//     from registers and V as an MN-major B operand.
// Pipelined as FlashAttention-3: iteration j starts S_j = Q K_j^T and then
// O += P_{j-1} V_{j-1}, waits for S_j only and runs softmax j while the PV
// product is in flight; K_j is released as soon as S_j is done, V_{j-1}
// when PV is.  The two consumer warpgroups take turns starting their wgmma
// (named barriers 1 and 2, "ping-pong"), so one's softmax overlaps the
// other's products.
// The wgmma accumulator of S (row 16w + g (+8), key 8i + 2t (+1) in
// element 4i (+1, +2, +3) of warp w, lane 4g + t) is, two 8-key blocks at
// a time, the A fragment of one 16-key step of PV, so P needs no shuffle.
// Keys past Skv and query rows past Sq are zero-filled by TMA (the map's
// extents are Skv and Sq); the mask gives such keys p = 0.  Only tiles that
// straddle the causal diagonal, the window's edge or Skv are masked
// element by element.
template <int DQK, int DV>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, Params p) {
  using L = WgLayout<DQK, DV>;
  extern __shared__ uint8_t wg_smem[];
  const uint32_t base = (smem_addr(wg_smem) + 1023) & ~1023u;
  const uint32_t sq = base;
  const uint32_t bars = base + L::kBarOffset;
  auto bar = [&](int kind, int s) {
    return bars + 8 * (1 + kind * WG_STAGES + s);
  };
  enum { FULL_K = 0, FULL_V = 1, EMPTY_K = 2, EMPTY_V = 3 };
  auto k_tile = [&](int s) { return base + L::kQBytes + s * L::kStageBytes; };

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * WG_BM;  // long tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.G;
  int first, last;
  kv_tiles<WG_BM, WG_BN>(p, q0, first, last);
  const int n_tiles = last - first;

  if (tid == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(bar(FULL_K, s), 1);
      mbar_init(bar(FULL_V, s), 1);
      mbar_init(bar(EMPTY_K, s), 8);  // one arrival per consumer warp
      mbar_init(bar(EMPTY_V, s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ------------------------------------------------ producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        WG_PRODUCER_REGS));
    if (tid == 0) {
      mbar_expect_tx(bars, L::kQBytes);
      for (int c = 0; c < L::kQKPanels; ++c)
        tma_load_4d(sq + c * L::kQPanel, &tq, bars, c * 64, h, q0, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % WG_STAGES, k0 = (first + n) * WG_BN;
        const int use = n / WG_STAGES;  // this slot's use number
        const uint32_t ks = k_tile(s), vs = ks + L::kKBytes;
        if (use > 0) mbar_wait(bar(EMPTY_K, s), (use - 1) & 1);
        mbar_expect_tx(bar(FULL_K, s), L::kKBytes);
        for (int c = 0; c < L::kQKPanels; ++c)
          tma_load_4d(ks + c * L::kKVPanel, &tk, bar(FULL_K, s), c * 64, hk,
                      k0, b);
        if (use > 0) mbar_wait(bar(EMPTY_V, s), (use - 1) & 1);
        mbar_expect_tx(bar(FULL_V, s), L::kVBytes);
        for (int c = 0; c < L::kVPanels; ++c)
          tma_load_4d(vs + c * L::kKVPanel, &tv, bar(FULL_V, s), c * 64, hk,
                      k0, b);
      }
    }
  } else {
    // ------------------------------------------------ consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        WG_CONSUMER_REGS));
    const int ct = tid - 128, cw = ct >> 7, w = (ct >> 5) & 3;
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int qw0 = q0 + 64 * cw + 16 * w;  // this warp's first row
    const int r0 = qw0 + g, r1 = r0 + 8;    // this thread's two rows
    const int pw0 = qw0 + p.qoff;           // the first row's position
    const int p0 = r0 + p.qoff, p1 = r1 + p.qoff;
    const float scale2 = p.scale * 1.4426950408889634f;
    // this warpgroup's 64 rows of Q: 8 KB into each panel
    const uint32_t qa = sq + cw * 64 * 128;
    const int my_turn = 1 + cw, other_turn = 2 - cw;

    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float sc[WG_BN / 2];
    uint32_t pa[WG_BN / 16][4];
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // l: partial
    float a0 = 1.f, a1 = 1.f;  // the last softmax's rescale of O

    // S = Q K^T over DQK / 16 steps of 16; step kk reads 32 bytes into the
    // 128-byte rows of panel kk / 4
    auto mma_s = [&](int s) {
      const uint32_t ks = k_tile(s);
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        wgmma_ss_n128(sc,
                      sw128_desc(qa + (kk >> 2) * L::kQPanel + off, 16, 1024),
                      sw128_desc(ks + (kk >> 2) * L::kKVPanel + off, 16, 1024),
                      kk);
      }
      wgmma_commit();
    };
    // O += P V over WG_BN / 16 steps of 16 keys; step kk starts 16 rows
    // (2,048 bytes) into each V panel, the panels kKVPanel bytes apart
    auto mma_pv = [&](int s) {
      const uint32_t vs = k_tile(s) + L::kKBytes;
#pragma unroll
      for (int kk = 0; kk < WG_BN / 16; ++kk)
        WgmmaPV<DV>::run(o, pa[kk],
                        sw128_desc(vs + kk * 16 * 128, L::kKVPanel, 1024));
      wgmma_commit();
    };
    // the online softmax of the S tile of keys k0.. in place: sc holds
    // p = exp2(s - m) after it; m, l and the rescale a0, a1 of O updated
    auto softmax = [&](int k0) {
      const bool edge = k0 + WG_BN > p.Skv ||
                        (p.causal && k0 + WG_BN - 1 > pw0) ||
                        (p.window > 0 && k0 <= pw0 + 15 - p.window);
      // edge tiles: the masked score in the log2 domain, es = 1; other
      // tiles: the raw dot, scaled inside the exponent (es = scale2) and
      // its max scaled after (scale2 > 0 keeps the order)
      float mx0 = -INFINITY, mx1 = -INFINITY, es;
      if (edge) {  // warp-uniform
        es = 1.f;
#pragma unroll
        for (int i = 0; i < WG_BN / 8; ++i) {
          const int kp = k0 + 8 * i + 2 * t;
          sc[4 * i + 0] = mask_score(p, sc[4 * i + 0], scale2, p0, kp);
          sc[4 * i + 1] = mask_score(p, sc[4 * i + 1], scale2, p0, kp + 1);
          sc[4 * i + 2] = mask_score(p, sc[4 * i + 2], scale2, p1, kp);
          sc[4 * i + 3] = mask_score(p, sc[4 * i + 3], scale2, p1, kp + 1);
          mx0 = fmaxf(mx0, fmaxf(sc[4 * i + 0], sc[4 * i + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
        }
      } else {
        es = scale2;
#pragma unroll
        for (int i = 0; i < WG_BN / 8; ++i) {
          mx0 = fmaxf(mx0, fmaxf(sc[4 * i + 0], sc[4 * i + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * es), mn1 = fmaxf(m1, mx1 * es);
      a0 = exp2f(m0 - mn0);
      a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < WG_BN / 8; ++i) {
        sc[4 * i + 0] = exp2f(fmaf(sc[4 * i + 0], es, -mn0));
        sc[4 * i + 1] = exp2f(fmaf(sc[4 * i + 1], es, -mn0));
        sc[4 * i + 2] = exp2f(fmaf(sc[4 * i + 2], es, -mn1));
        sc[4 * i + 3] = exp2f(fmaf(sc[4 * i + 3], es, -mn1));
        sum0 += sc[4 * i + 0] + sc[4 * i + 1];
        sum1 += sc[4 * i + 2] + sc[4 * i + 3];
      }
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
    };
    // rescale O by the last softmax's a0, a1 and pack its p into P (bf16):
    // keys 16kk + 2t, +1 (rows g, g + 8), then 16kk + 8 + 2t, +1
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int i = 0; i < DV / 8; ++i) {
        o[4 * i + 0] *= a0;
        o[4 * i + 1] *= a0;
        o[4 * i + 2] *= a1;
        o[4 * i + 3] *= a1;
      }
#pragma unroll
      for (int kk = 0; kk < WG_BN / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };
    auto release = [&](int kind, int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(kind, s));
    };

    mbar_wait(bars, 0);  // Q
    if (n_tiles > 0) {
      // turns: warpgroup 0 goes first; every turn of one warpgroup is
      // followed by one of the other (n_tiles + 1 turns each)
      if (cw == 1) named_arrive(other_turn);
      mbar_wait(bar(FULL_K, 0), 0);
      named_sync(my_turn);
      fence_regs(sc);
      wgmma_fence();
      mma_s(0);
      named_arrive(other_turn);
      wgmma_wait<0>();
      fence_regs(sc);
      release(EMPTY_K, 0);
      softmax(first * WG_BN);
      rescale_and_pack();

      for (int n = 1; n < n_tiles; ++n) {
        const int s = n % WG_STAGES, sp = (n - 1) % WG_STAGES;
        mbar_wait(bar(FULL_K, s), (n / WG_STAGES) & 1);
        mbar_wait(bar(FULL_V, sp), ((n - 1) / WG_STAGES) & 1);
        named_sync(my_turn);
        fence_regs(sc);
        fence_regs(o);
        fence_regs(pa);
        wgmma_fence();
        mma_s(s);
        mma_pv(sp);
        named_arrive(other_turn);
        wgmma_wait<1>();  // S_n is done, PV_{n-1} may run on
        fence_regs(sc);
        release(EMPTY_K, s);
        softmax((first + n) * WG_BN);
        wgmma_wait<0>();
        fence_regs(o);
        release(EMPTY_V, sp);
        rescale_and_pack();
      }

      const int sl = (n_tiles - 1) % WG_STAGES;
      mbar_wait(bar(FULL_V, sl), ((n_tiles - 1) / WG_STAGES) & 1);
      named_sync(my_turn);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
      mma_pv(sl);
      if (cw == 0) named_arrive(other_turn);  // warpgroup 1 goes last
      wgmma_wait<0>();
      fence_regs(o);
      release(EMPTY_V, sl);
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o);
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      const int c = 8 * i + 2 * t;
      if (r0 < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            og + ((static_cast<long long>(b) * p.Sq + r0) * p.H + h) * DV + c) =
            __floats2bfloat162_rn(o[4 * i + 0] * inv0, o[4 * i + 1] * inv0);
      if (r1 < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            og + ((static_cast<long long>(b) * p.Sq + r1) * p.H + h) * DV + c) =
            __floats2bfloat162_rn(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's entry-point query (no
// -lcuda link)
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A 4-D map over the strided (B, S, heads, D) bf16 view at ``ptr`` (element
// strides sb, ss, sh; the last dimension contiguous), boxes of 64 x 1 x
// rows x 1 elements in the 128-byte swizzle.  Out-of-range boxes read zeros.
CUresult encode_map(CUtensorMap* map, const void* ptr, int B, int S,
                    int heads, int D, long long sb, long long ss,
                    long long sh, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// a failed encode returns kEncodeError + its CUresult
constexpr int kEncodeError = 100000;

template <int DQK, int DV>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  CUresult r =
      encode_map(&tq, p.q, p.B, p.Sq, p.H, DQK, p.qb, p.qs, p.qh, WG_BM);
  if (r == CUDA_SUCCESS)
    r = encode_map(&tk, p.k, p.B, p.Skv, p.KV, DQK, p.kb, p.ks, p.kh, WG_BN);
  if (r == CUDA_SUCCESS)
    r = encode_map(&tv, p.v, p.B, p.Skv, p.KV, DV, p.vb, p.vs, p.vh, WG_BN);
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);
  constexpr int smem = WgLayout<DQK, DV>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.Sq + WG_BM - 1) / WG_BM, p.H, p.B);
  flash_wgmma<DQK, DV><<<grid, WG_THREADS, smem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
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

// dtype: 0 float32, 1 bfloat16.  D is q's and k's head dim, Dv v's (Dv <=
// D).  q_offset >= 0 is the position of query row 0.  use_wgmma: the tensor-core route (bf16, (D, Dv) in {(64, 64),
// (128, 128), (192, 128)}, 16-byte aligned bases, strides multiples of 8
// elements, as TMA requires).  Strides are in elements.  Returns the CUDA
// error of the launch (0 on success), or kEncodeError + the CUresult of a
// tensor map that could not be encoded.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Skv, int H, int KV, int D, int Dv, long long qb, long long qs,
    long long qh, long long kb, long long ks, long long kh, long long vb,
    long long vs, long long vh, int causal, int window, int q_offset,
    int use_wgmma, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0 || D <= 0 ||
      D > 256 || Dv <= 0 || Dv > D || (dtype != 0 && dtype != 1) ||
      q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,  k,  v,  o,  B,  Sq, Skv, H,      KV,       D, Dv, H / KV,
           qb, qs, qh, kb, ks, kh,  vb, vs, vh, causal, window, q_offset,
           static_cast<float>(1.0 / sqrt(static_cast<double>(D)))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_wgmma) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (D == 64 && Dv == 64) return launch_wgmma<64, 64>(p, st);
    if (D == 128 && Dv == 128) return launch_wgmma<128, 128>(p, st);
    if (D == 192 && Dv == 128) return launch_wgmma<192, 128>(p, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  cudaError_t err = dtype == 0 ? launch_fma_d<float>(p, grid, st)
                               : launch_fma_d<__nv_bfloat16>(p, grid, st);
  return static_cast<int>(err);
}
