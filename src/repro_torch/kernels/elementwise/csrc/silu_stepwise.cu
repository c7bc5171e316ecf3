// silu and tanh-approximated gelu rounded as the reference rounds them.
//
// jax.nn.silu is x * logistic(x), which XLA expands to 1 / (1 + exp(-x));
// jax.nn.gelu(approximate=True) is x * (0.5 * (1 + tanh(c0 * (x + c1 *
// ((x * x) * x))))).  Both round every operation to the input's dtype.  A
// one-rounding silu or gelu parts from them by an ulp in 40% of bfloat16
// entries.  These kernels compute each operation in float32 and round it to
// the dtype, as ATen's chain of elementwise ops does (ref.py), so they give
// its bits: expf and tanhf (never the __expf / __tanhf approximations), IEEE
// division, and the _rn intrinsics, which nvcc never contracts into an FMA.
//
// One thread handles 16 bytes at a time (8 bfloat16 or 4 float32 values)
// in a grid-stride loop: x is read once and y written once.  Pointers off
// a 16-byte boundary take the same loop one element at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

enum Op { kSilu = 0, kGelu = 1 };

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// c0 = sqrt(2 / pi) and c1 = 0.044715, each already rounded to the dtype
template <bool BF16, int OP>
__device__ __forceinline__ float apply(float x, float c0, float c1) {
  if constexpr (OP == kSilu) {
    float e = rnd<BF16>(expf(-x));
    float d = rnd<BF16>(__fadd_rn(1.0f, e));
    float r = rnd<BF16>(__fdiv_rn(1.0f, d));
    return __fmul_rn(x, r);  // rounded where it is stored
  } else {
    float x2 = rnd<BF16>(__fmul_rn(x, x));
    float x3 = rnd<BF16>(__fmul_rn(x2, x));
    float a = rnd<BF16>(__fmul_rn(c1, x3));
    float s = rnd<BF16>(__fadd_rn(x, a));
    float in = rnd<BF16>(__fmul_rn(c0, s));
    float t = rnd<BF16>(tanhf(in));
    float p = rnd<BF16>(__fadd_rn(1.0f, t));
    float h = rnd<BF16>(__fmul_rn(0.5f, p));
    return __fmul_rn(x, h);
  }
}

template <bool BF16>
struct Elem;
template <>
struct Elem<true> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float load(T v) { return __bfloat162float(v); }
  static __device__ __forceinline__ T store(float v) { return __float2bfloat16_rn(v); }
};
template <>
struct Elem<false> {
  using T = float;
  static __device__ __forceinline__ float load(T v) { return v; }
  static __device__ __forceinline__ T store(float v) { return v; }
};

template <bool BF16, int OP, bool VEC>
__global__ void __launch_bounds__(kThreads)
    elementwise_kernel(const void* __restrict__ xv, void* __restrict__ yv,
                       int64_t n, float c0, float c1) {
  using E = Elem<BF16>;
  using T = typename E::T;
  constexpr int kPer = VEC ? 16 / int(sizeof(T)) : 1;
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t first = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nvec = n / kPer;
  for (int64_t i = first; i < nvec; i += stride) {
    if constexpr (VEC) {
      union { uint4 q; T v[kPer]; } in, out;
      in.q = __ldg(reinterpret_cast<const uint4*>(x) + i);
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        out.v[j] = E::store(apply<BF16, OP>(E::load(in.v[j]), c0, c1));
      reinterpret_cast<uint4*>(y)[i] = out.q;
    } else {
      y[i] = E::store(apply<BF16, OP>(E::load(x[i]), c0, c1));
    }
  }
  // the last n % kPer elements
  for (int64_t i = nvec * kPer + first; i < n; i += stride)
    y[i] = E::store(apply<BF16, OP>(E::load(x[i]), c0, c1));
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

template <bool BF16, int OP>
int launch(const void* x, void* y, int64_t n, float c0, float c1,
           cudaStream_t stream) {
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const int per = vec ? 16 / (BF16 ? 2 : 4) : 1;
  int64_t work = n / per > 0 ? n / per : 1;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = int64_t(sm_count()) * kBlocksPerSM;
  if (blocks > cap) blocks = cap;
  if (vec)
    elementwise_kernel<BF16, OP, true>
        <<<unsigned(blocks), kThreads, 0, stream>>>(x, y, n, c0, c1);
  else
    elementwise_kernel<BF16, OP, false>
        <<<unsigned(blocks), kThreads, 0, stream>>>(x, y, n, c0, c1);
  return int(cudaGetLastError());
}

template <int OP>
int dispatch(const void* x, void* y, long long n, int dtype, float c0,
             float c1, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<true, OP>(x, y, n, c0, c1, s);
  if (dtype == 0) return launch<false, OP>(x, y, n, c0, c1, s);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  x and y hold n contiguous elements.
// Returns the CUDA error of the launch.
extern "C" int silu_stepwise_fwd(const void* x, void* y, long long n,
                                 int dtype, void* stream) {
  return dispatch<kSilu>(x, y, n, dtype, 0.0f, 0.0f, stream);
}

// c0 = sqrt(2 / pi) and c1 = 0.044715, rounded to the dtype by the caller.
extern "C" int gelu_stepwise_fwd(const void* x, void* y, long long n,
                                 int dtype, float c0, float c1,
                                 void* stream) {
  return dispatch<kGelu>(x, y, n, dtype, c0, c1, stream);
}
