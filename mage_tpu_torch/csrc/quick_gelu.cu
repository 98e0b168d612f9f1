// QuickGELU, y = x * sigmoid(1.702 x), and its gradient, each in one pass.
//
// It replaces no TPU kernel: XLA fuses QuickGELU into the elementwise code
// around the MLP's matmuls in JAX (mage_tpu/models/layers.py::quick_gelu),
// while PyTorch runs `x * torch.sigmoid(1.702 * x)` as three elementwise
// kernels (seven passes over the hidden) and autograd's backward of it as
// five (fourteen passes), keeping sigmoid's output alive for the backward.
//
// Forward, rounding point for rounding point the three-kernel chain, so that
// its output is bit-equal to PyTorch's on the card. With round() to x's
// dtype (none for f32) and every product, sum and quotient one IEEE-rounded
// f32 operation (no contraction into an FMA; the build has no fast math):
//   t = round(x * 1.702f), s = round(1 / (1 + expf(-t))), y = round(x * s).
// The quotient 1 / d is taken as the correctly rounded reciprocal
// (`__frcp_rn`), which is the IEEE quotient bit for bit in fewer
// instructions than a division.
// Backward, from x and the output's gradient g alone, in f32 with one
// rounding to x's dtype at the end:
//   s = 1 / (1 + expf(-(x * 1.702f))),
//   dx = g * (s + (x * (s * (1 - s))) * 1.702f),
// the product ordered so that it stays finite where 1.702 x overflows and
// keeps its bits where s is subnormal (x below about -51).
//
// Bound: bytes. A few flops an element against the card's 295 flops a byte:
// the forward reads x and writes y, the backward reads x and g and writes
// dx, once each. But the exact exp and reciprocal take dozens of
// instructions an element, so the arithmetic has to hide under the memory's
// time. Design: one 16-byte vector (8 bf16 or 4 f32) a thread, neighbouring
// threads on neighbouring vectors, in many small blocks, so that the loads
// of some warps run under the arithmetic of others (on an H100, four vectors
// a thread loaded before any was computed took 31.4 us at bf16 (8192, 2048)
// against 26.2 us, a plain copy 24.2 us); the last numel % (vector)
// elements go one a thread to the first block.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float K = 1.702f;

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return mage::to_f32(mage::from_f32<T>(v));
}

template <typename T>
__device__ __forceinline__ T forward_one(T xv) {
  const float x = mage::to_f32(xv);
  const float t = round_to<T>(__fmul_rn(x, K));
  const float s = round_to<T>(__frcp_rn(__fadd_rn(1.0f, expf(-t))));
  return mage::from_f32<T>(__fmul_rn(x, s));
}

template <typename T>
__device__ __forceinline__ T backward_one(T xv, T gv) {
  const float x = mage::to_f32(xv), g = mage::to_f32(gv);
  const float s = __frcp_rn(__fadd_rn(1.0f, expf(-__fmul_rn(x, K))));
  const float slope = __fmul_rn(__fmul_rn(x, __fmul_rn(s, __fsub_rn(1.0f, s))), K);
  return mage::from_f32<T>(__fmul_rn(g, __fadd_rn(s, slope)));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quick_gelu_fwd(const T* __restrict__ x, T* __restrict__ y, long long n) {
  constexpr int VEC = 16 / sizeof(T);
  const long long nv = n / VEC;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i < nv) {
    uint4 v = __ldg(reinterpret_cast<const uint4*>(x) + i);
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) e[k] = forward_one<T>(e[k]);
    reinterpret_cast<uint4*>(y)[i] = v;
  }
  const long long tail = nv * VEC + threadIdx.x;
  if (blockIdx.x == 0 && tail < n) y[tail] = forward_one<T>(x[tail]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quick_gelu_bwd(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
               long long n) {
  constexpr int VEC = 16 / sizeof(T);
  const long long nv = n / VEC;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i < nv) {
    uint4 xv = __ldg(reinterpret_cast<const uint4*>(x) + i);
    const uint4 gv = __ldg(reinterpret_cast<const uint4*>(g) + i);
    T* e = reinterpret_cast<T*>(&xv);
    const T* ge = reinterpret_cast<const T*>(&gv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) e[k] = backward_one<T>(e[k], ge[k]);
    reinterpret_cast<uint4*>(dx)[i] = xv;
  }
  const long long tail = nv * VEC + threadIdx.x;
  if (blockIdx.x == 0 && tail < n) dx[tail] = backward_one<T>(x[tail], g[tail]);
}

// blocks for n elements of `bytes` each: at least one, for the tail
unsigned blocks(long long n, int bytes) {
  const long long nv = n / (16 / bytes);
  return static_cast<unsigned>(nv > 0 ? (nv + THREADS - 1) / THREADS : 1);
}

}  // namespace

// x, y: n contiguous elements of `dtype` (mage::DType), 16-byte aligned.
extern "C" int mage_quick_gelu(const void* x, void* y, long long n, int dtype,
                               void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == mage::kBFloat16)
    quick_gelu_fwd<__nv_bfloat16><<<blocks(n, 2), THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n);
  else
    quick_gelu_fwd<float><<<blocks(n, 4), THREADS, 0, s>>>(static_cast<const float*>(x),
                                                           static_cast<float*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

// x, g, dx: n contiguous elements of `dtype` each, 16-byte aligned.
extern "C" int mage_quick_gelu_bwd(const void* x, const void* g, void* dx, long long n,
                                   int dtype, void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == mage::kBFloat16)
    quick_gelu_bwd<__nv_bfloat16><<<blocks(n, 2), THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(dx), n);
  else
    quick_gelu_bwd<float><<<blocks(n, 4), THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), static_cast<float*>(dx),
        n);
  return static_cast<int>(cudaGetLastError());
}
