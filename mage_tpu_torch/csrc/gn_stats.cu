// GroupNorm statistics as per-(image, channel) affine rows, in one read of x.
//
// For x (B, H, W, C) NHWC in f32 or bf16 and gamma, beta (C,) it writes the
// f32 rows a, b (B, C) with GroupNorm(x) == x * a + b:
//   mean = sum(x) / n and E[x^2] = sum(x * x) / n over (H, W, C / groups),
//   var = max(E[x^2] - mean^2, 0), a = gamma * 1 / sqrt(var + eps),
//   b = beta - mean * a,
// the formula of the plain version (ops/gn_conv.py::gn_affine_rows), with
// the same roundings after the sums (no FMA contraction). It replaces the
// XLA statistics that feed the TPU kernel (mage_tpu/ops/gn_conv.py::
// gn_affine_rows, outside the Pallas call), which the port had run as about
// ten small PyTorch ops per call.
//
// Bound: bytes. Every element of x is read once (2 or 4 bytes) for three
// flops, far below the card's 295 flops a byte, so the kernel is as fast as
// it reads x: at the decoder's 96-frame chunks 12.6-805 MB a call.
//
// Design, in two launches from one entry point:
//   1. gn_stats_partial: a grid of (images x pixel ranges, channel slices)
//      blocks of 256 threads. A block reads a contiguous range of pixels of one image,
//      whole pixel rows of up to 2048 bf16 (1024 f32) channels at a time, as
//      16-byte loads with neighbouring threads on neighbouring addresses, four
//      loads in flight a thread. Each thread keeps f32 sums and sums of
//      squares for its 16 bytes' channels; the block adds its rows in a fixed
//      order in shared memory and writes one (sum, sum of squares) pair per
//      channel to a scratch buffer (B, splits, C, 2).
//   2. gn_stats_finish: one warp per (image, group) adds the group's
//      channels of every split, each lane a fixed share and the lanes in a
//      fixed butterfly, and writes a, b.
// No atomics: two runs on the same input give the same a and b bit for bit.
#include "common.cuh"

namespace {

constexpr int ST = 256;  // threads of a partial-sum block

template <typename T>
__device__ __forceinline__ void accumulate(const uint4& raw, float (&s)[16 / sizeof(T)],
                                           float (&q)[16 / sizeof(T)]) {
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < static_cast<int>(16 / sizeof(T)); ++k) {
    const float f = mage::to_f32(v[k]);
    s[k] += f;
    q[k] = fmaf(f, f, q[k]);
  }
}

template <typename T>
__global__ void __launch_bounds__(ST)
gn_stats_partial(const T* __restrict__ x, float* __restrict__ part, int hw, int C,
                 int splits) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float red[2][ST * VEC];
  const int img = blockIdx.x / splits, split = blockIdx.x % splits;
  const int nv = C / VEC;
  const int v0 = blockIdx.y * ST;           // first vector column of this slice
  const int cols = min(nv - v0, ST);
  const int rows = ST / cols;                // pixels a step
  const int r = threadIdx.x / cols, cv = threadIdx.x % cols;
  const int p0 = static_cast<int>(static_cast<long long>(hw) * split / splits);
  const int p1 = static_cast<int>(static_cast<long long>(hw) * (split + 1) / splits);

  float s[VEC], q[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s[k] = q[k] = 0.f;
  if (r < rows) {
    const T* base = x + static_cast<size_t>(img) * hw * C + static_cast<size_t>(v0 + cv) * VEC;
    auto load = [&](int p) {
      return __ldg(reinterpret_cast<const uint4*>(base + static_cast<size_t>(p) * C));
    };
    int p = p0 + r;
    for (; p + 3 * rows < p1; p += 4 * rows) {  // four loads in flight, summed in order
      const uint4 v0_ = load(p), v1 = load(p + rows), v2 = load(p + 2 * rows),
                  v3 = load(p + 3 * rows);
      accumulate<T>(v0_, s, q);
      accumulate<T>(v1, s, q);
      accumulate<T>(v2, s, q);
      accumulate<T>(v3, s, q);
    }
    for (; p < p1; p += rows) accumulate<T>(load(p), s, q);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      red[0][(r * cols + cv) * VEC + k] = s[k];
      red[1][(r * cols + cv) * VEC + k] = q[k];
    }
  }
  __syncthreads();
  float* out = part + (static_cast<size_t>(img) * splits + split) * C * 2;
  for (int e = threadIdx.x; e < cols * VEC; e += ST) {
    float ss = 0.f, qq = 0.f;
    for (int rr = 0; rr < rows; ++rr) {
      ss += red[0][rr * cols * VEC + e];
      qq += red[1][rr * cols * VEC + e];
    }
    const int c = v0 * VEC + e;
    out[2 * c] = ss;
    out[2 * c + 1] = qq;
  }
}

__device__ __forceinline__ float param(const void* p, int dtype, int c) {
  return dtype == mage::kBFloat16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
                                  : static_cast<const float*>(p)[c];
}

// one warp per (image, group): lane l adds entries l, l + 32, ... of the
// group's splits x channels, then the lanes combine in a fixed butterfly
__global__ void gn_stats_finish(const float* __restrict__ part, const void* gamma,
                                const void* beta, int pdtype, float* __restrict__ a,
                                float* __restrict__ b, int batch, int C, int groups,
                                int splits, float n, float eps) {
  const int idx = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (idx >= batch * groups) return;
  const int img = idx / groups, g = idx % groups, gs = C / groups;
  float s = 0.f, q = 0.f;
  for (int e = lane; e < splits * gs; e += 32) {
    const int sp = e / gs, c = g * gs + e % gs;
    const float* row = part + (static_cast<size_t>(img) * splits + sp) * C * 2;
    s += row[2 * c];
    q += row[2 * c + 1];
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    q += __shfl_xor_sync(0xffffffffu, q, off);
  }
  const float mean = __fdiv_rn(s, n);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(q, n), __fmul_rn(mean, mean)), 0.f);
  const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  for (int c = g * gs + lane; c < (g + 1) * gs; c += 32) {
    const float ac = __fmul_rn(param(gamma, pdtype, c), inv);
    a[static_cast<size_t>(img) * C + c] = ac;
    b[static_cast<size_t>(img) * C + c] = __fsub_rn(param(beta, pdtype, c), __fmul_rn(mean, ac));
  }
}

}  // namespace

// x (batch, hw, C) contiguous and 16-byte aligned in dtype (C a multiple of
// 16, groups dividing C); gamma, beta (C,) in pdtype; a, b (batch, C) f32;
// part scratch of batch * splits * C * 2 floats.
extern "C" int mage_gn_affine_rows(const void* x, const void* gamma, const void* beta, void* a,
                                   void* b, void* part, int batch, int hw, int C, int groups,
                                   int splits, float eps, int dtype, int pdtype, void* stream) {
  if (batch <= 0 || hw <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  auto fpart = static_cast<float*>(part);
  const int vec = dtype == mage::kBFloat16 ? 8 : 4;
  // images x pixel ranges in x (which takes any batch), channel slices in y
  const dim3 grid(static_cast<unsigned>(batch) * splits, (C / vec + ST - 1) / ST);
  if (dtype == mage::kBFloat16)
    gn_stats_partial<__nv_bfloat16><<<grid, ST, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), fpart, hw, C, splits);
  else
    gn_stats_partial<float><<<grid, ST, 0, s>>>(static_cast<const float*>(x), fpart, hw, C,
                                                 splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pairs = batch * groups;  // a warp each, 4 a block
  gn_stats_finish<<<(pairs + 3) / 4, 128, 0, s>>>(
      fpart, gamma, beta, pdtype, static_cast<float*>(a), static_cast<float*>(b), batch, C,
      groups, splits, static_cast<float>(static_cast<long long>(hw) * (C / groups)), eps);
  return static_cast<int>(cudaGetLastError());
}
