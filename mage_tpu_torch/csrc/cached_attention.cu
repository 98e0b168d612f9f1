// One query slot against a time-major (L, N, D) KV cache, causal at `pos`.
//
// Replaces the TPU kernels mage_tpu/ops/cached_attention.py::_attn_kernel and
// _attn_kernel_v2 (wrapper _attn_pallas; the two compute the same function).
// Each of N rows attends its query (N, D) over the cache rows K[l, n, :] and
// V[l, n, :]; heads of width hd = D / n_head are split inside the kernel, the
// softmax runs per head in f32, and the output (N, D) is cast back to the
// input dtype.
//
// Slots l > pos are skipped, not masked. The reference adds -1e9 to their
// scores, and exp(-1e9 - m) is exactly 0 in f32 for any finite row maximum m
// (slot 0 is always valid), so skipping gives the same function while the
// kernel reads only (pos + 1) / L of the cache.
//
// Bound: bytes. At the main path's shape (L=16, N=8192, D=512, bf16) a call
// at pos reads 2 * (pos+1) * N*D*2 bytes of cache (268 MB at pos = 15, about
// 80 us at 3.35 TB/s) for 4 * (pos+1) * N*D operations.
//
// Design: a thread owns VEC consecutive channels of one row (16 bytes: 8 bf16
// or 4 f32), so a row's D channels are read as one contiguous, coalesced run
// per slot; the hd / VEC threads of a head are adjacent lanes of a warp and
// reduce their partial dot products with xor shuffles. An online softmax
// (running max, rescaled denominator and accumulator) makes one pass over
// the slots, reading K[l] and V[l] once each.
#include "common.cuh"

namespace {

template <typename T> struct Pack;
template <> struct Pack<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void load(const float* p, float (&out)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&in)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};
template <> struct Pack<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&out)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&in)[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <typename T>
__global__ void cached_attention(const T* __restrict__ q, const T* __restrict__ ck,
                                 const T* __restrict__ cv, T* __restrict__ out,
                                 int n, int d, int pos, int lanes_per_head,
                                 float inv_sqrt_hd) {
  constexpr int VEC = Pack<T>::kVec;
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const bool valid = row < n;
  // rows past the end compute on the last row and store nothing, so every
  // lane of the warp takes part in the shuffles
  const size_t r = valid ? row : n - 1;
  const size_t off = r * d + static_cast<size_t>(threadIdx.x) * VEC;
  const size_t slab = static_cast<size_t>(n) * d;

  float qv[VEC], kv[VEC], vv[VEC], acc[VEC];
  Pack<T>::load(q + off, qv);
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  float m = -INFINITY, denom = 0.f;

  for (int l = 0; l <= pos; ++l) {
    Pack<T>::load(ck + l * slab + off, kv);
    Pack<T>::load(cv + l * slab + off, vv);
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) part = fmaf(qv[i], kv[i], part);
    for (int o = lanes_per_head / 2; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    const float score = part * inv_sqrt_hd;
    const float m_new = fmaxf(m, score);
    const float corr = expf(m - m_new);  // 0 on the first slot (m = -inf)
    const float w = expf(score - m_new);
    denom = denom * corr + w;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = fmaf(w, vv[i], acc[i] * corr);
    m = m_new;
  }
  if (valid) {
    const float inv = 1.f / denom;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] *= inv;
    Pack<T>::store(out + off, acc);
  }
}

template <typename T>
int launch(const void* q, const void* ck, const void* cv, void* out, int n, int d,
           int n_head, int pos, cudaStream_t stream) {
  constexpr int VEC = Pack<T>::kVec;
  const int hd = d / n_head;
  const int lanes_per_head = hd / VEC;
  const int threads_per_row = d / VEC;
  const int rows_per_block = threads_per_row >= 256 ? 1 : 256 / threads_per_row;
  const dim3 block(threads_per_row, rows_per_block);
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  cached_attention<T><<<blocks, block, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck), static_cast<const T*>(cv),
      static_cast<T*>(out), n, d, pos, lanes_per_head,
      1.0f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (n, d); ck, cv: (L, n, d); contiguous, one dtype, 16-byte aligned.
// The wrapper checks: 0 <= pos < L; hd = d / n_head is a multiple of the
// vector width (8 bf16, 4 f32); hd / vector width is a power of two <= 32;
// the block's thread count is a multiple of 32.
extern "C" int mage_cached_attention(const void* q, const void* ck, const void* cv,
                                     void* out, int n, int d, int n_head, int pos,
                                     int dtype, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == mage::kBFloat16)
    return launch<__nv_bfloat16>(q, ck, cv, out, n, d, n_head, pos, st);
  return launch<float>(q, ck, cv, out, n, d, n_head, pos, st);
}
