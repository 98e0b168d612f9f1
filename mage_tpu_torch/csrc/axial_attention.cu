// Unmasked multi-head softmax attention along S on a flat (G, S, D) layout.
//
// Replaces the TPU kernel mage_tpu/ops/axial_attention.py::_axial_kernel
// (wrapper _axial_pallas). The sampler's spatial blocks attend over one short
// axis (S = 16 latent rows or columns) for G = batch * other axis independent
// groups; heads of width hd = D / n_head are split inside the kernel, so the
// caller's q, k, v and output stay in the flat (G, S, D) layout of the
// projections. Scores, softmax and the weighted sum run in f32.
//
// Bound: at the main path's shape (G=512, S=16, D=512, bf16) one call moves
// 4 * G*S*D*2 bytes = 33.6 MB for 4*G*S*S*D = 268 MFLOP, so it is bound by
// bytes: about 10 us at 3.35 TB/s.
//
// Design: one block per (group, head). It reads the (S, hd) slices of q, k
// and v once (hd consecutive channels per row, coalesced), keeps them in
// shared memory as f32 (k padded by one column so the score loop is free of
// bank conflicts), builds the S x S scores, normalises each row with
// exp(x - max) / sum, and writes the (S, hd) output slice in the input dtype.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS)
axial_attention(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ out, int s, int d,
                int n_head, float inv_sqrt_hd) {
  extern __shared__ float smem[];
  const int hd = d / n_head;
  const int g = blockIdx.x / n_head;
  const int h = blockIdx.x % n_head;
  float* qs = smem;                   // s * hd
  float* ks = qs + s * hd;            // s * (hd + 1)
  float* vs = ks + s * (hd + 1);      // s * hd
  float* p = vs + s * hd;             // s * s
  const size_t base = static_cast<size_t>(g) * s * d + static_cast<size_t>(h) * hd;

  for (int e = threadIdx.x; e < s * hd; e += THREADS) {
    const int i = e / hd, c = e % hd;
    const size_t off = base + static_cast<size_t>(i) * d + c;
    qs[i * hd + c] = mage::to_f32(q[off]);
    ks[i * (hd + 1) + c] = mage::to_f32(k[off]);
    vs[i * hd + c] = mage::to_f32(v[off]);
  }
  __syncthreads();

  for (int e = threadIdx.x; e < s * s; e += THREADS) {
    const int i = e / s, j = e % s;
    float acc = 0.f;
    for (int c = 0; c < hd; ++c) acc = fmaf(qs[i * hd + c], ks[j * (hd + 1) + c], acc);
    p[e] = acc * inv_sqrt_hd;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < s; i += THREADS) {
    float* row = p + i * s;
    float m = row[0];
    for (int j = 1; j < s; ++j) m = fmaxf(m, row[j]);
    float sum = 0.f;
    for (int j = 0; j < s; ++j) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    for (int j = 0; j < s; ++j) row[j] /= sum;
  }
  __syncthreads();

  for (int e = threadIdx.x; e < s * hd; e += THREADS) {
    const int i = e / hd, c = e % hd;
    float acc = 0.f;
    for (int j = 0; j < s; ++j) acc = fmaf(p[i * s + j], vs[j * hd + c], acc);
    out[base + static_cast<size_t>(i) * d + c] = mage::from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int g, int s,
           int d, int n_head, cudaStream_t stream) {
  const int hd = d / n_head;
  const size_t smem = sizeof(float) * (static_cast<size_t>(s) * hd * 2 +
                                       static_cast<size_t>(s) * (hd + 1) +
                                       static_cast<size_t>(s) * s);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(axial_attention<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float inv_sqrt_hd = 1.0f / sqrtf(static_cast<float>(hd));
  axial_attention<T><<<g * n_head, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s, d, n_head, inv_sqrt_hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: (g, s, d) contiguous, one dtype; d % n_head == 0.
extern "C" int mage_axial_attention(const void* q, const void* k, const void* v,
                                    void* out, int g, int s, int d, int n_head,
                                    int dtype, void* stream) {
  if (g <= 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == mage::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, out, g, s, d, n_head, st);
  return launch<float>(q, k, v, out, g, s, d, n_head, st);
}
