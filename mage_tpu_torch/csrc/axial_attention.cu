// Unmasked multi-head softmax attention along S on a flat (G, S, D) layout.
//
// Replaces the TPU kernel mage_tpu/ops/axial_attention.py::_axial_kernel
// (wrapper _axial_pallas). The sampler's spatial blocks attend over one short
// axis (S = 16 latent rows or columns) for G = batch * other axis independent
// groups; heads of width hd = D / n_head are split inside the kernel, so the
// caller's q, k, v and output stay in the flat (G, S, D) layout of the
// projections. Scores, softmax and the weighted sum run in f32.
//
// Bound: at the main path's shape (G=512, S=16, D=512, 16 heads, bf16) one
// call moves 4 * G*S*D*2 bytes = 33.6 MB for 4*G*S*S*D = 268 MFLOP, so it is
// bound by bytes: 10.0 us at 3.35 TB/s. The math is about 4 us on the CUDA
// cores, so the time is set by how the bytes move.
//
// Design (axial_attention_vec): a block of 128 threads takes whole groups
// and all their heads, or the heads of one group that fill it where a
// group has more rows (8 of 16 at the main shape: 1024 blocks, 6 an SM). The rows of a
// group are contiguous, so k and v come into shared memory as one coalesced
// run of 16-byte loads, widened to f32 once (not once a query row); the
// block's one barrier follows. One thread owns one (group, head, query)
// row and runs attend.cuh's routine: its S scores stay in registers, q
// comes from global memory and the output goes back to it as 16-byte
// vectors, 8 columns at a time; k and v are 16-byte broadcast reads of
// shared memory. Taken when S <= 32, D and hd are multiples of 8 and the
// pointers are 16-byte aligned.
// Scalar edge (axial_attention_scalar, every other shape): one block per
// (group, head), q, k, v widened to f32 in shared memory, one thread per
// score, then per row and per output element.
#include "attend.cuh"
#include "common.cuh"

namespace {

constexpr int THREADS = 128;       // scalar edge
constexpr int VEC_THREADS = 128;  // the vectorised kernel (3% faster than 256 measured)
constexpr int VEC_SMEM_TARGET = 32 * 1024;  // six blocks an SM
constexpr int VEC_SMEM_MAX = 227 * 1024;

template <typename T>
__global__ void __launch_bounds__(THREADS)
axial_attention_scalar(const T* __restrict__ q, const T* __restrict__ k,
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

template <typename T, int SMAX>
__global__ void __launch_bounds__(VEC_THREADS, 768 / VEC_THREADS)
axial_attention_vec(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ out, int g, int s, int d, int n_head, int gpb, int hpb,
                    float inv_sqrt_hd) {
  constexpr int VW = mage::vec_width<T>();
  extern __shared__ __align__(16) float kv_smem[];
  const int hd = d / n_head, ld = hpb * hd;  // the block's columns of a row
  float* ks = kv_smem;  // [gpb * s][ld] in f32: widened once, not once a query row
  float* vs = ks + static_cast<size_t>(gpb) * s * ld;
  const int head_blocks = n_head / hpb;
  const int g0 = blockIdx.x / head_blocks * gpb, h0 = blockIdx.x % head_blocks * hpb;
  const int ng = min(gpb, g - g0);
  // element (r, c) of the block: token row r from g0's first, column c from h0's first
  const size_t base = static_cast<size_t>(g0) * s * d + static_cast<size_t>(h0) * hd;

  const int row_vecs = ld / VW;
  for (int e = threadIdx.x; e < ng * s * row_vecs; e += VEC_THREADS) {
    const int r = e / row_vecs, c = (e % row_vecs) * VW;
    const size_t off = base + static_cast<size_t>(r) * d + c;
    float f[VW];
    mage::load_vec_global(k + off, f);
#pragma unroll
    for (int i = 0; i < VW; i += 4) mage::store_vec(ks + r * ld + c + i, f + i);
    mage::load_vec_global(v + off, f);
#pragma unroll
    for (int i = 0; i < VW; i += 4) mage::store_vec(vs + r * ld + c + i, f + i);
  }
  __syncthreads();

  // row w of the block: query w % s of unit w / s = (group, head), heads fastest
  for (int w = threadIdx.x; w < ng * hpb * s; w += VEC_THREADS) {
    const int u = w / s, i = w % s;
    const size_t row = base + (static_cast<size_t>(u / hpb) * s + i) * d + (u % hpb) * hd;
    const int unit = (u / hpb) * s * ld + (u % hpb) * hd;
    auto load_q = [&](int c0, float* f) { mage::load8_global(q + row + c0, f); };
    auto store_o = [&](int c0, const float* f) { mage::store8(out + row + c0, f); };
    mage::attend_row<SMAX, false>(load_q, store_o, ks + unit, vs + unit, ld, s, hd,
                                  inv_sqrt_hd);
  }
}

size_t vec_smem(int gpb, int s, int ld) {
  return 2 * sizeof(float) * static_cast<size_t>(gpb) * s * ld;
}

template <typename T, int SMAX>
int launch_vec(const void* q, const void* k, const void* v, void* out, int g, int s, int d,
               int n_head, cudaStream_t stream) {
  const int hd = d / n_head;
  // a block's rows: the heads of one group that fill its threads (a divisor
  // of n_head), or whole groups where a group has fewer rows, as far as
  // shared memory allows
  int hpb = 1, gpb = 1;
  for (int h = 1; h <= n_head; ++h)
    if (n_head % h == 0 && h * s <= VEC_THREADS && vec_smem(1, s, h * hd) <= VEC_SMEM_MAX)
      hpb = h;
  if (hpb == n_head) {
    gpb = VEC_THREADS / (n_head * s) > 1 ? VEC_THREADS / (n_head * s) : 1;
    while (gpb > 1 && vec_smem(gpb, s, d) > VEC_SMEM_TARGET) --gpb;
  }
  const size_t smem = vec_smem(gpb, s, hpb * hd);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(axial_attention_vec<T, SMAX>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float inv_sqrt_hd = 1.0f / sqrtf(static_cast<float>(hd));
  const unsigned blocks = static_cast<unsigned>((g + gpb - 1) / gpb * (n_head / hpb));
  axial_attention_vec<T, SMAX><<<blocks, VEC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), g, s, d, n_head, gpb, hpb, inv_sqrt_hd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int g, int s,
           int d, int n_head, cudaStream_t stream) {
  const int hd = d / n_head;
  const bool aligned = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (aligned && s <= mage::ATTEND_S_MAX && hd % 8 == 0 && d % 8 == 0 &&
      vec_smem(1, s, hd) <= VEC_SMEM_MAX)
    return s <= 16 ? launch_vec<T, 16>(q, k, v, out, g, s, d, n_head, stream)
                   : launch_vec<T, 32>(q, k, v, out, g, s, d, n_head, stream);
  const size_t smem = sizeof(float) * (static_cast<size_t>(s) * hd * 2 +
                                       static_cast<size_t>(s) * (hd + 1) +
                                       static_cast<size_t>(s) * s);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(axial_attention_scalar<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float inv_sqrt_hd = 1.0f / sqrtf(static_cast<float>(hd));
  axial_attention_scalar<T><<<g * n_head, THREADS, smem, stream>>>(
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
