// Nearest codebook entry for each token: ids and the gathered codes.
//
// Replaces the TPU kernel mage_tpu/ops/vq.py::_vq_kernel (wrapper
// _vq_pallas). For z (N, D) and a codebook (K, D) it computes
// dist = |e|^2 - 2 z.e in f32 (no |z|^2 term, exactly as the TPU kernel and
// _vq_xla, since adding it changes the rounding), takes the row argmin with
// ties to the lowest index, writes int32 ids and copies the winning rows into
// codes. The (N, K) distance matrix never reaches device memory.
//
// Bound: the ids must match the f32 reference, so the products run in f32 on
// the CUDA cores (no TF32, no bf16 tensor cores). At the main path's shape
// (N=8192, K=512, D=1024) that is 2*N*K*D = 8.6 GFLOP, about 128 us at the
// H100 SXM's 67 TFLOP/s f32, against about 10 us for the ~35 MB it moves: the
// kernel is bound by operations.
//
// Design: a block owns BM token rows and walks the codebook in tiles of BN
// codes. For each tile it stages BD-deep slices of z and the codebook in
// shared memory (as f32, transposed so each thread reads its 4 rows and 4
// codes with one 16-byte load each) and accumulates a 4x4 register tile of
// dot products. After each code tile every thread folds its distances into a
// running (min, argmin) per row with strict '<', visiting codes in increasing
// order; the 16 threads that share a row then reduce with warp shuffles,
// taking the lower index on equal distance. |e|^2 comes from a first small
// kernel, once per call.
#include "common.cuh"

namespace {

constexpr int BM = 32;   // token rows per block
constexpr int BN = 64;   // codes per tile
constexpr int BD = 32;   // depth of one shared-memory stage
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // codes per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 128
constexpr int ZS = BM + 4;  // padded row lengths, multiples of 4 for float4 reads
constexpr int CS = BN + 4;

template <typename T>
__global__ void codebook_sqnorm(const T* __restrict__ cb, float* __restrict__ cbsq,
                                int k, int d) {
  const int code = (blockIdx.x * blockDim.x + threadIdx.x) / 32;  // one warp per code
  const int lane = threadIdx.x % 32;
  if (code >= k) return;  // uniform across the warp
  const T* row = cb + static_cast<size_t>(code) * d;
  float s = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float e = mage::to_f32(row[i]);
    s = fmaf(e, e, s);
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) cbsq[code] = s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
vq_nearest(const T* __restrict__ z, const T* __restrict__ cb,
           const float* __restrict__ cbsq, int32_t* __restrict__ idx,
           T* __restrict__ codes, int n, int k, int d) {
  __shared__ __align__(16) float zs[BD][ZS];
  __shared__ __align__(16) float cs[BD][CS];
  __shared__ int best_row[BM];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // codes tx*4 .. tx*4+3 of the tile
  const int ty = tid / (BN / TN);  // rows ty*4 .. ty*4+3 of the block
  const int row0 = blockIdx.x * BM;

  float best_v[TM];
  int best_i[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best_v[i] = INFINITY;
    best_i[i] = 0;
  }

  for (int c0 = 0; c0 < k; c0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += BD) {
      for (int e = tid; e < BM * BD; e += THREADS) {
        const int r = e / BD, c = e % BD;
        const int gr = row0 + r, gc = d0 + c;
        zs[c][r] = (gr < n && gc < d) ? mage::to_f32(z[static_cast<size_t>(gr) * d + gc]) : 0.f;
      }
      for (int e = tid; e < BN * BD; e += THREADS) {
        const int r = e / BD, c = e % BD;
        const int gr = c0 + r, gc = d0 + c;
        cs[c][r] = (gr < k && gc < d) ? mage::to_f32(cb[static_cast<size_t>(gr) * d + gc]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < BD; ++dd) {
        const float4 a = *reinterpret_cast<const float4*>(&zs[dd][ty * TM]);
        const float4 b = *reinterpret_cast<const float4*>(&cs[dd][tx * TN]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < TN; ++j) {  // increasing code index: strict '<' keeps the lowest
      const int code = c0 + tx * TN + j;
      if (code < k) {
        const float sq = cbsq[code];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float dist = sq - 2.0f * acc[i][j];
          if (dist < best_v[i]) {
            best_v[i] = dist;
            best_i[i] = code;
          }
        }
      }
    }
  }

  // the 16 threads of a row group are one half-warp: xor offsets < 16 stay inside it
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float v = best_v[i];
    int bi = best_i[i];
#pragma unroll
    for (int o = (BN / TN) / 2; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov < v || (ov == v && oi < bi)) {
        v = ov;
        bi = oi;
      }
    }
    if (tx == 0) best_row[ty * TM + i] = bi;
  }
  __syncthreads();

  for (int r = tid; r < BM; r += THREADS)
    if (row0 + r < n) idx[row0 + r] = best_row[r];
  for (int r = 0; r < BM && row0 + r < n; ++r) {
    const T* src = cb + static_cast<size_t>(best_row[r]) * d;
    T* dst = codes + static_cast<size_t>(row0 + r) * d;
    for (int c = tid; c < d; c += THREADS) dst[c] = src[c];
  }
}

template <typename T>
void launch(const void* z, const void* cb, float* cbsq, int32_t* idx, void* codes,
            int n, int k, int d, cudaStream_t stream) {
  const int sq_threads = 256;
  const int sq_blocks = (k * 32 + sq_threads - 1) / sq_threads;
  codebook_sqnorm<T><<<sq_blocks, sq_threads, 0, stream>>>(static_cast<const T*>(cb), cbsq, k, d);
  const int blocks = (n + BM - 1) / BM;
  vq_nearest<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(cb), cbsq, idx,
      static_cast<T*>(codes), n, k, d);
}

}  // namespace

// z (n, d), cb (k, d) of one dtype; cbsq (k,) f32 scratch; idx (n,) int32;
// codes (n, d) in the codebook's dtype. All contiguous, on one device.
extern "C" int mage_vq_nearest(const void* z, const void* cb, void* cbsq, void* idx,
                               void* codes, int n, int k, int d, int dtype,
                               void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  auto sq = static_cast<float*>(cbsq);
  auto ids = static_cast<int32_t*>(idx);
  if (dtype == mage::kBFloat16)
    launch<__nv_bfloat16>(z, cb, sq, ids, codes, n, k, d, s);
  else
    launch<float>(z, cb, sq, ids, codes, n, k, d, s);
  return static_cast<int>(cudaGetLastError());
}
