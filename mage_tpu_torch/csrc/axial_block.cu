// Whole pre-LN axial transformer block on a flat (G, S, D) layout.
//
// Replaces the TPU kernel mage_tpu/ops/axial_attention.py::_block_kernel
// (wrapper _block_pallas, call axial_block_fused): for G independent groups
// of S tokens of width D = n_head * hd it computes
//   h   = LN1(x);  q, k, v = h Wq^T + bq, h Wk^T + bk, h Wv^T + bv
//   o   = per head softmax((q * scale) k^T) v,   scale = 1 / sqrt(hd)
//   seq = x + (o Wo^T + bo)
//   out = seq + c_proj(quick_gelu(c_fc(LN2(seq))))
// with torch's (out, in) weights. Products accumulate in f32, LayerNorm is
// two-pass in f32 (mean, then the mean of squared deviations, rsqrt(var +
// eps), the affine in f32), attention runs in f32. Rounding points, each to
// x's dtype and nowhere else, as in the TPU kernel: h; q, k, v (bias added in
// f32); the concatenated heads o; attn_out = o Wo^T + bo; seq = x + attn_out;
// h2 = LN2(seq); fc = h2 Wfc^T + bfc; act = fc * sigmoid(1.702 fc); proj =
// act Wp^T + bp; out = seq + proj. No intermediate reaches device memory.
//
// Bound: at the main path's shape (G=512, S=16, D=512, 16 heads, bf16) one
// launch does 51.9 GFLOP (QKV 12.9, attention 0.27, out-proj 4.3, MLP 34.4)
// and moves 23.1 MB (x in and out 16.8 MB, 6.3 MB of weights): bound by
// operations, 0.0525 ms at 989 TFLOP/s (bf16 tensor cores, dense). The
// weights stay in the 50 MB L2, but every block reads all of them once:
// 256 blocks x 6.3 MB = 1.6 GB of L2 traffic per launch, which may set the
// time before the products do.
//
// Design (a simple kernel that is right; wgmma and TMA are later work): one
// block of 8 warps owns a tile of ROWS = 32 token rows, i.e. 32 / S whole
// groups (2 at S = 16: 256 blocks at G = 512); a ragged last tile and the
// rows past tile_g * S are padding that is never stored.
//   bf16: every product is mma.sync m16n8k16 with f32 accumulators. A (the
//     activations) comes from shared memory, B (a weight) straight from
//     global memory / L2 in torch's (out, in) layout, which is already the
//     K-contiguous .col operand. Inside every 32-wide k step lane t takes
//     k 8t..8t+7 of both A and B (the same permutation of k on both sides
//     leaves the sum unchanged), so each fragment is one 16-byte load; the
//     next step's weight fragments are loaded while this step multiplies.
//     Warp w owns the n8 column tiles w, w + 8, ... of a product.
//   f32: the same tiling and accumulator layout on the CUDA cores (fmaf, no
//     TF32); only the f32 checks use it.
// Order inside a block: LN1 of the x tile into H; for each chunk of whole
// heads (CW columns: 128 bf16, 64 f32) project q, k, v into shared memory and
// run each (group, head)'s S x S attention in f32 on one warp (scores in a
// per-warp scratch, max-subtracted softmax divided by its sum), writing the
// heads into O; out-proj from O with the residual (x re-read from global)
// into H; LN2 of H into O; the MLP in 128-column chunks of fc: c_fc into an
// act chunk (activation and rounding in the epilogue), then c_proj's partial
// products added to f32 accumulators that stay in registers (64 a thread)
// across the chunks; out = seq + proj.
// Shared memory: H and O (ROWS x ld, ld = D rounded up to 64 plus 32, so the
// 16-byte fragment loads are free of bank conflicts), the q/k/v chunk (3 x
// ROWS x (CW + 8), which the act chunk reuses), the attention scratch (8 x S
// x (S + 1) f32). At D = 512, S = 16: 102 KB in bf16; at most 196 KB (f32,
// S = 32). Limits (the wrapper checks them): 1 <= S <= 32, D a multiple of
// 16 up to 512 (the c_proj accumulators), hd = D / n_head a multiple of 8 up
// to 64 (one head fits the f32 chunk).
//
// Probe switch (axial_block_probe.py builds variants with -D; the library is
// built without it): the bits of AXIAL_BLOCK_PROBE_SKIP drop one part of the
// bf16 kernel to time the rest (the output is then wrong): 1 the mma.sync
// products (the weight loads stay, folded into the sums times 0), 2 the weight
// loads (the products run on zeros), 4 the attention.
#include "common.cuh"

#ifndef AXIAL_BLOCK_PROBE_SKIP
#define AXIAL_BLOCK_PROBE_SKIP 0
#endif

namespace {

using mage::mma_bf16;

constexpr int SKIP = AXIAL_BLOCK_PROBE_SKIP;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 32;                    // token rows of a block's tile
constexpr int MT = ROWS / 16;               // m16 tiles
constexpr int S_MAX = 32;
constexpr int D_MAX = 512;
constexpr int HD_MAX = 64;
constexpr int NJ_D = D_MAX / 8 / WARPS;     // n8 tiles a warp owns of a D-wide product
constexpr int FC = 128;                     // fc columns of one MLP chunk
constexpr int NJ_FC = FC / 8 / WARPS;
constexpr int LDF = FC + 32;                // padded act row

template <typename T> struct Chunk;         // q/k/v columns projected at a time
template <> struct Chunk<__nv_bfloat16> { static constexpr int CW = 128; };
template <> struct Chunk<float> { static constexpr int CW = 64; };

__host__ __device__ __forceinline__ int padded_ld(int d) { return (d + 63) / 64 * 64 + 32; }

template <typename T>
__host__ __device__ __forceinline__ int ldq() { return Chunk<T>::CW + 8; }

template <typename T>
__host__ __device__ __forceinline__ size_t smem_bytes(int d, int s) {
  return sizeof(T) * (2 * static_cast<size_t>(ROWS) * padded_ld(d) + 3 * ROWS * ldq<T>()) +
         sizeof(float) * WARPS * s * (s + 1);
}

template <typename T>
struct Args {
  const T *x, *g1, *b1, *wq, *bq, *wk, *bk, *wv, *bv, *wo, *bo, *g2, *b2, *wfc, *bfc, *wp, *bp;
  T* out;
  int rows, s, d, n_head, tile_g;
  float scale, eps;
};

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[MT][NJ][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
}

// acc += A (ROWS x K, shared, row stride lda) * W^T over the n8 column tiles
// tile = j * WARPS + warp < n_tiles; W is row-major (N, ldw). K % 16 == 0.
template <int NJ>
__device__ __forceinline__ void gemm(float (&acc)[MT][NJ][4], const __nv_bfloat16* A, int lda,
                                     const __nv_bfloat16* W, int ldw, int n_tiles, int K) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int k32 = K & ~31;
  uint4 b[NJ] = {}, bn[NJ] = {};
  auto load_b = [&](uint4(&dst)[NJ], int k0) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int tile = j * WARPS + warp;
      if (tile < n_tiles && !(SKIP & 2))
        dst[j] = __ldg(reinterpret_cast<const uint4*>(
            W + static_cast<size_t>(tile * 8 + g) * ldw + k0 + 8 * t));
    }
  };
  if (k32 > 0) load_b(b, 0);
#pragma unroll 1
  for (int k0 = 0; k0 < k32; k0 += 32) {
    if (k0 + 32 < k32) load_b(bn, k0 + 32);  // in flight during this step's products
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const uint4 x = *reinterpret_cast<const uint4*>(A + (m * 16 + g) * lda + k0 + 8 * t);
      const uint4 y = *reinterpret_cast<const uint4*>(A + (m * 16 + g + 8) * lda + k0 + 8 * t);
      // logical k (2t, 2t+1 | 2t+8, 2t+9) of the first product are k 8t..8t+3,
      // of the second 8t+4..8t+7, in A and B alike
      const uint32_t a0[4] = {x.x, y.x, x.y, y.y};
      const uint32_t a1[4] = {x.z, y.z, x.w, y.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j * WARPS + warp < n_tiles) {
          if (SKIP & 1) {
            acc[m][j][0] += __uint_as_float(b[j].x ^ b[j].y ^ b[j].z ^ b[j].w ^ x.x ^ y.x) * 0.f;
          } else {
            mma_bf16(acc[m][j], a0, b[j].x, b[j].y);
            mma_bf16(acc[m][j], a1, b[j].z, b[j].w);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = bn[j];
  }
  if (K & 16) {  // a last 16-wide step: lane t takes k 4t..4t+3
    const int k0 = k32;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const uint2 x = *reinterpret_cast<const uint2*>(A + (m * 16 + g) * lda + k0 + 4 * t);
      const uint2 y = *reinterpret_cast<const uint2*>(A + (m * 16 + g + 8) * lda + k0 + 4 * t);
      const uint32_t a[4] = {x.x, y.x, x.y, y.y};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int tile = j * WARPS + warp;
        if (tile < n_tiles) {
          const uint2 w = __ldg(reinterpret_cast<const uint2*>(
              W + static_cast<size_t>(tile * 8 + g) * ldw + k0 + 4 * t));
          mma_bf16(acc[m][j], a, w.x, w.y);
        }
      }
    }
  }
}

// f32: the same product and accumulator layout on the CUDA cores. K % 4 == 0.
template <int NJ>
__device__ __forceinline__ void gemm(float (&acc)[MT][NJ][4], const float* A, int lda,
                                     const float* W, int ldw, int n_tiles, int K) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += 4) {
    float4 a[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      a[m][0] = *reinterpret_cast<const float4*>(A + (m * 16 + g) * lda + k0);
      a[m][1] = *reinterpret_cast<const float4*>(A + (m * 16 + g + 8) * lda + k0);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int tile = j * WARPS + warp;
      if (tile >= n_tiles) continue;
      const float* w = W + static_cast<size_t>(tile * 8 + 2 * t) * ldw + k0;
      const float4 w0 = __ldg(reinterpret_cast<const float4*>(w));
      const float4 w1 = __ldg(reinterpret_cast<const float4*>(w + ldw));
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 av = a[m][h];
          float& c0 = acc[m][j][2 * h];
          float& c1 = acc[m][j][2 * h + 1];
          c0 = fmaf(av.x, w0.x, c0); c0 = fmaf(av.y, w0.y, c0);
          c0 = fmaf(av.z, w0.z, c0); c0 = fmaf(av.w, w0.w, c0);
          c1 = fmaf(av.x, w1.x, c1); c1 = fmaf(av.y, w1.y, c1);
          c1 = fmaf(av.z, w1.z, c1); c1 = fmaf(av.w, w1.w, c1);
        }
    }
  }
}

// f(row, col, v(row, col), v(row, col + 1)) for every pair of accumulators
template <int NJ, typename F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[MT][NJ][4], int n_tiles, F&& f) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int tile = j * WARPS + warp;
      if (tile < n_tiles) {
        const int col = tile * 8 + 2 * t, r = m * 16 + g;
        f(r, col, acc[m][j][0], acc[m][j][1]);
        f(r + 8, col, acc[m][j][2], acc[m][j][3]);
      }
    }
}

__device__ __forceinline__ float rnd(float v, float) { return v; }
__device__ __forceinline__ float rnd(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}
// v rounded to T, as f32
template <typename T>
__device__ __forceinline__ float round_to(float v) { return rnd(v, T()); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dst row r = round(LN(src row r)) for the tile's rows; a row with src null
// (past the tokens) becomes 0
template <typename T>
__device__ __forceinline__ void layer_norm(T* dst, int ld_dst, const T* const* src_rows,
                                           const T* gamma, const T* beta, int d, float eps) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < ROWS; r += WARPS) {
    const T* src = src_rows[r];
    float v[D_MAX / 32];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < D_MAX / 32; ++i) {
      const int c = lane + 32 * i;
      v[i] = (src != nullptr && c < d) ? mage::to_f32(src[c]) : 0.f;
      sum += v[i];
    }
    const float mu = warp_sum(sum) / d;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < D_MAX / 32; ++i)
      if (lane + 32 * i < d) sq += (v[i] - mu) * (v[i] - mu);
    const float rstd = rsqrtf(warp_sum(sq) / d + eps);
#pragma unroll
    for (int i = 0; i < D_MAX / 32; ++i) {
      const int c = lane + 32 * i;
      if (c < d)
        dst[r * ld_dst + c] = src == nullptr ? mage::from_f32<T>(0.f)
                                             : mage::from_f32<T>((v[i] - mu) * rstd *
                                                                     mage::to_f32(gamma[c]) +
                                                                 mage::to_f32(beta[c]));
    }
  }
}

// one (group, head) on one warp: o = softmax((q * scale) k^T) v in f32
template <typename T>
__device__ __forceinline__ void attend(const T* q, const T* k, const T* v, int ld_qkv, T* o,
                                       int ld_o, float* P, int s, int hd, float scale) {
  const int lane = threadIdx.x % 32;
  const int lp = s + 1;
  for (int e = lane; e < s * s; e += 32) {
    const int i = e / s, j = e % s;
    float acc = 0.f;
    for (int c = 0; c < hd; ++c)
      acc = fmaf(__fmul_rn(mage::to_f32(q[i * ld_qkv + c]), scale),
                 mage::to_f32(k[j * ld_qkv + c]), acc);
    P[i * lp + j] = acc;
  }
  __syncwarp();
  for (int i = lane; i < s; i += 32) {
    float* row = P + i * lp;
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
  __syncwarp();
  for (int e = lane; e < s * hd; e += 32) {
    const int i = e / hd, c = e % hd;
    float acc = 0.f;
    for (int j = 0; j < s; ++j) acc = fmaf(P[i * lp + j], mage::to_f32(v[j * ld_qkv + c]), acc);
    o[i * ld_o + c] = mage::from_f32<T>(acc);
  }
  __syncwarp();  // P is reused by the warp's next unit
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) axial_block(const Args<T> p) {
  constexpr int CW = Chunk<T>::CW;
  constexpr int NJ_CW = CW / 8 / WARPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = p.d, s = p.s, ld = padded_ld(d), lq = ldq<T>();
  T* H = reinterpret_cast<T*>(smem_raw);          // [ROWS][ld]: h, then seq
  T* O = H + ROWS * ld;                           // [ROWS][ld]: heads, then h2
  T* Q = O + ROWS * ld;                           // [3][ROWS][lq]: q, k, v chunk
  T* Kc = Q + ROWS * lq;
  T* Vc = Kc + ROWS * lq;
  T* Act = Q;                                     // [ROWS][LDF]: act chunk
  float* P = reinterpret_cast<float*>(Vc + ROWS * lq) + (threadIdx.x / 32) * s * (s + 1);

  const int row0 = blockIdx.x * p.tile_g * s;
  const int n_rows = min(p.tile_g * s, p.rows - row0);  // valid token rows
  const int groups = n_rows / s;
  const int hd = d / p.n_head;
  const int warp = threadIdx.x / 32;

  __shared__ const T* rows[ROWS];
  if (threadIdx.x < ROWS)
    rows[threadIdx.x] =
        threadIdx.x < n_rows ? p.x + static_cast<size_t>(row0 + threadIdx.x) * d : nullptr;
  __syncthreads();
  layer_norm<T>(H, ld, rows, p.g1, p.b1, d, p.eps);
  __syncthreads();

  // q, k, v and attention, a chunk of whole heads at a time
  const int hpc = CW / hd;
  for (int h0 = 0; h0 < p.n_head; h0 += hpc) {
    const int nh = min(hpc, p.n_head - h0), c0 = h0 * hd, n_tiles = nh * hd / 8;
    const T* ws[3] = {p.wq, p.wk, p.wv};
    const T* bs[3] = {p.bq, p.bk, p.bv};
    T* dsts[3] = {Q, Kc, Vc};
#pragma unroll 1
    for (int i = 0; i < 3; ++i) {
      float acc[MT][NJ_CW][4];
      zero(acc);
      gemm(acc, H, ld, ws[i] + static_cast<size_t>(c0) * d, d, n_tiles, d);
      const T* bias = bs[i] + c0;
      T* dst = dsts[i];
      for_each_pair(acc, n_tiles, [&](int r, int col, float v0, float v1) {
        store2(dst + r * lq + col, v0 + mage::to_f32(bias[col]), v1 + mage::to_f32(bias[col + 1]));
      });
    }
    __syncthreads();
    for (int u = warp; u < groups * nh && !(SKIP & 4); u += WARPS) {
      const int gl = u / nh, hh = u % nh;
      const int off = gl * s * lq + hh * hd;
      attend<T>(Q + off, Kc + off, Vc + off, lq, O + gl * s * ld + c0 + hh * hd, ld, P, s, hd,
                p.scale);
    }
    __syncthreads();
  }

  // out-proj and the first residual: seq = round(x + round(o Wo^T + bo)) into H
  float acc[MT][NJ_D][4];
  zero(acc);
  gemm(acc, O, ld, p.wo, d, d / 8, d);
  for_each_pair(acc, d / 8, [&](int r, int col, float v0, float v1) {
    float x0 = 0.f, x1 = 0.f;
    if (r < n_rows) {
      x0 = mage::to_f32(rows[r][col]);
      x1 = mage::to_f32(rows[r][col + 1]);
    }
    store2(H + r * ld + col, x0 + round_to<T>(v0 + mage::to_f32(p.bo[col])),
           x1 + round_to<T>(v1 + mage::to_f32(p.bo[col + 1])));
  });
  __syncthreads();
  if (threadIdx.x < ROWS) rows[threadIdx.x] = H + threadIdx.x * ld;
  __syncthreads();
  layer_norm<T>(O, ld, rows, p.g2, p.b2, d, p.eps);
  __syncthreads();

  // MLP in fc chunks; c_proj's sums stay in registers
  zero(acc);
  const int f_total = 4 * d;
#pragma unroll 1
  for (int f0 = 0; f0 < f_total; f0 += FC) {
    const int fw = min(FC, f_total - f0), n_tiles = fw / 8;
    float accf[MT][NJ_FC][4];
    zero(accf);
    gemm(accf, O, ld, p.wfc + static_cast<size_t>(f0) * d, d, n_tiles, d);
    const T* bias = p.bfc + f0;
    for_each_pair(accf, n_tiles, [&](int r, int col, float v0, float v1) {
      const float f0v = round_to<T>(v0 + mage::to_f32(bias[col]));
      const float f1v = round_to<T>(v1 + mage::to_f32(bias[col + 1]));
      store2(Act + r * LDF + col, f0v * (1.0f / (1.0f + expf(-1.702f * f0v))),
             f1v * (1.0f / (1.0f + expf(-1.702f * f1v))));
    });
    __syncthreads();
    gemm(acc, Act, LDF, p.wp + f0, f_total, d / 8, fw);
    __syncthreads();  // the next chunk overwrites Act
  }

  // out = round(seq + round(proj + bp))
  for_each_pair(acc, d / 8, [&](int r, int col, float v0, float v1) {
    if (r >= n_rows) return;
    const T* seq = H + r * ld + col;
    store2(p.out + static_cast<size_t>(row0 + r) * d + col,
           mage::to_f32(seq[0]) + round_to<T>(v0 + mage::to_f32(p.bp[col])),
           mage::to_f32(seq[1]) + round_to<T>(v1 + mage::to_f32(p.bp[col + 1])));
  });
}

template <typename T>
int launch(const void* const* ptrs, void* out, int g, int s, int d, int n_head, float scale,
           float eps, cudaStream_t stream) {
  Args<T> a;
  const T** fields[] = {&a.x, &a.g1, &a.b1, &a.wq, &a.bq, &a.wk, &a.bk, &a.wv, &a.bv,
                        &a.wo, &a.bo, &a.g2, &a.b2, &a.wfc, &a.bfc, &a.wp, &a.bp};
  for (int i = 0; i < 17; ++i) *fields[i] = static_cast<const T*>(ptrs[i]);
  a.out = static_cast<T*>(out);
  a.rows = g * s;
  a.s = s;
  a.d = d;
  a.n_head = n_head;
  a.tile_g = ROWS / s;
  a.scale = scale;
  a.eps = eps;
  const size_t smem = smem_bytes<T>(d, s);
  cudaError_t err = cudaFuncSetAttribute(axial_block<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((g + a.tile_g - 1) / a.tile_g);
  axial_block<T><<<blocks, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out (g, s, d) and the 16 parameters (ln_1 weight and bias; Wq, bq, Wk,
// bk, Wv, bv as (d, d) and (d,); Wo (d, d), bo; ln_2 weight and bias; Wfc
// (4d, d), bfc (4d,); Wp (d, 4d), bp (d,)) in one dtype, contiguous and
// 16-byte aligned. Shapes outside the limits above return
// cudaErrorInvalidValue without a launch.
extern "C" int mage_axial_block(const void* x, const void* g1, const void* b1, const void* wq,
                                const void* bq, const void* wk, const void* bk, const void* wv,
                                const void* bv, const void* wo, const void* bo, const void* g2,
                                const void* b2, const void* wfc, const void* bfc, const void* wp,
                                const void* bp, void* out, int g, int s, int d, int n_head,
                                int dtype, float scale, float eps, void* stream) {
  if (s < 1 || s > S_MAX || d < 16 || d > D_MAX || d % 16 || n_head < 1 || d % n_head ||
      (d / n_head) % 8 || d / n_head > HD_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g <= 0) return static_cast<int>(cudaGetLastError());
  const void* ptrs[] = {x, g1, b1, wq, bq, wk, bk, wv, bv, wo, bo, g2, b2, wfc, bfc, wp, bp};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == mage::kBFloat16)
    return launch<__nv_bfloat16>(ptrs, out, g, s, d, n_head, scale, eps, st);
  return launch<float>(ptrs, out, g, s, d, n_head, scale, eps, st);
}
