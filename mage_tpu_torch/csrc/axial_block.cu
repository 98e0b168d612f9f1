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
// eps), the affine in f32), attention runs in f32 (attend.cuh). Rounding
// points, each to x's dtype and nowhere else, as in the TPU kernel: h; q, k,
// v (bias added in f32); the concatenated heads o; attn_out = o Wo^T + bo;
// seq = x + attn_out; h2 = LN2(seq); fc = h2 Wfc^T + bfc; act = fc *
// sigmoid(1.702 fc); proj = act Wp^T + bp; out = seq + proj. No
// intermediate reaches device memory.
//
// Bound: at the main path's shape (G=512, S=16, D=512, 16 heads, bf16) one
// launch does 51.9 GFLOP (QKV 12.9, attention 0.27, out-proj 4.3, MLP 34.4)
// and moves 23.1 MB (x in and out 16.8 MB, 6.3 MB of weights): bound by
// operations, 0.0525 ms at 989 TFLOP/s (bf16 tensor cores, dense). The
// weights stay in the 50 MB L2, but every tile of rows reads all of them
// (0.8 GB of L2 reads a launch at G = 512).
//
// bf16 design (axial_block_wg, sm_90a; taken when D % 64 == 0 and hd is 8,
// 16, 32 or 64, which every configuration meets):
//   - A tile is ROWS = 64 token rows, one wgmma M: floor(64 / S) whole groups
//     (4 at S = 16, so G = 512 is 128 tiles, one wave on 132 SMs); rows past
//     the tile's groups are padding that is never stored.
//   - Weights: every weight of the block streams through TMA, in the order
//     the products use them, through 2-D tensor maps with the 128-byte
//     swizzle over torch's (out, in) layout (already K-major for wgmma's B).
//     A stage is 128 output rows x 128 k; warpgroup w takes its rows 64w ..
//     64w + 63 (N = 64), so each warpgroup streams its own half of every
//     stage (two 64 x 64 boxes, 16 KB) through a ring of its own with a full
//     mbarrier per slot. The warpgroup's thread 0 loads a slot again as soon
//     as the warpgroup's products that read it are complete (wgmma.wait), so
//     no other thread releases it: no empty barrier and no handshake between
//     the warpgroups. The maps are encoded once per parameter set (a cache
//     keyed on the weight pointers and D). Measured and dropped: one ring
//     shared by both warpgroups (thread 0 refilling a slot once both had
//     released it cost about a microsecond a stage in barrier handshakes,
//     more than the products), 16 KB shared stages (twice the handshakes),
//     and a cluster of two CTAs sharing each box by TMA multicast (half the
//     L2 reads, no faster while the handshakes set the pace).
//   - Consumers: each stage is one k-step of 128, eight wgmma.mma_async
//     m64n64k16 with A and B in shared memory (SS), one stage's group queued
//     behind the next so a slot is refilled while the next multiplies.
//   - Activations stay in shared memory in the A descriptor's layout, 64-row
//     x 64-column blocks with the 128-byte swizzle: H (D x 128 bytes: LN1's
//     h, then LN2's h2, then out) and O (one 128-column chunk of heads);
//     LayerNorms and the attention write them with 16-byte stores, and a
//     fence.proxy.async hands them to the tensor cores.
//   - Order: LN1 into H. Per 128-column chunk of whole heads: q, k and v
//     (bias added, rounded) into a staging area; attend.cuh's routine, one
//     thread a query row, writes the chunk's heads into O; the chunk's k-steps
//     of the out-proj add into 128 f32 accumulators a thread that stay in
//     registers across the chunks (each warpgroup owns D / 2 output
//     columns), so O never holds more than one chunk. Then seq = x +
//     attn_out waits in out (global; this tile's rows only), LN2 reads it
//     back into H, and the MLP runs in 128-column fc chunks: c_fc and
//     QuickGELU into one of two act buffers (the staging area, double
//     buffered so one barrier a chunk does), c_proj's sums in the same
//     registers; out = seq + proj is staged in H and copied out as 16-byte
//     rows.
//   Shared memory at D = 512: H 64 KB, O 16 KB, staging 48 KB, the two rings
//   of 3 slots 96 KB: 225 KB, one CTA an SM. The ring has up to 8 stages at smaller D.
//   A full-width O beside H left room for 3 stages only, and the ring
//   then waited on L2's latency.
//   Registers: the MLP holds 160 accumulators a thread, so the block is the
//   two warpgroups alone (255 registers a thread). A producer warp beside
//   them caps a thread at 168 (ptxas counts whole warpgroups), where the
//   products spilled and ptxas serialised the wgmmas, and setmaxnreg did not
//   lift that cap.
// Second path (axial_block, every other shape, and the f32 checks): a block
// of 8 warps owns 32 token rows; bf16 products are mma.sync m16n8k16 with
// weight fragments loaded straight from L2 (k permuted identically in A and
// B so each fragment is one 16-byte load), f32 the same tiling on the CUDA
// cores (fmaf, no TF32); q, k, v in chunks of whole heads (128 columns bf16,
// 64 f32), the same attention routine; the MLP in 128-column fc chunks with
// c_proj's sums in registers. Limits (the wrapper checks them): 1 <= S <= 32,
// D a multiple of 16 up to 512, hd = D / n_head a multiple of 8 up to 64.
//
// Probe switch (axial_block_probe.py builds variants with -D; the library is
// built without it): the bits of AXIAL_BLOCK_PROBE_SKIP drop one part of the
// bf16 wgmma path to time the rest (the output is then wrong): 1 the wgmma
// products (the slots are still waited for and refilled, a warpgroup barrier
// in the products' place), 2 the weight TMA
// (the loader arrives without loading), 4 the attention, 16 the ring itself
// (no loads, no waits: the products read whatever the slots hold).
#include "attend.cuh"
#include "common.cuh"
#include "hopper.cuh"

#ifndef AXIAL_BLOCK_PROBE_SKIP
#define AXIAL_BLOCK_PROBE_SKIP 0
#endif

namespace {

using mage::mma_bf16;

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
__host__ __device__ __forceinline__ size_t smem_bytes(int d) {
  return sizeof(T) * (2 * static_cast<size_t>(ROWS) * padded_ld(d) + 3 * ROWS * ldq<T>());
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
      if (tile < n_tiles)
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
          mma_bf16(acc[m][j], a0, b[j].x, b[j].y);
          mma_bf16(acc[m][j], a1, b[j].z, b[j].w);
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

// attention of one head chunk: nh heads of every valid group, q, k and v in
// shared memory rows of stride ldq (the chunk's columns, head hh at hh * hd);
// one thread a query row (attend.cuh); store(row, col, f) writes 8 values of
// the output row from the chunk's column col
template <typename T, typename Store>
__device__ __forceinline__ void attend_chunk(const T* Q, const T* K, const T* V, int ldq,
                                             int groups, int nh, int s, int hd, float scale,
                                             int tid, int nthreads, Store&& store) {
  for (int w = tid; w < groups * nh * s; w += nthreads) {
    const int u = w / s, i = w % s, gl = u / nh, hh = u % nh;
    const int unit = gl * s * ldq + hh * hd;
    const T* q = Q + unit + i * ldq;
    auto load_q = [&](int c0, float* f) { mage::load8(q + c0, f); };
    auto store_o = [&](int c0, const float* f) { store(gl * s + i, hh * hd + c0, f); };
    if (s <= 16)
      mage::attend_row<16, true>(load_q, store_o, K + unit, V + unit, ldq, s, hd, scale);
    else
      mage::attend_row<32, true>(load_q, store_o, K + unit, V + unit, ldq, s, hd, scale);
  }
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

  const int row0 = blockIdx.x * p.tile_g * s;
  const int n_rows = min(p.tile_g * s, p.rows - row0);  // valid token rows
  const int groups = n_rows / s;
  const int hd = d / p.n_head;

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
    attend_chunk(Q, Kc, Vc, lq, groups, nh, s, hd, p.scale, threadIdx.x, THREADS,
                 [&](int r, int col, const float* f) { mage::store8(O + r * ld + c0 + col, f); });
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
  const size_t smem = smem_bytes<T>(d);
  cudaError_t err = cudaFuncSetAttribute(axial_block<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((g + a.tile_g - 1) / a.tile_g);
  axial_block<T><<<blocks, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------ bf16, TMA and wgmma ----

namespace wg {

constexpr int SKIP = AXIAL_BLOCK_PROBE_SKIP;
constexpr int ROWS = 64;                        // token rows of a tile: one wgmma M
constexpr int CONSUMERS = 256;                  // two warpgroups
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int THREADS = CONSUMERS;             // no producer warp: 255 registers a thread
constexpr int BK = 64;                          // k of a block: one 128-byte swizzle row
constexpr int KS = 2;                           // k-blocks of a stage
constexpr int SK = BK * KS;                     // k of a stage
constexpr int BN = 128;                         // weight rows of a stage, 64 a warpgroup
constexpr int STAGE_BYTES = BN * SK * 2;        // a weight stage, 32 KB (both warpgroups)
constexpr int WG_STAGE_BYTES = STAGE_BYTES / 2;  // a warpgroup's half, 16 KB
constexpr int BLOCK_BYTES = ROWS * BK * 2;      // 64 rows x 64 columns of an A operand
constexpr int CW = 128;                         // q/k/v columns of a head chunk
constexpr int FC = 128;                         // fc columns of an MLP chunk
constexpr int STAGING_BYTES = 3 * ROWS * CW * 2;  // q, k, v of a chunk; two act buffers
constexpr int ACT_BYTES = ROWS * FC * 2;
constexpr int OC_BYTES = ROWS * CW * 2;         // one chunk of heads, the out-proj's A
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;              // bytes of shared memory a block may use
constexpr int NP_MAX = D_MAX / BN;              // 128-column pieces of a D-wide product
static_assert(2 * ACT_BYTES <= STAGING_BYTES, "the act buffers live in the staging area");

// the six weights
enum { WQ, WK, WV, WO, WFC, WP, N_MAPS };
struct Maps {
  CUtensorMap w[N_MAPS];
};

struct Args {
  const __nv_bfloat16 *x, *g1, *b1, *bq, *bk, *bv, *bo, *g2, *b2, *bfc, *bp;
  __nv_bfloat16* out;
  int rows, s, d, n_head, tile_g, stages;
  float scale, eps;
};

// H, O and the staging area, the ring, its barriers, room to align the base
__host__ __device__ __forceinline__ int smem_bytes(int d, int stages) {
  return d * 128 + OC_BYTES + STAGING_BYTES + stages * STAGE_BYTES + 2 * stages * 8 + 1024;
}

// byte offset of element (r, c) in an activation of 64-column blocks with the
// 128-byte swizzle (the layout TMA's SWIZZLE_128B writes and wgmma reads)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 6) * BLOCK_BYTES + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// K-major operand with the 128-byte swizzle: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return mage::smem_desc(addr, 16, 1024, 1);
}

__device__ __forceinline__ void store_pair(unsigned char* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float bf(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

// f(row, col, v(row, col), v(row, col + 1)) over a warpgroup's m64n64
// accumulators; col is relative to the warpgroup's 64 columns
template <typename F>
__device__ __forceinline__ void for_frag(const float (&acc)[32], F&& f) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      f(warp * 16 + lane / 4 + 8 * half, 8 * j + 2 * (lane % 4), acc[4 * j + 2 * half],
        acc[4 * j + 2 * half + 1]);
}

// 16 bytes of bf16 at p as f32, through L2 only: for rows this kernel wrote
__device__ __forceinline__ void load_vec_cg(const __nv_bfloat16* p, float* f) {
  const uint4 u = __ldcg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// dst rows 0..63 (swizzled) = round(LN(src row)), src rows of stride d in
// global memory, read-only for the kernel (READ_ONLY: x) or written by it
// (seq); rows from n_rows on are 0. One warp a row, 16 bytes a lane.
template <bool READ_ONLY>
__device__ __forceinline__ void layer_norm(unsigned char* dst, const __nv_bfloat16* src,
                                           const __nv_bfloat16* gamma,
                                           const __nv_bfloat16* beta, int d, int n_rows,
                                           float eps) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  constexpr int NV = D_MAX / 256;  // 16-byte vectors a lane
  for (int r = warp; r < ROWS; r += CONSUMER_WARPS) {
    float v[NV][8];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = 8 * (lane + 32 * i);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[i][e] = 0.f;
      if (c < d && r < n_rows) {
        if (READ_ONLY)
          mage::load_vec_global(src + static_cast<size_t>(r) * d + c, v[i]);
        else
          load_vec_cg(src + static_cast<size_t>(r) * d + c, v[i]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[i][e];
    }
    const float mu = warp_sum(sum) / d;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (8 * (lane + 32 * i) < d) {
#pragma unroll
        for (int e = 0; e < 8; ++e) sq += (v[i][e] - mu) * (v[i][e] - mu);
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / d + eps);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = 8 * (lane + 32 * i);
      if (c >= d) continue;
      float gv[8], bv[8], o[8];
      mage::load_vec_global(gamma + c, gv);
      mage::load_vec_global(beta + c, bv);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = r < n_rows ? (v[i][e] - mu) * rstd * gv[e] + bv[e] : 0.f;
      mage::store_vec(reinterpret_cast<__nv_bfloat16*>(dst + swz(r, c)), o);
    }
  }
}

// the weight stages in the order the products take them, each 128 rows x
// SK = 128 columns (a chunk of heads and an fc chunk are 128 columns, so
// their out-proj and c_proj shares are one stage a 128 output columns): per
// head chunk the k-steps of Wq, Wk and Wv, then the chunk's Wo stage for
// each 128 out-proj columns; per fc chunk the k-steps of Wfc, then the
// chunk's Wp stage for each 128 c_proj columns
struct Schedule {
  int nk, np, nc, nf, per_c, per_f, total;
  __device__ __forceinline__ explicit Schedule(int d)
      : nk((d + SK - 1) / SK), np((d + BN - 1) / BN), nc((d + CW - 1) / CW), nf(4 * d / FC) {
    per_c = 3 * nk + np;
    per_f = nk + np;
    total = nc * per_c + nf * per_f;
  }
  // the box of `step`: weight m, its column k0 and row n0
  __device__ __forceinline__ void box(int step, int& m, int& k0, int& n0) const {
    if (step < nc * per_c) {
      const int c = step / per_c, u = step % per_c;
      m = u < 3 * nk ? WQ + u / nk : WO;
      k0 = u < 3 * nk ? u % nk * SK : c * CW;
      n0 = u < 3 * nk ? c * CW : (u - 3 * nk) * BN;
      return;
    }
    step -= nc * per_c;
    const int f = step / per_f, u = step % per_f;
    m = u < nk ? WFC : WP;
    k0 = u < nk ? u * SK : f * FC;
    n0 = u < nk ? f * FC : (u - nk) * BN;
  }
};

// the ring of one warpgroup: its 64 rows of every weight stage (two 64-row x
// 64-column boxes, 16 KB), `stages` slots with a full barrier each, and its
// first thread as the loader. A slot is loaded again as soon as the
// warpgroup's own products that read it are complete, so no other thread
// has to release it and no empty barrier exists.
struct Ring {
  const Maps* maps;
  Schedule sched;
  uint32_t base, bars;  // this warpgroup's slots and full barriers
  int stages, half;     // half: the warpgroup's first weight row of a stage
  __device__ __forceinline__ uint32_t full(int step) const { return bars + 8 * (step % stages); }
  __device__ __forceinline__ uint32_t slot(int step) const {
    return base + (step % stages) * WG_STAGE_BYTES;
  }
  // the loader (the warpgroup's thread 0) fills step's slot
  __device__ __forceinline__ void load(int step) const {
    if (step >= sched.total || threadIdx.x % 128 != 0 || (SKIP & 16)) return;
    if (SKIP & 2) {
      mage::mbar_arrive(full(step));
      return;
    }
    int m, k0, n0;
    sched.box(step, m, k0, n0);
    // a k-block past the weight's columns arrives as zeros (and is not multiplied)
    mage::mbar_expect_tx(full(step), WG_STAGE_BYTES);
#pragma unroll
    for (int j = 0; j < KS; ++j)
      mage::tma_load_2d(slot(step) + j * BLOCK_BYTES, &maps->w[m], full(step), k0 + j * BK,
                        n0 + half);
  }
};

// acc += A (64 rows x 64 * nkb, blocks of 64 columns from a) * this
// warpgroup's rows of the next ceil(nkb / KS) stages of its ring
__device__ __forceinline__ void product(float (&acc)[32], uint32_t a, int nkb, const Ring& ring,
                                        int& step) {
  const int nk = (nkb + KS - 1) / KS;
#pragma unroll 1
  for (int kb = 0; kb < nk; ++kb, ++step) {
    if (!(SKIP & 16)) mage::mbar_wait(ring.full(step), (step / ring.stages) & 1);
    if (!(SKIP & 1)) {
      mage::wgmma_fence();
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        if (kb * KS + j < nkb) {
          const uint32_t aj = a + (kb * KS + j) * BLOCK_BYTES;
          const uint32_t bj = ring.slot(step) + j * BLOCK_BYTES;
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            mage::wgmma_m64n64(acc, desc(aj + 32 * kk), desc(bj + 32 * kk));
        }
      }
      mage::wgmma_commit();
      mage::wgmma_wait<1>();  // the previous stage's products are done: refill its slot
    } else {
      // the wgmmas keep a warpgroup's warps within a stage of each other;
      // without them a barrier must, or a slot's full barrier could move on
      // before a lagging warp has waited for it
      mage::named_sync(2 + threadIdx.x / 128, 128);
    }
    if (kb > 0) ring.load(step - 1 + ring.stages);
  }
  mage::wgmma_wait<0>();
  mage::wgmma_pin(acc);
  ring.load(step - 1 + ring.stages);
}

__device__ __forceinline__ void zero(float (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
}

__global__ void __launch_bounds__(THREADS, 1)
axial_block_wg(const __grid_constant__ Maps maps, const Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (mage::smem_addr(smem_raw) & 1023)) & 1023);
  const int d = p.d, s = p.s;
  unsigned char* Hp = smem;                    // h, then h2, then out
  unsigned char* Op = smem + d * 128;          // one chunk of heads
  unsigned char* St = Op + OC_BYTES;           // q, k, v of a chunk; the act buffers
  const uint32_t H = mage::smem_addr(Hp), O = mage::smem_addr(Op), ST = mage::smem_addr(St);

  const int row0 = blockIdx.x * p.tile_g * s;
  const int n_rows = min(p.tile_g * s, p.rows - row0);
  const int groups = n_rows / s;
  const Schedule sched(d);
  const int nkb = d / BK, np = sched.np;

  const int wgi = threadIdx.x / 128;
  const uint32_t ring_base = ST + STAGING_BYTES;
  const uint32_t bars = ring_base + 2 * p.stages * WG_STAGE_BYTES;
  const Ring ring{&maps, sched, ring_base + wgi * p.stages * WG_STAGE_BYTES,
                  bars + 8 * wgi * p.stages, p.stages, wgi * ROWS};
  if (threadIdx.x % 128 == 0) {
    for (int i = 0; i < p.stages; ++i) mage::mbar_init(ring.full(i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int st = 0; st < p.stages; ++st) ring.load(st);

  const __nv_bfloat16* x = p.x + static_cast<size_t>(row0) * d;
  __nv_bfloat16* out = p.out + static_cast<size_t>(row0) * d;  // seq waits here, then out
  int step = 0;
  layer_norm<true>(Hp, x, p.g1, p.b1, d, n_rows, p.eps);
  mage::fence_proxy_async();
  mage::named_sync(1, CONSUMERS);

  // per chunk of whole heads: q, k, v, the attention into O, and the chunk's
  // share of the out-proj added to sums that stay in registers
  float acco[NP_MAX][32];
#pragma unroll
  for (int pc = 0; pc < NP_MAX; ++pc) zero(acco[pc]);
  const int hd = d / p.n_head;
  __nv_bfloat16* qkv = reinterpret_cast<__nv_bfloat16*>(St);  // [3][ROWS][CW]
#pragma unroll 1
  for (int c = 0; c < sched.nc; ++c) {
    const int c0 = c * CW, cw = min(CW, d - c0);
#pragma unroll 1
    for (int m = 0; m < 3; ++m) {
      float acc[32];
      zero(acc);
      product(acc, H, nkb, ring, step);
      // the last chunk's attention and out-proj are done with the staging and O
      if (m == 0 && c > 0) mage::named_sync(1, CONSUMERS);
      const __nv_bfloat16* bias = (m == 0 ? p.bq : m == 1 ? p.bk : p.bv) + c0;
      __nv_bfloat16* dst = qkv + m * ROWS * CW;
      for_frag(acc, [&](int r, int col, float v0, float v1) {
        col += 64 * wgi;
        if (col < cw)
          *reinterpret_cast<__nv_bfloat162*>(dst + r * CW + col) =
              __floats2bfloat162_rn(v0 + bf(bias, col), v1 + bf(bias, col + 1));
      });
    }
    mage::named_sync(1, CONSUMERS);
    if (!(SKIP & 4))
      attend_chunk(qkv, qkv + ROWS * CW, qkv + 2 * ROWS * CW, CW, groups, cw / hd, s, hd,
                   p.scale, threadIdx.x, CONSUMERS, [&](int r, int col, const float* f) {
                     mage::store_vec(reinterpret_cast<__nv_bfloat16*>(Op + swz(r, col)), f);
                   });
    mage::fence_proxy_async();
    mage::named_sync(1, CONSUMERS);
#pragma unroll
    for (int pc = 0; pc < NP_MAX; ++pc)
      if (pc < np) product(acco[pc], O, cw / BK, ring, step);
  }

  // the first residual: seq = round(x + round(o Wo^T + bo)), parked in out
#pragma unroll
  for (int pc = 0; pc < NP_MAX; ++pc) {
    if (pc >= np) continue;
    for_frag(acco[pc], [&](int r, int col, float v0, float v1) {
      col += pc * BN + 64 * wgi;
      if (col >= d || r >= n_rows) return;
      const size_t off = static_cast<size_t>(r) * d + col;
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + off));
      *reinterpret_cast<__nv_bfloat162*>(out + off) =
          __floats2bfloat162_rn(xv.x + round_to<__nv_bfloat16>(v0 + bf(p.bo, col)),
                                xv.y + round_to<__nv_bfloat16>(v1 + bf(p.bo, col + 1)));
    });
  }
  mage::named_sync(1, CONSUMERS);  // seq is in out; every product that read H is done
  layer_norm<false>(Hp, out, p.g2, p.b2, d, n_rows, p.eps);
  mage::fence_proxy_async();
  mage::named_sync(1, CONSUMERS);

  // the MLP in fc chunks; c_proj's sums stay in registers (acco's, reused)
  float (&accp)[NP_MAX][32] = acco;
#pragma unroll
  for (int pc = 0; pc < NP_MAX; ++pc) zero(accp[pc]);
#pragma unroll 1
  for (int f = 0; f < sched.nf; ++f) {
    float acc[32];
    zero(acc);
    product(acc, H, nkb, ring, step);
    unsigned char* act = St + (f & 1) * ACT_BYTES;
    const __nv_bfloat16* bias = p.bfc + f * FC;
    for_frag(acc, [&](int r, int col, float v0, float v1) {
      col += 64 * wgi;
      const float f0 = round_to<__nv_bfloat16>(v0 + bf(bias, col));
      const float f1 = round_to<__nv_bfloat16>(v1 + bf(bias, col + 1));
      store_pair(act + swz(r, col), f0 * (1.0f / (1.0f + expf(-1.702f * f0))),
                 f1 * (1.0f / (1.0f + expf(-1.702f * f1))));
    });
    mage::fence_proxy_async();
    mage::named_sync(1, CONSUMERS);  // both halves of the act chunk are written
#pragma unroll
    for (int pc = 0; pc < NP_MAX; ++pc)
      if (pc < np) product(accp[pc], mage::smem_addr(act), FC / BK, ring, step);
  }
  mage::named_sync(1, CONSUMERS);  // every product that read H (h2) is done

  // out = round(seq + round(proj + bp)), staged in H, then 16-byte rows out
#pragma unroll
  for (int pc = 0; pc < NP_MAX; ++pc) {
    if (pc >= np) continue;
    for_frag(accp[pc], [&](int r, int col, float v0, float v1) {
      col += pc * BN + 64 * wgi;
      if (col >= d || r >= n_rows) return;
      const float2 sv = __bfloat1622float2(
          __ldcg(reinterpret_cast<const __nv_bfloat162*>(out + static_cast<size_t>(r) * d + col)));
      store_pair(Hp + swz(r, col), sv.x + round_to<__nv_bfloat16>(v0 + bf(p.bp, col)),
                 sv.y + round_to<__nv_bfloat16>(v1 + bf(p.bp, col + 1)));
    });
  }
  mage::named_sync(1, CONSUMERS);
  const int vecs = d / 8;
  for (int e = threadIdx.x; e < n_rows * vecs; e += CONSUMERS) {
    const int r = e / vecs, c = (e % vecs) * 8;
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(r) * d + c) =
        *reinterpret_cast<const uint4*>(Hp + swz(r, c));
  }
}

// the tensor maps of one parameter set, encoded once: a small cache keyed on
// the six weight pointers and D (a map depends on nothing else)
struct MapEntry {
  const void* w[N_MAPS];
  int d;
  Maps maps;
};

const Maps* tensor_maps(const void* const* w, int d) {
  constexpr int N_ENTRIES = 64;
  static MapEntry cache[N_ENTRIES];
  static int used = 0, next = 0;
  for (int i = 0; i < used; ++i) {
    bool hit = cache[i].d == d;
    for (int m = 0; m < N_MAPS && hit; ++m) hit = cache[i].w[m] == w[m];
    if (hit) return &cache[i].maps;
  }
  const mage::EncodeTiled encode = mage::encode_tiled();
  if (encode == nullptr) return nullptr;
  MapEntry e;
  e.d = d;
  const cuuint64_t D = d;
  // (in, out) extents of Wq, Wk, Wv, Wo (d, d), Wfc (4d, d) and Wp (d, 4d)
  const cuuint64_t dims[N_MAPS][2] = {{D, D}, {D, D}, {D, D}, {D, D}, {D, 4 * D}, {4 * D, D}};
  const cuuint32_t box[2] = {BK, ROWS}, ones[2] = {1, 1};  // one warpgroup's rows
  for (int m = 0; m < N_MAPS; ++m) {
    e.w[m] = w[m];
    const cuuint64_t stride[1] = {dims[m][0] * 2};
    const CUresult r = encode(&e.maps.w[m], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                              const_cast<void*>(w[m]), dims[m], stride, box, ones,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return nullptr;
  }
  const int slot = used < N_ENTRIES ? used++ : (next++ % N_ENTRIES);
  cache[slot] = e;
  return &cache[slot].maps;
}

bool takes(int d, int hd) {
  return d % 64 == 0 && (hd == 8 || hd == 16 || hd == 32 || hd == 64);
}

// ptrs: x, g1, b1, wq, bq, wk, bk, wv, bv, wo, bo, g2, b2, wfc, bfc, wp, bp
int launch(const void* const* ptrs, void* out, int g, int s, int d, int n_head, float scale,
           float eps, cudaStream_t stream) {
  auto b16 = [&](int i) { return static_cast<const __nv_bfloat16*>(ptrs[i]); };
  const void* w[N_MAPS] = {ptrs[3], ptrs[5], ptrs[7], ptrs[9], ptrs[13], ptrs[15]};
  const Maps* maps = tensor_maps(w, d);
  if (maps == nullptr) return static_cast<int>(cudaErrorNotSupported);
  Args a{b16(0), b16(1), b16(2), b16(4), b16(6), b16(8), b16(10), b16(11), b16(12), b16(14),
         b16(16), static_cast<__nv_bfloat16*>(out)};
  a.rows = g * s;
  a.s = s;
  a.d = d;
  a.n_head = n_head;
  a.tile_g = ROWS / s;
  const int fit = (SMEM_LIMIT - smem_bytes(d, 0)) / (STAGE_BYTES + 16);
  a.stages = fit < MAX_STAGES ? fit : MAX_STAGES;
  a.scale = scale;
  a.eps = eps;
  const int smem = smem_bytes(d, a.stages);
  static int smem_set = 0;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(axial_block_wg,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  const unsigned tiles = static_cast<unsigned>((g + a.tile_g - 1) / a.tile_g);
  axial_block_wg<<<tiles, THREADS, smem, stream>>>(*maps, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

// x, out (g, s, d) and the 16 parameters (ln_1 weight and bias; Wq, bq, Wk,
// bk, Wv, bv as (d, d) and (d,); Wo (d, d), bo; ln_2 weight and bias; Wfc
// (4d, d), bfc (4d,); Wp (d, 4d), bp (d,)) in one dtype, contiguous and
// 16-byte aligned. bf16 with D % 64 == 0 and hd in {8, 16, 32, 64} takes the
// TMA / wgmma path, everything else the mma.sync / SIMT one. Shapes outside
// the limits above return cudaErrorInvalidValue without a launch.
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
  if (dtype == mage::kBFloat16 && wg::takes(d, d / n_head))
    return wg::launch(ptrs, out, g, s, d, n_head, scale, eps, st);
  if (dtype == mage::kBFloat16)
    return launch<__nv_bfloat16>(ptrs, out, g, s, d, n_head, scale, eps, st);
  return launch<float>(ptrs, out, g, s, d, n_head, scale, eps, st);
}
