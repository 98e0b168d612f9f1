// Fused GroupNorm affine -> SiLU -> 3x3 conv (+ bias) for the KL decoder.
//
// Replaces the TPU kernel mage_tpu/ops/gn_conv.py::_kernel (wrapper
// gn_silu_conv3x3). For x (B, H, W, C) NHWC and per-(image, channel) affine
// rows a, b (B, C) in f32 (the GroupNorm statistics, reduced outside), it
// computes
//   out[n,y,x,o] = bias[o] + sum_{dy,dx,c} h[n,y+dy-1,x+dx-1,c] * w[o,dy,dx,c]
//   h = round_to_x_dtype(silu(x * a + b)), and h = 0 outside the image,
// so the zero padding applies after the activation (silu(b) != 0). Products
// accumulate in f32; the bias is added in f32 and the result is rounded once
// to x's dtype. The activated tensor h never reaches device memory.
//
// Bound: per 128-px decoded frame the decoder's 28 fused convs do ~109 GFLOP
// against a few hundred MB of activations, so every call on the main path is
// bound by operations: bf16 runs on the tensor cores (989 TFLOP/s dense on
// an H100 SXM), f32 on the CUDA cores (67 TFLOP/s).
//
// Design (a simple kernel that is right; wgmma, TMA and a persistent
// schedule are later work): an implicit GEMM with M = output pixels, N = Cout
// and K = 9 * C. A block owns an 8 x 16 tile of output pixels of one image and
// a tile of output channels. It walks C in chunks; for each chunk it loads the
// 10 x 18 halo of the tile once into shared memory and applies the affine,
// the SiLU, the ring mask and the rounding there (the TPU kernel's XLA halo
// gather is not needed: the block bounds-checks its own halo); the nine taps
// then read shifted windows of the same halo tile against the packed weight
// (Cout, 9 * C).
//   bf16: 4 warps, each 64 pixels x 64 channels of a 128 x 128 tile,
//         mma.sync m16n8k16 with f32 accumulators, fragments loaded with
//         ldmatrix from rows padded to 80 bytes (conflict-free). The weights
//         of each (chunk, tap) step come through a 3-stage cp.async ring two
//         steps ahead; the raw halo comes by cp.async into one of two
//         buffers and each thread activates, in place, the vectors it
//         copied. The output tile is staged in shared memory and leaves as
//         16-byte stores. 59.5 KB of shared memory, 3 blocks per SM.
//         It reaches a fifth of the bf16 peak at the decoder's shapes
//         (PERF.md); wgmma is the way to the rest.
//   f32:  the same tiling on the CUDA cores (no TF32): 256 threads, each
//         4 pixels x 8 channels of a 128 x 64 tile, fmaf.
// C and Cout must be multiples of 16 (the wrapper checks); B, H and W are any.
//
// Probe switches (gn_conv_probe.py builds variants with -D; the library is
// built with neither): GN_CONV_KC sets the bf16 chunk of input channels, and
// the bits of GN_CONV_PROBE_SKIP drop one part of the bf16 kernel to time the
// rest (the output is then wrong): 1 the activation, 2 the weight loads, 4 the
// halo loads, 8 the mma.sync products.
#include "common.cuh"

#ifndef GN_CONV_KC
#define GN_CONV_KC 32
#endif
#ifndef GN_CONV_PROBE_SKIP
#define GN_CONV_PROBE_SKIP 0
#endif

namespace {

constexpr int TR = 8;                   // output rows of a block tile
constexpr int TC = 16;                  // output columns of a block tile
constexpr int HC = TC + 2;              // halo columns
constexpr int HP = (TR + 2) * HC;       // halo pixels (180)

// x * a + b as two rounded f32 operations (no contraction into an FMA) and
// silu(h) = h / (1 + exp(-h)): the same roundings as the plain PyTorch version.
__device__ __forceinline__ float affine_silu(float x, float a, float b) {
  const float h = __fadd_rn(__fmul_rn(x, a), b);
  return h / (1.0f + expf(-h));
}

struct Tile {
  int img, y0, x0, n0;
};

__device__ __forceinline__ Tile tile_of_block(int tiles_x, int tiles_y, int n_tiles, int bn) {
  int s = blockIdx.x;
  Tile t;
  t.n0 = (s % n_tiles) * bn;  // channel tiles vary fastest: neighbours share a halo
  s /= n_tiles;
  t.x0 = (s % tiles_x) * TC;
  s /= tiles_x;
  t.y0 = (s % tiles_y) * TR;
  t.img = s / tiles_y;
  return t;
}

// ---------------------------------------------------------------- bf16 ----

constexpr int BN = 128;                 // output channels of a block
constexpr int KC = GN_CONV_KC;          // input channels of one chunk
constexpr int SKIP = GN_CONV_PROBE_SKIP;
constexpr int BT = 128;                 // threads: 2 x 2 warps of 64 pixels x 64 channels
constexpr int KS = KC + 8;              // padded shared row: 80 bytes
constexpr int STAGES = 3;               // weight slices in flight
constexpr int A_BUF = HP * KS;          // one halo buffer (two: this chunk, the next)
constexpr int B_BUF = BN * KS;          // one weight slice: one tap of one chunk
constexpr int CS = BN + 8;              // padded row of the output staging tile
constexpr size_t SMEM_BF16 =
    static_cast<size_t>(2 * A_BUF + STAGES * B_BUF) * sizeof(__nv_bfloat16);
static_assert(TR * TC * CS <= 2 * A_BUF + STAGES * B_BUF, "output tile must fit");

using mage::cp_async16;
using mage::cp_async_commit;
using mage::cp_async_wait;
using mage::ldmatrix_x4;
using mage::mma_bf16;

struct Bf16Args {
  const __nv_bfloat16* x;
  const float* a;
  const float* b;
  const __nv_bfloat16* w;
  const float* bias;
  __nv_bfloat16* out;
  int H, W, C, Cout;
};

// The halo vectors (8 channels of one halo pixel) a thread owns:
// e = tid, tid + BT, ... below HP * KC / 8.
__device__ __forceinline__ bool halo_vector(const Bf16Args& p, const Tile& tile, int e, int c0,
                                            int& smem_off, size_t& gmem_off) {
  const int px = e / (KC / 8), part = e % (KC / 8);
  const int yy = tile.y0 - 1 + px / HC, xx = tile.x0 - 1 + px % HC;
  const int c = c0 + part * 8;
  smem_off = px * KS + part * 8;
  gmem_off = ((static_cast<size_t>(tile.img) * p.H + yy) * p.W + xx) * p.C + c;
  return yy >= 0 && yy < p.H && xx >= 0 && xx < p.W && c < p.C;
}

// raw x of chunk c0 into a halo buffer (in-image vectors only)
__device__ __forceinline__ void load_halo(const Bf16Args& p, const Tile& tile, int c0,
                                          __nv_bfloat16* As) {
  for (int e = threadIdx.x; e < HP * (KC / 8); e += BT) {
    int so;
    size_t go;
    if (halo_vector(p, tile, e, c0, so, go)) cp_async16(As + so, p.x + go, 16);
  }
}

// in place, on the vectors this thread loaded: silu(x * a + b) rounded to
// bf16, and 0 on the ring and past C (the padding comes after the activation)
__device__ __forceinline__ void activate_halo(const Bf16Args& p, const Tile& tile, int c0,
                                              __nv_bfloat16* As) {
  const size_t row_a = static_cast<size_t>(tile.img) * p.C;
  for (int e = threadIdx.x; e < HP * (KC / 8); e += BT) {
    int so;
    size_t go;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (halo_vector(p, tile, e, c0, so, go)) {
      const int c = c0 + (e % (KC / 8)) * 8;
      const float4 a0 = *reinterpret_cast<const float4*>(p.a + row_a + c);
      const float4 a1 = *reinterpret_cast<const float4*>(p.a + row_a + c + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(p.b + row_a + c);
      const float4 b1 = *reinterpret_cast<const float4*>(p.b + row_a + c + 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      const uint4 raw = *reinterpret_cast<const uint4*>(As + so);
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw);
      uint32_t hv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 xf = __bfloat1622float2(xv[i]);
        const __nv_bfloat162 h2 =
            __floats2bfloat162_rn(affine_silu(xf.x, av[2 * i], bv[2 * i]),
                                  affine_silu(xf.y, av[2 * i + 1], bv[2 * i + 1]));
        hv[i] = *reinterpret_cast<const uint32_t*>(&h2);
      }
      v = make_uint4(hv[0], hv[1], hv[2], hv[3]);
    }
    *reinterpret_cast<uint4*>(As + so) = v;
  }
}

// the weights of one step (tap t of chunk c0) for the block's BN channels
__device__ __forceinline__ void load_weights(const Bf16Args& p, const Tile& tile, int c0, int t,
                                             __nv_bfloat16* Bs) {
  for (int e = threadIdx.x; e < BN * (KC / 8); e += BT) {
    const int n = e / (KC / 8), part = e % (KC / 8);
    const int c = c0 + part * 8;
    const bool in = tile.n0 + n < p.Cout && c < p.C;
    const __nv_bfloat16* src =
        in ? p.w + (static_cast<size_t>(tile.n0 + n) * 9 + t) * p.C + c : p.w;
    cp_async16(Bs + n * KS + part * 8, src, in ? 16 : 0);
  }
}

__global__ void __launch_bounds__(BT, 3)
gn_conv_bf16(Bf16Args p, int tiles_x, int tiles_y, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][HP][KS]
  __nv_bfloat16* Bs = As + 2 * A_BUF;                               // [STAGES][BN][KS]

  const Tile tile = tile_of_block(tiles_x, tiles_y, n_tiles, BN);
  const int lane = threadIdx.x % 32;
  const int warp_m = (threadIdx.x / 32) % 2;  // tile rows 4*warp_m .. +3
  const int warp_n = (threadIdx.x / 32) / 2;  // channels warp_n*64 .. +63 of the block

  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Steps s = 0 .. 9 * chunks - 1 walk (chunk, tap). Copy group s holds the
  // weights of step s and, at a chunk's first tap, the chunk's raw halo; it
  // is issued two steps ahead, so loads overlap the products of earlier steps.
  const int steps = 9 * ((p.C + KC - 1) / KC);
  auto issue = [&](int s) {
    if (s < steps) {
      const int c0 = (s / 9) * KC, t = s % 9;
      if (t == 0 && !(SKIP & 4)) load_halo(p, tile, c0, As + ((s / 9) % 2) * A_BUF);
      if (!(SKIP & 2)) load_weights(p, tile, c0, t, Bs + (s % STAGES) * B_BUF);
    }
    cp_async_commit();  // empty groups past the end keep the count uniform
  };
  issue(0);
  issue(1);

#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const int chunk = s / 9, t = s % 9;
    const __nv_bfloat16* A = As + (chunk % 2) * A_BUF;
    const __nv_bfloat16* B = Bs + (s % STAGES) * B_BUF;
    cp_async_wait<1>();  // group s has landed (s + 1 may be in flight)
    if (t == 0 && !(SKIP & 1)) activate_halo(p, tile, chunk * KC, As + (chunk % 2) * A_BUF);
    __syncthreads();     // everyone's copies and activations are visible, and
                         // everyone is done with step s - 1's weight stage
    issue(s + 2);

    const int dy = t / 3, dx = t % 3;
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      // A (16 pixels of one tile row x 16 channels): lanes 0-15 give the
      // rows of k 0-7, lanes 16-31 the rows of k 8-15
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = warp_m * 4 + i;
        ldmatrix_x4(af[i], A + ((r + dy) * HC + lane % 16 + dx) * KS + ks + (lane / 16) * 8);
      }
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        // B for two n8 tiles: matrices (n 0-7, k 0-7), (n 0-7, k 8-15),
        // (n 8-15, k 0-7), (n 8-15, k 8-15)
        uint32_t bf[4];
        const int n = warp_n * 64 + jp * 16 + (lane / 16) * 8 + lane % 8;
        ldmatrix_x4(bf, B + n * KS + ks + ((lane / 8) % 2) * 8);
#pragma unroll
        for (int i = 0; i < 4 && !(SKIP & 8); ++i) {
          mma_bf16(acc[i][2 * jp], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * jp + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the shared buffers become the output staging tile

  // epilogue: + bias in f32, one rounding, staged in shared memory so that
  // each pixel's channels leave as 16-byte stores
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [TR*TC][CS]
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int px = (warp_m * 4 + i) * TC + g + half * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nl = warp_n * 64 + j * 8 + tig * 2;
        const int n = min(tile.n0 + nl, p.Cout - 2);  // columns past Cout are not stored
        *reinterpret_cast<__nv_bfloat162*>(Cs + px * CS + nl) = __floats2bfloat162_rn(
            acc[i][j][half * 2] + p.bias[n], acc[i][j][half * 2 + 1] + p.bias[n + 1]);
      }
    }
  __syncthreads();
  for (int e = threadIdx.x; e < TR * TC * (BN / 8); e += BT) {
    const int px = e / (BN / 8), v = e % (BN / 8);
    const int yy = tile.y0 + px / TC, xx = tile.x0 + px % TC, n = tile.n0 + v * 8;
    if (yy < p.H && xx < p.W && n < p.Cout)
      *reinterpret_cast<uint4*>(
          p.out + ((static_cast<size_t>(tile.img) * p.H + yy) * p.W + xx) * p.Cout + n) =
          *reinterpret_cast<const uint4*>(Cs + px * CS + v * 8);
  }
}

// ----------------------------------------------------------------- f32 ----

constexpr int FBN = 64;                 // output channels of a block
constexpr int FKC = 8;                  // input channels of one chunk
constexpr int FT = 256;                 // threads

__global__ void __launch_bounds__(FT)
gn_conv_f32(const float* __restrict__ x, const float* __restrict__ a,
            const float* __restrict__ b, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out, int H, int W, int C,
            int Cout, int tiles_x, int tiles_y, int n_tiles) {
  __shared__ float As[FKC][HP + 4];              // channel-major halo
  __shared__ __align__(16) float Bs[9][FKC][FBN];

  const Tile tile = tile_of_block(tiles_x, tiles_y, n_tiles, FBN);
  const int tid = threadIdx.x;
  const int tn = tid % 8;        // channels tn*8 .. +7 of the block
  const int tm = tid / 8;        // pixels: tile row tm/4, columns (tm%4)*4 .. +3
  const int r = tm / 4, col0 = (tm % 4) * 4;
  const size_t row_a = static_cast<size_t>(tile.img) * C;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += FKC) {
    for (int e = tid; e < HP * FKC; e += FT) {
      const int p = e / FKC, k = e % FKC;
      const int yy = tile.y0 - 1 + p / HC, xx = tile.x0 - 1 + p % HC;
      const int c = c0 + k;
      float v = 0.f;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W && c < C)
        v = affine_silu(x[((static_cast<size_t>(tile.img) * H + yy) * W + xx) * C + c],
                        a[row_a + c], b[row_a + c]);
      As[k][p] = v;
    }
    for (int e = tid; e < 9 * FKC * FBN; e += FT) {
      const int k = e % FKC;
      const int t = (e / FKC) % 9;
      const int n = e / (9 * FKC);
      const int c = c0 + k;
      Bs[t][k][n] = (tile.n0 + n < Cout && c < C)
                        ? w[(static_cast<size_t>(tile.n0 + n) * 9 + t) * C + c]
                        : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int base = (r + t / 3) * HC + col0 + t % 3;
#pragma unroll
      for (int k = 0; k < FKC; ++k) {
        float av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[k][base + i];
        const float4 w0 = *reinterpret_cast<const float4*>(&Bs[t][k][tn * 8]);
        const float4 w1 = *reinterpret_cast<const float4*>(&Bs[t][k][tn * 8 + 4]);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  const int yy = tile.y0 + r;
  if (yy >= H) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int xx = tile.x0 + col0 + i;
    if (xx >= W) continue;
    float* dst = out + ((static_cast<size_t>(tile.img) * H + yy) * W + xx) * Cout;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tile.n0 + tn * 8 + j;
      if (n < Cout) dst[n] = acc[i][j] + bias[n];
    }
  }
}

}  // namespace

// x (batch, H, W, C) and w (Cout, 9 * C) [w[o][(dy*3+dx)*C + c]] in one dtype;
// a, b (batch, C), bias (Cout,) and the f32 output or the bf16 out (batch, H,
// W, Cout). All contiguous and 16-byte aligned; C and Cout multiples of 16.
extern "C" int mage_gn_silu_conv3x3(const void* x, const void* a, const void* b,
                                    const void* w, const void* bias, void* out, int batch,
                                    int H, int W, int C, int Cout, int dtype, void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0 || Cout <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const int tiles_x = (W + TC - 1) / TC, tiles_y = (H + TR - 1) / TR;
  auto fa = static_cast<const float*>(a);
  auto fb = static_cast<const float*>(b);
  auto fbias = static_cast<const float*>(bias);
  if (dtype == mage::kBFloat16) {
    const int n_tiles = (Cout + BN - 1) / BN;
    cudaError_t err = cudaFuncSetAttribute(
        gn_conv_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM_BF16));
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks = static_cast<unsigned>(batch) * tiles_y * tiles_x * n_tiles;
    const Bf16Args args{static_cast<const __nv_bfloat16*>(x), fa, fb,
                        static_cast<const __nv_bfloat16*>(w), fbias,
                        static_cast<__nv_bfloat16*>(out), H, W, C, Cout};
    gn_conv_bf16<<<blocks, BT, SMEM_BF16, s>>>(args, tiles_x, tiles_y, n_tiles);
  } else {
    const int n_tiles = (Cout + FBN - 1) / FBN;
    const unsigned blocks = static_cast<unsigned>(batch) * tiles_y * tiles_x * n_tiles;
    gn_conv_f32<<<blocks, FT, 0, s>>>(
        static_cast<const float*>(x), fa, fb, static_cast<const float*>(w), fbias,
        static_cast<float*>(out), H, W, C, Cout, tiles_x, tiles_y, n_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
