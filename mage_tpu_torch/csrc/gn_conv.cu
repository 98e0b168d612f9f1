// Fused GroupNorm affine -> SiLU -> 3x3 conv (+ bias) for the KL decoder.
//
// Replaces the TPU kernel mage_tpu/ops/gn_conv.py::_kernel (wrapper
// gn_silu_conv3x3). For x (B, H, W, C) NHWC and per-(image, channel) affine
// rows a, b (B, C) in f32 (the GroupNorm statistics, from gn_stats.cu), it
// computes
//   out[n,y,x,o] = bias[o] + sum_{dy,dx,c} h[n,y+dy-1,x+dx-1,c] * w[o,dy,dx,c]
//   h = round_to_x_dtype(silu(x * a + b)), and h = 0 outside the image,
// so the zero padding applies after the activation (silu(b) != 0). Products
// accumulate in f32; the bias is added in f32 and the result is rounded once
// to x's dtype.
//
// Bound: per 128-px decoded frame the decoder's 28 fused convs do ~109 GFLOP
// against a few hundred MB of activations, so every call on the main path is
// bound by operations: bf16 runs on the tensor cores (989 TFLOP/s dense on
// an H100 SXM), f32 on the CUDA cores (67 TFLOP/s).
//
// bf16 design, for sm_90a, in two launches from one entry point:
//   1. gn_act_bf16, the activation once per element: h = round_to_bf16(silu(
//      x * a + b)) for every element of x, written to a scratch tensor laid
//      out (B, C / 8, H, W, 8). Bound by bytes (2 read, 2 written a value).
//   2. gn_conv_bf16, an implicit GEMM with M = output pixels, N = Cout and K =
//      9 * C, warp-specialised. A block (288 threads) owns a 16 x 8 tile of
//      output pixels of one image and BN = 256 output channels (128 when Cout
//      < 256). It walks C in chunks of 64 channels, nine taps a chunk.
//      - Producer (one thread of warp 8): TMA copies only. Each chunk's halo
//        of h, (16 + 2) x (8 + 2) pixels x 64 channels, comes through a 5-D
//        tensor map over h's (8, W, H, C / 8, B) view with box (8, 10, 18, 8,
//        1) at (0, x0 - 1, y0 - 1, 8 * chunk, image): it lands as [8-channel
//        group][row][column][8 channels], the no-swizzle K-major layout a
//        wgmma descriptor reads, into one of two buffers. TMA writes zeros
//        outside the image (negative coordinates included) and past C, and
//        those zeros are the conv's padding, which applies after the
//        activation. The weight, packed (Cout, 9 * C), comes through a 3-D
//        tensor map over its (C, 9, Cout) view: a box of 64 channels x 1 tap x
//        BN rows with the 128-byte swizzle per (chunk, tap) step, into a ring
//        with full/empty mbarriers: 160 KB (5 stages) at BN = 256, 48 KB (3
//        stages) at BN = 128, where two blocks share an SM so that one
//        block's first loads and epilogue overlap the other's products.
//      - Consumers (warpgroups 0 and 1): warpgroup g owns tile rows 8g .. 8g
//        + 7, 64 pixels x BN channels of f32 accumulators, and only issues
//        wgmma.mma_async m64nBNk16 with both operands in shared memory (SS),
//        four a tap, one commit group a tap; wait_group keeps IN_FLIGHT (1)
//        tap queued while the next is issued, and a weight stage or a halo
//        buffer goes back to the producer (one mbarrier arrival a warp) when
//        the products that read it are done. A comes from shared memory
//        because the tile is 8 pixels wide: each 8-row core matrix of A is one
//        tile row, 8 neighbouring halo pixels, and core matrices follow each
//        other at the uniform 10-pixel halo row pitch (stride byte offset 160
//        B; the 8-channel groups are the leading byte offset, 2880 B apart).
//      - Epilogue: + bias in f32, one rounding, staged in shared memory (the
//        weight ring, free once both warpgroups are done) and stored as
//        16-byte rows, masked at ragged edges.
//      Shared memory at BN = 256: the 160 KB ring, two 22.5 KB halo buffers,
//      14 mbarriers, 206 KB with 1 KB kept to align the swizzled stages to
//      1024 B: one block per SM, whose 168 registers a thread cover the 128
//      f32 accumulators without setmaxnreg. At BN = 128: 94 KB and at most
//      112 registers, two blocks per SM.
//   Why the activation is a pass of its own: the exact SiLU (accurate expf,
//   IEEE division) costs some 25 instructions an element. Done inside the
//   conv, by the consumer warps between their taps or by dedicated activator
//   warps, it did not overlap the tensor cores' work and cost 52 ms of a
//   125 ms kernel per MAGE+ generate (PERF.md), while a pass over x and h
//   costs bytes at the memory's rate, once per element.
// f32 design (the SIMT twin the f32 checks use): the same implicit GEMM on
// the CUDA cores (no TF32), one launch that activates its own halo in shared
// memory: 256 threads, each 4 pixels x 8 channels of an 8 x 16-pixel x
// 64-channel tile, fmaf.
// C and Cout must be multiples of 16 (the wrapper checks); B, H and W are any.
//
// Probe switch (gn_conv_probe.py builds variants with -D; the library is built
// without it): the bits of GN_CONV_PROBE_SKIP drop one part of the bf16 path
// to time the rest (the output is then wrong): 1 the activation pass, 2 the
// weight TMA, 4 the halo TMA, 8 the wgmma products. A dropped copy still
// arrives on its barrier, so the pipeline keeps its shape.
#include "common.cuh"
#include "hopper.cuh"  // mbarriers, TMA, wgmma; cuTensorMapEncodeTiled fetched at run time

#ifndef GN_CONV_PROBE_SKIP
#define GN_CONV_PROBE_SKIP 0
#endif

namespace {

// x * a + b as two rounded f32 operations (no contraction into an FMA) and
// silu(h) = h / (1 + exp(-h)): the same roundings as the plain PyTorch version.
__device__ __forceinline__ float affine_silu(float x, float a, float b) {
  const float h = __fadd_rn(__fmul_rn(x, a), b);
  return h / (1.0f + expf(-h));
}

// ---------------------------------------------------------------- bf16 ----

constexpr int SKIP = GN_CONV_PROBE_SKIP;
constexpr int RING_BYTES = 160 * 1024;        // the weight ring at BN = 256
constexpr int RING_SMALL_BYTES = 48 * 1024;   // and at BN = 128
constexpr int IN_FLIGHT = 1;  // taps of wgmma a warpgroup keeps queued (2 measured slower)
constexpr int QR = 16;                  // output rows of a block tile
constexpr int QC = 8;                   // output columns of a block tile
constexpr int QHC = QC + 2;             // halo columns (10)
constexpr int HALO_PX = (QR + 2) * QHC;  // halo pixels (180)
constexpr int KC = 64;                  // channels of one chunk
constexpr int KG = KC / 8;              // its 8-channel groups
constexpr int WG_ROWS = QR / 2;         // tile rows of one consumer warpgroup
constexpr int HALO_KG = HALO_PX * 16;   // bytes of one 8-channel group plane (2880)
constexpr int HALO_BYTES = KG * HALO_KG;  // one activated halo box
constexpr int CONSUMERS = 256;          // two warpgroups of products
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int ACT_THREADS = 256;        // threads of an activation block (one 8-channel
                                        // group of 256 pixels)

template <int BN>
struct Layout {
  // BN = 128 keeps a 48 KB ring so that two blocks share an SM: one block's
  // first loads and epilogue overlap the other's products
  static constexpr int BLOCKS_PER_SM = BN == 128 ? 2 : 1;
  static constexpr int W_STAGE = BN * KC * 2;
  static constexpr int STAGES = (BN == 128 ? RING_SMALL_BYTES : RING_BYTES) / W_STAGE;
  static constexpr int HALO_OFF = STAGES * W_STAGE;
  static constexpr int BAR_OFF = HALO_OFF + 2 * HALO_BYTES;
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 4) * 8;
  static constexpr int SMEM = BYTES + 1024;  // room to align the base to 1024 B
  static constexpr int OUT_PITCH = BN + 8;   // staged output row (elements)
  static_assert(IN_FLIGHT >= 1 && IN_FLIGHT < STAGES, "a stage must be free to load");
  static_assert(QR * QC * OUT_PITCH * 2 <= STAGES * W_STAGE, "output tile must fit");
  static_assert(SMEM <= 232448, "more shared memory than a block may use");
  static_assert(SMEM * BLOCKS_PER_SM <= 233472 - 1024 * BLOCKS_PER_SM,
                "more shared memory than the blocks of an SM may use");
};

using mage::mbar_arrive;
using mage::mbar_expect_tx;
using mage::mbar_init;
using mage::mbar_wait;
using mage::named_sync;
using mage::smem_addr;
using mage::smem_desc;
using mage::tma_load_3d;
using mage::tma_load_5d;
using mage::wgmma_commit;
using mage::wgmma_fence;
using mage::wgmma_m64n128;
using mage::wgmma_m64n256;
using mage::wgmma_wait;

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_tile<256>(float (&d)[128], uint64_t da, uint64_t db) {
  wgmma_m64n256(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_tile<128>(float (&d)[64], uint64_t da, uint64_t db) {
  wgmma_m64n128(d, da, db);
}

struct Bf16Args {
  const float* a;
  const float* b;
  const float* bias;
  __nv_bfloat16* out;
  int H, W, C, Cout, tiles_x, tiles_y, n_tiles;
};

// h[n][g][y][x][:] = round_to_bf16(silu(x[n][y][x][8g .. 8g + 7] * a + b)): one
// 16-byte vector a thread; a block owns one 8-channel group of 256 pixels,
// so its stores are one contiguous 4 KB run, and neighbouring blocks take
// the other groups of the same pixels (their loads share L2 sectors)
__global__ void __launch_bounds__(ACT_THREADS)
gn_act_bf16(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
            const float* __restrict__ b, __nv_bfloat16* __restrict__ h, int hw, int C) {
  const int groups = C / 8, tiles = (hw + ACT_THREADS - 1) / ACT_THREADS;
  const int g = blockIdx.x % groups, img = blockIdx.x / groups / tiles;
  const int px = (blockIdx.x / groups) % tiles * ACT_THREADS + threadIdx.x;
  if (px >= hw) return;
  const size_t row = static_cast<size_t>(img) * C + 8 * g;
  const float4 a0 = __ldg(reinterpret_cast<const float4*>(a + row));
  const float4 a1 = __ldg(reinterpret_cast<const float4*>(a + row + 4));
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(b + row));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(b + row + 4));
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
      x + (static_cast<size_t>(img) * hw + px) * C + 8 * g));
  const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint32_t hv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 xf = __bfloat1622float2(xv[k]);
    const __nv_bfloat162 h2 =
        __floats2bfloat162_rn(affine_silu(xf.x, av[2 * k], bv[2 * k]),
                              affine_silu(xf.y, av[2 * k + 1], bv[2 * k + 1]));
    hv[k] = *reinterpret_cast<const uint32_t*>(&h2);
  }
  *reinterpret_cast<uint4*>(h + ((static_cast<size_t>(img) * groups + g) * hw + px) * 8) =
      make_uint4(hv[0], hv[1], hv[2], hv[3]);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, Layout<BN>::BLOCKS_PER_SM)
gn_conv_bf16(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap wmap,
             Bf16Args p) {
  using L = Layout<BN>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t w_smem = base, halo_smem = base + L::HALO_OFF, bars = base + L::BAR_OFF;
  auto w_full = [&](int i) { return bars + 8 * i; };
  auto w_empty = [&](int i) { return bars + 8 * (STAGES + i); };
  auto halo_full = [&](int j) { return bars + 8 * (2 * STAGES + j); };
  auto halo_empty = [&](int j) { return bars + 8 * (2 * STAGES + 2 + j); };

  // channel tiles vary fastest: neighbouring blocks share a halo in L2
  int s = blockIdx.x;
  const int n0 = (s % p.n_tiles) * BN;
  s /= p.n_tiles;
  const int x0 = (s % p.tiles_x) * QC;
  s /= p.tiles_x;
  const int y0 = (s % p.tiles_y) * QR;
  const int img = s / p.tiles_y;
  const int chunks = (p.C + KC - 1) / KC;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(w_full(i), 1);
      mbar_init(w_empty(i), CONSUMER_WARPS);
    }
    for (int j = 0; j < 2; ++j) {
      mbar_init(halo_full(j), 1);
      mbar_init(halo_empty(j), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;

  if (threadIdx.x >= CONSUMERS) {
    // ---------------------------------------------------- producer ----
    if (lane != 0) return;
    // chunk ch's activated halo goes to buffer ch % 2 once the products of
    // chunk ch - 2 are done (released at tap IN_FLIGHT - 1 of chunk ch - 1)
    auto load_halo = [&](int ch) {
      const int j = ch & 1;
      mbar_wait(halo_empty(j), ((ch >> 1) & 1) ^ 1);
      if (SKIP & 4) {
        mbar_arrive(halo_full(j));
      } else {
        mbar_expect_tx(halo_full(j), HALO_BYTES);
        tma_load_5d(halo_smem + j * HALO_BYTES, &hmap, halo_full(j), 0, x0 - 1, y0 - 1,
                    ch * KG, img);
      }
    };
    load_halo(0);
    for (int ch = 0; ch < chunks; ++ch) {
      for (int t = 0; t < 9; ++t) {
        const int step = 9 * ch + t, stage = step % STAGES;
        mbar_wait(w_empty(stage), ((step / STAGES) & 1) ^ 1);
        if (SKIP & 2) {
          mbar_arrive(w_full(stage));
        } else {
          mbar_expect_tx(w_full(stage), L::W_STAGE);
          tma_load_3d(w_smem + stage * L::W_STAGE, &wmap, w_full(stage), ch * KC, t, n0);
        }
        if (t == IN_FLIGHT - 1 && ch + 1 < chunks) load_halo(ch + 1);
      }
    }
  } else {
    // ----------------------------------------------------- consumers ----
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    // a warp's lanes are done with a buffer: one arrival for the warp
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    // step = 9 * chunk + tap walks the weight ring: stage step % STAGES
#pragma unroll 1
    for (int ch = 0; ch < chunks; ++ch) {
      mbar_wait(halo_full(ch & 1), (ch >> 1) & 1);
      // this warpgroup's tile rows start at halo row 8 * wg
      const uint32_t a_chunk = halo_smem + (ch & 1) * HALO_BYTES + wg * WG_ROWS * QHC * 16;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int step = 9 * ch + t, stage = step % STAGES;
        mbar_wait(w_full(stage), (step / STAGES) & 1);
        if (!(SKIP & 8)) {
          const uint32_t a_tap = a_chunk + ((t / 3) * QHC + t % 3) * 16;
          const uint32_t b_tap = w_smem + stage * L::W_STAGE;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KC / 16; ++kk)
            wgmma_tile<BN>(acc, smem_desc(a_tap + 2 * kk * HALO_KG, HALO_KG, QHC * 16, 0),
                           smem_desc(b_tap + 32 * kk, 16, 1024, 1));
          wgmma_commit();
          wgmma_wait<IN_FLIGHT>();  // the products of step - IN_FLIGHT are done
        }
        if (step >= IN_FLIGHT) release(w_empty((step - IN_FLIGHT) % STAGES));
        // the previous chunk's products are all done: its halo buffer goes
        // back to the producer
        if (t == IN_FLIGHT - 1 && ch > 0) release(halo_empty((ch - 1) & 1));
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[i]) :: "memory");

    // epilogue: + bias in f32, one rounding, staged in the weight ring (free
    // once both warpgroups' products are done) and stored as 16-byte rows
    named_sync(1, CONSUMERS);
    __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem);  // [QR * QC][OUT_PITCH]
    const int warp = tid / 32;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j * 8 + (lane % 4) * 2, n = n0 + col;
      const float b0 = n < p.Cout ? p.bias[n] : 0.f;
      const float b1 = n + 1 < p.Cout ? p.bias[n + 1] : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int px = wg * 64 + warp * 16 + lane / 4 + 8 * half;
        *reinterpret_cast<__nv_bfloat162*>(cs + px * L::OUT_PITCH + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * half] + b0, acc[4 * j + 2 * half + 1] + b1);
      }
    }
    named_sync(1, CONSUMERS);
    for (int e = threadIdx.x; e < QR * QC * (BN / 8); e += CONSUMERS) {
      const int px = e / (BN / 8), v = e % (BN / 8);
      const int yy = y0 + px / QC, xx = x0 + px % QC, n = n0 + v * 8;
      if (yy < p.H && xx < p.W && n < p.Cout)
        *reinterpret_cast<uint4*>(
            p.out + ((static_cast<size_t>(img) * p.H + yy) * p.W + xx) * p.Cout + n) =
            *reinterpret_cast<const uint4*>(cs + px * L::OUT_PITCH + v * 8);
    }
  }
}

// ----------------------------------------------------------------- f32 ----

constexpr int TR = 8;                   // output rows of a block tile
constexpr int TC = 16;                  // output columns of a block tile
constexpr int HC = TC + 2;              // halo columns
constexpr int HP = (TR + 2) * HC;       // halo pixels (180)
constexpr int FBN = 64;                 // output channels of a block
constexpr int FKC = 8;                  // input channels of one chunk
constexpr int FT = 256;                 // threads

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

// ------------------------------------------------------------------ host ----

template <int BN>
int launch_bf16(const void* x, void* h, const void* w, const Bf16Args& args, int batch,
                cudaStream_t stream) {
  const mage::EncodeTiled encode = mage::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int hw = args.H * args.W, groups = args.C / 8;
  if (!(SKIP & 1)) {
    const unsigned blocks =
        static_cast<unsigned>(batch) * groups * ((hw + ACT_THREADS - 1) / ACT_THREADS);
    gn_act_bf16<<<blocks, ACT_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), args.a, args.b, static_cast<__nv_bfloat16*>(h),
        hw, args.C);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cuuint64_t C = args.C, W = args.W, H = args.H, G = groups;
  CUtensorMap hmap, wmap;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  // h (B, C / 8, H, W, 8) as (8, W, H, C / 8, B); box 8 channels x 10 columns
  // x 18 rows x 8 groups x 1 image: the halo lands as [group][row][column][8]
  const cuuint64_t hdim[5] = {8, W, H, G, static_cast<cuuint64_t>(batch)};
  const cuuint64_t hstride[4] = {16, W * 16, H * W * 16, G * H * W * 16};
  const cuuint32_t hbox[5] = {8, QHC, QR + 2, KG, 1};
  CUresult r = encode(&hmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, h, hdim, hstride, hbox, ones,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  // w (Cout, 9 * C) as (C, 9, Cout); box 64 channels x 1 tap x BN rows, swizzled
  const cuuint64_t wdim[3] = {C, 9, static_cast<cuuint64_t>(args.Cout)};
  const cuuint64_t wstride[2] = {C * 2, 9 * C * 2};
  const cuuint32_t wbox[3] = {KC, 1, BN};
  r = encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), wdim, wstride,
             wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);

  constexpr int smem = Layout<BN>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(gn_conv_bf16<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks =
      static_cast<unsigned>(batch) * args.tiles_y * args.tiles_x * args.n_tiles;
  gn_conv_bf16<BN><<<blocks, THREADS, smem, stream>>>(hmap, wmap, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (batch, H, W, C) and w (Cout, 9 * C) [w[o][(dy*3+dx)*C + c]] in one dtype;
// a, b (batch, C), bias (Cout,) and the f32 output or the bf16 out (batch, H,
// W, Cout); for bf16, h is scratch of batch * H * W * C elements for the
// activated input (unused for f32). All contiguous and 16-byte aligned; C and
// Cout multiples of 16.
extern "C" int mage_gn_silu_conv3x3(const void* x, const void* a, const void* b,
                                    const void* w, const void* bias, void* out, void* h,
                                    int batch, int H, int W, int C, int Cout, int dtype,
                                    void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0 || Cout <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  auto fa = static_cast<const float*>(a);
  auto fb = static_cast<const float*>(b);
  auto fbias = static_cast<const float*>(bias);
  if (dtype == mage::kBFloat16) {
    const int bn = Cout >= 256 ? 256 : 128;
    const Bf16Args args{fa, fb, fbias, static_cast<__nv_bfloat16*>(out), H, W, C, Cout,
                        (W + QC - 1) / QC, (H + QR - 1) / QR, (Cout + bn - 1) / bn};
    return bn == 256 ? launch_bf16<256>(x, h, w, args, batch, s)
                     : launch_bf16<128>(x, h, w, args, batch, s);
  }
  const int tiles_x = (W + TC - 1) / TC, tiles_y = (H + TR - 1) / TR;
  const int n_tiles = (Cout + FBN - 1) / FBN;
  const unsigned blocks = static_cast<unsigned>(batch) * tiles_y * tiles_x * n_tiles;
  gn_conv_f32<<<blocks, FT, 0, s>>>(
      static_cast<const float*>(x), fa, fb, static_cast<const float*>(w), fbias,
      static_cast<float*>(out), H, W, C, Cout, tiles_x, tiles_y, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
