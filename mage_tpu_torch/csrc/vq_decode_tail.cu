// The VQ-VAE f8 decoder's last 3x3 conv, its residual, the ReLU, the 1x1
// output conv and the tanh, in one launch.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses the pointwise tail into the conv on the TPU. It was added because the
// port's layer chain (cuDNN's conv, then PyTorch's elementwise kernels) wrote
// and read back several 256-channel tensors at 128 px to make a 3-channel
// frame: at 288 frames in bf16 one such tensor is 2.42 GB. For h (B, H, W, C)
// NHWC (the last DecoderBlock's block[5] output), x (B, H / 2, W / 2, Cout)
// NHWC (the block's input, which is its id path) and the weights of
// block[7] (w7 (Cout, C, 3, 3), b7) and decoder[8] (w8 (O, Cout, 1, 1), b8):
//   s[n,y,x,o] = sum_{dy,dx,c} relu(h)[n,y+dy-1,x+dx-1,c] * w7[o,c,dy,dx]
//   r = relu((s + b7[o]) + x[n, y / 2, x / 2, o])          (nearest 2x upsample)
//   out[n,y,x,k] = round_to_bf16(tanh(sum_o r[o] * w8[k,o] + b8[k]))
// with zero padding around relu(h). Products accumulate in f32; the bias, the
// residual, the ReLU, the Cout -> O product and the tanh are f32, with one
// rounding at the end. Only the O-channel frames reach device memory. The
// widths are the f8 decoder's at dim 256, the only ones that run it: C = 64,
// Cout = 256, O = 3.
//
// Bound: at 288 frames of 128 px the conv is 1.39 TFLOP on the tensor cores
// (1.41 ms at 989 TFLOP/s dense bf16) against about 1.23 GB read and written
// (0.37 ms at 3.35 TB/s): bound by operations.
//
// Design, for sm_90a (bf16 only): gn_conv.cu's implicit GEMM, M = output
// pixels, N = Cout, K = 9 * C, made persistent. One block a streaming
// multiprocessor (288 threads) walks its share of 16 x 8-pixel tiles; a block
// owns all 256 output channels of a tile, so a pixel's whole Cout -> O
// product happens inside the block, and C = 64 is one chunk of nine taps.
//   - Producer (one thread of warp 8): TMA copies only, running ahead across
//     tiles. Each tile's halo, (16 + 2) x (8 + 2) pixels x 64 channels, comes
//     straight from h through a 5-D tensor map over the (8, W, H, C / 8, B)
//     view of NHWC h (strides 2C, 2WC, 16 and 2HWC bytes), box (8, 10, 18, 8,
//     1): it lands as [8-channel group][row][column][8], the no-swizzle
//     K-major layout a wgmma descriptor reads, into one of two buffers; TMA
//     zero-fills outside the image, which is the conv's padding (relu(0) =
//     0). The weight, packed (Cout, 9 * C), comes through a 3-D map over its
//     (C, 9, Cout) view, a box of 64 channels x 1 tap x 256 rows with the
//     128-byte swizzle per tap, into a 5-stage ring with full/empty
//     mbarriers. The step counter runs on from tile to tile, so the next
//     tile's halo and first weight stages load during this tile's epilogue.
//   - Consumers (warpgroups 0 and 1): once a halo has landed they apply the
//     ReLU to it in shared memory (bf16 max with 0, NaN kept), fence it to
//     the async proxy and meet at a named barrier; then warpgroup g issues
//     wgmma.mma_async m64n256k16 over tile rows 8g .. 8g + 7, four a tap, one
//     commit group a tap, one tap kept in flight, releasing each weight stage
//     and halo buffer once the products that read it are done (as gn_conv).
//     (An activation pass of its own, gn_conv's design, writing relu(h) once
//     in the halo layout, measured 0.4 ms slower at 288 frames on an H100.)
//   - Epilogue, from the accumulators: a thread holds 2 pixels (tile rows 2w
//     and 2w + 1 of its warp, one column) x 64 channels, and the 4 threads of
//     a quad hold all 256 channels of the same two pixels, which share one
//     pixel of x at half resolution. Each thread adds b7 and x (32 bf16
//     pairs read from global memory, shared by both pixels), applies the
//     ReLU and takes its 64 channels' share of the 3 sums against w8 (b7
//     and w8 in f32 in shared memory, laid out by channel pair so a quad
//     reads 128 contiguous bytes); two xor shuffles finish the sums in the
//     quad; + b8, tanh, and two lanes of the quad store the two pixels' 3
//     values, masked at ragged edges.
//   Shared memory: the 160 KB ring, two 22.5 KB halo buffers, the epilogue's
//   b7 and w8 (4 KB), 14 mbarriers and 1 KB to align the swizzled stages:
//   about 211 KB, one block an SM.
// H and W must be even; B, H and W are otherwise any.
#include "common.cuh"
#include "hopper.cuh"  // mbarriers, TMA, wgmma; cuTensorMapEncodeTiled fetched at run time

namespace {

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
using mage::wgmma_m64n256;
using mage::wgmma_wait;

constexpr int C = 64;                   // channels of h: one chunk of nine taps
constexpr int BN = 256;                 // Cout: all output channels in one block
constexpr int O = 3;                    // output channels of the 1x1 conv
constexpr int STAGES = 5;               // weight ring stages
constexpr int IN_FLIGHT = 1;            // taps of wgmma a warpgroup keeps queued
constexpr int QR = 16;                  // output rows of a tile
constexpr int QC = 8;                   // output columns of a tile
constexpr int QHC = QC + 2;             // halo columns (10)
constexpr int HALO_PX = (QR + 2) * QHC;  // halo pixels (180)
constexpr int KG = C / 8;               // 8-channel groups of h
constexpr int WG_ROWS = QR / 2;         // tile rows of one consumer warpgroup
constexpr int HALO_KG = HALO_PX * 16;   // bytes of one 8-channel group plane (2880)
constexpr int HALO_BYTES = KG * HALO_KG;  // one halo box
constexpr int CONSUMERS = 256;          // two warpgroups of products
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int W_STAGE = BN * C * 2;
constexpr int HALO_OFF = STAGES * W_STAGE;
constexpr int PRM_OFF = HALO_OFF + 2 * HALO_BYTES;
constexpr int PRM_BYTES = (BN / 2) * 8 * 4;  // per channel pair: b7 and w8's 3 rows, as float2
constexpr int BAR_OFF = PRM_OFF + PRM_BYTES;
constexpr int SMEM = BAR_OFF + (2 * STAGES + 4) * 8 + 1024;
static_assert(IN_FLIGHT >= 1 && IN_FLIGHT < STAGES, "a stage must be free to load");
static_assert(SMEM <= 232448, "more shared memory than a block may use");

struct Args {
  const __nv_bfloat16* x;   // (B, H / 2, W / 2, 256): the id path
  const float* b7;          // (256,) f32
  const __nv_bfloat16* w8;  // (3, 256)
  const __nv_bfloat16* b8;  // (3,)
  __nv_bfloat16* out;       // (B, H, W, 3)
  int H, W, tiles_x, tiles_y, n_tiles;
};

struct TileAt {
  int img, y0, x0;
};

__device__ __forceinline__ TileAt tile_at(int tile, const Args& p) {
  TileAt t;
  t.x0 = (tile % p.tiles_x) * QC;  // columns vary fastest: neighbours share a halo in L2
  tile /= p.tiles_x;
  t.y0 = (tile % p.tiles_y) * QR;
  t.img = tile / p.tiles_y;
  return t;
}

__global__ void __launch_bounds__(THREADS, 1)
vq_tail_bf16(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap wmap,
             Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t w_smem = base, halo_smem = base + HALO_OFF, bars = base + BAR_OFF;
  auto w_full = [&](int i) { return bars + 8 * i; };
  auto w_empty = [&](int i) { return bars + 8 * (STAGES + i); };
  auto halo_full = [&](int j) { return bars + 8 * (2 * STAGES + j); };
  auto halo_empty = [&](int j) { return bars + 8 * (2 * STAGES + 2 + j); };

  // this block's tiles: blockIdx.x, + gridDim.x, ...; the it-th of them is
  // tile blockIdx.x + it * gridDim.x
  const int my_tiles = (p.n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;

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
    // tile it's halo goes to buffer it % 2 once the products of tile it - 2
    // are done (released at tap IN_FLIGHT - 1 of tile it - 1)
    auto load_halo = [&](int it) {
      const int j = it & 1;
      const TileAt t = tile_at(blockIdx.x + it * gridDim.x, p);
      mbar_wait(halo_empty(j), ((it >> 1) & 1) ^ 1);
      mbar_expect_tx(halo_full(j), HALO_BYTES);
      tma_load_5d(halo_smem + j * HALO_BYTES, &hmap, halo_full(j), 0, t.x0 - 1, t.y0 - 1, 0,
                  t.img);
    };
    load_halo(0);
    for (int it = 0; it < my_tiles; ++it) {
      for (int t = 0; t < 9; ++t) {
        const int step = 9 * it + t, stage = step % STAGES;
        mbar_wait(w_empty(stage), ((step / STAGES) & 1) ^ 1);
        mbar_expect_tx(w_full(stage), W_STAGE);
        tma_load_3d(w_smem + stage * W_STAGE, &wmap, w_full(stage), 0, t, 0);
        if (t == IN_FLIGHT - 1 && it + 1 < my_tiles) load_halo(it + 1);
      }
    }
    return;
  }

  // ------------------------------------------------------- consumers ----
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, quad = lane % 4;
  // a warp's lanes are done with a buffer: one arrival for the warp
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  // the epilogue's parameters, f32, by channel pair q: {b7, w8[0], w8[1],
  // w8[2]} at channels 2q, 2q + 1
  float2* prm = reinterpret_cast<float2*>(smem + PRM_OFF);
  for (int q = threadIdx.x; q < BN / 2; q += CONSUMERS) {
    prm[4 * q] = make_float2(p.b7[2 * q], p.b7[2 * q + 1]);
#pragma unroll
    for (int k = 0; k < O; ++k)
      prm[4 * q + 1 + k] = make_float2(__bfloat162float(p.w8[k * BN + 2 * q]),
                                       __bfloat162float(p.w8[k * BN + 2 * q + 1]));
  }
  float b8[O];
#pragma unroll
  for (int k = 0; k < O; ++k) b8[k] = __bfloat162float(p.b8[k]);
  named_sync(1, CONSUMERS);

  float acc[BN / 2];
  const int Hx = p.H / 2, Wx = p.W / 2;

#pragma unroll 1
  for (int it = 0; it < my_tiles; ++it) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const int j = it & 1;
    mbar_wait(halo_full(j), (it >> 1) & 1);
    // relu in place, handed to the async proxy before either warpgroup's
    // products read the buffer
    uint4* buf = reinterpret_cast<uint4*>(smem + HALO_OFF + j * HALO_BYTES);
    const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
    for (int i = threadIdx.x; i < HALO_BYTES / 16; i += CONSUMERS) {
      uint4 v = buf[i];
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k) e[k] = __hmax2_nan(e[k], zero);
      buf[i] = v;
    }
    mage::fence_proxy_async();
    named_sync(2, CONSUMERS);
    // this warpgroup's tile rows start at halo row 8 * wg
    const uint32_t a_tile = halo_smem + j * HALO_BYTES + wg * WG_ROWS * QHC * 16;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int step = 9 * it + t, stage = step % STAGES;
      mbar_wait(w_full(stage), (step / STAGES) & 1);
      const uint32_t a_tap = a_tile + ((t / 3) * QHC + t % 3) * 16;
      const uint32_t b_tap = w_smem + stage * W_STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        wgmma_m64n256(acc, smem_desc(a_tap + 2 * kk * HALO_KG, HALO_KG, QHC * 16, 0),
                      smem_desc(b_tap + 32 * kk, 16, 1024, 1));
      wgmma_commit();
      wgmma_wait<IN_FLIGHT>();  // the products of step - IN_FLIGHT are done
      if (step >= IN_FLIGHT) release(w_empty((step - IN_FLIGHT) % STAGES));
      // the previous tile's products are all done: its halo buffer goes back
      if (t == IN_FLIGHT - 1 && it > 0) release(halo_empty((it - 1) & 1));
    }
    wgmma_wait<0>();
    mage::wgmma_pin(acc);

    // ------------------------------------------------------ epilogue ----
    // accumulator rows warp * 16 + lane / 4 (+ 8) are tile rows 8 wg + 2 warp
    // (+ 1), column lane / 4; columns 8 jj + 2 quad (+ 1) are channels
    const TileAt tl = tile_at(blockIdx.x + it * gridDim.x, p);
    const int xx = tl.x0 + lane / 4, ya = tl.y0 + WG_ROWS * wg + 2 * warp;
    const bool in_a = ya < p.H && xx < p.W, in_b = ya + 1 < p.H && xx < p.W;
    const __nv_bfloat16* xp =
        p.x + ((static_cast<size_t>(tl.img) * Hx + ya / 2) * Wx + xx / 2) * BN + 2 * quad;
    float sa[O], sb[O];
#pragma unroll
    for (int k = 0; k < O; ++k) sa[k] = sb[k] = 0.f;
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const int q = 4 * jj + quad;  // channels 2q, 2q + 1
      float2 xv = make_float2(0.f, 0.f);
      if (in_a)
        xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xp + 8 * jj));
      const float4 pr0 = *reinterpret_cast<const float4*>(prm + 4 * q);
      const float4 pr1 = *reinterpret_cast<const float4*>(prm + 4 * q + 2);
      const float w[3][2] = {{pr0.z, pr0.w}, {pr1.x, pr1.y}, {pr1.z, pr1.w}};
      const float ra0 = fmaxf(__fadd_rn(__fadd_rn(acc[4 * jj], pr0.x), xv.x), 0.f);
      const float ra1 = fmaxf(__fadd_rn(__fadd_rn(acc[4 * jj + 1], pr0.y), xv.y), 0.f);
      const float rb0 = fmaxf(__fadd_rn(__fadd_rn(acc[4 * jj + 2], pr0.x), xv.x), 0.f);
      const float rb1 = fmaxf(__fadd_rn(__fadd_rn(acc[4 * jj + 3], pr0.y), xv.y), 0.f);
#pragma unroll
      for (int k = 0; k < O; ++k) {
        sa[k] = fmaf(ra1, w[k][1], fmaf(ra0, w[k][0], sa[k]));
        sb[k] = fmaf(rb1, w[k][1], fmaf(rb0, w[k][0], sb[k]));
      }
    }
#pragma unroll
    for (int k = 0; k < O; ++k) {
      sa[k] += __shfl_xor_sync(0xffffffffu, sa[k], 1);
      sa[k] += __shfl_xor_sync(0xffffffffu, sa[k], 2);
      sb[k] += __shfl_xor_sync(0xffffffffu, sb[k], 1);
      sb[k] += __shfl_xor_sync(0xffffffffu, sb[k], 2);
    }
    // lane 0 of the quad stores the upper pixel, lane 1 the lower one
    if (quad < 2 && (quad == 0 ? in_a : in_b)) {
      __nv_bfloat16* dst =
          p.out + ((static_cast<size_t>(tl.img) * p.H + ya + quad) * p.W + xx) * O;
#pragma unroll
      for (int k = 0; k < O; ++k)
        dst[k] = __float2bfloat16(tanhf(__fadd_rn(quad == 0 ? sa[k] : sb[k], b8[k])));
    }
  }
}

}  // namespace

// h (batch, H, W, 64), x (batch, H / 2, W / 2, 256), w7 packed (256, 9 * 64)
// [w7[o][(dy*3+dx)*64 + c]], w8 (3, 256), b8 (3,) and the output (batch, H, W,
// 3), all bf16; b7 (256,) f32. All contiguous; h and w7 16-byte aligned, x
// 4-byte aligned; H and W even.
extern "C" int mage_vq_decode_tail(const void* h, const void* x, const void* w7, const void* b7,
                                   const void* w8, const void* b8, void* out, int batch, int H,
                                   int W, void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  if (H % 2 || W % 2) return static_cast<int>(cudaErrorInvalidValue);
  const mage::EncodeTiled encode = mage::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int tiles_x = (W + QC - 1) / QC, tiles_y = (H + QR - 1) / QR;
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(b7),
               static_cast<const __nv_bfloat16*>(w8), static_cast<const __nv_bfloat16*>(b8),
               static_cast<__nv_bfloat16*>(out), H, W, tiles_x, tiles_y,
               batch * tiles_x * tiles_y};
  const cuuint64_t cC = C, cW = W, cH = H, B = batch;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  // NHWC h read in place as (8, W, H, C / 8, B): the box lands group-major
  const cuuint64_t hdim[5] = {8, cW, cH, KG, B};
  const cuuint64_t hstride[4] = {cC * 2, cW * cC * 2, 16, cH * cW * cC * 2};
  const cuuint32_t hbox[5] = {8, QHC, QR + 2, KG, 1};
  CUtensorMap hmap, wmap;
  CUresult r = encode(&hmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(h), hdim,
                      hstride, hbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  // w7 (256, 9 * 64) as (64, 9, 256); box 64 channels x 1 tap x 256 rows, swizzled
  const cuuint64_t wdim[3] = {cC, 9, BN};
  const cuuint64_t wstride[2] = {cC * 2, 9 * cC * 2};
  const cuuint32_t wbox[3] = {C, 1, BN};
  r = encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w7), wdim, wstride,
             wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(vq_tail_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(a.n_tiles < sms ? a.n_tiles : sms);
  auto s = static_cast<cudaStream_t>(stream);
  vq_tail_bf16<<<blocks, THREADS, SMEM, s>>>(hmap, wmap, a);
  return static_cast<int>(cudaGetLastError());
}
