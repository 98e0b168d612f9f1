// Nearest codebook entry for each token: int32 ids and, when asked, the
// gathered codes.
//
// Replaces the TPU kernel mage_tpu/ops/vq.py::_vq_kernel (wrapper
// _vq_pallas). For z (N, D) and a codebook (K, D) it computes
// dist = |e|^2 - 2 z.e in f32 (no |z|^2 term, exactly as the TPU kernel and
// _vq_xla, since adding it changes the rounding), takes the row argmin with
// ties to the lowest code, writes int32 ids and, when `codes` is not null,
// copies the winning rows into codes. A null `codes` is the ids-only entry:
// the gather and its N x D write are skipped. The (N, K) distance matrix
// never reaches device memory.
//
// Two hand-written variants, picked by the caller (ops/vq.py::route) and
// checked here; neither falls back to the other:
//
// wgmma (bf16, D % 8 == 0, z and the codebook 16-byte aligned: every shape
// the main path gives it). The products of two bf16 values are exact in f32,
// so bf16 tensor cores with f32 accumulators do the work of the f32 math of
// _vq_kernel; only the order of the sums differs.
//   - A CTA owns 64 token rows (one wgmma M) and walks all K codes in chunks
//     of 512: warpgroup w takes codes [512c + 256w, 512c + 256w + 256) with
//     m64n256k16 products, so at N = 8192 the grid is 128 CTAs, one wave on
//     132 SMs, with no cross-CTA merge.
//   - TMA feeds a ring of 3 stages of 72 KB in shared memory: the z box
//     (64 rows x 64 k) and the two warpgroups' codebook boxes (256 codes x 64
//     k), all with the 128-byte swizzle that wgmma reads. Boxes past N, K or
//     D arrive as zeros. Each warpgroup's thread 0 counts the slot as read
//     once its wgmma.wait says so; the second of the two to finish refills
//     it, so no thread waits on the other warpgroup.
//   - The argmin is the accumulators' epilogue: per chunk each thread folds
//     its 2 rows x 64 codes into a running (min, argmin), visiting codes in
//     increasing order with a strict '<'; then the 4 lanes of a quad and the
//     two warpgroups merge, taking the lower code on an equal distance.
//   - Bounds at (8192, 512, 1024) on an H100 SXM: 2NKD = 8.6 GFLOP, 8.7 us
//     at 989 TFLOP/s; 34.6 MB with codes (z in, codes out, the codebook, the
//     ids), 10.3 us at 3.35 TB/s, so 0.0103 ms set by bytes; ids-only 17.9 MB,
//     5.3 us, so 0.0087 ms set by operations. What sets the pace is neither
//     (an estimate, not split by measurement): every CTA streams the whole
//     1 MB codebook and its 128 KB of z from L2, about 147 MB in all, 21-27
//     us at the 5.5-7 TB/s L2 gives, while HBM sees each byte once and the
//     products take 9 us a CTA under the stream. A 2-CTA cluster multicasting
//     the codebook boxes would halve that stream.
//
// simt (f32, and bf16 shapes the tensor maps cannot take, e.g. D = 3).
// Ids stay those of a sequential f32 computation: every distance's dot
// product is summed by fmaf over d = 0 .. D-1 in order, whatever the tiling,
// so a tie between two equal rows stays a tie and f32 runs repeat bit for bit.
//   - 128 x 128 (rows x codes) tiles, 256 threads with an 8 x 8 register
//     tile each, 16-deep stages double-buffered in shared memory (the next
//     stage's loads in registers while this one is multiplied; one barrier a
//     stage; 16 deep halves the barriers and loop turns of 8 deep), f32
//     operands as 16-byte loads from row pointers set once.
//   - The codebook is split across CTAs (N = 8192, K = 512: 64 x 4 = 256
//     CTAs, two an SM). Each CTA's per-row best goes to a 64-bit atomicMin
//     on the key (order-preserving uint32 of dist) << 32 | code, whose order
//     is that of (dist, code): the merge is deterministic and ties go to the
//     lowest code. -0.0 is keyed as +0.0, so key and '<' agree on a tie. The
//     keys are reset on the call's stream before the launch; a last small
//     kernel turns them into ids and gathers the codes.
//   - Bound: 8.6 GFLOP at 67 TFLOP/s f32 = 0.128 ms, set by operations.
//   - Not taken: a 3xTF32 tensor-core screen with an exact re-check of the
//     codes near the minimum. Its hi and lo parts of two f32 operands make 4x
//     the bf16 variant's L2 stream (about 0.6 GB at 64-row tiles) and 3x its
//     products at half the rate: about 0.1-0.15 ms with the split, for the
//     dtype off the main path.
//
// |e|^2 comes from a first small kernel, once per call, for both variants.
#include "common.cuh"
#include "hopper.cuh"

namespace {

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

// (v, i) <- (ov, oi) if that is the lower distance, or the lower code at an
// equal one
__device__ __forceinline__ void take_lower(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// ------------------------------------------------ bf16, TMA and wgmma ----

namespace wg {

constexpr int ROWS = 64;                           // token rows of a CTA: one wgmma M
constexpr int HALF = 256;                          // a warpgroup's codes of a chunk: one wgmma N
constexpr int CHUNK = 2 * HALF;                    // codes of a chunk
constexpr int BK = 64;                             // k of a stage: one 128-byte swizzle row
constexpr int THREADS = 256;                       // two warpgroups, no producer warp
constexpr int A_BYTES = ROWS * BK * 2;             // the z box, 8 KB
constexpr int B_BYTES = HALF * BK * 2;             // a warpgroup's codebook box, 32 KB
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;  // 72 KB
constexpr int STAGES = 3;
// the ring, its full barriers, the slots' read counts, both warpgroups' (min,
// argmin) of each row, room to align the base to the swizzle's 1024 bytes
constexpr int SMEM = STAGES * STAGE_BYTES + STAGES * 8 + STAGES * 4 + 2 * ROWS * 8 + 1024;
static_assert(SMEM <= 232448, "the ring fits in a block's shared memory");

struct Maps {
  CUtensorMap z, cb;
};

struct Args {
  const __nv_bfloat16* cb;
  const float* cbsq;
  int32_t* idx;
  __nv_bfloat16* codes;  // null: ids only
  int n, k, d;
};

// K-major operand with the 128-byte swizzle: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return mage::smem_desc(addr, 16, 1024, 1);
}

__global__ void __launch_bounds__(THREADS, 1)
vq_wgmma(const __grid_constant__ Maps maps, const Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (mage::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring = mage::smem_addr(smem);
  const uint32_t bars = ring + STAGES * STAGE_BYTES;
  unsigned* reads = reinterpret_cast<unsigned*>(smem + STAGES * STAGE_BYTES + STAGES * 8);
  float* best_v = reinterpret_cast<float*>(reads + STAGES);  // [2][ROWS]
  int* best_i = reinterpret_cast<int*>(best_v + 2 * ROWS);   // [2][ROWS]

  const int wgi = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * ROWS;
  const int nkb = (p.d + BK - 1) / BK;
  const int total = (p.k + CHUNK - 1) / CHUNK * nkb;  // stages: chunk-major, then k
  auto full = [&](int s) { return bars + 8 * (s % STAGES); };
  auto slot = [&](int s) { return ring + (s % STAGES) * STAGE_BYTES; };
  auto load = [&](int s) {  // one thread
    if (s >= total) return;
    const int c0 = s / nkb * CHUNK, k0 = s % nkb * BK;
    mage::mbar_expect_tx(full(s), STAGE_BYTES);  // boxes past the edges count in full
    mage::tma_load_2d(slot(s), &maps.z, full(s), k0, row0);
    mage::tma_load_2d(slot(s) + A_BYTES, &maps.cb, full(s), k0, c0);
    mage::tma_load_2d(slot(s) + A_BYTES + B_BYTES, &maps.cb, full(s), k0, c0 + HALF);
  };
  // a warpgroup has read slot s: the second of the two to get here refills it
  auto release = [&](int s) {
    if (threadIdx.x % 128 != 0) return;
    __threadfence_block();
    if (atomicAdd(&reads[s % STAGES], 1u) & 1u) load(s + STAGES);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mage::mbar_init(full(i), 1);
      reads[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < STAGES; ++s) load(s);

  float acc[128];
  float bv[2] = {INFINITY, INFINITY};  // rows r and r + 8 of this thread
  int bi[2] = {0, 0};
  const uint32_t b_off = A_BYTES + wgi * B_BYTES;
  int step = 0;
#pragma unroll 1
  for (int c0 = 0; c0 < p.k; c0 += CHUNK) {
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int kb = 0; kb < nkb; ++kb, ++step) {
      mage::mbar_wait(full(step), (step / STAGES) & 1);
      const uint32_t a = slot(step), b = a + b_off;
      mage::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mage::wgmma_m64n256(acc, desc(a + 32 * kk), desc(b + 32 * kk));
      mage::wgmma_commit();
      mage::wgmma_wait<1>();  // the previous stage's products are done
      if (kb > 0) release(step - 1);
    }
    mage::wgmma_wait<0>();
    mage::wgmma_pin(acc);
    release(step - 1);
    // thread (warp, lane) holds rows 16 warp + lane / 4 (+ 8) and, per j,
    // codes 8 j + 2 (lane % 4) + {0, 1} of its warpgroup's 256: increasing
    const int code0 = c0 + wgi * HALF + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < HALF / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int code = code0 + 8 * j + e;
        if (code < p.k) {
          const float sq = __ldg(p.cbsq + code);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float dist = sq - 2.0f * acc[4 * j + 2 * h + e];
            if (dist < bv[h]) {
              bv[h] = dist;
              bi[h] = code;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = bv[h];
    int i = bi[h];
#pragma unroll
    for (int o = 1; o < 4; o <<= 1)  // the quad
      take_lower(v, i, __shfl_xor_sync(0xffffffffu, v, o), __shfl_xor_sync(0xffffffffu, i, o));
    if (lane % 4 == 0) {
      const int r = 16 * warp + lane / 4 + 8 * h;
      best_v[wgi * ROWS + r] = v;
      best_i[wgi * ROWS + r] = i;
    }
  }
  __syncthreads();
  const int rows = min(ROWS, p.n - row0);
  if (threadIdx.x < ROWS) {  // the two warpgroups
    const int r = threadIdx.x;
    float v = best_v[r];
    int i = best_i[r];
    take_lower(v, i, best_v[ROWS + r], best_i[ROWS + r]);
    best_i[r] = i;
    if (r < rows) p.idx[row0 + r] = i;
  }
  if (p.codes == nullptr) return;
  __syncthreads();
  const int vecs = p.d / 8;  // 16-byte vectors of a row
  for (int e = threadIdx.x; e < rows * vecs; e += THREADS) {
    const int r = e / vecs, v = e % vecs;
    const uint4 val =
        __ldg(reinterpret_cast<const uint4*>(p.cb + static_cast<size_t>(best_i[r]) * p.d) + v);
    reinterpret_cast<uint4*>(p.codes + static_cast<size_t>(row0 + r) * p.d)[v] = val;
  }
}

bool takes(const void* z, const void* cb, int d) {
  return d % 8 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(cb) % 16 == 0;
}

int launch(const void* z, const void* cb, const float* cbsq, int32_t* idx, void* codes, int n,
           int k, int d, cudaStream_t stream) {
  const mage::EncodeTiled encode = mage::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  Maps maps;
  const cuuint64_t z_dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n)};
  const cuuint64_t cb_dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(k)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(d) * 2};
  const cuuint32_t z_box[2] = {BK, ROWS}, cb_box[2] = {BK, HALF}, ones[2] = {1, 1};
  CUresult r = encode(&maps.z, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(z),
                      z_dims, stride, z_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r == CUDA_SUCCESS)
    r = encode(&maps.cb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(cb), cb_dims,
               stride, cb_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(vq_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const Args a{static_cast<const __nv_bfloat16*>(cb), cbsq, idx,
               static_cast<__nv_bfloat16*>(codes), n, k, d};
  vq_wgmma<<<(n + ROWS - 1) / ROWS, THREADS, SMEM, stream>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ------------------------------------------------------- f32 SIMT (any) ----

namespace simt {

constexpr int BM = 128;  // token rows of a tile
constexpr int BN = 128;  // codes of a tile
constexpr int BD = 16;   // depth of a stage
constexpr int TM = 8;    // rows a thread: 4 from each half of the tile
constexpr int TN = 8;    // codes a thread: 4 from each half of the tile
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int PITCH = BM + 4;  // 132: 16-byte rows, transposed stores at most 2-way
constexpr int LOADS = BM * BD / THREADS;  // values of each operand a thread a stage
constexpr int VECS = LOADS / 4;  // as 16-byte f32 vectors
static_assert(BM == BN && LOADS % 4 == 0, "one load pattern for both operands");

// (order-preserving uint32 of dist) << 32 | code: the u64 order is the
// order of (dist, code)
__device__ __forceinline__ unsigned long long key(float dist, int code) {
  uint32_t u = __float_as_uint(dist);
  if (u == 0x80000000u) u = 0;  // -0.0 is +0.0, as '<' has it
  const uint32_t o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(o) << 32) | static_cast<uint32_t>(code);
}

// rows (codes) of the tile a thread's register index i holds: 4 from each half
__device__ __forceinline__ int sub(int t, int i) { return (i < 4 ? 0 : 64) + 4 * t + i % 4; }

// VEC (f32, d % 4 == 0, 16-byte aligned bases): each thread loads one
// 16-byte vector of each operand a stage, at a row pointer set once; otherwise
// LOADS bounds-checked scalars.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
vq_simt(const T* __restrict__ z, const T* __restrict__ cb, const float* __restrict__ cbsq,
        unsigned long long* __restrict__ keys, int n, int k, int d) {
  __shared__ __align__(16) float zs[2][BD][PITCH];
  __shared__ __align__(16) float cs[2][BD][PITCH];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // codes sub(tx, 0..7) of the tile
  const int ty = tid / (BN / TN);  // rows sub(ty, 0..7) of the tile
  const int row0 = blockIdx.x * BM, code0 = blockIdx.y * BN;

  // VEC: vector v = t + THREADS v' of a stage is depths 4 (v % (BD / 4)) .. + 3
  // of tile row v / (BD / 4) (a warp reads rows of 32 bytes); a thread's rows
  // are vr + (THREADS * 4 / BD) v'. Scalar: value e = t + THREADS i is (tile
  // row e / BD, depth e % BD) (a warp reads rows of 8 values).
  constexpr int ROW_STEP = THREADS * 4 / BD;
  const int vr = tid / (BD / 4), vq = 4 * (tid % (BD / 4));
  const T* zp = z + static_cast<size_t>(row0 + vr) * d + vq;
  const T* cp = cb + static_cast<size_t>(code0 + vr) * d + vq;
  float zr[LOADS], cr[LOADS];
  auto fetch = [&](int d0) {
    if constexpr (VEC) {
      const bool in_d = d0 + vq < d;  // d % 4 == 0: a vector is all in or all out
#pragma unroll
      for (int v = 0; v < VECS; ++v) {
        const size_t off = static_cast<size_t>(ROW_STEP * v) * d + d0;
        float4 zv = make_float4(0.f, 0.f, 0.f, 0.f), cv = zv;
        if (in_d && row0 + vr + ROW_STEP * v < n)
          zv = __ldg(reinterpret_cast<const float4*>(zp + off));
        if (in_d && code0 + vr + ROW_STEP * v < k)
          cv = __ldg(reinterpret_cast<const float4*>(cp + off));
        zr[4 * v] = zv.x; zr[4 * v + 1] = zv.y; zr[4 * v + 2] = zv.z; zr[4 * v + 3] = zv.w;
        cr[4 * v] = cv.x; cr[4 * v + 1] = cv.y; cr[4 * v + 2] = cv.z; cr[4 * v + 3] = cv.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const int e = tid + THREADS * i, r = e / BD, c = d0 + e % BD;
        zr[i] = row0 + r < n && c < d ? mage::to_f32(z[static_cast<size_t>(row0 + r) * d + c])
                                      : 0.f;
        cr[i] = code0 + r < k && c < d ? mage::to_f32(cb[static_cast<size_t>(code0 + r) * d + c])
                                       : 0.f;
      }
    }
  };
  // transposed into [depth][row]
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int e = tid + THREADS * i;
      const int r = VEC ? vr + ROW_STEP * (i / 4) : e / BD, c = VEC ? vq + i % 4 : e % BD;
      zs[buf][c][r] = zr[i];
      cs[buf][c][r] = cr[i];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  fetch(0);
  stash(0);
  __syncthreads();
  const int stages = (d + BD - 1) / BD;
#pragma unroll 1
  for (int s = 0; s < stages; ++s) {
    const int buf = s & 1;
    if (s + 1 < stages) fetch((s + 1) * BD);
#pragma unroll
    for (int dd = 0; dd < BD; ++dd) {  // increasing d: each sum is sequential
      const float4 a0 = *reinterpret_cast<const float4*>(&zs[buf][dd][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&zs[buf][dd][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&cs[buf][dd][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&cs[buf][dd][64 + 4 * tx]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (s + 1 < stages) stash(buf ^ 1);  // the other buffer was read a stage ago
    __syncthreads();
  }

  float bv[TM];
  int bi[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    bv[i] = INFINITY;
    bi[i] = 0;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {  // increasing code: strict '<' keeps the lowest
    const int code = code0 + sub(tx, j);
    if (code < k) {
      const float sq = cbsq[code];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float dist = sq - 2.0f * acc[i][j];
        if (dist < bv[i]) {
          bv[i] = dist;
          bi[i] = code;
        }
      }
    }
  }
  // the 16 threads of a row group are one half-warp: xor offsets < 16 stay inside it
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float v = bv[i];
    int c = bi[i];
#pragma unroll
    for (int o = (BN / TN) / 2; o > 0; o >>= 1)
      take_lower(v, c, __shfl_xor_sync(0xffffffffu, v, o), __shfl_xor_sync(0xffffffffu, c, o));
    const int row = row0 + sub(ty, i);
    if (tx == 0 && row < n && v < INFINITY) atomicMin(keys + row, key(v, c));
  }
}

// ids from the keys, and the codes when asked; one warp a row
template <typename T>
__global__ void vq_finish(const unsigned long long* __restrict__ keys, const T* __restrict__ cb,
                          int32_t* __restrict__ idx, T* __restrict__ codes, int n, int d) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= n) return;
  const unsigned long long kv = keys[row];
  const int code = kv == ~0ull ? 0 : static_cast<int>(kv & 0xffffffffu);
  if (lane == 0) idx[row] = code;
  if (codes == nullptr) return;
  const T* src = cb + static_cast<size_t>(code) * d;
  T* dst = codes + static_cast<size_t>(row) * d;
  constexpr int PER = 16 / sizeof(T);  // values of a 16-byte vector
  const uintptr_t bases = reinterpret_cast<uintptr_t>(cb) | reinterpret_cast<uintptr_t>(codes);
  if (d % PER == 0 && bases % 16 == 0) {
    for (int c = lane; c < d / PER; c += 32)
      reinterpret_cast<uint4*>(dst)[c] = __ldg(reinterpret_cast<const uint4*>(src) + c);
  } else {
    for (int c = lane; c < d; c += 32) dst[c] = src[c];
  }
}

template <typename T>
int launch(const void* z, const void* cb, const float* cbsq, unsigned long long* keys,
           int32_t* idx, void* codes, int n, int k, int d, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * n, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BM - 1) / BM, (k + BN - 1) / BN);
  const T* zt = static_cast<const T*>(z);
  const T* cbt = static_cast<const T*>(cb);
  bool vec = false;  // 16-byte f32 vectors: f32 only, so no bf16 VEC kernel is compiled
  if constexpr (sizeof(T) == 4) {
    vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(cb) % 16 == 0;
    if (vec) vq_simt<T, true><<<grid, THREADS, 0, stream>>>(zt, cbt, cbsq, keys, n, k, d);
  }
  if (!vec) vq_simt<T, false><<<grid, THREADS, 0, stream>>>(zt, cbt, cbsq, keys, n, k, d);
  vq_finish<T><<<(n + 7) / 8, 256, 0, stream>>>(keys, static_cast<const T*>(cb), idx,
                                                 static_cast<T*>(codes), n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

}  // namespace

// z (n, d), cb (k, d) of one dtype; cbsq (k,) f32 scratch, keys (n,) u64
// scratch for route 0 (null for route 1, which does not read it);
// idx (n,) int32; codes (n, d) in the codebook's dtype, or null for ids
// only. All contiguous, on one device. route 1 is the bf16 TMA / wgmma
// variant (d % 8 == 0, z and cb 16-byte aligned), route 0 the SIMT one (any
// shape, f32 or bf16); a route that cannot take the inputs returns
// cudaErrorInvalidValue without a launch.
extern "C" int mage_vq_nearest(const void* z, const void* cb, void* cbsq, void* keys, void* idx,
                               void* codes, int n, int k, int d, int dtype, int route,
                               void* stream) {
  if (k < 1 || d < 1 || (route != 0 && route != 1) || (route == 0 && keys == nullptr) ||
      (route == 1 && (dtype != mage::kBFloat16 || !wg::takes(z, cb, d))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  auto sq = static_cast<float*>(cbsq);
  auto ids = static_cast<int32_t*>(idx);
  const int sq_threads = 256;
  const int sq_blocks = (k * 32 + sq_threads - 1) / sq_threads;
  if (dtype == mage::kBFloat16)
    codebook_sqnorm<__nv_bfloat16><<<sq_blocks, sq_threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(cb), sq, k, d);
  else
    codebook_sqnorm<float><<<sq_blocks, sq_threads, 0, s>>>(static_cast<const float*>(cb), sq,
                                                            k, d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto key = static_cast<unsigned long long*>(keys);
  if (route == 1) return wg::launch(z, cb, sq, ids, codes, n, k, d, s);
  if (dtype == mage::kBFloat16)
    return simt::launch<__nv_bfloat16>(z, cb, sq, key, ids, codes, n, k, d, s);
  return simt::launch<float>(z, cb, sq, key, ids, codes, n, k, d, s);
}
