// The f32 attention of one query row over the S <= 32 keys of its (group,
// head) unit, shared by axial_attention.cu and axial_block.cu. It keeps the
// TPU kernels' math (mage_tpu/ops/axial_attention.py::_axial_kernel and
// ::_block_kernel): scores = (q * scale) k^T in f32, max-subtracted expf,
// the row divided by its sum, P.V in f32 with P unrounded.
//
// One thread owns one query row: its S scores stay in registers, so the
// row's max and sum need no shuffle, no scratch and no barrier; q and the
// output pass through in 8-column chunks. k and v are read from shared
// memory as 16-byte vectors; the S threads of a unit read the same key row
// together (a broadcast), and a warp runs 32 / S units at once (two at
// S = 16).
#pragma once

#include "common.cuh"

namespace mage {

constexpr int ATTEND_S_MAX = 32;

// elements of T in one 16-byte vector
template <typename T>
__host__ __device__ constexpr int vec_width() { return 16 / static_cast<int>(sizeof(T)); }

// 16 bytes at p (16-byte aligned) as f32
__device__ __forceinline__ void load_vec(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the high half of the f32 with the same value
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// the same through the read-only path, for global memory the kernel never writes
__device__ __forceinline__ void load_vec_global(const float* p, float* f) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load_vec_global(const __nv_bfloat16* p, float* f) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// f rounded to T (nearest even), 16 bytes at p
__device__ __forceinline__ void store_vec(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// 8 values of T at p (16-byte aligned) as f32
__device__ __forceinline__ void load8(const float* p, float* f) {
  load_vec(p, f);
  load_vec(p + 4, f + 4);
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) { load_vec(p, f); }
__device__ __forceinline__ void load8_global(const float* p, float* f) {
  load_vec_global(p, f);
  load_vec_global(p + 4, f + 4);
}
__device__ __forceinline__ void load8_global(const __nv_bfloat16* p, float* f) {
  load_vec_global(p, f);
}

// f (8 values) rounded to T at p (16-byte aligned)
__device__ __forceinline__ void store8(float* p, const float* f) {
  store_vec(p, f);
  store_vec(p + 4, f + 4);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) { store_vec(p, f); }

// One query row: load_q(c0, f) gives q[c0 .. c0 + 7] as f32, store_o(c0, f)
// takes out[c0 .. c0 + 7]; k and v point at key row 0 of the unit, row
// stride ld elements; hd, ld and the pointers are multiples of 8 elements
// (16-byte aligned). The head is walked in 8-column chunks, so a thread holds
// its S scores and one chunk, not the whole q and output row; each score and
// each output still sums over c, resp. j, in ascending order.
// SCALE_Q: fmaf(q * scale, k, .) as _block_kernel; otherwise (q . k) * scale
// as _axial_kernel, whose plain versions differ there. SMAX (16 or 32)
// bounds s.
template <int SMAX, bool SCALE_Q, typename T, typename LoadQ, typename StoreO>
__device__ __forceinline__ void attend_row(LoadQ&& load_q, StoreO&& store_o, const T* k,
                                           const T* v, int ld, int s, int hd, float scale) {
  static_assert(SMAX <= ATTEND_S_MAX, "at most 32 keys");
  float sc[SMAX];
#pragma unroll
  for (int j = 0; j < SMAX; ++j) sc[j] = 0.f;
#pragma unroll 1
  for (int c0 = 0; c0 < hd; c0 += 8) {
    float qv[8];
    load_q(c0, qv);
    if (SCALE_Q) {
#pragma unroll
      for (int e = 0; e < 8; ++e) qv[e] = __fmul_rn(qv[e], scale);
    }
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      if (j < s) {
        float kv[8];
        load8(k + j * ld + c0, kv);
#pragma unroll
        for (int e = 0; e < 8; ++e) sc[j] = fmaf(qv[e], kv[e], sc[j]);
      }
    }
  }
  if (!SCALE_Q) {
#pragma unroll
    for (int j = 0; j < SMAX; ++j) sc[j] *= scale;
  }
  float m = sc[0];
#pragma unroll
  for (int j = 1; j < SMAX; ++j)
    if (j < s) m = fmaxf(m, sc[j]);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < SMAX; ++j) {
    if (j < s) {
      sc[j] = expf(sc[j] - m);
      sum += sc[j];
    }
  }
#pragma unroll
  for (int j = 0; j < SMAX; ++j)
    if (j < s) sc[j] = sc[j] / sum;
#pragma unroll 1
  for (int c0 = 0; c0 < hd; c0 += 8) {
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = 0.f;
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      if (j < s) {
        float vv[8];
        load8(v + j * ld + c0, vv);
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = fmaf(sc[j], vv[e], o[e]);
      }
    }
    store_o(c0, o);
  }
}

}  // namespace mage
