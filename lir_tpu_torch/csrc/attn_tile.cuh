// Tile machinery shared by the prefill attention kernels for Hopper
// (sm_90a): the cascade's trunk leg (cascade_prefill.cu, cascade_prefix
// kernels) and the prefill flash kernel (flash_attention.cu).
//
// One block of kThreads = 256 threads owns a tile of kQB = 64 query rows
// and walks the keys in tiles of kKB = 64 with an online softmax. The
// threads form a 16 x 16 grid (ty, tx): in the score product a thread
// owns the 4 x 4 scores of rows ty + 16 i and keys tx + 16 j, so each
// 16-byte shared-memory load feeds four products; in the PV product it
// owns rows ty + 16 i and columns tx + 16 c of the accumulator, kept in
// registers for the whole key loop. Tiles live in shared memory as float32
// rows padded to HD + 4 floats (int8 payloads: HD / 4 + 4 packed words),
// which keeps the 16-byte loads of a quarter warp on distinct banks.
//
// Scores, exponentials and sums are float32 with the _rn intrinsics where
// the order matters, as the plain versions compute them; the sum over a
// key tile is taken in another order than a single softmax over all keys,
// so the kernels match their plain versions within float tolerance, not
// bitwise (the int8 payloads and s32 dot products are exact and bitwise).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace attn_tile {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQB = 64;  // query rows per block
constexpr int kKB = 64;  // keys per tile
// Row stride of the score / probability tile: rows ty and ty + 1 of a
// warp land 16 banks apart.
constexpr int kLdP = kKB + 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Four consecutive elements of a row, as float32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}

template <int HD>
struct Dims {
  static_assert(HD % 16 == 0 && HD <= 128, "head dim: a multiple of 16, <= 128");
  static constexpr int kLd = HD + 4;       // float row stride in shared memory
  static constexpr int kLd8 = HD / 4 + 4;  // packed int8 row stride (words)
  static constexpr int kCols = HD / 16;    // accumulator columns a thread owns
};

// Load up to kQB (or kKB) rows into a padded float32 tile, ``scale``
// applied with one rounding (1 for none). Row r of the tile is
// src + row_off(r), or zeros where row_ok(r) is false. One warp a row,
// four elements a lane.
template <int HD, typename T, typename RowOff, typename RowOk>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int rows,
                                          float scale, RowOff row_off,
                                          RowOk row_ok) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kWarps) {
    const bool ok = row_ok(r);
    const T* row = ok ? src + row_off(r) : nullptr;
    for (int c = lane; c < HD / 4; c += 32) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok) {
        x = load4(row + 4 * c);
        if (scale != 1.f) {
          x.x = __fmul_rn(x.x, scale);
          x.y = __fmul_rn(x.y, scale);
          x.z = __fmul_rn(x.z, scale);
          x.w = __fmul_rn(x.w, scale);
        }
      }
      *reinterpret_cast<float4*>(dst + r * Dims<HD>::kLd + 4 * c) = x;
    }
  }
}

__device__ __forceinline__ int quant8(float x, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f);
  return static_cast<int>(r) & 0xff;
}

// Load rows as int8 payloads by the dynamic rule of models/quant.py
// (amax over the row, scale = max(amax, 1e-8) / 127, IEEE division,
// round half to even, clip to +-127), four payloads packed a word; the
// row's scale times ``scale_mul`` (one rounding) goes to scales[r]. A row
// where row_ok(r) is false is zeros with the zero row's scale.
template <int HD, typename T, typename RowOff, typename RowOk>
__device__ __forceinline__ void load_tile_int8(int* dst, float* scales,
                                               const T* src, int rows,
                                               float scale_mul, RowOff row_off,
                                               RowOk row_ok) {
  constexpr int kChunks = (HD / 4 + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kWarps) {
    const bool ok = row_ok(r);
    const T* row = ok ? src + row_off(r) : nullptr;
    float4 x[kChunks];
    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = lane + 32 * k;
      x[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok && c < HD / 4) x[k] = load4(row + 4 * c);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(x[k].x), fabsf(x[k].y)),
                               fmaxf(fabsf(x[k].z), fabsf(x[k].w))));
    }
    amax = warp_max(amax);
    const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = lane + 32 * k;
      if (c < HD / 4) {
        dst[r * Dims<HD>::kLd8 + c] =
            quant8(x[k].x, s) | (quant8(x[k].y, s) << 8) |
            (quant8(x[k].z, s) << 16) | (quant8(x[k].w, s) << 24);
      }
    }
    if (lane == 0) scales[r] = scale_mul == 1.f ? s : __fmul_rn(s, scale_mul);
  }
}

// The 4 x 4 float32 dot products of this thread's rows and keys.
template <int HD>
__device__ __forceinline__ void score_f32(const float* qs, const float* ks,
                                          float (&s)[4][4]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * Dims<HD>::kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * Dims<HD>::kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float acc = s[i][j];
        acc = __fmaf_rn(a[i].x, b[j].x, acc);
        acc = __fmaf_rn(a[i].y, b[j].y, acc);
        acc = __fmaf_rn(a[i].z, b[j].z, acc);
        acc = __fmaf_rn(a[i].w, b[j].w, acc);
        s[i][j] = acc;
      }
  }
}

// The 4 x 4 exact s32 dot products of packed int8 rows and keys.
template <int HD>
__device__ __forceinline__ void score_s8(const int* qs, const int* ks,
                                         int (&s)[4][4]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0;
#pragma unroll 2
  for (int w = 0; w < HD / 4; w += 4) {
    int4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const int4*>(qs + (ty + 16 * i) * Dims<HD>::kLd8 + w);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const int4*>(ks + (tx + 16 * j) * Dims<HD>::kLd8 + w);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int acc = s[i][j];
        acc = __dp4a(a[i].x, b[j].x, acc);
        acc = __dp4a(a[i].y, b[j].y, acc);
        acc = __dp4a(a[i].z, b[j].z, acc);
        acc = __dp4a(a[i].w, b[j].w, acc);
        s[i][j] = acc;
      }
  }
}

// Online-softmax update of one key tile, one warp a row: ps holds the
// tile's scores (-inf where masked) and gets the probabilities against
// the new running max; m, l advance; sc gets the factor that rescales
// the row's accumulator (0 while the row has seen no valid key).
__device__ __forceinline__ void online_softmax(float* ps, float* m, float* l,
                                               float* sc) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int n = warp; n < kQB; n += kWarps) {
    float* row = ps + n * kLdP;
    const float s0 = row[lane];
    const float s1 = row[lane + 32];
    const float m_old = m[n];
    const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
    const float p0 = (s0 == -CUDART_INF_F) ? 0.f : expf(__fsub_rn(s0, m_new));
    const float p1 = (s1 == -CUDART_INF_F) ? 0.f : expf(__fsub_rn(s1, m_new));
    row[lane] = p0;
    row[lane + 32] = p1;
    const float tsum = warp_sum(__fadd_rn(p0, p1));
    if (lane == 0) {
      const float f =
          (m_old == -CUDART_INF_F) ? 0.f : expf(__fsub_rn(m_old, m_new));
      sc[n] = f;
      l[n] = __fadd_rn(__fmul_rn(l[n], f), tsum);
      m[n] = m_new;
    }
  }
}

// acc = acc * sc[row] + P @ V over one key tile, acc this thread's
// rows ty + 16 i and columns tx + 16 c.
template <int HD>
__device__ __forceinline__ void pv_update(const float* ps, const float* vs,
                                          const float* sc,
                                          float (&acc)[4][Dims<HD>::kCols]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float f = sc[ty + 16 * i];
#pragma unroll
    for (int c = 0; c < Dims<HD>::kCols; ++c) acc[i][c] = __fmul_rn(acc[i][c], f);
  }
  float part[4][Dims<HD>::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < Dims<HD>::kCols; ++c) part[i][c] = 0.f;
#pragma unroll 4
  for (int t = 0; t < kKB; ++t) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kLdP + t];
#pragma unroll
    for (int c = 0; c < Dims<HD>::kCols; ++c) {
      const float v = vs[t * Dims<HD>::kLd + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) part[i][c] = __fmaf_rn(p[i], v, part[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < Dims<HD>::kCols; ++c)
      acc[i][c] = __fadd_rn(acc[i][c], part[i][c]);
}

}  // namespace attn_tile
