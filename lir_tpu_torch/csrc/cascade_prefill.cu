// Fused shared-trunk cascade attention for Hopper (sm_90a): one layer's
// remainder-window prefill on a shared-trunk dispatch.
//
// Replaces lir_tpu/ops/cascade_prefill.py:_fused_cascade_kernel (the
// default route of cascade_attention, _cascade_fused): every query of a
// row's remainder window attends the ONE shared trunk (the trunk leg: no
// mask, no causality, ALiBi on slot positions 0..Tt-1) and its row's own
// window (the suffix leg: mask-aware and causal on q_positions, ALiBi on
// q_positions), and the two partials merge by the log-sum-exp rule of
// merge_partials, trunk first.
//
// Layout (the JAX package's public shapes): q (B, R, H, hd); window k, v
// (B, R, K, hd); trunk k, v (K, Tt, hd); suffix_mask and q_positions
// (B, R) int32; slopes_rg (K, R * G) float32 or null: the per-flattened-
// row ALiBi slopes, built on the host as the JAX wrapper builds them
// (flattened query n = r * G + g of kv head kh uses head kh * G + g).
// Output (B, R, H, hd) in q's dtype.
//
// What bounds it on the H100: bytes, at this slice's shapes. At
// llama-2-7b width, B = 32, R = 80 and Tt = 432 it must read q, the window
// K/V and the trunk K/V and write the output, ~91 MB against ~20 GFLOP:
// ~220 FLOP per byte, under the card's bf16 tensor-core ridge (~295), so
// the least time is the bytes over the memory rate (~27 us). This first
// kernel is the simple one and runs two orders of magnitude over that:
// its products are float32 FMA on CUDA cores fed from shared memory, which
// tensor cores (wgmma, with TMA loads) would close. Its time stands beside
// the bound in PERF.md; the tensor-core rewrite is later work.
//
// Where it differs from the TPU kernel: the TPU keeps the whole trunk in
// VMEM as one block. Here a 512-slot trunk at hd 128 is 128 KB per side
// in bf16 (256 KB in float32) and does not fit in 227 KB of shared
// memory, so the trunk leg loops over tiles of W keys with an online
// softmax (running max and rescaled accumulator). The suffix leg runs the
// same loop over the window. The sum of the trunk leg is therefore taken
// in another order than the single-block prefix leg of the plain two-leg
// version: the kernel equals the plain version within float tolerance,
// not bitwise.
//
// One block per (query tile of QB flattened rows, batch row, kv head);
// its queries, the K/V tile, the score tile and both legs' accumulators
// live in shared memory, so no partial reaches device memory.
//
// The same file holds the trunk-leg kernels of the TWO-LEG route
// (lir_cascade_prefix below), which replace
// lir_tpu/ops/cascade_prefill.py:_prefix_kernel (reached from
// _prefix_partials): the (o, m, l) partials of every flattened query
// n = (b * R + r) * G + g of kv head kh against the whole trunk, in
// float32 QK^T or with in-kernel int8 QK^T (each query row and each trunk
// key row quantized by models/quant.py's dynamic rule, s8 x s8 -> s32
// with __dp4a, s = f32(s32) * (q_scale * sm_scale) * k_scale). The suffix
// leg and the merge of that route are plain PyTorch, as they are XLA in
// the JAX package.
//
// What bounds the trunk leg on the H100: bytes. At the cascade dispatch's
// shape (llama-2-7b, B = 32, R = 80, Tt = 432) it must read q (21 MB) and
// the trunk (7 MB) and write float32 partials (43 MB) against 18 GFLOP:
// ~0.021 ms of bytes, ~0.018 ms of bf16 tensor-core time. This first
// kernel multiplies on CUDA cores (float32 FMA or __dp4a) from shared
// memory tiles (attn_tile.cuh: 64 queries x 64 keys a tile, a 4 x 4
// register micro-tile a thread), so operations bound it in practice; mma
// or wgmma with TMA loads is later work. The TPU holds the whole trunk in
// one VMEM block; here a 432-slot trunk does not fit in shared memory
// beside the queries, so the kernel loops over key tiles with an online
// softmax. Its final m is the row max over the whole trunk and l, o are
// rescaled to it, so the merge sees what the TPU partial gives, within
// float tolerance (the sum runs in another order).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <cmath>

#include "attn_tile.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kQB = 32;  // flattened query rows per block
constexpr int kW = 32;   // keys per tile

using attn_tile::from_f32;
using attn_tile::to_f32;
using attn_tile::warp_max;
using attn_tile::warp_sum;

struct Args {
  const void* q;
  const void* sk;
  const void* sv;
  const void* tk;
  const void* tv;
  const int* smask;
  const int* qpos;
  const float* slopes_rg;
  void* out;
  int B, R, H, K, Tt, hd;
  float sm_scale;
};

__host__ __device__ inline size_t smem_floats(int hd) {
  return size_t(kQB) * hd          // queries
         + size_t(kW) * (hd + 1)   // K tile (padded rows)
         + size_t(kW) * hd         // V tile
         + size_t(kQB) * kW        // scores / probabilities
         + 2 * size_t(kQB) * hd    // trunk and suffix accumulators
         + 5 * size_t(kQB);        // m, l of both legs + rescale factor
}

// Online-softmax update of one leg with the probabilities of one tile:
// ss holds the tile's scores (-inf where masked), vs its values.
__device__ void online_update(float* ss, const float* vs, float* acc,
                              float* m, float* l, float* sc, int hd) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int n = warp; n < kQB; n += nwarps) {
    float* sn = ss + n * kW;
    const float m_old = m[n];
    float tmax = -CUDART_INF_F;
    for (int t = lane; t < kW; t += 32) tmax = fmaxf(tmax, sn[t]);
    tmax = warp_max(tmax);
    const float m_new = fmaxf(m_old, tmax);
    float lt = 0.f;
    for (int t = lane; t < kW; t += 32) {
      const float s = sn[t];
      const float p = (s == -CUDART_INF_F) ? 0.f : expf(__fsub_rn(s, m_new));
      sn[t] = p;
      lt = __fadd_rn(lt, p);
    }
    lt = warp_sum(lt);
    if (lane == 0) {
      const float scale =
          (m_old == -CUDART_INF_F) ? 0.f : expf(__fsub_rn(m_old, m_new));
      sc[n] = scale;
      l[n] = __fadd_rn(__fmul_rn(l[n], scale), lt);
      m[n] = m_new;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kQB * hd; i += blockDim.x) {
    const int n = i / hd;
    const int d = i - n * hd;
    const float* pn = ss + n * kW;
    float a = 0.f;
    for (int t = 0; t < kW; ++t) a = __fmaf_rn(pn[t], vs[t * hd + d], a);
    acc[i] = __fadd_rn(__fmul_rn(acc[i], sc[n]), a);
  }
  __syncthreads();
}

// Grid (ceil(R * G / kQB), B, K).
template <typename T>
__global__ void __launch_bounds__(kThreads) cascade_kernel(Args a) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int kh = blockIdx.z;
  const int G = a.H / a.K;
  const int RG = a.R * G;
  const int n0 = blockIdx.x * kQB;
  const int hd = a.hd;

  float* qs = smem;
  float* ks = qs + kQB * hd;
  float* vs = ks + kW * (hd + 1);
  float* ss = vs + kW * hd;
  float* ot = ss + kQB * kW;
  float* os = ot + kQB * hd;
  float* mt = os + kQB * hd;
  float* lt = mt + kQB;
  float* ms = lt + kQB;
  float* ls = ms + kQB;
  float* sc = ls + kQB;

  const T* q = static_cast<const T*>(a.q);
  const T* sk = static_cast<const T*>(a.sk);
  const T* sv = static_cast<const T*>(a.sv);
  const T* tk = static_cast<const T*>(a.tk);
  const T* tv = static_cast<const T*>(a.tv);
  const int* qpos_b = a.qpos + size_t(b) * a.R;
  const int* smask_b = a.smask + size_t(b) * a.R;
  const float* slope_k =
      a.slopes_rg ? a.slopes_rg + size_t(kh) * RG : nullptr;

  for (int i = threadIdx.x; i < kQB * hd; i += blockDim.x) {
    const int n = i / hd;
    const int d = i - n * hd;
    const int ng = n0 + n;
    float x = 0.f;
    if (ng < RG) {
      const int r = ng / G;
      const int g = ng - r * G;
      x = __fmul_rn(
          to_f32(q[((size_t(b) * a.R + r) * a.H + size_t(kh) * G + g) * hd + d]),
          a.sm_scale);
    }
    qs[i] = x;
    ot[i] = 0.f;
    os[i] = 0.f;
  }
  for (int i = threadIdx.x; i < kQB; i += blockDim.x) {
    mt[i] = -CUDART_INF_F;
    lt[i] = 0.f;
    ms[i] = -CUDART_INF_F;
    ls[i] = 0.f;
  }
  __syncthreads();

  // Trunk leg: every slot real, slot t is position t.
  for (int t0 = 0; t0 < a.Tt; t0 += kW) {
    for (int i = threadIdx.x; i < kW * hd; i += blockDim.x) {
      const int t = i / hd;
      const int d = i - t * hd;
      const int tg = t0 + t;
      float kv = 0.f, vv = 0.f;
      if (tg < a.Tt) {
        const size_t off = (size_t(kh) * a.Tt + tg) * hd + d;
        kv = to_f32(tk[off]);
        vv = to_f32(tv[off]);
      }
      ks[t * (hd + 1) + d] = kv;
      vs[t * hd + d] = vv;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kQB * kW; idx += blockDim.x) {
      const int n = idx / kW;
      const int t = idx - n * kW;
      const int tg = t0 + t;
      const int ng = n0 + n;
      float s = -CUDART_INF_F;
      if (tg < a.Tt && ng < RG) {
        const float* qn = qs + n * hd;
        const float* kt = ks + t * (hd + 1);
        float acc = 0.f;
        for (int d = 0; d < hd; ++d) acc = __fmaf_rn(qn[d], kt[d], acc);
        if (slope_k != nullptr)
          acc = __fadd_rn(acc, __fmul_rn(slope_k[ng], float(tg)));
        s = acc;
      }
      ss[idx] = s;
    }
    __syncthreads();
    online_update(ss, vs, ot, mt, lt, sc, hd);
  }

  // Suffix leg: the row's own window, mask-aware and causal.
  for (int t0 = 0; t0 < a.R; t0 += kW) {
    for (int i = threadIdx.x; i < kW * hd; i += blockDim.x) {
      const int t = i / hd;
      const int d = i - t * hd;
      const int tg = t0 + t;
      float kv = 0.f, vv = 0.f;
      if (tg < a.R) {
        const size_t off = ((size_t(b) * a.R + tg) * a.K + kh) * hd + d;
        kv = to_f32(sk[off]);
        vv = to_f32(sv[off]);
      }
      ks[t * (hd + 1) + d] = kv;
      vs[t * hd + d] = vv;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kQB * kW; idx += blockDim.x) {
      const int n = idx / kW;
      const int t = idx - n * kW;
      const int tg = t0 + t;
      const int ng = n0 + n;
      float s = -CUDART_INF_F;
      if (tg < a.R && ng < RG) {
        const int kp = qpos_b[tg];
        const int qp = qpos_b[ng / G];
        if (smask_b[tg] > 0 && kp <= qp) {
          const float* qn = qs + n * hd;
          const float* kt = ks + t * (hd + 1);
          float acc = 0.f;
          for (int d = 0; d < hd; ++d) acc = __fmaf_rn(qn[d], kt[d], acc);
          if (slope_k != nullptr)
            acc = __fadd_rn(acc, __fmul_rn(slope_k[ng], float(kp)));
          s = acc;
        }
      }
      ss[idx] = s;
    }
    __syncthreads();
    online_update(ss, vs, os, ms, ls, sc, hd);
  }

  // Merge the two partials, trunk first, as merge_partials does.
  T* out = static_cast<T*>(a.out);
  for (int i = threadIdx.x; i < kQB * hd; i += blockDim.x) {
    const int n = i / hd;
    const int d = i - n * hd;
    const int ng = n0 + n;
    if (ng >= RG) continue;
    const float m = fmaxf(mt[n], ms[n]);
    const float wt = isfinite(mt[n]) ? expf(__fsub_rn(mt[n], m)) : 0.f;
    const float ws = isfinite(ms[n]) ? expf(__fsub_rn(ms[n], m)) : 0.f;
    const float l = __fadd_rn(__fmul_rn(wt, lt[n]), __fmul_rn(ws, ls[n]));
    const float o = __fadd_rn(__fmul_rn(wt, ot[i]), __fmul_rn(ws, os[i]));
    const int r = ng / G;
    const int g = ng - r * G;
    out[((size_t(b) * a.R + r) * a.H + size_t(kh) * G + g) * hd + d] =
        from_f32<T>(__fdiv_rn(o, fmaxf(l, 1e-30f)));
  }
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const size_t smem = smem_floats(a.hd) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      cascade_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return e;
  const int G = a.H / a.K;
  dim3 grid((a.R * G + kQB - 1) / kQB, a.B, a.K);
  cascade_kernel<T><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() (or the
// error of a refused attribute), 0 on success.
extern "C" int lir_cascade_attention(const void* q, const void* sk,
                                     const void* sv, const void* tk,
                                     const void* tv, const void* smask,
                                     const void* qpos, const void* slopes_rg,
                                     void* out, int B, int R, int H, int K,
                                     int Tt, int hd, int dtype, void* stream) {
  Args a;
  a.q = q;
  a.sk = sk;
  a.sv = sv;
  a.tk = tk;
  a.tv = tv;
  a.smask = static_cast<const int*>(smask);
  a.qpos = static_cast<const int*>(qpos);
  a.slopes_rg = static_cast<const float*>(slopes_rg);
  a.out = out;
  a.B = B;
  a.R = R;
  a.H = H;
  a.K = K;
  a.Tt = Tt;
  a.hd = hd;
  // 1/sqrt(hd) rounded once from double, as the JAX package computes it.
  a.sm_scale = float(1.0 / sqrt(double(hd)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(launch<float>(a, st));
  if (dtype == 1) return int(launch<__nv_bfloat16>(a, st));
  return int(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// Trunk leg of the two-leg route: cascade_prefix (float32 QK^T) and
// cascade_prefix_int8 (in-kernel int8 QK^T).
// ---------------------------------------------------------------------------

namespace {

namespace tile = attn_tile;

struct PrefixArgs {
  const void* q;           // (B, R, H, hd)
  const void* tk;          // (K, Tt, hd)
  const void* tv;          // (K, Tt, hd)
  const float* slopes;     // (H,) or null
  float* o;                // (B, K, R, G, hd)
  float* m;                // (B, K, R, G)
  float* l;                // (B, K, R, G)
  int B, R, H, K, Tt;
  float sm_scale;
};

template <int HD, bool INT8>
struct PrefixSmem {
  using D = tile::Dims<HD>;
  // float: q tile, one K-then-V tile; int8: q and k payloads + scales and
  // a V tile. Then the probability tile and the row statistics.
  static constexpr size_t kQ = INT8 ? tile::kQB * D::kLd8 * 4 + tile::kQB * 4
                                    : tile::kQB * D::kLd * 4;
  static constexpr size_t kK = INT8 ? tile::kKB * D::kLd8 * 4 + tile::kKB * 4 : 0;
  static constexpr size_t kV = tile::kKB * D::kLd * 4;
  static constexpr size_t kP = tile::kQB * tile::kLdP * 4;
  static constexpr size_t kStats = 3 * tile::kQB * 4;
  static constexpr size_t kBytes = kQ + kK + kV + kP + kStats;
};

// Grid (ceil(N / kQB), K) with N = B * R * G flattened queries; the tail
// tile's rows past N are masked (never loaded, never written).
template <typename T, int HD, bool INT8>
__global__ void __launch_bounds__(tile::kThreads) prefix_kernel(PrefixArgs a) {
  using D = tile::Dims<HD>;
  using S = PrefixSmem<HD, INT8>;
  extern __shared__ __align__(16) unsigned char prefix_smem[];
  const int kh = blockIdx.y;
  const int n0 = blockIdx.x * tile::kQB;
  const int G = a.H / a.K;
  const int RG = a.R * G;
  const int N = a.B * RG;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  unsigned char* p = prefix_smem;
  float* qf = reinterpret_cast<float*>(p);         // float variant
  int* q8 = reinterpret_cast<int*>(p);             // int8 variant
  float* qsc = reinterpret_cast<float*>(p + tile::kQB * D::kLd8 * 4);
  p += S::kQ;
  int* k8 = reinterpret_cast<int*>(p);
  float* ksc = reinterpret_cast<float*>(p + tile::kKB * D::kLd8 * 4);
  p += S::kK;
  float* vs = reinterpret_cast<float*>(p);         // float: K, then V
  p += S::kV;
  float* ps = reinterpret_cast<float*>(p);
  p += S::kP;
  float* m = reinterpret_cast<float*>(p);
  float* l = m + tile::kQB;
  float* sc = l + tile::kQB;

  const T* q = static_cast<const T*>(a.q);
  const T* tk = static_cast<const T*>(a.tk);
  const T* tv = static_cast<const T*>(a.tv);
  // Flattened query n is q[b, r, kh * G + g] with b * R + r = n / G.
  auto q_off = [&](int r) {
    const int n = n0 + r;
    return (size_t(n / G) * a.H + size_t(kh) * G + n % G) * HD;
  };
  auto q_ok = [&](int r) { return n0 + r < N; };
  if constexpr (INT8) {
    // Payloads of the raw query row; its scale carries sm_scale, folded
    // as the TPU kernel folds it: (q_scale * sm_scale).
    tile::load_tile_int8<HD>(q8, qsc, q, tile::kQB, a.sm_scale, q_off, q_ok);
  } else {
    tile::load_tile<HD>(qf, q, tile::kQB, a.sm_scale, q_off, q_ok);
  }
  for (int i = threadIdx.x; i < tile::kQB; i += blockDim.x) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
  }
  float slope[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    slope[i] = (a.slopes != nullptr && n < N) ? a.slopes[kh * G + n % G] : 0.f;
  }
  float acc[4][D::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D::kCols; ++c) acc[i][c] = 0.f;

  for (int t0 = 0; t0 < a.Tt; t0 += tile::kKB) {
    __syncthreads();  // the previous tile's PV is done with vs and ps
    auto k_off = [&](int r) { return (size_t(kh) * a.Tt + t0 + r) * HD; };
    auto k_ok = [&](int r) { return t0 + r < a.Tt; };
    if constexpr (INT8) {
      tile::load_tile_int8<HD>(k8, ksc, tk, tile::kKB, 1.f, k_off, k_ok);
      tile::load_tile<HD>(vs, tv, tile::kKB, 1.f, k_off, k_ok);
    } else {
      tile::load_tile<HD>(vs, tk, tile::kKB, 1.f, k_off, k_ok);
    }
    __syncthreads();
    float s[4][4];
    if constexpr (INT8) {
      int s32[4][4];
      tile::score_s8<HD>(q8, k8, s32);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = __fmul_rn(__fmul_rn(float(s32[i][j]), qsc[ty + 16 * i]),
                              ksc[tx + 16 * j]);
    } else {
      tile::score_f32<HD>(qf, vs, s);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + tx + 16 * j;
        float x = s[i][j];
        if (a.slopes != nullptr) x = __fadd_rn(x, __fmul_rn(slope[i], float(t)));
        ps[(ty + 16 * i) * tile::kLdP + tx + 16 * j] =
            t < a.Tt ? x : -CUDART_INF_F;
      }
    __syncthreads();
    if constexpr (!INT8) {
      tile::load_tile<HD>(vs, tv, tile::kKB, 1.f, k_off, k_ok);
    }
    tile::online_softmax(ps, m, l, sc);
    __syncthreads();
    tile::pv_update<HD>(ps, vs, sc, acc);
  }
  __syncthreads();

  // Partials in the (B, K, R, G) layout of the plain twin: flattened
  // query n of batch row b sits at (b * K + kh) * R * G + n % (R * G).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= N) continue;
    const size_t row = size_t(n / RG) * a.K * RG + size_t(kh) * RG + n % RG;
#pragma unroll
    for (int c = 0; c < D::kCols; ++c) a.o[row * HD + tx + 16 * c] = acc[i][c];
  }
  for (int i = threadIdx.x; i < tile::kQB; i += blockDim.x) {
    const int n = n0 + i;
    if (n >= N) continue;
    const size_t row = size_t(n / RG) * a.K * RG + size_t(kh) * RG + n % RG;
    a.m[row] = m[i];
    a.l[row] = l[i];
  }
}

template <typename T, int HD, bool INT8>
cudaError_t launch_prefix(const PrefixArgs& a, cudaStream_t st) {
  const int smem = int(PrefixSmem<HD, INT8>::kBytes);
  cudaError_t e = cudaFuncSetAttribute(
      prefix_kernel<T, HD, INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const long long N = (long long)a.B * a.R * (a.H / a.K);
  dim3 grid(unsigned((N + tile::kQB - 1) / tile::kQB), a.K);
  prefix_kernel<T, HD, INT8><<<grid, tile::kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, bool INT8>
cudaError_t prefix_by_hd(const PrefixArgs& a, int hd, cudaStream_t st) {
  switch (hd) {
    case 32: return launch_prefix<T, 32, INT8>(a, st);
    case 64: return launch_prefix<T, 64, INT8>(a, st);
    case 80: return launch_prefix<T, 80, INT8>(a, st);
    case 96: return launch_prefix<T, 96, INT8>(a, st);
    case 128: return launch_prefix<T, 128, INT8>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Trunk-leg partials of the two-leg cascade. dtype: 0 = float32,
// 1 = bfloat16; int8_qk: 0 = float32 QK^T, 1 = int8 QK^T. hd one of 32,
// 64, 80, 96, 128. Returns cudaGetLastError() (or the error of a refused
// attribute), 0 on success.
extern "C" int lir_cascade_prefix(const void* q, const void* tk, const void* tv,
                                  const void* slopes, void* o, void* m, void* l,
                                  int B, int R, int H, int K, int Tt, int hd,
                                  int dtype, int int8_qk, void* stream) {
  PrefixArgs a;
  a.q = q;
  a.tk = tk;
  a.tv = tv;
  a.slopes = static_cast<const float*>(slopes);
  a.o = static_cast<float*>(o);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.B = B;
  a.R = R;
  a.H = H;
  a.K = K;
  a.Tt = Tt;
  a.sm_scale = float(1.0 / sqrt(double(hd)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(int8_qk ? prefix_by_hd<float, true>(a, hd, st)
                       : prefix_by_hd<float, false>(a, hd, st));
  if (dtype == 1)
    return int(int8_qk ? prefix_by_hd<__nv_bfloat16, true>(a, hd, st)
                       : prefix_by_hd<__nv_bfloat16, false>(a, hd, st));
  return int(cudaErrorInvalidValue);
}
