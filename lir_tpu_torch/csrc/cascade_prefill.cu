// Shared-trunk cascade prefill for Hopper (sm_90a): one layer's
// remainder-window prefill on a shared-trunk dispatch, on both routes of
// ops/cascade_prefill.py.
//
// lir_cascade_attention replaces lir_tpu/ops/cascade_prefill.py:
// _fused_cascade_kernel (the default route, _cascade_fused): every query
// of a row's remainder window attends the ONE shared trunk (the trunk leg:
// no mask, no causality, ALiBi on slot positions 0..Tt-1) and its row's
// own window (the suffix leg: mask-aware and causal on q_positions, ALiBi
// on q_positions); the result is the softmax over trunk + window keys.
// lir_cascade_prefix replaces _prefix_kernel (reached from
// _prefix_partials, the TWO-LEG route): the (o, m, l) partials of every
// flattened query n = (b * R + r) * G + g of kv head kh against the whole
// trunk, float32, in the (B, K, R, G) layout merge_partials expects; with
// int8_qk the QK^T is quantized in the kernel (each query row and trunk
// key row by models/quant.py's dynamic rule, s8 x s8 -> s32 with __dp4a,
// s = f32(s32) * (q_scale * sm_scale) * k_scale). That route's suffix leg
// and merge are plain PyTorch, as they are XLA in the JAX package.
//
// Layout (the JAX package's public shapes): q (B, R, H, hd); window k, v
// (B, R, K, hd); trunk k, v (K, Tt, hd); suffix_mask and q_positions
// (B, R) int32; fused ALiBi slopes_rg (K, R * G) float32 (flattened row
// n = r * G + g of kv head kh uses head kh * G + g, built on the host as
// the JAX wrapper builds them), trunk-leg slopes (H,). Output (B, R, H, hd)
// in q's dtype; partials o (B, K, R, G, hd), m and l (B, K, R, G).
//
// What bounds them on the H100: bytes, at the cascade dispatch's shape
// (llama-2-7b, B = 32, R = 80, Tt = 432). The fused kernel reads q, the
// window K/V and the trunk K/V and writes the output, ~91 MB against
// ~20 GFLOP of the model's work (~27 us of bytes); the trunk leg reads q
// (21 MB) and the trunk (7 MB) and writes 43 MB of float32 partials
// against 18 GFLOP (~21 us of bytes, ~18 us of bf16 tensor-core time).
// Both sit at or under the card's bf16 ridge (~295 FLOP per byte).
//
// The bf16 route (the main path's dtype) runs on tensor cores, from the
// tile code of attn_mma.cuh (cascade_mma_kernel, prefix_mma_kernel):
// mma.sync m16n8k16 with ldmatrix operands, raw bf16 q and k summed in
// float32 and then scaled, a 3-stage cp.async ring of 64-key K/V tiles
// (tiles i + 1 and i + 2 in flight while tile i multiplies), Q held in
// registers, the online softmax in registers, and P V in two passes over
// P = bf16 hi + bf16 lo, which keeps the float32 partials within 1e-3 of
// the float32 reference (one bf16 P misses that by an order of
// magnitude). mma.sync rather than wgmma: at these intensities a well-fed
// mma.sync kernel should come within a small factor of the byte bound;
// wgmma with TMA is the lever where it does not.
// - Both kernels tile the queries the same way: flattened rows
//   n = (b * R + r) * G + g of one kv head over ALL batch rows, 16 a warp,
//   four warps a block (the last tile's rows past N = B * R * G are
//   zero-filled and never written). A block of one batch row's R * G = 80
//   rows would have five warps on the SM's four schedulers, and its
//   barriers would wait on the scheduler that holds two.
// - Trunk leg: each block walks the whole trunk of its kv head, the last
//   key tile masked past Tt. Its final m is the row max over the trunk and
//   l, o are rescaled to it; o leaves the accumulator fragments as 16-byte
//   stores (two neighbouring lanes trade halves so each holds four
//   columns of one row).
// - Fused: each block walks one sequence of keys, the trunk (no mask,
//   ALiBi on slot t) and then the windows of the batch rows its queries
//   belong to (mask-aware, causal, ALiBi on the key's position; a row sees
//   only its own batch row's window), under ONE running (m, l, o) a row:
//   the same softmax over trunk + window keys that the merge of two
//   partials gives, in another order of summation, so it equals the plain
//   two-leg version within float tolerance, not bitwise. Every trunk key
//   is valid, so no row is empty. The output is normalized and stored as
//   bf16 in q's layout.
// - Each block reads its head's trunk (221 KB at hd 128, Tt 432) from L2;
//   only q, the windows and the outputs come from or go to device memory
//   once.
//
// Float32 inputs (the small float32 slice of chip_smoke.py, any float32
// caller) take the float32-exact CUDA-core kernels instead, chosen by the
// dtype argument: cascade_kernel (float32 FMA over shared-memory tiles
// with an online softmax per leg, merged trunk first) and prefix_kernel
// (attn_tile.cuh's 64 x 64 tiles with 4 x 4 register micro-tiles). This
// is a dispatch on the input type, not a fallback: a bf16 call never
// reaches that code, and a bf16 call with a head dim outside 32, 64, 80,
// 96, 128 is refused (the wrapper raises before the launch; the entry
// point returns cudaErrorInvalidValue). The int8-QK^T trunk leg keeps the
// same CUDA-core tiles in both dtypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <cmath>

#include "attn_mma.cuh"
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

// The float32 route on CUDA cores. Grid (ceil(R * G / kQB), B, K).
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

namespace am = attn_mma;

// The bf16 route on tensor cores. Its query tiles are those of the trunk
// leg: flattened rows n = (b * R + r) * G + g of kv head kh over all batch
// rows, 16 a warp, so every block has the same few warps (a block of
// R * G = 80 rows would put five warps on four schedulers). A block's rows
// span batch rows b_lo .. b_lo + nb - 1; it walks one sequence of
// Tt + nb * R keys: key k < Tt is the trunk's slot k, and key Tt + w is
// row w % R of batch row b_lo + w / R's window. A 64-key tile may hold
// the trunk's last keys and a window's first.

// Q row i of a block of either bf16 kernel: flattened query n = n0 + i of
// kv head kh is q[b, r, kh * G + g] with b * R + r = n / G.
struct FlatQ {
  const am::bf16* q;
  int n0, N, kh, G, H, hd;
  __device__ __forceinline__ am::Row operator()(int i) const {
    const int n = n0 + i;
    const bool ok = n < N;
    const int m = ok ? n : n0;
    return {q + (size_t(m / G) * H + size_t(kh) * G + m % G) * hd, ok};
  }
};

// Launch of either bf16 kernel: grid (ceil(N / rows), K) over N flattened
// queries of K kv heads, am::warps_for(N) warps of 16 rows a block.
template <int HD, typename A>
cudaError_t launch_flat(void (*kernel)(A), const A& a, long long N, int K, cudaStream_t st) {
  const int warps = am::warps_for(N);
  const int rows = warps * 16;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(am::Dims<HD>::kBytes));
  if (e != cudaSuccess) return e;
  dim3 grid(unsigned((N + rows - 1) / rows), K);
  kernel<<<grid, warps * 32, am::Dims<HD>::kBytes, st>>>(a);
  return cudaGetLastError();
}

// Key k of a block's sequence: the trunk's slot k, then window row k - Tt.
struct FusedKV {
  const am::bf16 *tk, *tv, *sk, *sv;
  int b_lo, n_win, kh, Tt, R, K, hd;
  __device__ __forceinline__ am::KVRow operator()(int key) const {
    if (key < Tt) {
      const size_t off = (size_t(kh) * Tt + key) * hd;
      return {tk + off, tv + off, true};
    }
    const int w = key - Tt;
    const bool ok = w < n_win;
    // Window row w of the block is row b_lo * R + w of (B * R, K, hd).
    const size_t off = ((size_t(b_lo) * R + (ok ? w : 0)) * K + kh) * hd;
    return {sk + off, sv + off, ok};
  }
};

// Scores of one warp's tile: scale, ALiBi on the key's position (slot t on
// the trunk, q_positions in a window), and -inf where masked: the trunk is
// all valid; a window key counts for a row of its own batch row where it
// is real, unmasked and not after the row's position.
struct FusedFix {
  const int* qpos;   // (B, R), the block's window rows from b_lo * R on
  const int* smask;  // (B, R), the same
  float sm_scale;
  bool alibi;
  int Tt, R, n_win, c0;
  float slope[2];
  int qp[2];         // the rows' query positions
  int wb[2];         // the rows' batch rows, counted from b_lo
  __device__ __forceinline__ void operator()(int t, float (&s)[8][4]) const {
    const int k0 = t * am::kKeys;
    if (k0 + am::kKeys <= Tt) {  // a tile of trunk keys only
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(s[j][e], sm_scale);
          if (alibi) x = __fadd_rn(x, __fmul_rn(slope[e >> 1], float(k0 + 8 * j + c0 + (e & 1))));
          s[j][e] = x;
        }
      return;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * j + c0 + c;
        const bool trunk = key < Tt;
        const int w = key - Tt;
        const bool in = !trunk && w < n_win;
        const int kp = trunk ? key : (in ? qpos[w] : 0);
        const bool live = in && smask[w] > 0;
        const int kb = in ? w / R : -1;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + c;
          float x = __fmul_rn(s[j][e], sm_scale);
          if (alibi) x = __fadd_rn(x, __fmul_rn(slope[h], float(kp)));
          s[j][e] = (trunk || (live && kb == wb[h] && kp <= qp[h])) ? x : -CUDART_INF_F;
        }
      }
  }
};

// Normalized output of one lane's four columns of row half h, as bf16 in
// q's (B, R, H, hd) layout.
struct FusedStore {
  am::bf16* out;
  int N, kh, G, H, hd, nr;
  float l[2];
  __device__ __forceinline__ void operator()(int h, int col, float4 v) const {
    const int n = nr + 8 * h;
    if (n >= N) return;
    const float lh = h ? l[1] : l[0];
    uint2 pk;
    pk.x = am::as_u32(__floats2bfloat162_rn(__fdiv_rn(v.x, lh), __fdiv_rn(v.y, lh)));
    pk.y = am::as_u32(__floats2bfloat162_rn(__fdiv_rn(v.z, lh), __fdiv_rn(v.w, lh)));
    *reinterpret_cast<uint2*>(out + (size_t(n / G) * H + size_t(kh) * G + n % G) * hd + col) = pk;
  }
};

// Grid (ceil(N / rows), K) with N = B * R * G flattened queries,
// rows = 16 * blockDim.x / 32.
template <int HD>
__global__ void __launch_bounds__(am::kWarps * 32) cascade_mma_kernel(Args a) {
  using am::bf16;
  extern __shared__ __align__(16) unsigned char cascade_mma_smem[];
  bf16* ring = reinterpret_cast<bf16*>(cascade_mma_smem);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kh = blockIdx.y;
  const int G = a.H / a.K;
  const int RG = a.R * G;
  const int N = a.B * RG;
  const int rows = (blockDim.x >> 5) * 16;
  const int n0 = blockIdx.x * rows;
  am::load_rows<HD>(am::q_stage<HD>(ring), rows,
                    FlatQ{static_cast<const bf16*>(a.q), n0, N, kh, G, a.H, HD});
  // The batch rows of the block's queries, and their window keys.
  const int b_lo = n0 / RG;
  const int n_win = ((min(n0 + rows, N) - 1) / RG - b_lo + 1) * a.R;
  const FusedKV key{static_cast<const bf16*>(a.tk), static_cast<const bf16*>(a.tv),
                    static_cast<const bf16*>(a.sk), static_cast<const bf16*>(a.sv),
                    b_lo, n_win, kh, a.Tt, a.R, a.K, HD};

  // This lane's two rows (half h is row g + 8 h of the warp's tile): their
  // ALiBi slope, query position and batch row.
  const int nr = n0 + warp * 16 + (lane >> 2);
  FusedFix fix{a.qpos + size_t(b_lo) * a.R, a.smask + size_t(b_lo) * a.R, a.sm_scale,
               a.slopes_rg != nullptr, a.Tt, a.R, n_win, 2 * (lane & 3),
               {0.f, 0.f}, {0, 0}, {-2, -2}};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = nr + 8 * h;
    if (n >= N) continue;
    const int b = n / RG;
    const int r = (n - b * RG) / G;
    if (fix.alibi) fix.slope[h] = a.slopes_rg[size_t(kh) * RG + (n - b * RG)];
    fix.qp[h] = a.qpos[size_t(b) * a.R + r];
    fix.wb[h] = b - b_lo;
  }

  am::Acc<HD> acc;
  am::acc_init<HD>(acc);
  const bool active = n0 + warp * 16 < N;
  am::key_loop<HD>(ring, (a.Tt + n_win + am::kKeys - 1) / am::kKeys, active, key, fix, acc);
  if (!active) return;
  am::store_rows<HD>(acc, FusedStore{static_cast<bf16*>(a.out), N, kh, G, a.H, HD, nr,
                                     {fmaxf(acc.l[0], 1e-30f), fmaxf(acc.l[1], 1e-30f)}});
}

template <int HD>
cudaError_t launch_mma(const Args& a, cudaStream_t st) {
  return launch_flat<HD>(cascade_mma_kernel<HD>, a, (long long)a.B * a.R * (a.H / a.K), a.K, st);
}

cudaError_t launch_mma_by_hd(const Args& a, cudaStream_t st) {
  switch (a.hd) {
    case 32: return launch_mma<32>(a, st);
    case 64: return launch_mma<64>(a, st);
    case 80: return launch_mma<80>(a, st);
    case 96: return launch_mma<96>(a, st);
    case 128: return launch_mma<128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (CUDA cores, any hd), 1 = bfloat16 (tensor cores, hd
// one of 32, 64, 80, 96, 128). Returns cudaGetLastError() (or the error
// of a refused attribute or head dim), 0 on success.
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
  if (dtype == 1) return int(launch_mma_by_hd(a, st));
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

// CUDA-core trunk leg: float32 inputs, and int8 QK^T in both dtypes.
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

// Key k of the trunk (rows past Tt zero-filled).
struct PrefixKV {
  const am::bf16 *tk, *tv;
  int kh, Tt, hd;
  __device__ __forceinline__ am::KVRow operator()(int key) const {
    const bool ok = key < Tt;
    const size_t off = (size_t(kh) * Tt + (ok ? key : 0)) * hd;
    return {tk + off, tv + off, ok};
  }
};

// Scores of one warp's tile: scale, ALiBi on slot positions, -inf past Tt.
struct PrefixFix {
  float sm_scale;
  bool alibi;
  int Tt, c0;
  float slope[2];
  __device__ __forceinline__ void operator()(int t, float (&s)[8][4]) const {
    const int k0 = t * am::kKeys;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + c0 + (e & 1);
        float x = __fmul_rn(s[j][e], sm_scale);
        if (alibi) x = __fadd_rn(x, __fmul_rn(slope[e >> 1], float(key)));
        s[j][e] = key < Tt ? x : -CUDART_INF_F;
      }
  }
};

// The partials of one lane's four columns of row half h, in the (B, K, R,
// G) layout of the plain twin: flattened query n of batch row b sits at
// (b * K + kh) * R * G + n % (R * G).
struct PrefixStore {
  float* o;
  int N, RG, K, kh, hd, nr;
  __device__ __forceinline__ size_t row(int n) const {
    return size_t(n / RG) * K * RG + size_t(kh) * RG + n % RG;
  }
  __device__ __forceinline__ void operator()(int h, int col, float4 v) const {
    const int n = nr + 8 * h;
    if (n < N) *reinterpret_cast<float4*>(o + row(n) * hd + col) = v;
  }
};

// The bf16 trunk leg on tensor cores. Grid (ceil(N / rows), K) with
// N = B * R * G flattened queries, rows = 16 * blockDim.x / 32.
template <int HD>
__global__ void __launch_bounds__(am::kWarps * 32) prefix_mma_kernel(PrefixArgs a) {
  using am::bf16;
  extern __shared__ __align__(16) unsigned char prefix_mma_smem[];
  bf16* ring = reinterpret_cast<bf16*>(prefix_mma_smem);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kh = blockIdx.y;
  const int G = a.H / a.K;
  const int RG = a.R * G;
  const int N = a.B * RG;
  const int n0 = blockIdx.x * (blockDim.x >> 5) * 16;
  am::load_rows<HD>(am::q_stage<HD>(ring), (blockDim.x >> 5) * 16,
                    FlatQ{static_cast<const bf16*>(a.q), n0, N, kh, G, a.H, HD});
  const PrefixKV key{static_cast<const bf16*>(a.tk), static_cast<const bf16*>(a.tv), kh, a.Tt,
                     HD};
  PrefixFix fix{a.sm_scale, a.slopes != nullptr, a.Tt, 2 * (lane & 3), {0.f, 0.f}};
  const int nr = n0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = nr + 8 * h;
    if (fix.alibi && n < N) fix.slope[h] = a.slopes[kh * G + n % G];
  }

  am::Acc<HD> acc;
  am::acc_init<HD>(acc);
  const bool active = n0 + warp * 16 < N;
  am::key_loop<HD>(ring, (a.Tt + am::kKeys - 1) / am::kKeys, active, key, fix, acc);
  if (!active) return;
  const PrefixStore store{a.o, N, RG, a.K, kh, HD, nr};
  am::store_rows<HD>(acc, store);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = nr + 8 * h;
      if (n >= N) continue;
      a.m[store.row(n)] = acc.m[h];
      a.l[store.row(n)] = acc.l[h];
    }
  }
}

template <int HD>
cudaError_t launch_prefix_mma(const PrefixArgs& a, cudaStream_t st) {
  return launch_flat<HD>(prefix_mma_kernel<HD>, a, (long long)a.B * a.R * (a.H / a.K), a.K,
                         st);
}

cudaError_t prefix_mma_by_hd(const PrefixArgs& a, int hd, cudaStream_t st) {
  switch (hd) {
    case 32: return launch_prefix_mma<32>(a, st);
    case 64: return launch_prefix_mma<64>(a, st);
    case 80: return launch_prefix_mma<80>(a, st);
    case 96: return launch_prefix_mma<96>(a, st);
    case 128: return launch_prefix_mma<128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Trunk-leg partials of the two-leg cascade. dtype: 0 = float32,
// 1 = bfloat16; int8_qk: 0 = float32 QK^T (bf16: on tensor cores), 1 =
// int8 QK^T. hd one of 32, 64, 80, 96, 128. Returns cudaGetLastError() (or
// the error of a refused attribute or head dim), 0 on success.
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
                       : prefix_mma_by_hd(a, hd, st));
  return int(cudaErrorInvalidValue);
}
