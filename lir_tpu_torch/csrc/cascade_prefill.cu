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
// int8_qk the QK^T runs s8 x s8 -> s32 on payloads quantized by
// models/quant.py's dynamic rule (each query row and trunk key row),
// s = f32(s32) * (q_scale * sm_scale) * k_scale.
// lir_cascade_suffix_merge is the two-leg route's suffix leg and merge
// (XLA in the JAX package), lir_quantize_rows (lir_quantize_rows_f32) the
// trunk keys' int8 quantization that the int8 trunk leg reads (in the
// JAX package inside _prefix_kernel; decoder.cascade_extend quantizes
// every layer's trunk keys in one launch).
//
// Fused == two-leg, bitwise (the JAX package's "BITWISE the two-leg path",
// lir_tpu/ops/cascade_prefill.py:204-215). The fused kernel runs the
// two-leg arithmetic in the two-leg order, from one template per dtype:
// (1) the trunk walk alone, the trunk leg's own code (the last trunk tile
// masked past Tt, no window key in it), giving the bits cascade_prefix
// writes as (o_t, m_t, l_t); (2) the window walk under a fresh
// accumulator (m_s = -inf, l_s = 0 for a row with no valid key); (3) the
// merge in merge_partials' order with _rn intrinsics (nothing contracts
// into an FMA): m = max(m_t, m_s), w = isfinite(m_p) ? exp(m_p - m) : 0,
// l = w_t l_t + w_s l_s, o = (w_t o_t + w_s o_s) / max(l, 1e-30). The
// suffix merge (suffix_merge_kernel) reads (o_t, m_t, l_t) from device
// memory, walks the same window tiles with the same arithmetic and merges
// with the same code (merge_rows), so cascade_prefix (or
// cascade_prefix_int8) followed by it gives the fused kernel's bits. A
// row's trunk walk depends on nothing else of its block; its window walk
// takes the window keys of the batch rows of its 64 flattened rows as
// 64-key tiles from the first of them, in both kernels.
//
// Layout (the JAX package's public shapes): q (B, R, H, hd); window k, v
// (B, R, K, hd); trunk k, v (K, Tt, hd); suffix_mask and q_positions
// (B, R) int32; ALiBi slopes (H,) float32 (flattened row n of kv head kh
// uses head kh * G + n % G). Output (B, R, H, hd) in q's dtype; partials
// o (B, K, R, G, hd), m and l (B, K, R, G); int8 trunk payload (K, Tt, hd)
// with float32 scales (K, Tt).
//
// What bounds them on the H100: bytes, at the cascade dispatch's shape
// (llama-2-7b, B = 32, R = 80, Tt = 432). The fused kernel reads q, the
// window K/V and the trunk K/V and writes the output, ~91 MB against
// ~20 GFLOP of the model's work (~27 us of bytes); the trunk leg reads q
// (21 MB) and the trunk (7 MB) and writes 43 MB of float32 partials
// against 18 GFLOP (~21 us of bytes, ~18 us of bf16 tensor-core time);
// the suffix merge reads q, the window K/V (42 MB) and the partials
// (43 MB) and writes the output, ~126 MB (~38 us); the quantization of a
// dispatch's trunk keys (32 layers) reads 113 MB and writes 58 MB (~51
// us). All sit at or under the card's bf16 ridge (~295 FLOP per byte).
//
// The bf16 route (the main path's dtype) runs on tensor cores, with the
// online softmax in registers and P V in two passes over P = bf16 hi +
// bf16 lo, which keeps the float32 partials within 1e-3 of the float32
// reference.
// - The kernels tile the queries the same way: flattened rows
//   n = (b * R + r) * G + g of one kv head over ALL batch rows, 16 a warp,
//   64 (a warpgroup) a block of the fused kernel and an item of the suffix
//   merge, 128 (two) a block of the trunk leg (the last tile's rows past
//   N = B * R * G are zero-filled and never written).
// - Trunk walk (prefix_wgmma_kernel, and step (1) of the fused kernel):
//   attn_wgmma.cuh's wgmma walk over the trunk of the block's kv head,
//   its 64-key tiles by TMA into an mbarrier ring, the last tile masked
//   past Tt; o leaves the accumulator fragments as 16-byte stores. Its
//   accumulator is attn_mma's per-warp fragment layout, which the window
//   walk and the merge take as they are.
// - Window walk: 64 rows walk the windows of the batch rows they belong to
//   (mask-aware, causal, ALiBi on the key's position; a row sees only its
//   own batch row's window). The fused kernel: mma.sync with ldmatrix
//   operands, a cp.async ring (attn_mma.cuh); the suffix merge: wgmma
//   (attn_wgmma's tile_step, split P), which gives mma.sync's bits for the
//   same k16 chains in the same order.
// - Suffix merge (suffix_merge_kernel), persistent. Its predecessor, the
//   fused kernel's template with the trunk walk replaced by a read of the
//   partials (1,280 blocks of 64 rows at the dispatch's shape, 0.172 ms),
//   measured in pieces (kernel_variants.py, PERF.md): its products were
//   not overlapped with its loads, its partials' float2 reads came after
//   the walk, one exposed load at a time. Here two blocks an SM (three at
//   hd <= 64) stay resident and walk a static list of (kv head, 64 rows)
//   items, the kv head fastest (neighbouring blocks read neighbouring
//   heads of the same window rows, partials and q rows; tile-fastest is
//   slower). A producer warp copies each item's Q rows by cp.async into
//   the Q tile (any G; the tile's barrier counts its lanes' arrivals),
//   asks by TMA for the window tiles (a 3-D map over (B * R, K, hd)) as
//   the two ring stages free up, and bulk-copies the item's float32
//   partials, a row a copy, into a stash as soon as the item before is
//   merged; the consumer warpgroup walks and merges the item before. The
//   merge reads all its partials from the stash before its arithmetic,
//   and the output rows go out by bulk copies staged over the stash
//   (faster than each lane's stores). One slot and two stages leave room
//   for two consumers an SM, which beats deeper prefetch at one an SM;
//   the merge divides by __fdiv_rn (a Markstein quotient with its checks
//   was slower). What still holds it at ~3x its bound: each item's loads
//   start only when the item before frees its slot and stages, and queue
//   behind the ~30 MB that all blocks ask for at once (112 KB a block);
//   the window products add about a fifth of its time that no load hides
//   (the variants without them).
// - The fused kernel keeps (o_t) in shared memory between the walks (two
//   accumulators of 64 floats a thread would spill) and runs a 2-stage
//   ring, which fits two blocks an SM beside that stash.
// - int8 trunk leg (prefix_imma_kernel): the trunk keys are quantized once
//   per (layer, kv head, key) by lir_quantize_rows, every layer's in one
//   launch a dispatch, not once per block of query rows (about 80 blocks a
//   kv head at N = 2,560); each block quantizes its
//   query rows once at load, the scale carrying sm_scale; QK^T runs on
//   IMMA (mma.sync m16n8k32 s8 x s8 -> s32, exact), the scores fold as
//   f32(s32) * (q_scale * sm_scale) * k_scale, so they and the row max are
//   bitwise the plain twin's; P V is the bf16 split-P pass over bf16 V.
//   Head dims that are not a multiple of 32 (80) run with zero-padded
//   depth, which adds exact zeros.
//
// Float32 inputs take float32-exact CUDA-core kernels, chosen by the dtype
// argument: prefix_kernel (attn_tile.cuh's 64 x 64 tiles with 4 x 4
// register micro-tiles; also the float32 int8-QK^T trunk leg with __dp4a
// on the keys' lir_quantize_rows_f32 payload)
// and cascade_tile_kernel (the same trunk walk, then the window walk and
// the merge, for the fused route and the suffix merge). This is a
// dispatch on the input type, not a fallback: a bf16 call never reaches
// that code. Every kernel is built for head dims 32, 64, 80, 96 and 128;
// another is refused (the wrapper raises before the launch; the entry
// point returns cudaErrorInvalidValue).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <cmath>

#include "attn_mma.cuh"
#include "attn_tile.cuh"
#include "attn_wgmma.cuh"

namespace {

namespace am = attn_mma;
namespace aw = attn_wgmma;
namespace hp = hopper;
namespace tile = attn_tile;

struct Args {
  const void* q;        // (B, R, H, hd)
  const void* sk;       // (B, R, K, hd) window keys
  const void* sv;
  const void* tk;       // (K, Tt, hd) trunk (or, int8: the s8 payload)
  const void* tv;
  const float* tks;     // (K, Tt) int8 trunk key scales
  const int* smask;     // (B, R)
  const int* qpos;      // (B, R)
  const float* slopes;  // (H,) or null
  void* out;            // (B, R, H, hd)
  float* o;             // trunk partials: written by the trunk leg, read by
  float* m;             // the suffix merge
  float* l;
  int B, R, H, K, Tt;
  float sm_scale;
};

// Partials of flattened query n (of N = B * R * G) of kv head kh sit at row
// (b * K + kh) * R * G + n % (R * G) of the (B, K, R, G) layout.
__device__ __forceinline__ size_t part_row(int n, int RG, int K, int kh) {
  return size_t(n / RG) * K * RG + size_t(kh) * RG + n % RG;
}

// The log-sum-exp merge of a row's trunk partial (o_t, m_t, l_t) and
// window partial (o_s, m_s, l_s), in merge_partials' order: the row's
// weights once, then each output element (w_t o_t + w_s o_s) / max(l, 1e-30).
struct Merge {
  float w_t, w_s, den;
  __device__ __forceinline__ Merge(float m_t, float l_t, float m_s, float l_s) {
    const float m = fmaxf(m_t, m_s);
    w_t = isfinite(m_t) ? expf(__fsub_rn(m_t, m)) : 0.f;
    w_s = isfinite(m_s) ? expf(__fsub_rn(m_s, m)) : 0.f;
    den = fmaxf(__fadd_rn(__fmul_rn(w_t, l_t), __fmul_rn(w_s, l_s)), 1e-30f);
  }
  __device__ __forceinline__ float operator()(float o_t, float o_s) const {
    return __fdiv_rn(__fadd_rn(__fmul_rn(w_t, o_t), __fmul_rn(w_s, o_s)), den);
  }
};

// ---------------------------------------------------------------------------
// Float32 inputs: CUDA-core tiles of attn_tile.cuh.
// ---------------------------------------------------------------------------

template <int HD, bool INT8>
struct TileSmem {
  using D = tile::Dims<HD>;
  // float: q tile, one K-then-V tile; int8: q and k payloads + scales and
  // a V tile. Then the probability tile and the row statistics of two
  // partials (m, l, rescale factor; m_s, l_s).
  static constexpr size_t kQ = INT8 ? tile::kQB * D::kLd8 * 4 + tile::kQB * 4
                                    : tile::kQB * D::kLd * 4;
  static constexpr size_t kK = INT8 ? tile::kKB * D::kLd8 * 4 + tile::kKB * 4 : 0;
  static constexpr size_t kV = tile::kKB * D::kLd * 4;
  static constexpr size_t kP = tile::kQB * tile::kLdP * 4;
  static constexpr size_t kStats = 5 * tile::kQB * 4;
  static constexpr size_t kBytes = kQ + kK + kV + kP + kStats;
};

template <int HD, bool INT8>
struct TileView {
  float* qf;   // float query tile
  int* q8;     // int8 query payloads
  float* qsc;  // their scales (times sm_scale)
  int* k8;
  float* ksc;
  float* vs;   // float: K, then V
  float* ps;
  float* m;
  float* l;
  float* sc;
  float* ms;
  float* ls;
  __device__ explicit TileView(unsigned char* p) {
    using S = TileSmem<HD, INT8>;
    using D = tile::Dims<HD>;
    qf = reinterpret_cast<float*>(p);
    q8 = reinterpret_cast<int*>(p);
    qsc = reinterpret_cast<float*>(p + tile::kQB * D::kLd8 * 4);
    p += S::kQ;
    k8 = reinterpret_cast<int*>(p);
    ksc = reinterpret_cast<float*>(p + tile::kKB * D::kLd8 * 4);
    p += S::kK;
    vs = reinterpret_cast<float*>(p);
    p += S::kV;
    ps = reinterpret_cast<float*>(p);
    p += S::kP;
    m = reinterpret_cast<float*>(p);
    l = m + tile::kQB;
    sc = l + tile::kQB;
    ms = sc + tile::kQB;
    ls = ms + tile::kQB;
  }
};

// The trunk leg of one block of kQB flattened queries against the whole
// trunk of kv head kh: loads the block's query tile (kept in shared memory
// for a later window walk), leaves the running (m, l) in smem and the PV
// accumulator of the thread's rows ty + 16 i and columns tx + 16 c in acc.
template <typename T, int HD, bool INT8>
__device__ __forceinline__ void trunk_walk(const Args& a, const TileView<HD, INT8>& v, int n0,
                                           int kh, float (&acc)[4][tile::Dims<HD>::kCols]) {
  using D = tile::Dims<HD>;
  const int G = a.H / a.K;
  const int N = a.B * a.R * G;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
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
    tile::load_tile_int8<HD>(v.q8, v.qsc, q, tile::kQB, a.sm_scale, q_off, q_ok);
  } else {
    tile::load_tile<HD>(v.qf, q, tile::kQB, a.sm_scale, q_off, q_ok);
  }
  for (int i = threadIdx.x; i < tile::kQB; i += blockDim.x) {
    v.m[i] = -CUDART_INF_F;
    v.l[i] = 0.f;
  }
  float slope[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    slope[i] = (a.slopes != nullptr && n < N) ? a.slopes[kh * G + n % G] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D::kCols; ++c) acc[i][c] = 0.f;

  for (int t0 = 0; t0 < a.Tt; t0 += tile::kKB) {
    __syncthreads();  // the previous tile's PV is done with vs and ps
    auto k_off = [&](int r) { return (size_t(kh) * a.Tt + t0 + r) * HD; };
    auto k_ok = [&](int r) { return t0 + r < a.Tt; };
    if constexpr (INT8) {
      // The keys' s8 payload (four a word) and scales, quantized apart
      // (lir_quantize_rows_f32); keys past Tt are zeros.
      const int* tk8 = static_cast<const int*>(a.tk);
      for (int i = threadIdx.x; i < tile::kKB * (HD / 4); i += blockDim.x) {
        const int r = i / (HD / 4);
        const int c = i - r * (HD / 4);
        v.k8[r * D::kLd8 + c] =
            t0 + r < a.Tt ? tk8[(size_t(kh) * a.Tt + t0 + r) * (HD / 4) + c] : 0;
      }
      for (int r = threadIdx.x; r < tile::kKB; r += blockDim.x)
        v.ksc[r] = t0 + r < a.Tt ? a.tks[size_t(kh) * a.Tt + t0 + r] : 0.f;
      tile::load_tile<HD>(v.vs, tv, tile::kKB, 1.f, k_off, k_ok);
    } else {
      tile::load_tile<HD>(v.vs, tk, tile::kKB, 1.f, k_off, k_ok);
    }
    __syncthreads();
    float s[4][4];
    if constexpr (INT8) {
      int s32[4][4];
      tile::score_s8<HD>(v.q8, v.k8, s32);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = __fmul_rn(__fmul_rn(float(s32[i][j]), v.qsc[ty + 16 * i]),
                              v.ksc[tx + 16 * j]);
    } else {
      tile::score_f32<HD>(v.qf, v.vs, s);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + tx + 16 * j;
        float x = s[i][j];
        if (a.slopes != nullptr) x = __fadd_rn(x, __fmul_rn(slope[i], float(t)));
        v.ps[(ty + 16 * i) * tile::kLdP + tx + 16 * j] = t < a.Tt ? x : -CUDART_INF_F;
      }
    __syncthreads();
    if constexpr (!INT8) {
      tile::load_tile<HD>(v.vs, tv, tile::kKB, 1.f, k_off, k_ok);
    }
    tile::online_softmax(v.ps, v.m, v.l, v.sc);
    __syncthreads();
    tile::pv_update<HD>(v.ps, v.vs, v.sc, acc);
  }
  __syncthreads();
}

// CUDA-core trunk leg: float32 inputs, float or int8 QK^T. Grid
// (ceil(N / kQB), K); the tail tile's rows past N are never written.
template <typename T, int HD, bool INT8>
__global__ void __launch_bounds__(tile::kThreads) prefix_kernel(Args a) {
  using D = tile::Dims<HD>;
  extern __shared__ __align__(16) unsigned char prefix_smem[];
  const TileView<HD, INT8> v(prefix_smem);
  const int kh = blockIdx.y;
  const int n0 = blockIdx.x * tile::kQB;
  const int RG = a.R * (a.H / a.K);
  const int N = a.B * RG;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc[4][D::kCols];
  trunk_walk<T, HD, INT8>(a, v, n0, kh, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= N) continue;
    const size_t row = part_row(n, RG, a.K, kh);
#pragma unroll
    for (int c = 0; c < D::kCols; ++c) a.o[row * HD + tx + 16 * c] = acc[i][c];
  }
  for (int i = threadIdx.x; i < tile::kQB; i += blockDim.x) {
    const int n = n0 + i;
    if (n >= N) continue;
    const size_t row = part_row(n, RG, a.K, kh);
    a.m[row] = v.m[i];
    a.l[row] = v.l[i];
  }
}

// Float32 fused cascade (kFused: the trunk walk of prefix_kernel) or suffix
// merge (the trunk partials read from a.o, a.m, a.l), then the window walk
// and the merge. Grid (ceil(N / kQB), K).
template <typename T, int HD, bool kFused>
__global__ void __launch_bounds__(tile::kThreads) cascade_tile_kernel(Args a) {
  using D = tile::Dims<HD>;
  extern __shared__ __align__(16) unsigned char cascade_tile_smem[];
  const TileView<HD, false> v(cascade_tile_smem);
  const int kh = blockIdx.y;
  const int n0 = blockIdx.x * tile::kQB;
  const int G = a.H / a.K;
  const int RG = a.R * G;
  const int N = a.B * RG;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  // Step 1: the trunk partial, into registers (o_t) and v.m / v.l.
  float acc_t[4][D::kCols];
  if constexpr (kFused) {
    trunk_walk<T, HD, false>(a, v, n0, kh, acc_t);
  } else {
    const T* q = static_cast<const T*>(a.q);
    tile::load_tile<HD>(
        v.qf, q, tile::kQB, a.sm_scale,
        [&](int r) {
          const int n = n0 + r;
          return (size_t(n / G) * a.H + size_t(kh) * G + n % G) * HD;
        },
        [&](int r) { return n0 + r < N; });
    for (int i = threadIdx.x; i < tile::kQB; i += blockDim.x) {
      const int n = n0 + i;
      const size_t row = n < N ? part_row(n, RG, a.K, kh) : 0;
      v.m[i] = n < N ? a.m[row] : -CUDART_INF_F;
      v.l[i] = n < N ? a.l[row] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + ty + 16 * i;
      const size_t row = n < N ? part_row(n, RG, a.K, kh) : 0;
#pragma unroll
      for (int c = 0; c < D::kCols; ++c)
        acc_t[i][c] = n < N ? a.o[row * HD + tx + 16 * c] : 0.f;
    }
    __syncthreads();
  }

  // Step 2: the window walk under a fresh accumulator. The block's rows
  // span batch rows b_lo ..; their windows are rows b_lo * R + w of the
  // (B * R, K, hd) window k/v, w < n_win.
  const T* sk = static_cast<const T*>(a.sk);
  const T* sv = static_cast<const T*>(a.sv);
  const int b_lo = n0 / RG;
  const int n_win = ((min(n0 + tile::kQB, N) - 1) / RG - b_lo + 1) * a.R;
  const int* qpos = a.qpos + size_t(b_lo) * a.R;
  const int* smask = a.smask + size_t(b_lo) * a.R;
  for (int i = threadIdx.x; i < tile::kQB; i += blockDim.x) {
    v.ms[i] = -CUDART_INF_F;
    v.ls[i] = 0.f;
  }
  float slope[4];
  int qp[4], wb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    const bool ok = n < N;
    slope[i] = (a.slopes != nullptr && ok) ? a.slopes[kh * G + n % G] : 0.f;
    const int b = ok ? n / RG : 0;
    qp[i] = ok ? a.qpos[size_t(b) * a.R + (n - b * RG) / G] : 0;
    wb[i] = ok ? b - b_lo : -2;
  }
  float acc_s[4][D::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D::kCols; ++c) acc_s[i][c] = 0.f;
  for (int w0 = 0; w0 < n_win; w0 += tile::kKB) {
    __syncthreads();  // the previous tile's PV is done with vs and ps
    auto k_off = [&](int r) { return ((size_t(b_lo) * a.R + w0 + r) * a.K + kh) * HD; };
    auto k_ok = [&](int r) { return w0 + r < n_win; };
    tile::load_tile<HD>(v.vs, sk, tile::kKB, 1.f, k_off, k_ok);
    __syncthreads();
    float s[4][4];
    tile::score_f32<HD>(v.qf, v.vs, s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = w0 + tx + 16 * j;
      const bool in = w < n_win;
      const int kp = in ? qpos[w] : 0;
      const bool live = in && smask[w] > 0;
      const int kb = in ? w / a.R : -1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[i][j];
        if (a.slopes != nullptr) x = __fadd_rn(x, __fmul_rn(slope[i], float(kp)));
        v.ps[(ty + 16 * i) * tile::kLdP + tx + 16 * j] =
            (live && kb == wb[i] && kp <= qp[i]) ? x : -CUDART_INF_F;
      }
    }
    __syncthreads();
    tile::load_tile<HD>(v.vs, sv, tile::kKB, 1.f, k_off, k_ok);
    tile::online_softmax(v.ps, v.ms, v.ls, v.sc);
    __syncthreads();
    tile::pv_update<HD>(v.ps, v.vs, v.sc, acc_s);
  }
  __syncthreads();

  // Step 3: the merge, written in q's layout.
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int n = n0 + r;
    if (n >= N) continue;
    T* dst = out + (size_t(n / G) * a.H + size_t(kh) * G + n % G) * HD;
    const Merge merge(v.m[r], v.l[r], v.ms[r], v.ls[r]);
#pragma unroll
    for (int c = 0; c < D::kCols; ++c)
      dst[tx + 16 * c] = tile::from_f32<T>(merge(acc_t[i][c], acc_s[i][c]));
  }
}

template <int HD, bool INT8>
cudaError_t launch_tile(void (*kernel)(Args), const Args& a, cudaStream_t st) {
  const int smem = int(TileSmem<HD, INT8>::kBytes);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long long N = (long long)a.B * a.R * (a.H / a.K);
  dim3 grid(unsigned((N + tile::kQB - 1) / tile::kQB), a.K);
  kernel<<<grid, tile::kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 inputs: tensor cores (attn_mma.cuh).
// ---------------------------------------------------------------------------

using am::bf16;

// Q row i of a block of the bf16 kernels: flattened query n = n0 + i of
// kv head kh is q[b, r, kh * G + g] with b * R + r = n / G.
struct FlatQ {
  const bf16* q;
  int n0, N, kh, G, H, hd;
  __device__ __forceinline__ am::Row operator()(int i) const {
    const int n = n0 + i;
    const bool ok = n < N;
    const int m = ok ? n : n0;
    return {q + (size_t(m / G) * H + size_t(kh) * G + m % G) * hd, ok};
  }
};

// Launch of a bf16 kernel: grid (ceil(N / rows), K) over N flattened
// queries of K kv heads, am::warps_for(N) warps of 16 rows a block.
cudaError_t launch_flat(void (*kernel)(Args), const Args& a, size_t smem, cudaStream_t st) {
  const long long N = (long long)a.B * a.R * (a.H / a.K);
  const int warps = am::warps_for(N);
  const int rows = warps * 16;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  dim3 grid(unsigned((N + rows - 1) / rows), a.K);
  kernel<<<grid, warps * 32, smem, st>>>(a);
  return cudaGetLastError();
}

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

// The partials of one lane's four columns of row half h.
struct PrefixStore {
  float* o;
  int N, RG, K, kh, hd, nr;
  __device__ __forceinline__ void operator()(int h, int col, float4 v) const {
    const int n = nr + 8 * h;
    if (n < N) *reinterpret_cast<float4*>(o + part_row(n, RG, K, kh) * hd + col) = v;
  }
};

// This lane's two rows (half h is row g + 8 h of the warp's tile) in a
// block of the bf16 kernels.
struct LaneRows {
  int nr;          // flattened query of half 0
  float slope[2];  // their ALiBi slopes
};

__device__ __forceinline__ LaneRows lane_rows(const Args& a, int n0, int kh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int G = a.H / a.K;
  const int N = a.B * a.R * G;
  LaneRows lr{n0 + warp * 16 + (lane >> 2), {0.f, 0.f}};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = lr.nr + 8 * h;
    if (a.slopes != nullptr && n < N) lr.slope[h] = a.slopes[kh * G + n % G];
  }
  return lr;
}

// Arguments of the kernels that walk the trunk by TMA: its tensor maps
// (in kernel parameter space, where TMA reads them) and the rest.
struct TrunkArgs {
  CUtensorMap tk;  // trunk k (K, Tt, hd)
  CUtensorMap tv;  // trunk v
  Args a;
};

// Ring stages of the trunk-leg kernel's walk (two warpgroups and a
// producer warp a block, one block an SM), and of the fused kernel's (one
// warpgroup; its tiles, reused by the window walk's ring and the o_t
// stash, fit two blocks an SM).
constexpr int kPrefixStages = 5;
constexpr int kFusedTrunkStages = 2;
constexpr int kPrefixWG = 2;
constexpr int kPrefixThreads = kPrefixWG * 128 + 32;

// The block's trunk (kv head blockIdx.y) and its Q tiles (rows n0 .. n0 +
// rows - 1, 64 a warpgroup) in shared memory at smem, barriers at bars;
// the Q copies issued and committed by every thread. consumer_warps: the
// arrivals that free a stage where a producer warp refills the ring.
template <int HD, int kSt>
__device__ __forceinline__ aw::Trunk trunk_setup(const TrunkArgs& ta, unsigned char* smem,
                                                 uint64_t* bars, int n0, int rows,
                                                 int consumer_warps) {
  using W = aw::Dims<HD>;
  const Args& a = ta.a;
  const int kh = blockIdx.y;
  const int G = a.H / a.K;
  const aw::Trunk tr{smem + (rows / 64) * W::kTile, bars, bars + kSt, &ta.tk, &ta.tv, kh,
                     (a.Tt + am::kKeys - 1) / am::kKeys};
  aw::init_ring<kSt>(tr, consumer_warps);
  aw::load_q<HD>(smem, rows, FlatQ{static_cast<const bf16*>(a.q), n0, a.B * a.R * G, kh, G, a.H,
                                   HD});
  am::cp_async_commit();
  return tr;
}

// The Q copies landed and visible to wgmma, every barrier initialised.
__device__ __forceinline__ void q_ready() {
  am::cp_async_wait<0>();
  hp::fence_proxy_async();
  __syncthreads();
}

__device__ __forceinline__ PrefixFix prefix_fix(const Args& a, const LaneRows& lr) {
  return PrefixFix{a.sm_scale, a.slopes != nullptr, a.Tt, 2 * int(threadIdx.x & 3),
                   {lr.slope[0], lr.slope[1]}};
}

// Shared memory of the trunk leg: tiles (a Q tile a warpgroup, then the
// ring), full and empty barriers.
template <int HD>
struct PrefixSmem {
  static constexpr size_t kTiles =
      size_t(kPrefixWG) * aw::Dims<HD>::kTile + size_t(kPrefixStages) * aw::Dims<HD>::kStage;
  static constexpr size_t kBytes = kTiles + 16 * kPrefixStages;
};

// The bf16 trunk leg on wgmma: two warpgroups of 64 flattened queries a
// block over one ring, and a producer warp that refills it. Grid
// (ceil(N / 128), K), N = B * R * G.
template <int HD>
__global__ void __launch_bounds__(kPrefixThreads, 1)
    prefix_wgmma_kernel(const __grid_constant__ TrunkArgs ta) {
  extern __shared__ unsigned char prefix_wgmma_smem_raw[];
  unsigned char* smem = hp::aligned_smem(prefix_wgmma_smem_raw);
  const Args& a = ta.a;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int G = a.H / a.K;
  const int RG = a.R * G;
  const int N = a.B * RG;
  const int n0 = blockIdx.x * kPrefixWG * 64;
  constexpr int kSt = kPrefixStages;
  const aw::Trunk tr =
      trunk_setup<HD, kSt>(ta, smem, reinterpret_cast<uint64_t*>(smem + PrefixSmem<HD>::kTiles),
                           n0, kPrefixWG * 64, kPrefixWG * 4);
  if (threadIdx.x == kPrefixWG * 128)
    for (int t = 0; t < kSt && t < tr.n_tiles; ++t) aw::issue_tile<HD>(tr, t, t);
  q_ready();
  if (warp == kPrefixWG * 4) {
    // Producer warp: tile t into its stage once tile t - kSt has left it.
    if (lane == 0)
      for (int t = kSt; t < tr.n_tiles; ++t) {
        hp::mbar_wait(&tr.empty[t % kSt], (t / kSt - 1) & 1);
        aw::issue_tile<HD>(tr, t % kSt, t);
      }
    return;
  }
  const LaneRows lr = lane_rows(a, n0, blockIdx.y);
  float o[aw::Dims<HD>::kAcc], m[2], l[2];
  aw::trunk_walk<HD, kSt>(
      tr, smem + (threadIdx.x >> 7) * aw::Dims<HD>::kTile, prefix_fix(a, lr),
      [&](int t) {
        __syncwarp();
        if (lane == 0) hp::mbar_arrive(&tr.empty[t % kSt]);
      },
      o, m, l);
  if (n0 + warp * 16 >= N) return;
  am::Acc<HD> acc;
  aw::to_acc<HD>(o, m, l, acc);
  am::store_rows<HD>(acc, PrefixStore{a.o, N, RG, a.K, int(blockIdx.y), HD, lr.nr});
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = lr.nr + 8 * h;
      if (n >= N) continue;
      a.m[part_row(n, RG, a.K, blockIdx.y)] = acc.m[h];
      a.l[part_row(n, RG, a.K, blockIdx.y)] = acc.l[h];
    }
  }
}

// Window row w of a block is row b_lo * R + w of (B * R, K, hd).
struct WindowKV {
  const bf16 *sk, *sv;
  int b_lo, n_win, kh, R, K, hd;
  __device__ __forceinline__ am::KVRow operator()(int w) const {
    const bool ok = w < n_win;
    const size_t off = ((size_t(b_lo) * R + (ok ? w : 0)) * K + kh) * hd;
    return {sk + off, sv + off, ok};
  }
};

// A lane's 16 key columns of a 64-key window tile (n-tile j, column c: key
// k0 + 8 j + c0 + c): whether each is visible to the lane's row half h
// (bit 4 j + 2 c + h), and its position for ALiBi.
struct WindowCols {
  uint32_t vis;
  float kp[16];
};

// Window scores of one warp's tile: scale, ALiBi on the key's position, and
// -inf unless the key is real, unmasked, of the row's own batch row and
// not after the row's position. load(t) reads the lane's key columns of
// tile t (before its products, where the caller can), apply() fixes the
// raw scores up from them.
struct WindowFix {
  const int* qpos;   // (B, R), from the block's first window row on
  const int* smask;  // the same
  float sm_scale;
  bool alibi;
  int R, n_win, c0;
  float slope[2];
  int qp[2];  // the rows' query positions
  int wb[2];  // the rows' batch rows, counted from b_lo
  __device__ __forceinline__ WindowCols load(int t) const {
    WindowCols cols;
    cols.vis = 0;
    const int k0 = t * am::kKeys;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int w = k0 + 8 * j + c0 + c;
        const bool in = w < n_win;
        const int kp = in ? __ldg(qpos + w) : 0;
        const bool live = in && __ldg(smask + w) > 0;
        const int kb = in ? w / R : -1;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          cols.vis |= uint32_t(live && kb == wb[h] && kp <= qp[h]) << (4 * j + 2 * c + h);
        cols.kp[2 * j + c] = float(kp);
      }
    return cols;
  }
  __device__ __forceinline__ void apply(const WindowCols& cols, float (&s)[8][4]) const {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + c;
          float x = __fmul_rn(s[j][e], sm_scale);
          if (alibi) x = __fadd_rn(x, __fmul_rn(slope[h], cols.kp[2 * j + c]));
          s[j][e] = (cols.vis >> (4 * j + 2 * c + h)) & 1u ? x : -CUDART_INF_F;
        }
  }
  __device__ __forceinline__ void operator()(int t, float (&s)[8][4]) const {
    apply(load(t), s);
  }
};

// A lane's window fix-up for the block's rows n0 .. n0 + 63 of kv head kh
// (the lane's two rows lr.nr, lr.nr + 8), whose windows start at batch
// row b_lo and span n_win window rows.
__device__ __forceinline__ WindowFix window_fix(const Args& a, const LaneRows& lr, int b_lo,
                                                int n_win) {
  const int G = a.H / a.K;
  const int RG = a.R * G;
  const int N = a.B * RG;
  WindowFix fix{a.qpos + size_t(b_lo) * a.R, a.smask + size_t(b_lo) * a.R, a.sm_scale,
                a.slopes != nullptr, a.R, n_win, 2 * int(threadIdx.x & 3),
                {lr.slope[0], lr.slope[1]}, {0, 0}, {-2, -2}};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = lr.nr + 8 * h;
    if (n >= N) continue;
    const int b = n / RG;
    fix.qp[h] = a.qpos[size_t(b) * a.R + (n - b * RG) / G];
    fix.wb[h] = b - b_lo;
  }
  return fix;
}

// The batch row b_lo of the first of the 64 flattened rows from n0, and
// the window rows their batch rows span (a whole window each).
__device__ __forceinline__ int window_rows(const Args& a, int n0, int& b_lo) {
  const int RG = a.R * (a.H / a.K);
  const int N = a.B * RG;
  b_lo = n0 / RG;
  return ((min(n0 + 64, N) - 1) / RG - b_lo + 1) * a.R;
}

// The merge of one lane's rows (Merge, in merge_partials' order) of the
// window partial acc with the trunk partial (o_t from ot(h, j): the
// float2 of row half h, n-tile j; m_t, l_t), into acc. Every o_t is read
// before the first is used.
template <int HD, typename OT>
__device__ __forceinline__ void merge_rows(const float (&m_t)[2], const float (&l_t)[2],
                                           const OT& ot, am::Acc<HD>& acc) {
  constexpr int kNT = am::Dims<HD>::kNT;
  float2 o_t[kNT][2];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) o_t[j][h] = ot(h, j);
  const Merge merge[2] = {Merge(m_t[0], l_t[0], acc.m[0], acc.l[0]),
                          Merge(m_t[1], l_t[1], acc.m[1], acc.l[1])};
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc.o[j][2 * h] = merge[h](o_t[j][h].x, acc.o[j][2 * h]);
      acc.o[j][2 * h + 1] = merge[h](o_t[j][h].y, acc.o[j][2 * h + 1]);
    }
}

// Flattened query n's output row (q's layout) of kv head kh.
__device__ __forceinline__ bf16* out_row(const Args& a, int n, int kh, int hd) {
  const int G = a.H / a.K;
  return static_cast<bf16*>(a.out) + (size_t(n / G) * a.H + size_t(kh) * G + n % G) * hd;
}

// One lane's rows of acc as bf16 in q's layout, rows past N skipped.
template <int HD>
__device__ __forceinline__ void store_out(const Args& a, const LaneRows& lr, int kh,
                                          const am::Acc<HD>& acc) {
  const int N = a.B * a.R * (a.H / a.K);
  am::store_rows<HD>(acc, [&](int h, int col, float4 v) {
    const int n = lr.nr + 8 * h;
    if (n >= N) return;
    uint2 pk;
    pk.x = am::as_u32(__floats2bfloat162_rn(v.x, v.y));
    pk.y = am::as_u32(__floats2bfloat162_rn(v.z, v.w));
    *reinterpret_cast<uint2*>(out_row(a, n, kh, HD) + col) = pk;
  });
}

// Ring stages of the fused kernel's window walk: two, which leave room for
// its (o_t) stash at two blocks an SM. The depth of a ring moves no bit.
// It takes 64 rows (a warpgroup) a block, whatever N.
constexpr int kCascadeStages = 2;

// Shared memory of the fused kernel: its tiles (the trunk walk's Q tile
// and ring, then, over the same bytes, the window walk's ring and the o_t
// stash), then the trunk ring's barriers.
template <int HD>
struct CascadeSmem {
  static constexpr size_t kWindow =
      am::Dims<HD>::kTile * 2 * sizeof(bf16) * kCascadeStages +
      size_t(am::kWarps) * 32 * am::Dims<HD>::kNT * 4 * sizeof(float);
  static constexpr size_t kTrunk =
      aw::Dims<HD>::kTile + size_t(kFusedTrunkStages) * aw::Dims<HD>::kStage;
  static constexpr size_t kTiles = kWindow > kTrunk ? kWindow : kTrunk;
  static constexpr size_t kBytes = kTiles + 16 * kFusedTrunkStages;
};

// The fused cascade: (1) the trunk walk, (2) the window walk, (3) the
// merge. Grid (ceil(N / 64), K) with N = B * R * G flattened queries, four
// warps.
template <int HD>
__global__ void __launch_bounds__(am::kWarps * 32)
    cascade_mma_kernel(const __grid_constant__ TrunkArgs ta) {
  using D = am::Dims<HD>;
  extern __shared__ unsigned char cascade_mma_smem_raw[];
  unsigned char* smem = hp::aligned_smem(cascade_mma_smem_raw);
  const Args& a = ta.a;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  constexpr int kSt = kCascadeStages;
  constexpr size_t kRing = size_t(2) * kSt * D::kTile * sizeof(bf16);
  float* stash = reinterpret_cast<float*>(smem + kRing);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kh = blockIdx.y;
  const int G = a.H / a.K;
  const int N = a.B * a.R * G;
  const int rows = (blockDim.x >> 5) * 16;
  const int n0 = blockIdx.x * rows;
  const LaneRows lr = lane_rows(a, n0, blockIdx.y);
  const bool active = n0 + warp * 16 < N;

  // Step 1: the trunk leg's walk, its o_t stashed lane by lane (fragment
  // j, element e at ((warp * kNT + j) * 4 + e) * 32 + lane). One
  // warpgroup: thread 0 refills a stage after a block barrier.
  am::Acc<HD> acc;
  float m_t[2], l_t[2];
  {
    constexpr int kTS = kFusedTrunkStages;
    const aw::Trunk tr = trunk_setup<HD, kTS>(
        ta, smem, reinterpret_cast<uint64_t*>(smem + CascadeSmem<HD>::kTiles), n0, rows, 0);
    if (threadIdx.x == 0)
      for (int t = 0; t < kTS && t < tr.n_tiles; ++t) aw::issue_tile<HD>(tr, t, t);
    q_ready();
    float o[aw::Dims<HD>::kAcc], m[2], l[2];
    aw::trunk_walk<HD, kTS>(
        tr, smem, prefix_fix(a, lr),
        [&](int t) {
          __syncthreads();
          if (threadIdx.x == 0 && t + kTS < tr.n_tiles) aw::issue_tile<HD>(tr, t % kTS, t + kTS);
        },
        o, m, l);
    aw::to_acc<HD>(o, m, l, acc);
    float* st = stash + size_t(warp) * D::kNT * 4 * 32 + lane;
#pragma unroll
    for (int j = 0; j < D::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[(j * 4 + e) * 32] = acc.o[j][e];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_t[h] = acc.m[h];
      l_t[h] = acc.l[h];
    }
    hp::fence_proxy_async();  // the window walk's copies reuse the trunk's bytes
    __syncthreads();
  }

  // Step 2: the window walk under a fresh accumulator, 64-key tiles of the
  // block's batch rows' windows from row b_lo * R on (mma.sync).
  int b_lo;
  const int n_win = window_rows(a, n0, b_lo);
  am::load_rows<HD>(am::q_stage<HD, kSt>(ring), rows,
                    FlatQ{static_cast<const bf16*>(a.q), n0, N, kh, G, a.H, HD});
  const WindowKV key{static_cast<const bf16*>(a.sk), static_cast<const bf16*>(a.sv),
                     b_lo, n_win, kh, a.R, a.K, HD};
  am::acc_init<HD>(acc);
  am::key_loop<HD, true, kSt>(ring, (n_win + am::kKeys - 1) / am::kKeys, active, key,
                              window_fix(a, lr, b_lo, n_win), acc);
  if (!active) return;

  // Step 3: the merge with the stashed o_t, then bf16 stores.
  const float* st = stash + size_t(warp) * D::kNT * 4 * 32 + lane;
  merge_rows<HD>(m_t, l_t,
                 [&](int h, int j) {
                   return make_float2(st[(j * 4 + 2 * h) * 32], st[(j * 4 + 2 * h + 1) * 32]);
                 },
                 acc);
  store_out<HD>(a, lr, kh, acc);
}

// ---------------------------------------------------------------------------
// The two-leg route's suffix merge: persistent, TMA + wgmma.
// ---------------------------------------------------------------------------

// Arguments of the suffix merge: the window's tensor maps (in kernel
// parameter space, where TMA reads them), the rest, and its work items.
struct WindowArgs {
  CUtensorMap k;  // window k (B, R, K, hd): dims {hd, K, B * R}, boxes {64, 1, 64}
  CUtensorMap v;  // window v, the same
  Args a;
  int n_items;    // K * ceil(N / 64)
};

// A block: one consumer warpgroup and a producer warp.
constexpr int kMergeThreads = 128 + 32;

// Dynamic shared memory of the suffix merge: kSlots slots (each an item's
// Q tile and the stash of its trunk partials o_t, 64 rows of hd floats),
// the K/V ring, then the barriers. One slot and two stages: 114,752 bytes
// at hd 128, so that two blocks fit an SM (three at hd <= 64).
template <int HD>
struct MergeSmem {
  using W = aw::Dims<HD>;
  static constexpr int kSlots = 1;
  static constexpr int kStages = 2;
  static constexpr int kBlocksPerSM = HD <= 64 ? 3 : 2;
  static constexpr int kO = kSlots * W::kTile;
  static constexpr int kRing = kO + kSlots * 64 * HD * 4;
  static constexpr int kBars = kRing + kStages * W::kStage;
  static constexpr int kBytes = kBars + 8 * (4 * kSlots + 2 * kStages);
  static_assert(kRing % 1024 == 0, "the ring's stages 1024-byte aligned");
};

// The block's j-th item: 64 flattened rows from n0 of kv head kh; false
// past its last. Block x takes items x, x + gridDim.x, ..., item i being
// (kv head i % K, rows 64 (i / K) ..): the blocks at work at one time
// read neighbouring kv heads of the same window rows, trunk partials
// and query rows.
__device__ __forceinline__ bool merge_item(const WindowArgs& wa, int j, int& kh, int& n0) {
  const int i = blockIdx.x + j * gridDim.x;
  if (i >= wa.n_items) return false;
  kh = i % wa.a.K;
  n0 = (i / wa.a.K) * 64;
  return true;
}

// Grid: as many blocks an SM as fit, each walking its items (merge_item).
// Block: a consumer warpgroup (threads 0 .. 127) and a producer warp. For
// each item the producer copies the Q rows by cp.async into the slot's Q
// tile (swizzled panels, rows past N zero-filled; the slot's barrier
// counts the lanes' arrivals as their copies land), asks by TMA for the
// window tiles (64 keys of the concatenated windows from row b_lo * R on,
// as the fused kernel tiles them; rows past B * R zero-filled) as ring
// stages free up, and bulk-copies the item's trunk partials o_t (one row
// a copy) into the slot's stash; the next item's loads run while the
// consumers work. The consumers walk the tiles on wgmma (attn_wgmma's
// tile_step, P split hi + lo), then merge with the stashed partials and
// store.
template <int HD>
__global__ void __launch_bounds__(kMergeThreads, MergeSmem<HD>::kBlocksPerSM)
    suffix_merge_kernel(const __grid_constant__ WindowArgs wa) {
  using W = aw::Dims<HD>;
  using Sm = MergeSmem<HD>;
  constexpr int kSl = Sm::kSlots;
  constexpr int kSt = Sm::kStages;
  extern __shared__ unsigned char suffix_merge_smem_raw[];
  unsigned char* smem = hp::aligned_smem(suffix_merge_smem_raw);
  float* stash = reinterpret_cast<float*>(smem + Sm::kO);
  unsigned char* ring = smem + Sm::kRing;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + Sm::kBars);
  uint64_t* qempty = qfull + kSl;
  uint64_t* ofull = qempty + kSl;
  uint64_t* oempty = ofull + kSl;
  uint64_t* full = oempty + kSl;
  uint64_t* empty = full + kSt;
  const Args& a = wa.a;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int G = a.H / a.K;
  const int RG = a.R * G;
  const int N = a.B * RG;
  if (tid == 0) {
    for (int s = 0; s < kSl; ++s) {
      hp::mbar_init(&qfull[s], 32);
      hp::mbar_init(&qempty[s], 4);
      hp::mbar_init(&ofull[s], 1);
      hp::mbar_init(&oempty[s], 4);
    }
    for (int s = 0; s < kSt; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 4);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  int kh, n0;
  if (tid >= 128) {
    // Producer warp.
    const bf16* q = static_cast<const bf16*>(a.q);
    constexpr int kChunks = W::kPanels * 8;  // 16-byte chunks of a padded Q row
    int kv = 0;
    for (int j = 0; merge_item(wa, j, kh, n0); ++j) {
      const int slot = j % kSl;
      const uint32_t free_parity = ((j / kSl) & 1) ^ 1;
      hp::mbar_wait(&qempty[slot], free_parity);
      unsigned char* qs = smem + slot * W::kTile;
      const FlatQ at{q, n0, N, kh, G, a.H, HD};
      for (int i = lane; i < 64 * kChunks; i += 32) {
        const int r = i / kChunks;
        const int c = i - r * kChunks;
        const am::Row row = at(r);
        const bool ok = row.ok && c * 8 < HD;
        am::cp_async16(qs + (c >> 3) * W::kPanel + r * 128 + (((c & 7) ^ (r & 7)) << 4),
                       ok ? row.p + c * 8 : row.p, ok);
      }
      hp::cp_async_mbar_arrive(&qfull[slot]);
      int b_lo;
      const int n_tiles = (window_rows(a, n0, b_lo) + am::kKeys - 1) / am::kKeys;
      // Window tile t into the next stage once the walk has handed it back.
      auto issue = [&](int t) {
        if (lane != 0) return;
        const int st = kv % kSt;
        unsigned char* kt = ring + st * W::kStage;
        hp::mbar_wait(&empty[st], ((kv / kSt) & 1) ^ 1);
        hp::mbar_expect_tx(&full[st], W::kStage);
        const int w0 = b_lo * a.R + t * am::kKeys;
#pragma unroll
        for (int p = 0; p < W::kPanels; ++p) {
          hp::tma_load_3d(kt + p * W::kPanel, &wa.k, &full[st], 64 * p, kh, w0);
          hp::tma_load_3d(kt + W::kTile + p * W::kPanel, &wa.v, &full[st], 64 * p, kh, w0);
        }
      };
      // The tiles that the item before frees the stages of, then the
      // stash (free once the item kSl before is merged), then the item's
      // other tiles.
      const int first = min(n_tiles, kSt);
      for (int t = 0; t < first; ++t, ++kv) issue(t);
      hp::mbar_wait(&oempty[slot], free_parity);
      if (lane == 0) hp::mbar_expect_tx(&ofull[slot], uint32_t(min(64, N - n0)) * HD * 4);
      __syncwarp();
      float* os = stash + slot * 64 * HD;
      for (int r = lane; r < 64 && n0 + r < N; r += 32)
        hp::bulk_load(os + r * HD, a.o + part_row(n0 + r, RG, a.K, kh) * HD, HD * 4,
                      &ofull[slot]);
      for (int t = first; t < n_tiles; ++t, ++kv) issue(t);
      __syncwarp();
    }
    return;
  }

  // Consumer warpgroup: warp w owns rows 16 w .. 16 w + 15 of each item.
  const int warp = tid >> 5;
  int kv = 0;
  for (int j = 0; merge_item(wa, j, kh, n0); ++j) {
    const int slot = j % kSl;
    const uint32_t parity = (j / kSl) & 1;
    const LaneRows lr = lane_rows(a, n0, kh);
    int b_lo;
    const int n_win = window_rows(a, n0, b_lo);
    const int n_tiles = (n_win + am::kKeys - 1) / am::kKeys;
    const WindowFix fix = window_fix(a, lr, b_lo, n_win);
    float m_t[2], l_t[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = lr.nr + 8 * h;
      const size_t row = n < N ? part_row(n, RG, a.K, kh) : 0;
      m_t[h] = n < N ? a.m[row] : -CUDART_INF_F;
      l_t[h] = n < N ? a.l[row] : 0.f;
    }
    float o[W::kAcc], m[2], l[2];
    aw::walk_init<HD>(o, m, l);
    hp::mbar_wait(&qfull[slot], parity);
    hp::fence_proxy_async();  // the Q copies, visible to wgmma
    const unsigned char* qs = smem + slot * W::kTile;
    for (int t = 0; t < n_tiles; ++t, ++kv) {
      const int st = kv % kSt;
      const WindowCols cols = fix.load(t);
      hp::mbar_wait(&full[st], (kv / kSt) & 1);
      const unsigned char* kt = ring + st * W::kStage;
      aw::tile_step<HD, true>(qs, kt, kt + W::kTile,
                              [&](float (&s)[8][4]) { fix.apply(cols, s); }, o, m, l);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty[st]);
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&qempty[slot]);  // its products are done
    am::Acc<HD> acc;
    aw::to_acc<HD>(o, m, l, acc);
    hp::mbar_wait(&ofull[slot], parity);
    float* os = stash + slot * 64 * HD;  // row r of the item at os + r * HD
    if (n0 + warp * 16 < N) {            // else no rows: nothing to write
      const float* own = os + (warp * 16 + (lane >> 2)) * HD + 2 * (lane & 3);
      merge_rows<HD>(m_t, l_t,
                     [&](int h, int jj) {
                       return *reinterpret_cast<const float2*>(own + 8 * h * HD + 8 * jj);
                     },
                     acc);
      // The warp's 16 rows staged as bf16 over their own stash rows (read
      // already), then a bulk copy a row (faster than each lane's stores);
      // the stash is handed back once the copies have read it.
      {
        __syncwarp();
        am::store_rows<HD>(acc, [&](int h, int col, float4 v) {
          uint2 pk;
          pk.x = am::as_u32(__floats2bfloat162_rn(v.x, v.y));
          pk.y = am::as_u32(__floats2bfloat162_rn(v.z, v.w));
          *reinterpret_cast<uint2*>(os + (warp * 16 + (lane >> 2) + 8 * h) * HD + col / 2) = pk;
        });
        hp::fence_proxy_async();
        __syncwarp();
        const int n = n0 + warp * 16 + lane;
        if (lane < 16 && n < N) {
          hp::bulk_store(out_row(a, n, kh, HD), os + (warp * 16 + lane) * HD, HD * 2);
          hp::bulk_commit();
          hp::bulk_wait_read<0>();
        }
      }
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&oempty[slot]);  // its stash is read
  }
  if (lane < 16) hp::bulk_wait_all();  // the last rows have landed
}

// The window's tensor map (k or v of (B, R, K, hd) bf16: dims {hd, K, B *
// R}), host side.
bool window_map(CUtensorMap* map, const void* base, int rows, int K, int hd) {
  const cuuint64_t dims[3] = {cuuint64_t(hd), cuuint64_t(K), cuuint64_t(rows)};
  const cuuint64_t strides[2] = {cuuint64_t(hd) * 2, cuuint64_t(K) * hd * 2};
  const cuuint32_t box[3] = {64, 1, 64};
  return hp::encode_map(map, base, 3, dims, strides, box);
}

template <int HD>
cudaError_t launch_suffix_merge(const Args& a, cudaStream_t st) {
  const int smem = MergeSmem<HD>::kBytes;
  // Blocks an SM and SMs, asked once per instantiation. A refusal is
  // returned and taken off the runtime's last error, so that it is not
  // reported again by the next launch's check.
  static int grid_max = 0;
  if (grid_max == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaFuncSetAttribute(suffix_merge_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, suffix_merge_kernel<HD>,
                                                        kMergeThreads, smem);
    if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
    if (e != cudaSuccess) {
      cudaGetLastError();
      return e;
    }
    grid_max = sms * per_sm;
  }
  WindowArgs wa{};
  wa.a = a;
  if (!window_map(&wa.k, a.sk, a.B * a.R, a.K, HD) || !window_map(&wa.v, a.sv, a.B * a.R, a.K, HD))
    return cudaErrorInvalidValue;
  const long long N = (long long)a.B * a.R * (a.H / a.K);
  const long long items = (long long)a.K * ((N + 63) / 64);
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  wa.n_items = int(items);
  const int grid = items < grid_max ? int(items) : grid_max;
  suffix_merge_kernel<HD><<<grid, kMergeThreads, smem, st>>>(wa);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The int8 trunk leg on IMMA (bf16 inputs).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One row of hd bf16 (lane l holds elements 4 l .. 4 l + 3 where 4 l < hd)
// quantized by models/quant.py's dynamic rule (attn_tile::load_tile_int8's
// device arithmetic): scale = max(amax, 1e-8) / 127 by IEEE division,
// payload = clip(rint(x / scale), +-127). Returns the packed payload word
// (0 for lanes past hd) and the scale (the same in every lane).
__device__ __forceinline__ uint32_t quant_row(const bf16* row, int hd, bool ok, float& scale) {
  const int lane = threadIdx.x & 31;
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ok && 4 * lane < hd) x = tile::load4(row + 4 * lane);
  float amax = fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)), fmaxf(fabsf(x.z), fabsf(x.w)));
  amax = tile::warp_max(amax);
  scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  if (4 * lane >= hd) return 0u;
  return uint32_t(tile::quant8(x.x, scale) | (tile::quant8(x.y, scale) << 8) |
                  (tile::quant8(x.z, scale) << 16) | (tile::quant8(x.w, scale) << 24));
}

// Eight consecutive elements of a row (16 bytes of bf16, 32 of float32) as
// raw words, read by the read-only path; zeros where not loaded.
template <typename T>
struct Raw8 {
  uint4 w[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ Raw8<T> load8(const T* p) {
  Raw8<T> r;
#pragma unroll
  for (int i = 0; i < int(sizeof(T) / 2); ++i)
    r.w[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  return r;
}

__device__ __forceinline__ void to_f32(const Raw8<bf16>& r, float (&x)[8]) {
  const uint32_t u[4] = {r.w[0].x, r.w[0].y, r.w[0].z, r.w[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u[i]);
    x[2 * i] = __low2float(b);
    x[2 * i + 1] = __high2float(b);
  }
}

__device__ __forceinline__ void to_f32(const Raw8<float>& r, float (&x)[8]) {
  const uint32_t u[8] = {r.w[0].x, r.w[0].y, r.w[0].z, r.w[0].w,
                         r.w[1].x, r.w[1].y, r.w[1].z, r.w[1].w};
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __uint_as_float(u[i]);
}

// x / s rounded once (IEEE round to nearest even), given y = 1 / s rounded
// once: q = x y is within an ulp of the quotient, r = x - q s is exact (one
// FMA), and q + r y rounded once is the correctly rounded quotient
// (Markstein's theorem; here |x / s| <= 127 cannot overflow, and a quotient
// small enough to underflow rounds to a zero payload either way). Three
// instructions where __fdiv_rn takes a dozen with its range checks.
__device__ __forceinline__ float div_rn(float x, float s, float y) {
  const float q = __fmul_rn(x, y);
  return __fmaf_rn(__fmaf_rn(-q, s, x), y, q);
}

// The payload of x at scale s (y = 1 / s): clip(rint(x / s), +-127), as a byte.
__device__ __forceinline__ uint32_t quant8(float x, float s, float y) {
  return uint32_t(int(fminf(fmaxf(rintf(div_rn(x, s, y)), -127.f), 127.f)) & 0xff);
}

// Passes of a warp: two rows each (one a half-warp, eight elements a
// lane), their loads all issued before the first reduction.
constexpr int kQuantPasses = 4;
constexpr int kQuantThreads = 256;

// The trunk keys' quantization, of all layers at once: (rows, hd) bf16 (or
// float32) into the (rows, hd) s8 payload and (rows,) float32 scales, by
// models/quant.py's dynamic rule: scale = max(amax, 1e-8) / 127 by IEEE
// division, payload = clip(rint(x / scale), +-127). Rows are independent,
// so their grouping moves no bit. Grid: a warp for every 2 kQuantPasses
// rows.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                      float* __restrict__ scales, int rows, int hd) {
  const int lane = threadIdx.x & 31;
  const int c8 = 8 * (lane & 15);  // the lane's first element of its row
  const bool col = c8 < hd;
  const int r0 = ((blockIdx.x * (kQuantThreads / 32) + (threadIdx.x >> 5)) * kQuantPasses) * 2 +
                 (lane >> 4);      // the lane's row of pass 0
  Raw8<T> raw[kQuantPasses];
#pragma unroll
  for (int i = 0; i < kQuantPasses; ++i) {
    raw[i] = Raw8<T>{};
    if (col && r0 + 2 * i < rows) raw[i] = load8(x + size_t(r0 + 2 * i) * hd + c8);
  }
#pragma unroll
  for (int i = 0; i < kQuantPasses; ++i) {
    float v[8];
    to_f32(raw[i], v);
    float amax = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(am::kFull, amax, off));
    const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
    const float y = __frcp_rn(s);
    const int row = r0 + 2 * i;
    if (row >= rows) continue;
    if (col) {
      uint2 pk;
      pk.x = quant8(v[0], s, y) | (quant8(v[1], s, y) << 8) | (quant8(v[2], s, y) << 16) |
             (quant8(v[3], s, y) << 24);
      pk.y = quant8(v[4], s, y) | (quant8(v[5], s, y) << 8) | (quant8(v[6], s, y) << 16) |
             (quant8(v[7], s, y) << 24);
      *reinterpret_cast<uint2*>(q + size_t(row) * hd + c8) = pk;
    }
    if ((lane & 15) == 0) scales[row] = s;
  }
}

template <typename T>
cudaError_t launch_quant(const void* x, void* q, void* scales, int rows, int hd,
                         cudaStream_t st) {
  if (rows <= 0 || hd <= 0 || hd > 128 || hd % 8) return cudaErrorInvalidValue;
  constexpr int kRows = kQuantThreads / 32 * kQuantPasses * 2;  // rows a block
  quant_rows_kernel<T><<<(rows + kRows - 1) / kRows, kQuantThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scales), rows, hd);
  return cudaGetLastError();
}

template <int HD>
struct Imma {
  static constexpr int kKS = (HD + 31) / 32;    // 32-deep k-steps of Q K^T
  static constexpr int kRow = kKS * 32 + 16;    // s8 row stride (bytes): odd 16-byte chunks
  static constexpr int kK8 = am::kKeys * kRow;  // bytes of one s8 key tile
  static constexpr int kV = am::kKeys * am::Dims<HD>::kLd * 2;  // bytes of a bf16 V tile
  static constexpr int kStage = kK8 + kV;
  static constexpr int kStages = am::kStages;
  static constexpr size_t kBytes =
      size_t(kStages) * kStage + size_t(16 * am::kWarps) * kRow + 16 * am::kWarps * 4;
};

// The int8 trunk leg on tensor cores: S = Q K^T on IMMA from the block's
// query payloads and the trunk payload, then attn_mma's online softmax and
// split-P PV over bf16 V. Grid (ceil(N / rows), K), rows = 16 * warps.
template <int HD>
__global__ void __launch_bounds__(am::kWarps * 32) prefix_imma_kernel(Args a) {
  using I = Imma<HD>;
  extern __shared__ __align__(16) unsigned char prefix_imma_smem[];
  unsigned char* ring = prefix_imma_smem;
  unsigned char* q8 = ring + I::kStages * I::kStage;
  float* qsc = reinterpret_cast<float*>(q8 + 16 * am::kWarps * I::kRow);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kh = blockIdx.y;
  const int G = a.H / a.K;
  const int RG = a.R * G;
  const int N = a.B * RG;
  const int n0 = blockIdx.x * (blockDim.x >> 5) * 16;
  const int n_tiles = (a.Tt + am::kKeys - 1) / am::kKeys;
  const LaneRows lr = lane_rows(a, n0, blockIdx.y);
  const bool active = n0 + warp * 16 < N;
  const int8_t* tk8 = static_cast<const int8_t*>(a.tk);
  const bf16* tv = static_cast<const bf16*>(a.tv);
  const float* tks = a.tks + size_t(kh) * a.Tt;

  // Copies of key tile t into its stage: s8 rows (depth past hd
  // zero-filled) and bf16 V rows; keys past Tt zero-filled.
  auto load = [&](int t) {
    unsigned char* k8 = ring + (t % I::kStages) * I::kStage;
    bf16* vs = reinterpret_cast<bf16*>(k8 + I::kK8);
    const int k0 = t * am::kKeys;
    for (int i = threadIdx.x; i < am::kKeys * I::kKS * 2; i += blockDim.x) {
      const int r = i / (I::kKS * 2);
      const int c = i - r * I::kKS * 2;
      const bool ok = k0 + r < a.Tt && c * 16 < HD;
      am::cp_async16(k8 + r * I::kRow + c * 16,
                     ok ? tk8 + (size_t(kh) * a.Tt + k0 + r) * HD + c * 16 : tk8, ok);
    }
    for (int i = threadIdx.x; i < am::kKeys * (HD / 8); i += blockDim.x) {
      const int r = i / (HD / 8);
      const int c = i - r * (HD / 8);
      const bool ok = k0 + r < a.Tt;
      am::cp_async16(vs + r * am::Dims<HD>::kLd + c * 8,
                     ok ? tv + (size_t(kh) * a.Tt + k0 + r) * HD + c * 8 : tv, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < I::kStages - 1; ++t) {
    if (t < n_tiles) load(t);
    am::cp_async_commit();
  }

  // The warp's 16 query rows, quantized while the first tiles land.
  const bf16* q = static_cast<const bf16*>(a.q);
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    const int n = n0 + r;
    const bool ok = n < N;
    const bf16* row = q + (size_t((ok ? n : n0) / G) * a.H + size_t(kh) * G + (ok ? n : n0) % G) *
                              HD;
    float s;
    const uint32_t w = quant_row(row, HD, ok, s);
    if (4 * lane < I::kKS * 32) reinterpret_cast<uint32_t*>(q8 + r * I::kRow)[lane] = w;
    if (lane == 0) qsc[r] = __fmul_rn(s, a.sm_scale);
  }
  __syncwarp();
  uint32_t qf[I::kKS][4];
  {
    const unsigned char* qa = q8 + (warp * 16 + (lane & 15)) * I::kRow + (lane >> 4) * 16;
#pragma unroll
    for (int kk = 0; kk < I::kKS; ++kk)
      am::ldmatrix_x4(qf[kk], reinterpret_cast<const bf16*>(qa + kk * 32));
  }
  const float q_scale[2] = {qsc[warp * 16 + (lane >> 2)], qsc[warp * 16 + (lane >> 2) + 8]};
  const int c0 = 2 * (lane & 3);

  am::Acc<HD> acc;
  am::acc_init<HD>(acc);
  for (int t = 0; t < n_tiles; ++t) {
    const int ahead = t + I::kStages - 1;
    if (ahead < n_tiles) load(ahead);
    am::cp_async_commit();
    am::cp_async_wait<I::kStages - 1>();  // tile t has landed
    __syncthreads();
    if (active) {
      const unsigned char* k8 = ring + (t % I::kStages) * I::kStage;
      int s32[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s32[j][e] = 0;
      // B from key rows (lane & 7) + 8 (lane / 16), depth half (lane / 8) & 1.
      const unsigned char* ka =
          k8 + ((lane & 7) + ((lane >> 4) << 3)) * I::kRow + ((lane >> 3) & 1) * 16;
#pragma unroll
      for (int kk = 0; kk < I::kKS; ++kk) {
        uint32_t b[4][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          am::ldmatrix_x4(b[jj], reinterpret_cast<const bf16*>(ka + jj * 16 * I::kRow + kk * 32));
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          mma_s8(s32[2 * jj], qf[kk], b[jj][0], b[jj][1]);
          mma_s8(s32[2 * jj + 1], qf[kk], b[jj][2], b[jj][3]);
        }
      }
      // Scores in the plain twin's order: (f32(s32) * q_scale) * k_scale,
      // then + slope * t; -inf past Tt.
      float s[8][4];
      const int k0 = t * am::kKeys;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + c0 + (e & 1);
          const bool in = key < a.Tt;
          float x = __fmul_rn(__fmul_rn(float(s32[j][e]), q_scale[e >> 1]),
                              in ? __ldg(tks + key) : 0.f);
          if (a.slopes != nullptr) x = __fadd_rn(x, __fmul_rn(lr.slope[e >> 1], float(key)));
          s[j][e] = in ? x : -CUDART_INF_F;
        }
      am::softmax_pv<HD, true>(s, reinterpret_cast<const bf16*>(k8 + I::kK8), acc);
    }
    __syncthreads();  // the next copies reuse this stage
  }
  if (!active) return;
  const PrefixStore store{a.o, N, RG, a.K, kh, HD, lr.nr};
  am::store_rows<HD>(acc, store);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = lr.nr + 8 * h;
      if (n >= N) continue;
      a.m[part_row(n, RG, a.K, kh)] = acc.m[h];
      a.l[part_row(n, RG, a.K, kh)] = acc.l[h];
    }
  }
}

// Launch of a kernel of TrunkArgs: grid (ceil(N / (64 wgs)), K) over N
// flattened queries of K kv heads, wgs warpgroups (of query rows) a block
// of ``threads``, and the trunk's tensor maps.
cudaError_t launch_trunk(void (*kernel)(TrunkArgs), const Args& a, int hd, size_t smem, int wgs,
                         int threads, cudaStream_t st) {
  TrunkArgs ta{};
  ta.a = a;
  if (!(aw::trunk_map(&ta.tk, a.tk, a.K, a.Tt, hd) && aw::trunk_map(&ta.tv, a.tv, a.K, a.Tt, hd)))
    return cudaErrorInvalidValue;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const long long N = (long long)a.B * a.R * (a.H / a.K);
  const int rows = 64 * wgs;
  dim3 grid(unsigned((N + rows - 1) / rows), a.K);
  kernel<<<grid, threads, smem, st>>>(ta);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Dispatch by head dim.
// ---------------------------------------------------------------------------

enum class Op { kFused, kSuffixMerge, kPrefix, kPrefixInt8 };

template <int HD>
cudaError_t launch_hd(Op op, int dtype, const Args& a, cudaStream_t st) {
  if (dtype == 0) {
    switch (op) {
      case Op::kFused:
        return launch_tile<HD, false>(cascade_tile_kernel<float, HD, true>, a, st);
      case Op::kSuffixMerge:
        return launch_tile<HD, false>(cascade_tile_kernel<float, HD, false>, a, st);
      case Op::kPrefix:
        return launch_tile<HD, false>(prefix_kernel<float, HD, false>, a, st);
      case Op::kPrefixInt8:
        return launch_tile<HD, true>(prefix_kernel<float, HD, true>, a, st);
    }
  }
  switch (op) {
    case Op::kFused:
      return launch_trunk(cascade_mma_kernel<HD>, a, HD, CascadeSmem<HD>::kBytes, 1, 128, st);
    case Op::kSuffixMerge:
      return launch_suffix_merge<HD>(a, st);
    case Op::kPrefix:
      return launch_trunk(prefix_wgmma_kernel<HD>, a, HD, PrefixSmem<HD>::kBytes, kPrefixWG,
                          kPrefixThreads, st);
    case Op::kPrefixInt8:
      return launch_flat(prefix_imma_kernel<HD>, a, Imma<HD>::kBytes, st);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_op(Op op, int dtype, int hd, const Args& a, cudaStream_t st) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (hd) {
    case 32: return launch_hd<32>(op, dtype, a, st);
    case 64: return launch_hd<64>(op, dtype, a, st);
    case 80: return launch_hd<80>(op, dtype, a, st);
    case 96: return launch_hd<96>(op, dtype, a, st);
    case 128: return launch_hd<128>(op, dtype, a, st);
    default: return cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, int B, int R, int H, int K, int Tt, int hd) {
  Args a{};
  a.q = q;
  a.B = B;
  a.R = R;
  a.H = H;
  a.K = K;
  a.Tt = Tt;
  // 1/sqrt(hd) rounded once from double, as the JAX package computes it.
  a.sm_scale = float(1.0 / sqrt(double(hd)));
  return a;
}

}  // namespace

// Every entry point: dtype 0 = float32 (CUDA cores), 1 = bfloat16 (tensor
// cores); hd one of 32, 64, 80, 96, 128. Returns cudaGetLastError() (or the
// error of a refused attribute, dtype or head dim), 0 on success.

// The fused cascade: softmax over trunk + window keys, out (B, R, H, hd).
extern "C" int lir_cascade_attention(const void* q, const void* sk, const void* sv,
                                     const void* tk, const void* tv, const void* smask,
                                     const void* qpos, const void* slopes, void* out, int B,
                                     int R, int H, int K, int Tt, int hd, int dtype,
                                     void* stream) {
  Args a = make_args(q, B, R, H, K, Tt, hd);
  a.sk = sk;
  a.sv = sv;
  a.tk = tk;
  a.tv = tv;
  a.smask = static_cast<const int*>(smask);
  a.qpos = static_cast<const int*>(qpos);
  a.slopes = static_cast<const float*>(slopes);
  a.out = out;
  return int(launch_op(Op::kFused, dtype, hd, a, static_cast<cudaStream_t>(stream)));
}

// The two-leg route's suffix leg and merge over given trunk partials.
extern "C" int lir_cascade_suffix_merge(const void* q, const void* sk, const void* sv,
                                        const void* o_t, const void* m_t, const void* l_t,
                                        const void* smask, const void* qpos, const void* slopes,
                                        void* out, int B, int R, int H, int K, int hd, int dtype,
                                        void* stream) {
  Args a = make_args(q, B, R, H, K, 0, hd);
  a.sk = sk;
  a.sv = sv;
  a.o = static_cast<float*>(const_cast<void*>(o_t));
  a.m = static_cast<float*>(const_cast<void*>(m_t));
  a.l = static_cast<float*>(const_cast<void*>(l_t));
  a.smask = static_cast<const int*>(smask);
  a.qpos = static_cast<const int*>(qpos);
  a.slopes = static_cast<const float*>(slopes);
  a.out = out;
  return int(launch_op(Op::kSuffixMerge, dtype, hd, a, static_cast<cudaStream_t>(stream)));
}

// Trunk-leg partials of the two-leg cascade. int8_qk 0: float QK^T of the
// trunk keys tk; 1: int8 QK^T of tk read as the s8 payload and tks as its
// scales (lir_quantize_rows or, float32, lir_quantize_rows_f32).
extern "C" int lir_cascade_prefix(const void* q, const void* tk, const void* tks,
                                  const void* tv, const void* slopes, void* o, void* m, void* l,
                                  int B, int R, int H, int K, int Tt, int hd, int dtype,
                                  int int8_qk, void* stream) {
  Args a = make_args(q, B, R, H, K, Tt, hd);
  a.tk = tk;
  a.tks = static_cast<const float*>(tks);
  a.tv = tv;
  a.slopes = static_cast<const float*>(slopes);
  a.o = static_cast<float*>(o);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  return int(launch_op(int8_qk ? Op::kPrefixInt8 : Op::kPrefix, dtype, hd, a,
                       static_cast<cudaStream_t>(stream)));
}

// (rows, hd) bf16 -> s8 payload (rows, hd) and float32 scales (rows,) by
// the dynamic rule; hd a multiple of 8 up to 128. lir_quantize_rows_f32:
// the same from float32.
extern "C" int lir_quantize_rows(const void* x, void* q, void* scales, int rows, int hd,
                                 void* stream) {
  return int(launch_quant<bf16>(x, q, scales, rows, hd, static_cast<cudaStream_t>(stream)));
}

extern "C" int lir_quantize_rows_f32(const void* x, void* q, void* scales, int rows, int hd,
                                     void* stream) {
  return int(launch_quant<float>(x, q, scales, rows, hd, static_cast<cudaStream_t>(stream)));
}
