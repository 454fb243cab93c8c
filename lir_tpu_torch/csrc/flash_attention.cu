// Prefill flash attention for Hopper (sm_90a).
//
// Replaces lir_tpu/ops/flash_attention.py:_flash_kernel (reached from
// flash_attention): exact self-attention of a prompt without the (S, S)
// score matrix. Causal on slot indices (key j <= query i), keys masked by
// a (B, S) key mask of any pattern (left pad, right pad, holes), ALiBi as
// slope_h * key_position on mask-aware positions, an online softmax over
// key tiles that starts at the tile of the row's first valid key and
// stops at the causal diagonal. A query row with no valid key gives 0.
//
// Layout (the JAX package's public shapes): q (B, S, H, hd); k, v
// (B, S, K, hd) un-repeated for GQA/MQA: query head h reads kv head
// h / G, where the JAX decoder repeats k/v to H heads before its kernel
// (the same function). key_mask, key_positions (B, S) int32; slopes (H,)
// float32 or null. Output (B, S, H, hd) in q's dtype.
//
// What bounds it on the H100: bytes. At bucket 512, B = 32, llama-2-7b
// width it must read q, k, v and write the output, 537 MB, against 68.7
// causal GFLOP: ~0.160 ms of bytes, ~0.069 ms of bf16 tensor-core time.
// This first kernel multiplies on CUDA cores in float32 from shared
// memory tiles (attn_tile.cuh: 64 queries x 64 keys, a 4 x 4 register
// micro-tile a thread, the accumulator in registers), so operations bound
// it in practice; mma or wgmma with TMA loads is later work. One block
// per (query tile, head, batch row); a GQA group's blocks read their kv
// head's tiles through L2. The key tiles are summed in another order than
// the plain version's single softmax, so the two match within float
// tolerance, not bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <cmath>

#include "attn_tile.cuh"

namespace {

namespace tile = attn_tile;

struct FlashArgs {
  const void* q;           // (B, S, H, hd)
  const void* k;           // (B, S, K, hd)
  const void* v;           // (B, S, K, hd)
  const int* mask;         // (B, S)
  const int* kpos;         // (B, S) or null (no ALiBi)
  const float* slopes;     // (H,) or null
  void* out;               // (B, S, H, hd)
  int B, S, H, K;
  float sm_scale;
};

template <int HD>
struct FlashSmem {
  using D = tile::Dims<HD>;
  // q tile, one K-then-V tile, the probability tile, the key tile's mask
  // and positions, the row statistics.
  static constexpr size_t kBytes =
      (tile::kQB + tile::kKB) * D::kLd * 4 + tile::kQB * tile::kLdP * 4 +
      2 * tile::kKB * 4 + 3 * tile::kQB * 4;
};

// Grid (ceil(S / kQB), H, B).
template <typename T, int HD>
__global__ void __launch_bounds__(tile::kThreads) flash_kernel(FlashArgs a) {
  using D = tile::Dims<HD>;
  extern __shared__ __align__(16) unsigned char flash_smem[];
  __shared__ int first_valid;
  const int i0 = blockIdx.x * tile::kQB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.H / a.K;
  const int kh = h / G;
  const int S = a.S;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  float* qs = reinterpret_cast<float*>(flash_smem);
  float* kvs = qs + tile::kQB * D::kLd;           // K, then V
  float* ps = kvs + tile::kKB * D::kLd;
  int* kmask = reinterpret_cast<int*>(ps + tile::kQB * tile::kLdP);
  float* kposf = reinterpret_cast<float*>(kmask + tile::kKB);
  float* m = kposf + tile::kKB;
  float* l = m + tile::kQB;
  float* sc = l + tile::kQB;

  const int* mask_b = a.mask + size_t(b) * S;
  // The row's first valid key: the loop starts at its tile (an all-masked
  // row starts at 0 and every score stays -inf).
  if (threadIdx.x == 0) first_valid = S;
  __syncthreads();
  int mine = S;
  for (int j = threadIdx.x; j < S; j += blockDim.x)
    if (mask_b[j] > 0) {
      mine = j;
      break;
    }
  mine = __reduce_min_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0) atomicMin(&first_valid, mine);

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  tile::load_tile<HD>(
      qs, q, tile::kQB, a.sm_scale,
      [&](int r) { return ((size_t(b) * S + i0 + r) * a.H + h) * HD; },
      [&](int r) { return i0 + r < S; });
  for (int i = threadIdx.x; i < tile::kQB; i += blockDim.x) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
  }
  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
  float acc[4][D::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D::kCols; ++c) acc[i][c] = 0.f;
  __syncthreads();

  const int lower = (first_valid % S) / tile::kKB * tile::kKB;
  const int upper = min(S, i0 + tile::kQB);  // the causal diagonal
  for (int t0 = lower; t0 < upper; t0 += tile::kKB) {
    __syncthreads();  // the previous tile's PV is done with kvs and ps
    auto kv_off = [&](int r) {
      return ((size_t(b) * S + t0 + r) * a.K + kh) * HD;
    };
    auto kv_ok = [&](int r) { return t0 + r < S; };
    tile::load_tile<HD>(kvs, k, tile::kKB, 1.f, kv_off, kv_ok);
    for (int r = threadIdx.x; r < tile::kKB; r += blockDim.x) {
      const int j = t0 + r;
      kmask[r] = j < S ? mask_b[j] : 0;
      kposf[r] = (j < S && a.kpos != nullptr) ? float(a.kpos[size_t(b) * S + j])
                                              : 0.f;
    }
    __syncthreads();
    float s[4][4];
    tile::score_f32<HD>(qs, kvs, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int r = tx + 16 * jj;
        const int qi = i0 + ty + 16 * i;
        const int kj = t0 + r;
        float x = s[i][jj];
        if (a.slopes != nullptr) x = __fadd_rn(x, __fmul_rn(slope, kposf[r]));
        const bool ok = kmask[r] > 0 && kj <= qi;
        ps[(ty + 16 * i) * tile::kLdP + r] = ok ? x : -CUDART_INF_F;
      }
    __syncthreads();
    tile::load_tile<HD>(kvs, v, tile::kKB, 1.f, kv_off, kv_ok);
    tile::online_softmax(ps, m, l, sc);
    __syncthreads();
    tile::pv_update<HD>(ps, kvs, sc, acc);
  }
  __syncthreads();

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    const int qi = i0 + row;
    if (qi >= S) continue;
    const float denom = fmaxf(l[row], 1e-30f);
    T* o = out + ((size_t(b) * S + qi) * a.H + h) * HD;
#pragma unroll
    for (int c = 0; c < D::kCols; ++c)
      o[tx + 16 * c] = tile::from_f32<T>(__fdiv_rn(acc[i][c], denom));
  }
}

template <typename T, int HD>
cudaError_t launch(const FlashArgs& a, cudaStream_t st) {
  const int smem = int(FlashSmem<HD>::kBytes);
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.S + tile::kQB - 1) / tile::kQB, a.H, a.B);
  flash_kernel<T, HD><<<grid, tile::kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_hd(const FlashArgs& a, int hd, cudaStream_t st) {
  switch (hd) {
    case 32: return launch<T, 32>(a, st);
    case 64: return launch<T, 64>(a, st);
    case 80: return launch<T, 80>(a, st);
    case 96: return launch<T, 96>(a, st);
    case 128: return launch<T, 128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd one of 32, 64, 80, 96, 128.
// Returns cudaGetLastError() (or the error of a refused attribute), 0 on
// success.
extern "C" int lir_flash_attention(const void* q, const void* k, const void* v,
                                   const void* mask, const void* kpos,
                                   const void* slopes, void* out, int B, int S,
                                   int H, int K, int hd, int dtype,
                                   void* stream) {
  FlashArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = static_cast<const int*>(mask);
  a.kpos = static_cast<const int*>(kpos);
  a.slopes = static_cast<const float*>(slopes);
  a.out = out;
  a.B = B;
  a.S = S;
  a.H = H;
  a.K = K;
  // 1/sqrt(hd) rounded once from double, as the JAX package computes it.
  a.sm_scale = float(1.0 / sqrt(double(hd)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(by_hd<float>(a, hd, st));
  if (dtype == 1) return int(by_hd<__nv_bfloat16>(a, hd, st));
  return int(cudaErrorInvalidValue);
}
