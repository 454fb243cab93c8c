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
// What bounds it on the H100. At bucket 512, B = 32, llama-2-7b width it
// must read q, k, v and write the output, 537 MB (~0.160 ms at 3.35 TB/s),
// against 68.7 causal GFLOP (~0.069 ms of bf16 tensor-core time): bytes,
// by a factor of two, if the products run on tensor cores. On CUDA cores
// in float32 the same work takes over 1 ms whatever else is done, which is
// what bounded the first kernel (flash_kernel below, still the float32
// route): 64 x 64 float32 tiles in shared memory, K and V loaded into one
// buffer with a barrier between each load and its use.
//
// bf16 inputs take flash_mma_kernel, built on attn_mma.cuh as the cascade
// kernels are:
// - A block owns 64 query rows (four warps of 16) of one (batch row, query
//   head) and reads kv head h / G. Stacking a GQA group's G heads as rows
//   would not read fewer key tiles: a 64-row tile would then span 64 / G
//   query positions, so as many blocks walk as many tiles, and the causal
//   bound of a tile would loosen; the group's blocks share their kv head's
//   tiles through L2 instead.
// - The key walk starts at the tile of the batch row's first valid key (a
//   scan of the key mask) and stops at the causal diagonal; key_loop feeds
//   it through a 2-stage cp.async ring, the walk's first slot in the Key
//   functor. Rows with no valid key walk nothing and write 0. Two stages
//   (not the cascade kernels' three) and a cap of 168 registers let three
//   blocks share an SM: at these prompt lengths a block walks few tiles,
//   so more blocks in flight beat a deeper ring.
// - S = Q K^T by mma.sync from raw bf16 q and k, summed in float32, then
//   x sm_scale in float32 (q is never pre-scaled into bf16), + ALiBi
//   slope_h * kpos in float32, -inf where the key mask is 0 or kj > qi.
// - P V from one bf16 P: the output is bf16, and the CPU emulation of this
//   arithmetic (tests/test_torch_cascade_mma_numerics.py) stays under 0.6
//   of the card's 1e-2 bar of flash_attention_plain, so the cascade kernels'
//   hi + lo split, which their float32 partials need, is not taken.
// - The grid's slowest axis is the query tile, reversed: the tiles nearest
//   the end of the prompt walk the most keys and are scheduled first.
// What is left: wgmma with TMA loads (a warpgroup's 64 rows, softmax
// overlapped with the next tile's products), as FlashAttention-3 does.
// The key tiles are summed in another order than the plain version's
// single softmax, so the two match within bf16 tolerance, not bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <cmath>

#include "attn_mma.cuh"
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

namespace am = attn_mma;

// Q row r of a block: query i0 + r of batch row b, head h (past the
// queries: zero-filled).
struct FlashQ {
  const am::bf16* q;
  int b, S, H, h, i0, hd;
  __device__ __forceinline__ am::Row operator()(int r) const {
    const int i = i0 + r;
    const bool ok = i < S;
    return {q + ((size_t(b) * S + (ok ? i : i0)) * H + h) * hd, ok};
  }
};

// Key k of a block's walk: slot lower + k of batch row b, kv head kh.
struct FlashKV {
  const am::bf16 *k, *v;
  int b, S, K, kh, lower, hd;
  __device__ __forceinline__ am::KVRow operator()(int key) const {
    const int j = lower + key;
    const bool ok = j < S;
    const size_t off = ((size_t(b) * S + (ok ? j : 0)) * K + kh) * hd;
    return {k + off, v + off, ok};
  }
};

// Scores of one warp's tile: x sm_scale, ALiBi on the key's mask-aware
// position, -inf where the key is masked, past S or after the row's query.
struct FlashFix {
  const int* mask;  // the batch row's (S,)
  const int* kpos;  // the batch row's (S,), or null (no ALiBi)
  float sm_scale, slope;
  int S, lower, c0;
  int qi[2];        // the lane's two query rows (row g, row g + 8)
  __device__ __forceinline__ void operator()(int t, float (&s)[8][4]) const {
    const int k0 = lower + t * am::kKeys;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kj = k0 + 8 * j + c0 + c;
        const bool in = kj < S;
        const bool live = in && __ldg(mask + kj) > 0;
        const float kp = (kpos != nullptr && in) ? float(__ldg(kpos + kj)) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x = __fmul_rn(s[j][2 * h + c], sm_scale);
          if (kpos != nullptr) x = __fadd_rn(x, __fmul_rn(slope, kp));
          s[j][2 * h + c] = (live && kj <= qi[h]) ? x : -CUDART_INF_F;
        }
      }
  }
};

// The normalized output of one lane's four columns of row half h, bf16.
struct FlashStore {
  am::bf16* out;
  int b, S, H, h, hd, qi;
  float l[2];
  __device__ __forceinline__ void operator()(int half, int col, float4 v) const {
    const int i = qi + 8 * half;
    if (i >= S) return;
    const float lh = half ? l[1] : l[0];
    uint2 pk;
    pk.x = am::as_u32(__floats2bfloat162_rn(__fdiv_rn(v.x, lh), __fdiv_rn(v.y, lh)));
    pk.y = am::as_u32(__floats2bfloat162_rn(__fdiv_rn(v.z, lh), __fdiv_rn(v.w, lh)));
    *reinterpret_cast<uint2*>(out + ((size_t(b) * S + i) * H + h) * hd + col) = pk;
  }
};

// Stages of the flash kernel's K/V ring: two, so that three blocks fit an
// SM (3 x 69,632 B at hd 128, and at most 168 registers a thread).
constexpr int kFlashStages = 2;

// bf16 on tensor cores. Grid (H, B, ceil(S / 64)); blockIdx.z counts query
// tiles from the last one down.
template <int HD>
__global__ void __launch_bounds__(am::kWarps * 32, 3) flash_mma_kernel(FlashArgs a) {
  using am::bf16;
  extern __shared__ __align__(16) unsigned char flash_mma_smem[];
  __shared__ int first_valid;
  bf16* ring = reinterpret_cast<bf16*>(flash_mma_smem);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * 16 * am::kWarps;
  const int S = a.S;
  const int kh = h / (a.H / a.K);
  am::load_rows<HD>(am::q_stage<HD, kFlashStages>(ring), 16 * am::kWarps,
                    FlashQ{static_cast<const bf16*>(a.q), b, S, a.H, h, i0, HD});

  // The row's first valid key: the walk starts at its tile.
  const int* mask_b = a.mask + size_t(b) * S;
  if (threadIdx.x == 0) first_valid = S;
  __syncthreads();
  int mine = S;
  for (int j = threadIdx.x; j < S; j += blockDim.x)
    if (mask_b[j] > 0) {
      mine = j;
      break;
    }
  mine = __reduce_min_sync(am::kFull, mine);
  if (lane == 0) atomicMin(&first_valid, mine);
  __syncthreads();
  const int lower = first_valid / am::kKeys * am::kKeys;
  const int upper = min(S, i0 + 16 * am::kWarps);  // the causal diagonal
  const int n_tiles = first_valid < S && upper > lower
                          ? (upper - lower + am::kKeys - 1) / am::kKeys : 0;

  const FlashKV key{static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
                    b, S, a.K, kh, lower, HD};
  const int qi = i0 + warp * 16 + (lane >> 2);
  const FlashFix fix{mask_b, a.kpos != nullptr ? a.kpos + size_t(b) * S : nullptr,
                     a.sm_scale, a.slopes != nullptr ? a.slopes[h] : 0.f,
                     S, lower, 2 * (lane & 3), {qi, qi + 8}};
  am::Acc<HD> acc;
  am::acc_init<HD>(acc);
  const bool active = i0 + warp * 16 < S;
  am::key_loop<HD, false, kFlashStages>(ring, n_tiles, active, key, fix, acc);
  if (!active) return;
  am::store_rows<HD>(acc, FlashStore{static_cast<bf16*>(a.out), b, S, a.H, h, HD, qi,
                                     {fmaxf(acc.l[0], 1e-30f), fmaxf(acc.l[1], 1e-30f)}});
}

template <int HD>
cudaError_t launch_mma(const FlashArgs& a, cudaStream_t st) {
  const int smem = int(am::Dims<HD>::ring_bytes(kFlashStages));
  cudaError_t e = cudaFuncSetAttribute(
      flash_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int rows = 16 * am::kWarps;
  dim3 grid(a.H, a.B, (a.S + rows - 1) / rows);
  flash_mma_kernel<HD><<<grid, am::kWarps * 32, smem, st>>>(a);
  return cudaGetLastError();
}

cudaError_t mma_by_hd(const FlashArgs& a, int hd, cudaStream_t st) {
  switch (hd) {
    case 32: return launch_mma<32>(a, st);
    case 64: return launch_mma<64>(a, st);
    case 80: return launch_mma<80>(a, st);
    case 96: return launch_mma<96>(a, st);
    case 128: return launch_mma<128>(a, st);
    default: return cudaErrorInvalidValue;
  }
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

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); hd one
// of 32, 64, 80, 96, 128.
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
  if (dtype == 1) return int(mma_by_hd(a, hd, st));
  return int(cudaErrorInvalidValue);
}
