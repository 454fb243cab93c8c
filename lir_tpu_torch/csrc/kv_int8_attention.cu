// Cached attention over the int8 KV cache: S queries a batch row against
// int8 key/value payloads with float32 scales, both products s8 x s8 -> s32.
//
// No Pallas original: this stands in for the JAX package's XLA einsums in
// `_attention_cached_int8` (lir_tpu/models/decoder.py:229-262), the
// cached attention of `extend`, `decode_step` and `verify_extend` on an
// engine with `ModelConfig.kv_cache_int8`. Per batch row b, query
// position s and query head h = k * G + g of kv head k (grouped queries
// read the un-repeated cache):
//   1. the query (hd,) is quantized as models/quant.dynamic_quant does:
//      scale = max(amax, 1e-8) / 127 (IEEE division), payload
//      rint(x / scale) (round half to even) clipped to +-127;
//   2. s32 = dot(q payload, kq[k, t, b, :]) with dp4a, exact; the score
//      ((float)s32 * qs) * ks[k, t, b], divided by sqrt(hd), plus the
//      bias (0 where key_mask[b, t] > 0 and key_pos[b, t] <= q_pos[b, s],
//      else the finite -1e9, plus slope[h] * key_pos[b, t] under ALiBi);
//   3. a float32 softmax over the T slots: m = max, e = exp(x - m),
//      p = e / sum(e);
//   4. pw = p * vs[k, t, b], quantized over the T slots by the rule of 1;
//   5. o32 = sum_t pq[t] * vq[k, t, b, :] (exact), out = (float)o32 * ps,
//      rounded to q's dtype.
// Every float operation is written with its _rn intrinsic so that no
// contraction into an FMA changes a rounding; expf is the accurate one
// (no --use_fast_math). The plain twin (ops/kv_int8_attention.py) runs
// the same chain in torch; the integer parts agree bit for bit, the
// float chains only in value (other summation orders), so a value of pw
// at a rounding tie may take the neighbouring int8 level.
//
// What bounds it on the H100: bytes. A decode step reads each (b, k)
// pair's T key and value rows (hd int8 bytes each) and their scales
// once, against 2 * hd int8 operations a key per query row: at
// llama-2-7b width, B = 32, T = 552, S = 1 that is 149 MB against
// 1.2 G operations, 0.0445 ms of memory against 0.0006 ms of int8
// tensor-core time. The quantization scale of step 4 needs the max of
// pw over all T slots before any product with V, so the one online pass
// of the flash-decode kernels does not apply: a block keeps its rows'
// scores on chip. One block takes one (b, k) pair and up to kMaxRows of
// its S * G query rows (all of them at S = 1), so each K/V row it needs
// is read from device memory once for all its query heads; the scores
// (float32) and the probabilities' payload (int8) of its rows, T slots
// each, live in dynamic shared memory. Pass 1: a thread a slot loads the
// key row (hd / 4 words) into registers and runs dp4a against every
// row's query payload; pass 2: a warp a row takes the softmax, the
// value-scale fold and the quantization; pass 3: a thread a 4-byte word
// of the value rows, for its share of the rows, walks the slots (the
// warp's loads coalesce over one value row) and accumulates in int32.
// A simple kernel first: the dp4a products run on the CUDA cores, not
// the int8 tensor cores, which this size does not need.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// models/quant.dynamic_quant's scale and level.
__device__ __forceinline__ float quant_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
}

__device__ __forceinline__ int quant_level(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  return (int)fminf(fmaxf(r, -127.0f), 127.0f);
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
kv_int8_attention_kernel(const T* __restrict__ q,
                         const int8_t* __restrict__ kq, int64_t kq_stride,
                         const float* __restrict__ ks, int64_t ks_stride,
                         const int8_t* __restrict__ vq, int64_t vq_stride,
                         const float* __restrict__ vs, int64_t vs_stride,
                         const int* __restrict__ q_pos,
                         const int* __restrict__ key_mask,
                         const int* __restrict__ key_pos,
                         const float* __restrict__ slopes, int B, int S,
                         int H, int K, int Tk, int rows_per_block,
                         float sqrt_hd, T* __restrict__ out,
                         int* __restrict__ s32_out) {
  constexpr int W = HD / 4;              // 4-byte words of a row
  constexpr int NG = kThreads / W;       // row groups of pass 3
  constexpr int RPT = (kMaxRows + NG - 1) / NG;
  const int G = H / K;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = blockIdx.x * rows_per_block;
  const int R = min(rows_per_block, S * G - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);                  // R x Tk
  int8_t* qq = reinterpret_cast<int8_t*>(sc + rows_per_block * Tk);
  int8_t* pq = qq + rows_per_block * HD;                       // R x Tk
  __shared__ float qs_s[kMaxRows];
  __shared__ float ps_s[kMaxRows];
  __shared__ float slope_s[kMaxRows];
  __shared__ int qpos_s[kMaxRows];
  __shared__ int head_s[kMaxRows];
  __shared__ int spos_s[kMaxRows];

  // Pass 0: each row's query payload and scale (a warp a row).
  for (int r = warp; r < R; r += kWarps) {
    const int j = r0 + r;
    const int s = j / G;
    const int h = k * G + j % G;
    const T* qr = q + (((int64_t)b * S + s) * H + h) * HD;
    float amax = 0.0f;
    for (int d = lane; d < HD; d += 32) amax = fmaxf(amax, fabsf(load_f(qr + d)));
    amax = warp_max(amax);
    const float scale = quant_scale(amax);
    for (int d = lane; d < HD; d += 32)
      qq[r * HD + d] = (int8_t)quant_level(load_f(qr + d), scale);
    if (lane == 0) {
      qs_s[r] = scale;
      qpos_s[r] = q_pos[b * S + s];
      slope_s[r] = slopes ? slopes[h] : 0.0f;
      head_s[r] = h;
      spos_s[r] = s;
    }
  }
  __syncthreads();

  // Pass 1: the scores, a thread a slot.
  const int8_t* kb = kq + (int64_t)k * kq_stride + (int64_t)b * HD;
  const float* ksb = ks + (int64_t)k * ks_stride + b;
  const int* qqw = reinterpret_cast<const int*>(qq);
  for (int t = tid; t < Tk; t += kThreads) {
    const int* kr = reinterpret_cast<const int*>(kb + (int64_t)t * B * HD);
    int kw[W];
#pragma unroll
    for (int w = 0; w < W; ++w) kw[w] = kr[w];
    const float kscale = ksb[(int64_t)t * B];
    const bool valid = key_mask[b * Tk + t] > 0;
    const int kp = key_pos[b * Tk + t];
    for (int r = 0; r < R; ++r) {
      int acc = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) acc = __dp4a(qqw[r * W + w], kw[w], acc);
      if (s32_out)
        s32_out[(((int64_t)b * H + head_s[r]) * S + spos_s[r]) * Tk + t] = acc;
      float x = __fmul_rn(__fmul_rn((float)acc, qs_s[r]), kscale);
      x = __fdiv_rn(x, sqrt_hd);
      float bias = (valid && kp <= qpos_s[r]) ? 0.0f : -1e9f;
      if (slopes) bias = __fadd_rn(bias, __fmul_rn(slope_s[r], (float)kp));
      sc[r * Tk + t] = __fadd_rn(x, bias);
    }
  }
  __syncthreads();

  // Pass 2: softmax, the value-scale fold and its quantization (a warp
  // a row).
  const float* vsb = vs + (int64_t)k * vs_stride + b;
  for (int r = warp; r < R; r += kWarps) {
    float* row = sc + r * Tk;
    float m = -INFINITY;
    for (int t = lane; t < Tk; t += 32) m = fmaxf(m, row[t]);
    m = warp_max(m);
    float l = 0.0f;
    for (int t = lane; t < Tk; t += 32) {
      const float e = expf(__fsub_rn(row[t], m));
      row[t] = e;
      l = __fadd_rn(l, e);
    }
    l = warp_sum(l);
    float amax = 0.0f;
    for (int t = lane; t < Tk; t += 32) {
      const float pw = __fmul_rn(__fdiv_rn(row[t], l), vsb[(int64_t)t * B]);
      row[t] = pw;
      amax = fmaxf(amax, fabsf(pw));
    }
    amax = warp_max(amax);
    const float scale = quant_scale(amax);
    for (int t = lane; t < Tk; t += 32)
      pq[r * Tk + t] = (int8_t)quant_level(row[t], scale);
    if (lane == 0) ps_s[r] = scale;
  }
  __syncthreads();

  // Pass 3: the value products, a thread a word of the value rows and
  // its share of the rows.
  const int w = tid % W;
  const int grp = tid / W;
  if (grp >= NG) return;
  int acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0;
  const int8_t* vb = vq + (int64_t)vq_stride * k + (int64_t)b * HD + 4 * w;
  for (int t = 0; t < Tk; ++t) {
    const int v = *reinterpret_cast<const int*>(vb + (int64_t)t * B * HD);
    const int v0 = (int)(int8_t)(v & 0xff);
    const int v1 = (int)(int8_t)((v >> 8) & 0xff);
    const int v2 = (int)(int8_t)((v >> 16) & 0xff);
    const int v3 = (int)(int8_t)((v >> 24) & 0xff);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = grp + i * NG;
      if (r < R) {
        const int p = pq[r * Tk + t];
        acc[i][0] += p * v0;
        acc[i][1] += p * v1;
        acc[i][2] += p * v2;
        acc[i][3] += p * v3;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = grp + i * NG;
    if (r >= R) continue;
    T* o = out + (((int64_t)b * S + spos_s[r]) * H + head_s[r]) * HD + 4 * w;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      store_f(o + c, __fmul_rn((float)acc[i][c], ps_s[r]));
  }
}

template <int HD, typename T>
int launch(const void* q, const int8_t* kq, int64_t kq_stride,
           const float* ks, int64_t ks_stride, const int8_t* vq,
           int64_t vq_stride, const float* vs, int64_t vs_stride,
           const int* q_pos, const int* key_mask, const int* key_pos,
           const float* slopes, int B, int S, int H, int K, int Tk, int rows,
           float sqrt_hd, void* out, int* s32_out, cudaStream_t stream) {
  const size_t smem = (size_t)rows * (5 * (size_t)Tk + HD);
  auto kernel = kv_int8_attention_kernel<HD, T>;
  static bool raised = false;
  if (!raised) {
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  const int chunks = (S * (H / K) + rows - 1) / rows;
  const dim3 grid(chunks, K, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), kq, kq_stride, ks, ks_stride, vq, vq_stride,
      vs, vs_stride, q_pos, key_mask, key_pos, slopes, B, S, H, K, Tk, rows,
      sqrt_hd, static_cast<T*>(out), s32_out);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const int8_t* kq, int64_t kq_stride,
                const float* ks, int64_t ks_stride, const int8_t* vq,
                int64_t vq_stride, const float* vs, int64_t vs_stride,
                const int* q_pos, const int* key_mask, const int* key_pos,
                const float* slopes, int B, int S, int H, int K, int Tk,
                int rows, float sqrt_hd, void* out, int* s32_out,
                cudaStream_t stream) {
#define LIR_KV_INT8_CASE(D)                                                  \
  case D:                                                                    \
    return launch<D, T>(q, kq, kq_stride, ks, ks_stride, vq, vq_stride, vs,  \
                        vs_stride, q_pos, key_mask, key_pos, slopes, B, S,   \
                        H, K, Tk, rows, sqrt_hd, out, s32_out, stream);
  switch (hd) {
    LIR_KV_INT8_CASE(32)
    LIR_KV_INT8_CASE(64)
    LIR_KV_INT8_CASE(80)
    LIR_KV_INT8_CASE(96)
    LIR_KV_INT8_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LIR_KV_INT8_CASE
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q and out). rows: query rows a block,
// at most kMaxRows; the scores of rows * Tk slots must fit the block's
// shared memory (lir_kv_int8_max_smem).
extern "C" int lir_kv_int8_attention(
    const void* q, int dtype, const int8_t* kq, int64_t kq_stride,
    const float* ks, int64_t ks_stride, const int8_t* vq, int64_t vq_stride,
    const float* vs, int64_t vs_stride, const int* q_pos,
    const int* key_mask, const int* key_pos, const float* slopes, int B,
    int S, int H, int K, int Tk, int hd, int rows, float sqrt_hd, void* out,
    int* s32_out, cudaStream_t stream) {
  if (B <= 0 || S <= 0) return 0;
  if (rows < 1 || rows > kMaxRows || K <= 0 || H % K)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(
        hd, q, kq, kq_stride, ks, ks_stride, vq, vq_stride, vs, vs_stride,
        q_pos, key_mask, key_pos, slopes, B, S, H, K, Tk, rows, sqrt_hd, out,
        s32_out, stream);
  return dispatch_hd<float>(hd, q, kq, kq_stride, ks, ks_stride, vq,
                            vq_stride, vs, vs_stride, q_pos, key_mask,
                            key_pos, slopes, B, S, H, K, Tk, rows, sqrt_hd,
                            out, s32_out, stream);
}

// The most dynamic shared memory a block of this kernel may take on
// device `dev`: the opt-in limit less the static per-row slots (six
// words a row) and a kilobyte of slack.
extern "C" int lir_kv_int8_max_smem(int dev) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 48 * 1024 - 6 * kMaxRows * 4;
  return optin - 6 * kMaxRows * 4 - 1024;
}
