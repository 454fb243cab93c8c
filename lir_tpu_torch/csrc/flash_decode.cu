// Split-K flash decode for Hopper (sm_90a): single-query and multi-query
// attention over the KV cache, plus their trunk-aware siblings.
//
// Replaces lir_tpu/ops/flash_decode.py: _decode_kernel (flash_decode),
// _trunk_decode_kernel (flash_decode_trunk), _decode_kernel_mq
// (flash_decode_mq, and the tail leg of flash_decode_mq_trunk),
// _trunk_decode_kernel_mq (the trunk leg of flash_decode_mq_trunk), and
// the merge_partials call that follows each of them.
//
// Layout (the JAX package's public shapes, with the query axis S made
// explicit; single-query decode is S = 1): q (B, S, H, hd); k, v in the
// cache layout (K, T, B, hd), head-major and batch-minor, un-repeated for
// GQA/MQA (query head h = kh * G + g reads kv head kh); q_pos (B, S)
// int32, one mask-aware position per query; mask and kpos (B, T) int32;
// slopes (H,) float32 or null (ALiBi). A key is valid for query s iff
// mask > 0 and kpos <= q_pos[s].
//
// What bounds it on the H100: the bytes of the cache. One step at
// llama-2-7b width (K = 32, hd = 128), B = 32, T = 552 streams
// 2 * 32 * 552 * 32 * 128 * 2 B = 289 MB per layer and does about
// 4 * B * H * T * hd = 289 MFLOP, two orders under the ridge point; a
// speculative verify window (S = 4) at T = 576 reads 302 MB for four
// times the FLOPs, still far under it. The design therefore reads every
// K/V element once, with neighbouring threads on neighbouring elements of
// a key's hd vector (one key row of one batch row is contiguous; the next
// key of that row is B * hd elements on). Parallelism comes from the key
// axis: the cache splits into fixed-width splits (the last one ragged and
// masked), one block per (split, kv head, row). The block loads its K/V
// tile once and reduces every query of its row against it, one query at
// a time (S * G query rows: the shared memory holds one query's G rows,
// so MQA at falcon-7b width, G = 71, needs the same 69 KB at S = 4 as at
// S = 1), each into a partial (o, m, l) in float32. A second kernel
// merges the partials in split order, as merge_partials does, and writes
// the output straight in (B, S, H, hd).
//
// The trunk kernel reads a split that lies inside the shared trunk from
// cache row 0 once per (kv head, split, group of rows) and reduces the
// group's queries against it, so the trunk's bytes stream a few times
// per step, not once per row. It calls the same split_partial() as the
// flat kernel, with the same thread mapping, and writes into the same
// partial buffer; the tail splits run the flat kernel at a split offset.
// Each (row, query, group, split) partial is therefore computed by the
// same instructions on the same values whatever kernel, S or trunk
// extent produced it: the trunk kernels' output is bitwise the flat
// kernels', and query s of a multi-query launch is bitwise a
// single-query launch with q_pos[:, s]. The arithmetic uses the _rn
// intrinsics, so no contraction choice of the compiler can differ
// between the kernels.
//
// Simple on purpose: float32 FMA on CUDA cores, no tensor cores, no TMA.
// The score and probability tiles live in shared memory and never reach
// device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;

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

// The G queries of one (row, kv head), scaled by sm_scale as float32.
template <typename T>
__device__ void load_query(const T* __restrict__ q, float* qs, int n,
                           float sm_scale) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    qs[i] = __fmul_rn(to_f32(q[i]), sm_scale);
}

// Keys [t0, t0 + W) of cache row `row`, kv head kh, as float32. K rows
// are padded by one float so the score loop reads them without bank
// conflicts. Slots past T load as zeros (they are masked, and a zero
// keeps 0 * v finite). Where a key row is a whole number of 16-byte
// vectors, each thread issues kVecPerThread 16-byte loads of K and of V
// before converting any, so that many bytes are in flight per SM; the
// values stored are the same either way.
constexpr int kVecPerThread = 8;

template <typename T>
__device__ void load_tile(const T* __restrict__ k, const T* __restrict__ v,
                          float* ks, float* vs, int kh, int row, int t0,
                          int W, int T_, int B, int hd) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const bool vectors = hd % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (!vectors) {
    for (int i = threadIdx.x; i < W * hd; i += blockDim.x) {
      const int t = i / hd;
      const int d = i - t * hd;
      const int tg = t0 + t;
      float kv = 0.f, vv = 0.f;
      if (tg < T_) {
        const size_t off =
            ((size_t(kh) * T_ + tg) * B + row) * size_t(hd) + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[t * (hd + 1) + d] = kv;
      vs[t * hd + d] = vv;
    }
    return;
  }
  const int nvec = W * hd / kVec;
  for (int base = 0; base < nvec; base += kVecPerThread * blockDim.x) {
    uint4 kr[kVecPerThread], vr[kVecPerThread];
#pragma unroll
    for (int u = 0; u < kVecPerThread; ++u) {
      const int i = base + u * blockDim.x + threadIdx.x;
      kr[u] = make_uint4(0u, 0u, 0u, 0u);
      vr[u] = make_uint4(0u, 0u, 0u, 0u);
      const int e = i * kVec;
      const int t = e / hd;
      if (i < nvec && t0 + t < T_) {
        const size_t off = ((size_t(kh) * T_ + t0 + t) * B + row) * size_t(hd) +
                           (e - t * hd);
        kr[u] = *reinterpret_cast<const uint4*>(k + off);
        vr[u] = *reinterpret_cast<const uint4*>(v + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kVecPerThread; ++u) {
      const int i = base + u * blockDim.x + threadIdx.x;
      if (i >= nvec) continue;
      const int e = i * kVec;
      const int t = e / hd;
      const int d = e - t * hd;
      const T* kk = reinterpret_cast<const T*>(&kr[u]);
      const T* vv = reinterpret_cast<const T*>(&vr[u]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        ks[t * (hd + 1) + d + j] = to_f32(kk[j]);
        vs[t * hd + d + j] = to_f32(vv[j]);
      }
    }
  }
}

// One split's partial (o, m, l) for the G queries in qs against the
// K/V tile in ks/vs. mask_row/kpos_row are the row's (T,) arrays.
// Shared by the flat and the trunk kernel: it is the only place the
// per-(row, group, split) arithmetic happens.
__device__ void split_partial(const float* qs, const float* ks,
                              const float* vs, float* ss,
                              const int* __restrict__ mask_row,
                              const int* __restrict__ kpos_row, int qp,
                              const float* __restrict__ slope_g, int t0,
                              int W, int T_, int G, int hd,
                              float* __restrict__ o_out,
                              float* __restrict__ m_out,
                              float* __restrict__ l_out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  // Scores: s[g][t] = q_g . k_t (+ slope_g * kpos_t), -inf where masked.
  for (int idx = threadIdx.x; idx < G * W; idx += blockDim.x) {
    const int g = idx / W;
    const int t = idx - g * W;
    const int tg = t0 + t;
    float s = -CUDART_INF_F;
    if (tg < T_) {
      const int kp = kpos_row[tg];
      if (mask_row[tg] > 0 && kp <= qp) {
        const float* qg = qs + g * hd;
        const float* kt = ks + t * (hd + 1);
        float acc = 0.f;
        for (int d = 0; d < hd; ++d) acc = __fmaf_rn(qg[d], kt[d], acc);
        if (slope_g != nullptr)
          acc = __fadd_rn(acc, __fmul_rn(slope_g[g], float(kp)));
        s = acc;
      }
    }
    ss[idx] = s;
  }
  __syncthreads();

  // Softmax pieces per query: one warp per g. An all-masked split gives
  // m = -inf and l = 0.
  for (int g = warp; g < G; g += nwarps) {
    float* sg = ss + g * W;
    float m = -CUDART_INF_F;
    for (int t = lane; t < W; t += 32) m = fmaxf(m, sg[t]);
    m = warp_max(m);
    float l = 0.f;
    for (int t = lane; t < W; t += 32) {
      const float s = sg[t];
      const float p = (s == -CUDART_INF_F) ? 0.f : expf(__fsub_rn(s, m));
      sg[t] = p;
      l = __fadd_rn(l, p);
    }
    l = warp_sum(l);
    if (lane == 0) {
      m_out[g] = m;
      l_out[g] = l;
    }
  }
  __syncthreads();

  // o[g][d] = sum_t p[g][t] * v[t][d], in key order.
  for (int idx = threadIdx.x; idx < G * hd; idx += blockDim.x) {
    const int g = idx / hd;
    const int d = idx - g * hd;
    const float* pg = ss + g * W;
    float acc = 0.f;
    for (int t = 0; t < W; ++t) acc = __fmaf_rn(pg[t], vs[t * hd + d], acc);
    o_out[idx] = acc;
  }
  __syncthreads();
}

struct Args {
  const void* q;    // (B, S, H, hd)
  const void* k;
  const void* v;
  const int* qpos;  // (B, S)
  const int* mask;
  const int* kpos;
  const float* slopes;
  float* o_p;  // (B, K, NS, S, G, hd)
  float* m_p;  // (B, K, NS, S, G)
  float* l_p;
  int B, S, H, K, T, hd, W, NS;
  float sm_scale;
};

__host__ __device__ inline size_t smem_floats(int G, int hd, int W) {
  return size_t(G) * hd + size_t(W) * (hd + 1) + size_t(W) * hd +
         size_t(G) * W;
}

// The S queries of row b against the K/V tile of split j in ks/vs, one
// query at a time: its G rows into qs, then split_partial() into the
// partial slot (b, kh, j, s). split_partial() ends in a barrier, so the
// next query may overwrite qs.
template <typename T>
__device__ void row_partials(const Args& a, float* qs, const float* ks,
                             const float* vs, float* ss, int b, int kh,
                             int j) {
  const int G = a.H / a.K;
  const T* q = static_cast<const T*>(a.q);
  for (int s = 0; s < a.S; ++s) {
    const size_t qrow = size_t(b) * a.S + s;
    load_query<T>(q + (qrow * a.H + size_t(kh) * G) * a.hd, qs, G * a.hd,
                  a.sm_scale);
    __syncthreads();
    const size_t part = ((size_t(b) * a.K + kh) * a.NS + j) * a.S + s;
    split_partial(qs, ks, vs, ss, a.mask + size_t(b) * a.T,
                  a.kpos + size_t(b) * a.T, a.qpos[qrow],
                  a.slopes ? a.slopes + size_t(kh) * G : nullptr, j * a.W,
                  a.W, a.T, G, a.hd, a.o_p + part * G * a.hd,
                  a.m_p + part * G, a.l_p + part * G);
  }
}

// Grid (splits - offset, K, B): one block per (split, kv head, row). The
// tile is loaded once; the row's S queries reduce against it in turn.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(Args a, int split_offset) {
  extern __shared__ float smem[];
  const int j = blockIdx.x + split_offset;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.H / a.K;
  float* qs = smem;
  float* ks = qs + G * a.hd;
  float* vs = ks + a.W * (a.hd + 1);
  float* ss = vs + a.W * a.hd;
  load_tile<T>(static_cast<const T*>(a.k), static_cast<const T*>(a.v), ks, vs,
               kh, b, j * a.W, a.W, a.T, a.B, a.hd);
  row_partials<T>(a, qs, ks, vs, ss, b, kh, j);
}

// Grid (nt, K, row groups): one block per (trunk split, kv head, group
// of rows_per_block rows). The K/V tile comes from cache row 0 once per
// block; every query of every row of the group reduces against it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_trunk_kernel(Args a, int rows_per_block) {
  extern __shared__ float smem[];
  const int j = blockIdx.x;
  const int kh = blockIdx.y;
  const int b0 = blockIdx.z * rows_per_block;
  const int b1 = min(a.B, b0 + rows_per_block);
  const int G = a.H / a.K;
  float* qs = smem;
  float* ks = qs + G * a.hd;
  float* vs = ks + a.W * (a.hd + 1);
  float* ss = vs + a.W * a.hd;
  load_tile<T>(static_cast<const T*>(a.k), static_cast<const T*>(a.v), ks, vs,
               kh, 0, j * a.W, a.W, a.T, a.B, a.hd);
  for (int b = b0; b < b1; ++b) row_partials<T>(a, qs, ks, vs, ss, b, kh, j);
}

// out[b, s, h, d] = merge over splits in order (merge_partials).
template <typename T>
__global__ void merge_kernel(const float* __restrict__ o_p,
                             const float* __restrict__ m_p,
                             const float* __restrict__ l_p, T* __restrict__ out,
                             int B, int S, int H, int K, int NS, int hd) {
  const size_t idx = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = size_t(B) * S * H * hd;
  if (idx >= total) return;
  const int d = int(idx % hd);
  const int h = int((idx / hd) % H);
  const size_t bs = idx / (size_t(hd) * H);
  const int s = int(bs % S);
  const int b = int(bs / S);
  const int G = H / K;
  const int kh = h / G;
  const int g = h - kh * G;
  // Partial (b, kh, j, s, g) sits at ((base + j) * S + s) * G + g.
  const size_t base = (size_t(b) * K + kh) * NS;
  float m = -CUDART_INF_F;
  for (int j = 0; j < NS; ++j)
    m = fmaxf(m, m_p[((base + j) * S + s) * G + g]);
  float l = 0.f, o = 0.f;
  for (int j = 0; j < NS; ++j) {
    const size_t p = ((base + j) * S + s) * G + g;
    const float mj = m_p[p];
    const float w = isfinite(mj) ? expf(__fsub_rn(mj, m)) : 0.f;
    l = __fadd_rn(l, __fmul_rn(w, l_p[p]));
    o = __fadd_rn(o, __fmul_rn(w, o_p[p * hd + d]));
  }
  out[idx] = from_f32<T>(__fdiv_rn(o, fmaxf(l, 1e-30f)));
}

template <typename T>
cudaError_t launch_splits(const Args& a, int split_offset, cudaStream_t st) {
  const int G = a.H / a.K;
  const size_t smem = smem_floats(G, a.hd, a.W) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      decode_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return e;
  dim3 grid(a.NS - split_offset, a.K, a.B);
  decode_split_kernel<T><<<grid, kThreads, smem, st>>>(a, split_offset);
  return cudaGetLastError();
}

// Rows per trunk block: as many as keep at least two blocks per SM in
// flight. More rows per block read the trunk tile fewer times; fewer
// rows give the card more blocks.
int trunk_rows_per_block(int nt, int K, int B) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms <= 0)
    sms = 132;
  const int blocks = nt * K;
  int groups = (2 * sms + blocks - 1) / blocks;
  groups = groups < 1 ? 1 : (groups > B ? B : groups);
  return (B + groups - 1) / groups;
}

template <typename T>
cudaError_t launch_trunk(const Args& a, int nt, cudaStream_t st) {
  const int G = a.H / a.K;
  const size_t smem = smem_floats(G, a.hd, a.W) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      decode_trunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return e;
  const int rpb = trunk_rows_per_block(nt, a.K, a.B);
  dim3 grid(nt, a.K, (a.B + rpb - 1) / rpb);
  decode_trunk_kernel<T><<<grid, kThreads, smem, st>>>(a, rpb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_merge(const float* o_p, const float* m_p, const float* l_p,
                         void* out, int B, int S, int H, int K, int NS, int hd,
                         cudaStream_t st) {
  const size_t total = size_t(B) * S * H * hd;
  const int threads = 256;
  const unsigned blocks = unsigned((total + threads - 1) / threads);
  merge_kernel<T><<<blocks, threads, 0, st>>>(o_p, m_p, l_p,
                                              static_cast<T*>(out), B, S, H,
                                              K, NS, hd);
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* qpos,
               const void* mask, const void* kpos, const void* slopes,
               void* o_p, void* m_p, void* l_p, int B, int S, int H, int K,
               int T, int hd, int W, int NS) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.qpos = static_cast<const int*>(qpos);
  a.mask = static_cast<const int*>(mask);
  a.kpos = static_cast<const int*>(kpos);
  a.slopes = static_cast<const float*>(slopes);
  a.o_p = static_cast<float*>(o_p);
  a.m_p = static_cast<float*>(m_p);
  a.l_p = static_cast<float*>(l_p);
  a.B = B;
  a.S = S;
  a.H = H;
  a.K = K;
  a.T = T;
  a.hd = hd;
  a.W = W;
  a.NS = NS;
  // 1/sqrt(hd) rounded once from double, as the JAX package computes it.
  a.sm_scale = float(1.0 / sqrt(double(hd)));
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. S: queries per row (1 for a decode
// step, spec_k for a verify window). Every function returns
// cudaGetLastError() (or the error of a refused attribute), 0 on success.
extern "C" int lir_flash_decode_splits(
    const void* q, const void* k, const void* v, const void* qpos,
    const void* mask, const void* kpos, const void* slopes, void* o_p,
    void* m_p, void* l_p, int B, int S, int H, int K, int T, int hd, int W,
    int NS,
    int split_offset, int dtype, void* stream) {
  if (split_offset >= NS) return int(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, qpos, mask, kpos, slopes, o_p, m_p, l_p, B, S,
                     H, K, T, hd, W, NS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(launch_splits<float>(a, split_offset, st));
  if (dtype == 1) return int(launch_splits<__nv_bfloat16>(a, split_offset, st));
  return int(cudaErrorInvalidValue);
}

extern "C" int lir_flash_decode_trunk_splits(
    const void* q, const void* k, const void* v, const void* qpos,
    const void* mask, const void* kpos, const void* slopes, void* o_p,
    void* m_p, void* l_p, int B, int S, int H, int K, int T, int hd, int W,
    int NS,
    int nt, int dtype, void* stream) {
  if (nt <= 0 || nt > NS) return int(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, qpos, mask, kpos, slopes, o_p, m_p, l_p, B, S,
                     H, K, T, hd, W, NS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(launch_trunk<float>(a, nt, st));
  if (dtype == 1) return int(launch_trunk<__nv_bfloat16>(a, nt, st));
  return int(cudaErrorInvalidValue);
}

extern "C" int lir_flash_decode_merge(const void* o_p, const void* m_p,
                                      const void* l_p, void* out, int B, int S,
                                      int H, int K, int NS, int hd, int dtype,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* o = static_cast<const float*>(o_p);
  const float* m = static_cast<const float*>(m_p);
  const float* l = static_cast<const float*>(l_p);
  if (dtype == 0)
    return int(launch_merge<float>(o, m, l, out, B, S, H, K, NS, hd, st));
  if (dtype == 1)
    return int(
        launch_merge<__nv_bfloat16>(o, m, l, out, B, S, H, K, NS, hd, st));
  return int(cudaErrorInvalidValue);
}
