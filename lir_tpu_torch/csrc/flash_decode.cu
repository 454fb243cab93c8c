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
// times the FLOPs, still far under it. So the design is about bytes in
// flight and latency, not arithmetic rate: float32 FMA on CUDA cores.
//
// The cache splits into fixed-width splits of kW = 64 keys (the last one
// ragged and masked). One device function, split_partial(), turns one
// split's K/V tile and a set of query rows into one partial (o, m, l) in
// float32 per (row, query, group head, split); a second kernel merges the
// partials in split order, as merge_partials does, and writes the output
// straight in (B, S, H, hd). One kernel, decode_kernel(), runs both legs:
// - Row leg (flash_decode, flash_decode_mq, and the tail splits of the
//   trunk variants): a block owns up to kRowsMax of one batch row's S * G
//   query rows (falcon-7b's G = 71 at S = 4, 284 rows, takes nine blocks
//   of 32) and reads that row's K/V.
// - Trunk leg (the full splits inside a shared trunk): a block owns up to
//   kRowsMax rows flattened over all batch rows and reads the trunk's K/V
//   from cache row 0, so the trunk streams from device memory once per
//   step and from L2 once per block.
// In both, a block walks up to kMaxWalk consecutive splits through a
// kStages = 2 ring of bf16 (or float32) tiles in shared memory, filled by
// 16-byte cp.async copies that zero-fill keys past T: the next split's
// copies are in flight while this one reduces. Splits per block are
// chosen so that the launch still gives each SM several blocks.
// In split_partial() all of a block's rows go through one pass of scores,
// one warp per row for the softmax, and one pass of P V. The rows fall in
// at most four groups of 8, 4 or 1 rows (the fewest rows a group that keep
// one group a warp), held in registers: in the scores, a warp takes a
// group and a lane two keys of it, each K element converted from bf16
// once in registers and used by all the group's rows; in P V, a thread
// takes four columns of V for all of a group's rows. The query rows are
// float32 in shared memory, read as warp-wide broadcasts; the key mask
// and positions of a lane's keys are loaded before the wait for the tile.
//
// Bitwise invariants. Each partial's arithmetic is fixed whatever thread,
// block, kernel leg, S or trunk extent computes it: a score is a sequential
// __fmaf_rn chain over d of the float32 query (q * sm_scale, rounded once)
// and the key, then + slope * kpos; the softmax of a row is one warp's
// fixed lane order (max, expf(s - m), sums as a fixed shuffle tree); each
// output element is a sequential __fmaf_rn chain over the split's keys in
// order. So the trunk leg's partials are bitwise the row leg's where the
// trunk rows are identical (trunk == flat), and query s of a multi-query
// launch is bitwise a single-query launch with q_pos[:, s]. The _rn
// intrinsics keep the compiler from contracting differently anywhere.
//
// What is left: the merge reads each m_p twice per output element; a
// split-K over finer splits for the single-query step, whose S = 1 rows
// leave most threads of a block idle in the scores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kW = 64;         // keys per split (ops/flash_decode.py DECODE_SPLIT)
constexpr int kStages = 2;     // split tiles in the cp.async ring
constexpr int kRowsMax = 32;   // query rows a block reduces together
constexpr int kRowsPerThreadMax = 8;  // query rows a thread holds, at most
constexpr int kMaxWalk = 4;    // splits a block walks, at most
static_assert(kRowsMax <= kRowsPerThreadMax * kWarps, "at most one row group a warp");

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

// One 16-byte copy global -> shared; zero-fills the destination when !ok
// (src is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Eight consecutive elements (16-byte aligned) as float32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// Four consecutive elements (aligned to their size) as float32.
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc = fma(q[7], k[7], ... fma(q[0], k[0], acc)): eight steps of a score's
// sequential chain over d.
__device__ __forceinline__ float dot8(float acc, const float4& qa, const float4& qb,
                                      const float (&k)[8]) {
  acc = __fmaf_rn(qa.x, k[0], acc);
  acc = __fmaf_rn(qa.y, k[1], acc);
  acc = __fmaf_rn(qa.z, k[2], acc);
  acc = __fmaf_rn(qa.w, k[3], acc);
  acc = __fmaf_rn(qb.x, k[4], acc);
  acc = __fmaf_rn(qb.y, k[5], acc);
  acc = __fmaf_rn(qb.z, k[6], acc);
  return __fmaf_rn(qb.w, k[7], acc);
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

// The work of one launch of decode_kernel: splits [j0, j1), spb of them
// a block; query rows in blocks of ``rows``; row leg: ``chunks`` blocks a
// batch row, each reading that row's K/V; trunk leg: rows flattened over
// all batch rows, K/V from cache row 0.
struct Walk {
  int j0, j1, spb, rows, chunks;
  bool trunk;
};

// Row stride of a K/V tile in shared memory: hd plus one 16-byte chunk,
// an odd number of chunks for hd % 8 == 0, so that the eight rows read by
// a quarter-warp's 16-byte loads land on distinct banks.
template <typename T>
__host__ __device__ inline int tile_ld(int hd) {
  return hd + 16 / int(sizeof(T));
}

template <typename T>
__host__ __device__ inline size_t ring_bytes(int hd) {
  return size_t(kStages) * 2 * kW * tile_ld<T>(hd) * sizeof(T);
}

// Query rows of a block as laid out in shared memory: a whole number of
// the largest row group.
__host__ __device__ inline int rows_pad(int rows) {
  return (rows + kRowsPerThreadMax - 1) / kRowsPerThreadMax * kRowsPerThreadMax;
}

// Query rows a thread holds (a row group) for a block of ``rows`` rows:
// the fewest that make at most one group a warp.
inline int rows_per_thread(int rows) {
  return rows <= kWarps ? 1 : (rows <= 4 * kWarps ? 4 : 8);
}

template <typename T>
size_t smem_bytes(int hd, int rows) {
  return ring_bytes<T>(hd) + size_t(rows_pad(rows)) * (hd + kW) * sizeof(float);
}

// The copies of split j's K and V tile (cache row kv_row, kv head kh).
template <typename T>
__device__ __forceinline__ void load_split(T* kd, T* vd, const Args& a, int kh,
                                           int kv_row, int j) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = a.hd / kVec;
  const int ld = tile_ld<T>(a.hd);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  for (int i = threadIdx.x; i < kW * chunks; i += blockDim.x) {
    const int t = i / chunks;
    const int c = i - t * chunks;
    const int tg = j * kW + t;
    const bool ok = tg < a.T;
    const size_t off =
        ((size_t(kh) * a.T + (ok ? tg : 0)) * a.B + kv_row) * size_t(a.hd) + c * kVec;
    cp_async16(kd + t * ld + c * kVec, k + off, ok);
    cp_async16(vd + t * ld + c * kVec, v + off, ok);
  }
}

// The block's query rows: global row n (flattened (b, s, g) of kv head kh)
// is row i = n - n_lo of the block.
struct Rows {
  const int* b;       // batch row
  const int* qpos;    // query position
  const float* slope; // ALiBi slope (0 without)
  const size_t* part; // partial index at split 0; split j adds j * S * G
  int n;              // rows held
};

// One split's partials for the block's rows against the K/V tile in ks/vs
// (split j, the last cp.async group but one), RB rows a row group, at most
// one group a warp. Every thread of the block takes part; waits for the
// tile and ends in a barrier. It is the only place the per-(row, split)
// arithmetic happens.
template <typename T, int RB>
__device__ void split_partial(const Args& a, const Rows& r, const float* qs,
                              const T* ks, const T* vs, float* ss, int j) {
  const int hd = a.hd;
  const int ld = tile_ld<T>(hd);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = (r.n + RB - 1) / RB;
  const size_t SG = size_t(a.S) * (a.H / a.K);

  // Scores: ss[i][t] = q_i . k_t (+ slope_i * kpos_t), -inf where masked.
  // Warp w takes row group w; a lane takes keys lane and lane + 32 of it,
  // their mask and positions loaded before the wait for the tile.
  const int i0 = warp * RB;
  const bool mine = warp < groups;
  int live[RB][2], kp[RB][2];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int tg = j * kW + lane + 32 * c;
      const size_t at = size_t(r.b[min(i0 + i, r.n - 1)]) * a.T + tg;
      const bool in = mine && tg < a.T;
      live[i][c] = in ? a.mask[at] : 0;
      kp[i][c] = in ? a.kpos[at] : 0;
    }
  cp_async_wait1();  // split j has landed
  __syncthreads();
  if (mine) {
    float acc[RB][2];
#pragma unroll
    for (int i = 0; i < RB; ++i) acc[i][0] = acc[i][1] = 0.f;
    const T* k0 = ks + lane * ld;
    const T* k1 = ks + (lane + 32) * ld;
#pragma unroll 2
    for (int d = 0; d < hd; d += 8) {
      float ka[8], kb[8];
      load8(k0 + d, ka);
      load8(k1 + d, kb);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const float4 qa = *reinterpret_cast<const float4*>(qs + (i0 + i) * hd + d);
        const float4 qb = *reinterpret_cast<const float4*>(qs + (i0 + i) * hd + d + 4);
        acc[i][0] = dot8(acc[i][0], qa, qb, ka);
        acc[i][1] = dot8(acc[i][1], qa, qb, kb);
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int row = i0 + i;
      if (row >= r.n) break;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float s = -CUDART_INF_F;
        if (live[i][c] > 0 && kp[i][c] <= r.qpos[row]) {
          s = acc[i][c];
          if (a.slopes != nullptr) s = __fadd_rn(s, __fmul_rn(r.slope[row], float(kp[i][c])));
        }
        ss[row * kW + lane + 32 * c] = s;
      }
    }
  }
  __syncthreads();

  // Softmax pieces, one warp a row. An all-masked split gives m = -inf
  // and l = 0.
  for (int row = warp; row < r.n; row += kWarps) {
    float* sg = ss + row * kW;
    float m = -CUDART_INF_F;
    for (int t = lane; t < kW; t += 32) m = fmaxf(m, sg[t]);
    m = warp_max(m);
    float l = 0.f;
    for (int t = lane; t < kW; t += 32) {
      const float s = sg[t];
      const float p = (s == -CUDART_INF_F) ? 0.f : expf(__fsub_rn(s, m));
      sg[t] = p;
      l = __fadd_rn(l, p);
    }
    l = warp_sum(l);
    if (lane == 0) {
      const size_t at = r.part[row] + size_t(j) * SG;
      a.m_p[at] = m;
      a.l_p[at] = l;
    }
  }
  __syncthreads();

  // o[i][d] = sum_t p[i][t] * v[t][d] in key order. A thread takes four
  // columns d .. d + 3 of a row group.
  const int quads = hd / 4;
  for (int u = threadIdx.x; u < groups * quads; u += blockDim.x) {
    const int dq = u % quads;
    const int i0 = u / quads * RB;
    float o[RB][4];
#pragma unroll
    for (int i = 0; i < RB; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
    const T* vc = vs + 4 * dq;
    for (int t = 0; t < kW; t += 4) {
      float p[RB][4];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(ss + (i0 + i) * kW + t);
        p[i][0] = pv.x;
        p[i][1] = pv.y;
        p[i][2] = pv.z;
        p[i][3] = pv.w;
      }
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const float4 vv = load4(vc + (t + tt) * ld);
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          o[i][0] = __fmaf_rn(p[i][tt], vv.x, o[i][0]);
          o[i][1] = __fmaf_rn(p[i][tt], vv.y, o[i][1]);
          o[i][2] = __fmaf_rn(p[i][tt], vv.z, o[i][2]);
          o[i][3] = __fmaf_rn(p[i][tt], vv.w, o[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int row = i0 + i;
      if (row >= r.n) break;
      const size_t at = r.part[row] + size_t(j) * SG;
      *reinterpret_cast<float4*>(a.o_p + at * hd + 4 * dq) =
          make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
    }
  }
  __syncthreads();
}

// Grid (split groups, K, row blocks), see Walk.
template <typename T, int RB>
__global__ void __launch_bounds__(kThreads) decode_kernel(Args a, Walk w) {
  extern __shared__ __align__(16) unsigned char decode_smem[];
  __shared__ int row_b[kRowsMax], row_qpos[kRowsMax];
  __shared__ float row_slope[kRowsMax];
  __shared__ size_t row_part[kRowsMax];
  const int hd = a.hd;
  const int G = a.H / a.K;
  const int SG = a.S * G;
  const int kh = blockIdx.y;
  const int j_lo = w.j0 + blockIdx.x * w.spb;
  const int n_j = min(w.j1, j_lo + w.spb) - j_lo;
  int n_lo, n_hi, kv_row;
  if (w.trunk) {
    n_lo = blockIdx.z * w.rows;
    n_hi = min(a.B * SG, n_lo + w.rows);
    kv_row = 0;
  } else {
    kv_row = blockIdx.z / w.chunks;
    n_lo = kv_row * SG + (blockIdx.z - kv_row * w.chunks) * w.rows;
    n_hi = min((kv_row + 1) * SG, n_lo + w.rows);
  }
  const int n = n_hi - n_lo;
  const int ld = tile_ld<T>(hd);
  T* ring = reinterpret_cast<T*>(decode_smem);
  float* qs = reinterpret_cast<float*>(decode_smem + ring_bytes<T>(hd));
  float* ss = qs + rows_pad(w.rows) * hd;
  auto k_stage = [&](int i) { return ring + size_t(i % kStages) * 2 * kW * ld; };

  // The first split's copies fly while the rows are set up.
  load_split<T>(k_stage(0), k_stage(0) + kW * ld, a, kh, kv_row, j_lo);
  cp_async_commit();

  // Row i: flattened query n_lo + i = (b * S + s) * G + g of kv head kh,
  // its query scaled by sm_scale in float32; the last row group's padding
  // rows are zeros. Each pass issues four 8-element loads a thread before
  // it uses any.
  const T* q = static_cast<const T*>(a.q);
  auto q_row = [&](int i) {
    const int nn = n_lo + i;
    const int b = nn / SG;
    const int s = (nn - b * SG) / G;
    return q + ((size_t(b) * a.S + s) * a.H + size_t(kh) * G + (nn - b * SG - s * G)) * hd;
  };
  const int per_row = hd / 8;
  const int chunks = (n + RB - 1) / RB * RB * per_row;
  for (int c0 = 0; c0 < chunks; c0 += 4 * kThreads) {
    float f[4][8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * kThreads + threadIdx.x;
      const int i = c / per_row;
      if (c < chunks && i < n) {
        load8(q_row(i) + (c - i * per_row) * 8, f[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) f[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * kThreads + threadIdx.x;
      if (c >= chunks) break;
      float* dst = qs + (c / per_row) * hd + (c % per_row) * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = __fmul_rn(f[u][e], a.sm_scale);
    }
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int nn = n_lo + i;
    const int b = nn / SG;
    const int rs = nn - b * SG;
    const int s = rs / G;
    row_b[i] = b;
    row_qpos[i] = a.qpos[size_t(b) * a.S + s];
    row_slope[i] = a.slopes != nullptr ? a.slopes[size_t(kh) * G + rs - s * G] : 0.f;
    row_part[i] = (size_t(b) * a.K + kh) * a.NS * size_t(SG) + rs;
  }
  __syncthreads();  // the rows' indices, read before the first tile's barrier
  const Rows rows{row_b, row_qpos, row_slope, row_part, n};

  for (int i = 0; i < n_j; ++i) {
    if (i + 1 < n_j)
      load_split<T>(k_stage(i + 1), k_stage(i + 1) + kW * ld, a, kh, kv_row, j_lo + i + 1);
    cp_async_commit();
    split_partial<T, RB>(a, rows, qs, k_stage(i), k_stage(i) + kW * ld, ss, j_lo + i);
  }
}

// out[b, s, h, d] = merge over splits in order (merge_partials), four
// columns d .. d + 3 a thread (each with the one-column arithmetic).
template <typename T>
__device__ __forceinline__ void store4(T* out, float4 v);
template <>
__device__ __forceinline__ void store4<float>(float* out, float4 v) {
  *reinterpret_cast<float4*>(out) = v;
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* out, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 pk;
  pk.x = *reinterpret_cast<uint32_t*>(&lo);
  pk.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out) = pk;
}

template <typename T>
__global__ void merge_kernel(const float* __restrict__ o_p,
                             const float* __restrict__ m_p,
                             const float* __restrict__ l_p, T* __restrict__ out,
                             int B, int S, int H, int K, int NS, int hd) {
  const int quads = hd / 4;
  const size_t idx = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = size_t(B) * S * H * quads;
  if (idx >= total) return;
  const int d = int(idx % quads) * 4;
  const int h = int((idx / quads) % H);
  const size_t bs = idx / (size_t(quads) * H);
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
  float l = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < NS; ++j) {
    const size_t p = ((base + j) * S + s) * G + g;
    const float mj = m_p[p];
    const float w = isfinite(mj) ? expf(__fsub_rn(mj, m)) : 0.f;
    const float4 oj = *reinterpret_cast<const float4*>(o_p + p * hd + d);
    l = __fadd_rn(l, __fmul_rn(w, l_p[p]));
    o.x = __fadd_rn(o.x, __fmul_rn(w, oj.x));
    o.y = __fadd_rn(o.y, __fmul_rn(w, oj.y));
    o.z = __fadd_rn(o.z, __fmul_rn(w, oj.z));
    o.w = __fadd_rn(o.w, __fmul_rn(w, oj.w));
  }
  const float den = fmaxf(l, 1e-30f);
  store4<T>(out + (bs * H + h) * hd + d,
            make_float4(__fdiv_rn(o.x, den), __fdiv_rn(o.y, den), __fdiv_rn(o.z, den),
                        __fdiv_rn(o.w, den)));
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms <= 0)
    sms = 132;
  return sms;
}

// One launch of decode_kernel over splits [j0, j1): the row leg, or with
// ``trunk`` the trunk leg. Rows go in the fewest blocks of at most
// kRowsMax, spread evenly; each block walks as many splits (at most
// kMaxWalk) as still leave four blocks' worth of (split, kv head, row
// block) units an SM, the splits spread evenly over the blocks.
template <typename T>
cudaError_t launch_walk(const Args& a, int j0, int j1, bool trunk, cudaStream_t st) {
  if (a.W != kW || a.hd <= 0 || a.hd % 8 != 0 || j0 < 0 || j1 <= j0 || j1 > a.NS)
    return cudaErrorInvalidValue;
  const long long SG = (long long)a.S * (a.H / a.K);
  const long long all = trunk ? a.B * SG : SG;
  const long long chunks = (all + kRowsMax - 1) / kRowsMax;
  Walk w;
  w.j0 = j0;
  w.j1 = j1;
  w.trunk = trunk;
  w.rows = int((all + chunks - 1) / chunks);
  w.chunks = int(chunks);
  const long long row_blocks = trunk ? chunks : chunks * a.B;
  const int ns = j1 - j0;
  long long spb = (long long)ns * a.K * row_blocks / (4LL * sm_count());
  spb = spb < 1 ? 1 : (spb > kMaxWalk ? kMaxWalk : spb);
  const int groups = int((ns + spb - 1) / spb);
  w.spb = (ns + groups - 1) / groups;
  const int rb = rows_per_thread(w.rows);
  auto kernel = rb == 8 ? decode_kernel<T, 8> : rb == 4 ? decode_kernel<T, 4> : decode_kernel<T, 1>;
  const size_t smem = smem_bytes<T>(a.hd, w.rows);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  dim3 grid(groups, a.K, unsigned(row_blocks));
  kernel<<<grid, kThreads, smem, st>>>(a, w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_merge(const float* o_p, const float* m_p, const float* l_p,
                         void* out, int B, int S, int H, int K, int NS, int hd,
                         cudaStream_t st) {
  const size_t total = size_t(B) * S * H * (hd / 4);
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
// step, spec_k for a verify window). W must be kW (64) and hd a multiple
// of 8 (16-byte tile rows); q, k and v 16-byte aligned. Every function returns
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
  if (dtype == 0) return int(launch_walk<float>(a, split_offset, NS, false, st));
  if (dtype == 1) return int(launch_walk<__nv_bfloat16>(a, split_offset, NS, false, st));
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
  if (dtype == 0) return int(launch_walk<float>(a, 0, nt, true, st));
  if (dtype == 1) return int(launch_walk<__nv_bfloat16>(a, 0, nt, true, st));
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
