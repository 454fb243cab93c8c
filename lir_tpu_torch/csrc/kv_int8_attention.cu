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
//   2. s32 = dot(q payload, kq[k, t, b, :]), exact; the score
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
// 1.2 G operations, 0.0447 ms of memory against 0.0006 ms of int8
// tensor-core time. So the design reads each byte once and keeps the
// memory system busy with many small blocks:
// - T is split across the blocks of a thread-block cluster (the plan of
//   ops/kv_int8_attention.py: 1 to 8 blocks of `slice` slots, the fewest
//   whose slices hold at most 64 KB of keys, from T and hd alone), one
//   cluster a (b, k, query-row chunk); each block holds the scores of its
//   slice in shared memory. The scale of step 4 needs max |pw| over all T
//   slots before any product with V, so the blocks exchange each row's
//   max, then its partial sums of e (added in rank order by every block
//   alike), then its max |pw|: each block stores its values into every
//   block's shared memory (distributed shared memory) before a cluster
//   barrier and reads its own after it. Each block multiplies its own
//   slice's probabilities into V and adds its s32 partial output into
//   the block that finishes each element (integer `red` into
//   distributed shared memory, exact in any order); after one more
//   barrier each block writes its share. One launch, no scratch in
//   device memory, no float atomics.
// - A block's K and then V tiles (32 slots each) stream through a ring
//   of two shared-memory stages filled by 16-byte cp.async copies (the
//   copy of the next tile runs while one is read; deeper rings measured
//   slower: fewer blocks fit an SM and the memory system congests), so a
//   warp reads whole cache rows. The query rows, the first loads a block
//   issues, are quantized while the first tile lands.
// - A block holds up to 64 query rows (all S * G of a (b, k) pair at the
//   main path's shapes), so each K/V byte is read once for all of them.
//   From 8 rows on (256 threads, four blocks an SM), both products run on
//   the int8 tensor cores (mma.sync m16n8k32 s8 x s8 -> s32): QK^T from
//   the staged key rows, PV from each value tile transposed in shared
//   memory (byte permutes); hd 80 / 96 pad to 96 with zero query bytes
//   and the slot tail with zero probabilities, which add exact zeros.
//   Fewer rows (128 threads, eight blocks an SM) take dp4a: QK^T with 8
//   lanes a slot, 16 bytes each; PV a thread a 4-byte word of the value
//   rows and a quad of slots, the quad's 4 x 4 bytes transposed in
//   registers, the quads' sums added by shared-memory integer atomics.
// Every float reduction of a row depends on T and hd alone: the max and
// max |pw| are order-free, the sum of e runs lane by lane over the
// block's slice (slot lane + 32 j into lane's sum), then warp_sum's
// butterfly, then the blocks in rank order. So a row's bits do not
// depend on B, S, G, the row chunk or the product's route, and launch
// after launch gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace hp = hopper;

constexpr int kThreads = 128;        // a dp4a block's threads (eight blocks an SM)
constexpr int kMmaThreads = 256;     // an IMMA block's (four an SM)
constexpr int kTile = 32;            // slots a ring stage
constexpr int kMaxRows = 64;         // query rows a block
constexpr int kMaxSplits = 8;        // blocks a cluster (the portable size)
constexpr int kStages = 2;           // stages of the ring: double buffering
constexpr int kMmaRows = 8;          // a block of this many rows or more runs IMMA
constexpr int kVtPitch = kTile + 4;  // bytes of a transposed value row

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The dynamic shared memory of a block (byte offsets, all 16-aligned),
// from the head dim, the rows a block, the slots of a slice and the
// blocks of a cluster; ops/kv_int8_attention.py's `dyn_smem` is the same
// sum.
struct Layout {
  int kp;      // bytes between staged cache rows (hd padded to 32, + 16)
  int ntp;     // slots of a slice padded to whole tiles
  int rp;      // query rows padded to the IMMA tile (16) or not
  int qpitch;  // bytes between query payload rows
  int ppitch;  // bytes between probability payload rows
  int ring, o32, mine, xch, vt, sc, pq, qq, slots, total;
  __host__ __device__ Layout(int hd, int rows, int slice, int splits) {
    const bool mma = rows >= kMmaRows;
    const int hdp = round_up(hd, 32);
    kp = hdp + 16;
    ntp = round_up(slice, kTile);
    rp = mma ? round_up(rows, 16) : rows;
    qpitch = mma ? kp : hd;
    ppitch = mma ? ntp + 16 : ntp;
    ring = 0;
    o32 = round_up(kStages * kTile * kp, 16);
    mine = o32 + round_up(rows * hd * 4, 16);
    xch = mine + (mma ? 0 : round_up(rows * hd * 4, 16));
    vt = xch + round_up(3 * splits * rows * 4, 16);
    sc = vt + (mma ? round_up(hdp * kVtPitch, 16) : 0);
    pq = sc + round_up(rows * slice * 4, 16);
    qq = pq + round_up(rp * ppitch, 16);
    slots = qq + round_up(rp * qpitch, 16);
    total = slots + 16 * slice;
  }
};

struct Params {
  const void* q;
  const int8_t* kq;
  const int8_t* vq;
  const float* ks;
  const float* vs;
  int64_t kq_stride, vq_stride, ks_stride, vs_stride;
  const int* q_pos;
  const int* key_mask;
  const int* key_pos;
  const float* slopes;
  void* out;
  int* s32_out;
  int B, S, H, K, T;
  int rows, splits, slice;
  float sqrt_hd;
};

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
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
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

// Step 2's score of one (row, slot), the same operations on every route.
__device__ __forceinline__ float score(int s32, float qs, float ks, float sqrt_hd, bool ok,
                                       int kp, int qpos, bool alibi, float slope) {
  float x = __fmul_rn(__fmul_rn((float)s32, qs), ks);
  x = __fdiv_rn(x, sqrt_hd);
  float bias = (ok && kp <= qpos) ? 0.0f : -1e9f;
  if (alibi) bias = __fadd_rn(bias, __fmul_rn(slope, (float)kp));
  return __fadd_rn(x, bias);
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(hp::smem_u32(dst)), "l"(src)
               : "memory");
}

// One 4-byte copy global -> shared (through L1: the scales of
// neighbouring batch rows share lines).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(hp::smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A store into, and an integer add onto, the shared memory of cluster
// block `rank` at `p`'s offset.
__device__ __forceinline__ void st_cluster(float* p, int rank, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(hp::cluster_addr(p, uint32_t(rank))),
               "f"(v)
               : "memory");
}

__device__ __forceinline__ void red_cluster(int* p, int rank, int v) {
  asm volatile("red.shared::cluster.add.s32 [%0], %1;\n" ::"r"(hp::cluster_addr(p, uint32_t(rank))),
               "r"(v)
               : "memory");
}

// Grid (splits * chunks, B, K) in clusters of `splits` along x: block
// rank c of a cluster takes slots [c * slice, (c + 1) * slice) of T
// (perhaps none) for query rows [chunk * rows, ...) of kv head k and
// batch row b. MMA: the products on the int8 tensor cores.
template <int HD, typename T, bool MMA>
__global__ void __launch_bounds__(MMA ? kMmaThreads : kThreads, MMA ? 4 : 8)
    kv_int8_attention_kernel(const __grid_constant__ Params p) {
  constexpr int NT = MMA ? kMmaThreads : kThreads;
  constexpr int NW = NT / 32;
  constexpr int CH = HD / 16;            // 16-byte chunks of a cache row
  constexpr int HDP = round_up(HD, 32);  // the IMMA depth
  constexpr int KP = HDP + 16;           // bytes between staged rows
  constexpr int kStageBytes = kTile * KP;
  const Layout L(HD, p.rows, p.slice, p.splits);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float qs_s[kMaxRows], ps_s[kMaxRows], slope_s[kMaxRows];
  __shared__ int qpos_s[kMaxRows];
  unsigned char* ring = smem + L.ring;
  int* o32 = reinterpret_cast<int*>(smem + L.o32);
  int* mine = reinterpret_cast<int*>(smem + L.mine);  // dp4a: the groups' sum
  float* xch = reinterpret_cast<float*>(smem + L.xch);  // [3][splits][rows]
  unsigned char* vt = smem + L.vt;
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  int8_t* pq = reinterpret_cast<int8_t*>(smem + L.pq);
  int8_t* qq = reinterpret_cast<int8_t*>(smem + L.qq);
  float* ks_s = reinterpret_cast<float*>(smem + L.slots);
  float* vs_s = ks_s + p.slice;
  int* kp_s = reinterpret_cast<int*>(vs_s + p.slice);
  int* mask_s = kp_s + p.slice;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int C = p.splits;
  const int rank = int(blockIdx.x) % C;
  const int chunk = int(blockIdx.x) / C;
  const int b = blockIdx.y;
  const int k = blockIdx.z;
  const int G = p.H / p.K;
  const int r0 = chunk * p.rows;
  const int R = min(p.rows, p.S * G - r0);
  const int lo = rank * p.slice;
  const int n = max(0, min(p.slice, p.T - lo));  // slots of this block
  const int ntiles = (n + kTile - 1) / kTile;
  const int total = 2 * ntiles;                  // K tiles, then V tiles
  const int64_t row_step = int64_t(p.B) * HD;
  const bool alibi = p.slopes != nullptr;

  // The ring: tile i < ntiles is K tile i, then V tile i - ntiles; the
  // copy of tile i + 1 runs while tile i is read.
  auto issue = [&](int i) {
    const bool is_v = i >= ntiles;
    const int t0 = (is_v ? i - ntiles : i) * kTile;
    const int cnt = min(kTile, n - t0);
    const int8_t* src = (is_v ? p.vq + int64_t(k) * p.vq_stride : p.kq + int64_t(k) * p.kq_stride) +
                        int64_t(lo + t0) * row_step + int64_t(b) * HD;
    unsigned char* dst = ring + (i % kStages) * kStageBytes;
    for (int u = tid; u < cnt * CH; u += NT) {
      const int r = u / CH;
      const int c = u - r * CH;
      cp_async16(dst + r * KP + c * 16, src + r * row_step + c * 16);
    }
    cp_async_commit();
  };
  // The first two query rows of each warp (all of them up to 16), their
  // positions and slopes: loaded before any copy is issued, which they
  // would queue behind.
  auto q_row = [&](int r) {
    const int j = r0 + r;
    return static_cast<const T*>(p.q) + ((int64_t(b) * p.S + j / G) * p.H + k * G + j % G) * HD;
  };
  constexpr int QV = (HD + 31) / 32;  // a lane's elements of a query row
  float qv[2][QV];
  int qpos_v[2];
  float slope_v[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp + i * NW;
    const int j = r0 + r;
#pragma unroll
    for (int e = 0; e < QV; ++e)
      qv[i][e] = (r < R && lane + 32 * e < HD) ? load_f(q_row(r) + lane + 32 * e) : 0.0f;
    qpos_v[i] = r < R ? p.q_pos[b * p.S + j / G] : 0;
    slope_v[i] = (r < R && alibi) ? p.slopes[k * G + j % G] : 0.0f;
  }
  // The slice's scales, key positions and mask, in the first group.
  for (int t = tid; t < n; t += NT) {
    const int64_t at = int64_t(lo + t) * p.B + b;
    cp_async4(ks_s + t, p.ks + int64_t(k) * p.ks_stride + at);
    cp_async4(vs_s + t, p.vs + int64_t(k) * p.vs_stride + at);
    cp_async4(kp_s + t, p.key_pos + int64_t(b) * p.T + lo + t);
    cp_async4(mask_s + t, p.key_mask + int64_t(b) * p.T + lo + t);
  }
  if (total > 0) issue(0);
  // Tile i has landed and every warp is done with tile i - 1, whose stage
  // the copy of tile i + 1 fills.
  auto acquire = [&](int i) {
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < total) issue(i + 1);
    return ring + (i % kStages) * kStageBytes;
  };

  // Each row's query payload and scale (a warp a row), while the tiles
  // land; IMMA's pad rows and pad depth are zeros. The partial output
  // starts at zero (before the first cluster barrier: the other blocks
  // add into it).
  for (int u = tid; u < R * HD; u += NT) {
    o32[u] = 0;
    if (!MMA) mine[u] = 0;
  }
  for (int r = warp; r < L.rp; r += NW) {
    int8_t* qrow = qq + r * L.qpitch;
    if (r >= R) {
      for (int d = lane; d < L.qpitch; d += 32) qrow[d] = 0;
      for (int t = lane; t < L.ntp; t += 32) pq[r * L.ppitch + t] = 0;
      continue;
    }
    const int i = (r - warp) / NW;
    const int j = r0 + r;
    float x[QV];
#pragma unroll
    for (int e = 0; e < QV; ++e)
      x[e] = i == 0 ? qv[0][e]
             : i == 1 ? qv[1][e]
                      : (lane + 32 * e < HD ? load_f(q_row(r) + lane + 32 * e) : 0.0f);
    float amax = 0.0f;
#pragma unroll
    for (int e = 0; e < QV; ++e) amax = fmaxf(amax, fabsf(x[e]));
    const float scale = quant_scale(warp_max(amax));
#pragma unroll
    for (int e = 0; e < QV; ++e)
      if (lane + 32 * e < HD) qrow[lane + 32 * e] = (int8_t)quant_level(x[e], scale);
    for (int d = HD + lane; d < L.qpitch; d += 32) qrow[d] = 0;
    if (lane == 0) {
      qs_s[r] = scale;
      qpos_s[r] = i == 0 ? qpos_v[0] : i == 1 ? qpos_v[1] : p.q_pos[b * p.S + j / G];
      slope_s[r] = i == 0 ? slope_v[0]
                   : i == 1 ? slope_v[1]
                            : (alibi ? p.slopes[k * G + j % G] : 0.0f);
    }
  }
  __syncthreads();

  auto store_score = [&](int r, int tl, int acc) {
    if (p.s32_out) {
      const int j = r0 + r;
      const int h = k * G + j % G;
      p.s32_out[((int64_t(b) * p.H + h) * p.S + j / G) * p.T + lo + tl] = acc;
    }
    sc[r * p.slice + tl] = score(acc, qs_s[r], ks_s[tl], p.sqrt_hd, mask_s[tl] > 0, kp_s[tl],
                                 qpos_s[r], alibi, slope_s[r]);
  };

  // Pass 1: the slice's scores.
  if constexpr (MMA) {
    // A warp an (m16 row tile, 8-slot block) item: A = the query rows, B =
    // the staged key rows (depth contiguous in both).
    const int items = (L.rp / 16) * (kTile / 8);
    for (int i = 0; i < ntiles; ++i) {
      const unsigned char* st = acquire(i);
      for (int item = warp; item < items; item += NW) {
        const int mt = item / (kTile / 8);
        const int nb = item % (kTile / 8);
        const unsigned char* qa =
            reinterpret_cast<const unsigned char*>(qq) + (mt * 16 + (lane >> 2)) * KP + 4 * (lane & 3);
        const unsigned char* kb = st + (nb * 8 + (lane >> 2)) * KP + 4 * (lane & 3);
        int d[4] = {0, 0, 0, 0};
#pragma unroll
        for (int kc = 0; kc < HDP / 32; ++kc) {
          const uint32_t a[4] = {ld32(qa + kc * 32), ld32(qa + 8 * KP + kc * 32),
                                 ld32(qa + kc * 32 + 16), ld32(qa + 8 * KP + kc * 32 + 16)};
          mma_s8(d, a, ld32(kb + kc * 32), ld32(kb + kc * 32 + 16));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = mt * 16 + (lane >> 2) + 8 * (e >> 1);
          const int tl = i * kTile + nb * 8 + 2 * (lane & 3) + (e & 1);
          if (r < R && tl < n) store_score(r, tl, d[e]);
        }
      }
    }
  } else {
    // Eight lanes a slot, 16 bytes of its key row each: dp4a against each
    // row's query words, the lanes' sums added by shuffles; lane c of the
    // eight keeps row c's.
    const int c = tid & 7;
    for (int i = 0; i < ntiles; ++i) {
      const unsigned char* st = acquire(i);
      for (int sl = tid >> 3; sl < kTile; sl += NT / 8) {
        const int tl = i * kTile + sl;
        int4 kw = make_int4(0, 0, 0, 0);
        if (c < CH) kw = *reinterpret_cast<const int4*>(st + sl * KP + c * 16);
        int mine = 0;
#pragma unroll
        for (int r = 0; r < kMmaRows - 1; ++r) {
          if (r >= R) break;
          int4 qw = make_int4(0, 0, 0, 0);
          if (c < CH) qw = *reinterpret_cast<const int4*>(qq + r * HD + c * 16);
          int acc = __dp4a(qw.x, kw.x, 0);
          acc = __dp4a(qw.y, kw.y, acc);
          acc = __dp4a(qw.z, kw.z, acc);
          acc = __dp4a(qw.w, kw.w, acc);
#pragma unroll
          for (int o = 4; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
          if (c == r) mine = acc;
        }
        if (c < R && tl < n) store_score(c, tl, mine);
      }
    }
  }
  __syncthreads();

  // Pass 2: softmax over all T slots, the value-scale fold and its
  // quantization (a warp a row). Each block stores its row max, then its
  // sum, then its max |pw| into slot `rank` of every block's exchange,
  // and after each cluster barrier reads the C slots of its own.
  float* xm = xch;
  float* xl = xch + C * p.rows;
  float* xa = xch + 2 * C * p.rows;
  for (int r = warp; r < R; r += NW) {
    const float* row = sc + r * p.slice;
    float m = -INFINITY;
#pragma unroll 4
    for (int t = lane; t < n; t += 32) m = fmaxf(m, row[t]);
    m = warp_max(m);
    if (lane < C) st_cluster(xm + rank * p.rows + r, lane, m);
  }
  hp::cluster_sync();
  for (int r = warp; r < R; r += NW) {
    float* row = sc + r * p.slice;
    const float m = warp_max(lane < C ? xm[lane * p.rows + r] : -INFINITY);
    float l = 0.0f;
#pragma unroll 4
    for (int t = lane; t < n; t += 32) {
      const float e = expf(__fsub_rn(row[t], m));
      row[t] = e;
      l = __fadd_rn(l, e);
    }
    l = warp_sum(l);
    if (lane < C) st_cluster(xl + rank * p.rows + r, lane, l);
  }
  hp::cluster_sync();
  for (int r = warp; r < R; r += NW) {
    float* row = sc + r * p.slice;
    float l = xl[r];
    for (int c = 1; c < C; ++c) l = __fadd_rn(l, xl[c * p.rows + r]);
    float amax = 0.0f;
#pragma unroll 4
    for (int t = lane; t < n; t += 32) {
      const float pw = __fmul_rn(__fdiv_rn(row[t], l), vs_s[t]);
      row[t] = pw;
      amax = fmaxf(amax, fabsf(pw));
    }
    amax = warp_max(amax);
    if (lane < C) st_cluster(xa + rank * p.rows + r, lane, amax);
  }
  hp::cluster_sync();
  for (int r = warp; r < R; r += NW) {
    const float* row = sc + r * p.slice;
    const float scale = quant_scale(warp_max(lane < C ? xa[lane * p.rows + r] : 0.0f));
#pragma unroll 4
    for (int t = lane; t < L.ntp; t += 32)
      pq[r * L.ppitch + t] = t < n ? (int8_t)quant_level(row[t], scale) : 0;
    if (lane == 0) ps_s[r] = scale;
  }
  __syncthreads();

  // Pass 3: the slice's s32 partial output, added into the partial of the
  // block that finishes each element (element e of the R x HD output
  // belongs to block e / per).
  const int per = (R * HD + C - 1) / C;
  auto add_out = [&](int e, int v) { red_cluster(o32 + e, e / per, v); };
  if constexpr (MMA) {
    // Each value tile transposed (slots contiguous a column) by 4 x 4 byte
    // blocks, then a warp an (m16 row tile, 8-column block) item: A = the
    // probability payloads, B = the transposed tile.
    constexpr int NB = HDP / 8;
    constexpr int kItems = kMaxRows / 16 * NB / NW;  // a warp's at most
    const int items = (L.rp / 16) * NB;
    int acc[kItems][4];
#pragma unroll
    for (int ii = 0; ii < kItems; ++ii)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ii][e] = 0;
    for (int i = 0; i < ntiles; ++i) {
      const unsigned char* st = acquire(ntiles + i);
      for (int u = tid; u < 8 * (HDP / 4); u += NT) {
        const int sq = (u & 3) + 4 * ((u >> 5) & 1);
        const int cq = ((u >> 2) & 7) + 8 * (u >> 6);
        const unsigned char* at = st + 4 * sq * KP + 4 * cq;
        const uint32_t w0 = ld32(at), w1 = ld32(at + KP), w2 = ld32(at + 2 * KP),
                       w3 = ld32(at + 3 * KP);
        const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), hi01 = __byte_perm(w0, w1, 0x7362);
        const uint32_t lo23 = __byte_perm(w2, w3, 0x5140), hi23 = __byte_perm(w2, w3, 0x7362);
        uint32_t* col = reinterpret_cast<uint32_t*>(vt + 4 * cq * kVtPitch + 4 * sq);
        col[0] = __byte_perm(lo01, lo23, 0x5410);
        col[kVtPitch / 4] = __byte_perm(lo01, lo23, 0x7632);
        col[2 * kVtPitch / 4] = __byte_perm(hi01, hi23, 0x5410);
        col[3 * kVtPitch / 4] = __byte_perm(hi01, hi23, 0x7632);
      }
      __syncthreads();
#pragma unroll
      for (int ii = 0; ii < kItems; ++ii) {
        const int item = warp + ii * NW;
        if (item < items) {
          const int mt = item / NB;
          const int nb = item % NB;
          const unsigned char* pa = reinterpret_cast<const unsigned char*>(pq) +
                                    (mt * 16 + (lane >> 2)) * L.ppitch + i * kTile + 4 * (lane & 3);
          const unsigned char* vb = vt + (nb * 8 + (lane >> 2)) * kVtPitch + 4 * (lane & 3);
          const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * L.ppitch), ld32(pa + 16),
                                 ld32(pa + 8 * L.ppitch + 16)};
          mma_s8(acc[ii], a, ld32(vb), ld32(vb + 16));
        }
      }
    }
#pragma unroll
    for (int ii = 0; ii < kItems; ++ii) {
      const int item = warp + ii * NW;
      if (item >= items) continue;
      const int mt = item / NB;
      const int nb = item % NB;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mt * 16 + (lane >> 2) + 8 * (e >> 1);
        const int d = nb * 8 + 2 * (lane & 3) + (e & 1);
        if (r < R && d < HD) add_out(r * HD + d, acc[ii][e]);
      }
    }
  } else {
    // A thread a 4-byte word of the value rows and a quad of slots: the
    // quad's 4 x 4 bytes transposed in registers (a word a column), then
    // dp4a against each row's 4 probabilities. The quads' sums meet by
    // shared-memory integer atomics (exact in any order), then one add an
    // element goes to its block.
    constexpr int W = HD / 4;
    constexpr int NQ = NT / W;  // quads a pass of the block
    const int w = tid % W;
    const int g0 = tid / W;
    int acc[kMmaRows - 1][4];
#pragma unroll
    for (int r = 0; r < kMmaRows - 1; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0;
    for (int i = 0; i < ntiles; ++i) {
      const unsigned char* st = acquire(ntiles + i);
      for (int g = g0; g0 < NQ && g < kTile / 4; g += NQ) {
        const unsigned char* at = st + 4 * g * KP + 4 * w;
        const uint32_t w0 = ld32(at), w1 = ld32(at + KP), w2 = ld32(at + 2 * KP),
                       w3 = ld32(at + 3 * KP);
        const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), hi01 = __byte_perm(w0, w1, 0x7362);
        const uint32_t lo23 = __byte_perm(w2, w3, 0x5140), hi23 = __byte_perm(w2, w3, 0x7362);
        const int col[4] = {int(__byte_perm(lo01, lo23, 0x5410)), int(__byte_perm(lo01, lo23, 0x7632)),
                            int(__byte_perm(hi01, hi23, 0x5410)), int(__byte_perm(hi01, hi23, 0x7632))};
#pragma unroll
        for (int r = 0; r < kMmaRows - 1; ++r) {
          if (r >= R) break;
          const int pw = int(ld32(reinterpret_cast<const unsigned char*>(pq) + r * L.ppitch +
                                  i * kTile + 4 * g));
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] = __dp4a(pw, col[e], acc[r][e]);
        }
      }
    }
    if (g0 < NQ && g0 < kTile / 4) {
#pragma unroll
      for (int r = 0; r < kMmaRows - 1; ++r) {
        if (r >= R) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) atomicAdd(mine + r * HD + 4 * w + e, acc[r][e]);
      }
    }
    __syncthreads();
    for (int e = tid; e < R * HD; e += NT) add_out(e, mine[e]);
  }
  hp::cluster_sync();

  // The output: this block's elements, every block's partial added in,
  // times the row's scale.
  const int e1 = min(R * HD, (rank + 1) * per);
  for (int e = rank * per + tid; e < e1; e += NT) {
    const int r = e / HD;
    const int d = e - r * HD;
    const int j = r0 + r;
    const int h = k * G + j % G;
    T* o = static_cast<T*>(p.out) + ((int64_t(b) * p.S + j / G) * p.H + h) * HD + d;
    store_f(o, __fmul_rn((float)o32[e], ps_s[r]));
  }
}

template <int HD, typename T, bool MMA>
int launch(const Params& p, int chunks, cudaStream_t stream) {
  auto kernel = kv_int8_attention_kernel<HD, T, MMA>;
  const int smem = Layout(HD, p.rows, p.slice, p.splits).total;
  static int limit = -1;  // the dynamic shared memory the kernel may take
  if (limit < 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - int(attr.sharedSizeBytes));
    if (err != cudaSuccess) return int(err);
    limit = optin - int(attr.sharedSizeBytes);
  }
  if (smem > limit) return int(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(p.splits * chunks), unsigned(p.B), unsigned(p.K));
  cfg.blockDim = dim3(MMA ? kMmaThreads : kThreads);
  cfg.dynamicSmemBytes = size_t(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(p.splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

template <typename T, bool MMA>
int dispatch_hd(int hd, const Params& p, int chunks, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32, T, MMA>(p, chunks, stream);
    case 64: return launch<64, T, MMA>(p, chunks, stream);
    case 80: return launch<80, T, MMA>(p, chunks, stream);
    case 96: return launch<96, T, MMA>(p, chunks, stream);
    case 128: return launch<128, T, MMA>(p, chunks, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename T, bool MMA>
int static_smem_hd(int hd) {
  cudaFuncAttributes attr;
  cudaError_t err;
  switch (hd) {
    case 32: err = cudaFuncGetAttributes(&attr, kv_int8_attention_kernel<32, T, MMA>); break;
    case 64: err = cudaFuncGetAttributes(&attr, kv_int8_attention_kernel<64, T, MMA>); break;
    case 80: err = cudaFuncGetAttributes(&attr, kv_int8_attention_kernel<80, T, MMA>); break;
    case 96: err = cudaFuncGetAttributes(&attr, kv_int8_attention_kernel<96, T, MMA>); break;
    case 128: err = cudaFuncGetAttributes(&attr, kv_int8_attention_kernel<128, T, MMA>); break;
    default: return -1;
  }
  return err == cudaSuccess ? int(attr.sharedSizeBytes) : -1;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q and out). The launch plan
// (ops/kv_int8_attention.py's plan):
// `splits` blocks a cluster (1..8) of `slice` slots each, covering T;
// `rows` query rows a block (1..64).
extern "C" int lir_kv_int8_attention(
    const void* q, int dtype, const int8_t* kq, int64_t kq_stride, const float* ks,
    int64_t ks_stride, const int8_t* vq, int64_t vq_stride, const float* vs, int64_t vs_stride,
    const int* q_pos, const int* key_mask, const int* key_pos, const float* slopes, int B, int S,
    int H, int K, int Tk, int hd, int rows, int splits, int slice, float sqrt_hd,
    void* out, int* s32_out, cudaStream_t stream) {
  if (B <= 0 || S <= 0) return 0;
  if (K <= 0 || H % K || B > 65535 || K > 65535 || Tk <= 0 || rows < 1 || rows > kMaxRows || splits < 1 ||
      splits > kMaxSplits || slice < 1 || int64_t(slice) * splits < Tk)
    return int(cudaErrorInvalidValue);
  const int chunks = (S * (H / K) + rows - 1) / rows;
  const Params p{q,         kq,        vq,      ks,      vs,      kq_stride, vq_stride,
                 ks_stride, vs_stride, q_pos,   key_mask, key_pos, slopes,   out,
                 s32_out,   B,         S,       H,       K,       Tk,        rows,
                 splits,    slice,     sqrt_hd};
  const bool mma = rows >= kMmaRows;
  if (dtype == 1)
    return mma ? dispatch_hd<__nv_bfloat16, true>(hd, p, chunks, stream)
               : dispatch_hd<__nv_bfloat16, false>(hd, p, chunks, stream);
  return mma ? dispatch_hd<float, true>(hd, p, chunks, stream)
             : dispatch_hd<float, false>(hd, p, chunks, stream);
}

// The dynamic shared memory of a block of the plan (ops' `dyn_smem`).
extern "C" int lir_kv_int8_smem(int hd, int rows, int slice, int splits) {
  return Layout(hd, rows, slice, splits).total;
}

// The static shared memory of an instantiation (ops' STATIC_SMEM bounds
// it), -1 for an unknown head dim.
extern "C" int lir_kv_int8_static_smem(int hd, int dtype, int mma) {
  if (dtype == 1)
    return mma ? static_smem_hd<__nv_bfloat16, true>(hd) : static_smem_hd<__nv_bfloat16, false>(hd);
  return mma ? static_smem_hd<float, true>(hd) : static_smem_hd<float, false>(hd);
}

// The shared memory a block may take on device `dev` (the opt-in limit).
extern "C" int lir_kv_int8_max_smem(int dev) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  return optin;
}
