// Row-invariant linear layer and norm for Hopper (sm_90a): the bf16
// projections and norms of the decode step and of the speculative verify
// window.
//
// No Pallas original. The JAX package leaves these products and norms to
// XLA (lir_tpu/models/decoder.py _block, _norm, _unembed); the port needs
// its own because the speculative route's contract
// (lir_tpu/engine/generate.py:694-712) holds the verify window's logits
// BITWISE the sequential step's. The step multiplies B rows, the window
// B * spec_k; a library GEMM picks its tiles, split-K and reduction plan
// from the row count M, and PyTorch's row reductions pick theirs from the
// number of rows, so a row's bits depend on how many rows share the call.
// Here they do not:
//
// - row_gemm_kernel: Y (M, N) = X (M, K) @ W (K, N), bf16 in, float32
//   sums, bf16 out. Each output element is one chain of wgmma k16 steps
//   over k in order, from a zero accumulator, within each of ``splits``
//   ranges of K; the ranges' float32 partials are then added in split
//   order, in the same launch. The split count comes from (N, K) alone
//   (ops/row_gemm.py gemm_splits), never from M. Every product is the one
//   instruction m64n32k16 (swap AB: 64 weight columns x 32 rows of X), at
//   every M: only the number of such products covering the rows varies,
//   and an output column of a wgmma depends on its own row of X and the
//   weights only. So a row's bits are the same at M = 1, 32 or 128, in
//   any place among the rows.
// - row_norm_kernel: RMSNorm or LayerNorm of one row a block, the row's
//   sums in an order fixed by the width D alone (each thread's values in
//   order, then a fixed shuffle tree, then the warps in order); with the
//   residual add before it (lir_row_add_norm), in the same pass.
//
// What bounds them on the H100: bytes. A decode step at llama-2-7b width
// streams 405 MB of bf16 weights a layer (wq, wk, wv, wo 4 x 34 MB;
// w_up, w_gate, w_down 3 x 90 MB) against 2 * M * 202 M FLOP: at
// M = 128 (B = 32, spec_k = 4) 52 GFLOP, 128 FLOP a byte, under the bf16
// ridge (~295 FLOP a byte). So the design streams each weight slice once
// and keeps the copies off the threads that multiply:
// - Swap AB. A 64-column slice of W, in the converter's (K, N) row-major
//   layout (one copy of the weights), is wgmma's 64-row A operand straight
//   from its TMA tile (MN-major, the transpose bit); a 32-row group of X is
//   the B operand (K-major). Output columns fill the m64 side at any M.
// - A block is one producer warp, which keeps a ring of 64-deep stages
//   (W 128 columns, X up to 128 rows: 20-32 KB a stage; 5 stages at 32
//   rows, 3 at 128, two blocks an SM) filled by TMA with the 128-byte
//   swizzle, and two consumer warpgroups, 64 columns each, that share each
//   X tile (X is read from L2 once per 128 columns, not per 64).
// - The split reduction is in the launch: the splits of a 128-column
//   tile run as one thread-block cluster, each split's CTA stages its
//   float32 partial in its own shared memory, and after a cluster barrier
//   every CTA adds a share of the tile's rows p0 + p1 + ... in split order
//   from the cluster's shared memory (DSMEM) and writes bf16. No partial
//   reaches device memory and nothing is kept between launches. Which CTA
//   adds an element moves no bit.
// - Blocks in flight together take neighbouring column tiles of one K
//   range (split), so the weight's rows stream from device memory whole.
//
// The norms move 8 KB a row at llama-2-7b width (0.16 us of bytes for 32
// rows): their time is latency, not bytes. The first row_norm_kernel (128
// threads a row) read x two or three times, each pass waiting on the last,
// and ran after a separate bf16 residual add whose sum went to device
// memory and came back. Now a block is sized to the row (D / 8 threads,
// one 16-byte chunk each, up to 1,024 threads; wider rows two chunks a
// thread): x, d, scale and bias are all asked for before the first sum,
// the row stays in registers, RMSNorm takes one block-wide sum and
// LayerNorm two (mean, then the mean square of x - mu), and the residual
// add before the norm (the decoder's x + attn then ln2, and x + mlp then
// the next block's ln1) is the same launch, which writes the sum and the
// normed row together. One row a block, the order fixed by D: a row's bits
// do not depend on the row count or on its place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace hp = hopper;
using bf16 = __nv_bfloat16;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBK = 64;                             // depth of a ring stage
constexpr int kRows = 32;                           // rows of one wgmma (its n), at every M
constexpr int kGroups = 4;                          // row groups of a block: 128 rows
constexpr int kConsumers = 2;                       // consumer warpgroups, 64 columns each
constexpr int kTileN = 64 * kConsumers;             // output columns of a block
constexpr int kThreads = kConsumers * 128 + 32;     // + the producer warp
constexpr int kWBytes = kBK * 64 * 2;               // one warpgroup's W tile of a stage
constexpr int kXBytes = kRows * kBK * 2;            // one row group's X tile of a stage
constexpr int kMaxStages = 8;
constexpr int kMaxSplits = 8;                       // a portable cluster
constexpr int kSmemBudget = 113 * 1024;             // two blocks an SM
constexpr int kLdP = kTileN + 4;                    // staged partial row (floats)

struct GemmParams {
  CUtensorMap wmap;  // W (K, N): dims {N, K}, boxes {64, 64}
  CUtensorMap xmap;  // X (M, K): dims {K, M}, boxes {64, 32}
  bf16* out;         // (M, N)
  int M, N, splits, cps, nk, n_tiles, m_blocks, groups_max, stages;
};

// Four floats at ``p``'s offset in the shared memory of cluster block
// ``rank``.
__device__ __forceinline__ float4 ld_cluster4(const float* p, uint32_t rank) {
  const uint32_t remote = hp::cluster_addr(p, rank);
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// Grid: m_blocks * n_tiles * splits blocks of kThreads in clusters of
// ``splits`` (one per split of a (row block, column tile)); dynamic
// shared memory stages * (stage bytes + 16): the ring, then its barriers.
__global__ void __launch_bounds__(kThreads, 2)
    row_gemm_kernel(const __grid_constant__ GemmParams p) {
  extern __shared__ unsigned char row_gemm_smem[];
  unsigned char* ring = hp::aligned_smem(row_gemm_smem);
  const int stage_bytes = kConsumers * kWBytes + p.groups_max * kXBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * stage_bytes);
  uint64_t* empty = full + p.stages;
  const int tid = threadIdx.x;
  // The block: split (its rank in the cluster) of column tile col and row
  // block mb; neighbouring clusters take neighbouring column tiles.
  const int split = int(blockIdx.x) % p.splits;
  const int q = int(blockIdx.x) / p.splits;
  const int col = q / p.m_blocks;
  const int mb = q - col * p.m_blocks;
  const int n0 = col * kTileN;
  const int m0 = mb * kRows * kGroups;
  const int groups = min(kGroups, (p.M - m0 + kRows - 1) / kRows);
  const int c_lo = split * p.cps;
  const int nc = min(c_lo + p.cps, p.nk) - c_lo;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kConsumers * 4);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  // Consumer warpgroup wg: output columns n0 + 64 wg .. + 63.
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const bool active = n0 + 64 * wg < p.N;
  float acc[kGroups][16];
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[g][e] = 0.f;
  if (tid >= kConsumers * 128) {
    // Producer warp: one thread fills the ring.
    if (tid == kConsumers * 128) {
      const int wtiles = min(kConsumers, (p.N - n0 + 63) / 64);
      const uint32_t bytes = wtiles * kWBytes + groups * kXBytes;
      int st = 0;
      uint32_t ph = 0;
      for (int c = 0; c < nc; ++c) {
        hp::mbar_wait(&empty[st], ph ^ 1);
        hp::mbar_expect_tx(&full[st], bytes);
        unsigned char* s = ring + st * stage_bytes;
        const int k0 = (c_lo + c) * kBK;
        for (int w = 0; w < wtiles; ++w)
          hp::tma_load_2d(s + w * kWBytes, &p.wmap, &full[st], n0 + 64 * w, k0);
        for (int g = 0; g < groups; ++g)
          hp::tma_load_2d(s + kConsumers * kWBytes + g * kXBytes, &p.xmap, &full[st], k0,
                          m0 + kRows * g);
        if (++st == p.stages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    int st = 0;
    uint32_t ph = 0;
    for (int c = 0; c < nc; ++c) {
      hp::mbar_wait(&full[st], ph);
      if (active) {
        const unsigned char* s = ring + st * stage_bytes;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) hp::fence_regs(acc[g]);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t a = hp::desc_mn(s + wg * kWBytes + kk * 16 * 128, kWBytes);
#pragma unroll
          for (int g = 0; g < kGroups; ++g)
            if (g < groups)
              hp::wgmma_ss_n32<1, 0>(
                  acc[g], a, hp::desc_k(s + kConsumers * kWBytes + g * kXBytes + kk * 32));
        }
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
#pragma unroll
        for (int g = 0; g < kGroups; ++g) hp::fence_regs(acc[g]);
      }
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty[st]);
      if (++st == p.stages) {
        st = 0;
        ph ^= 1;
      }
    }
  }
  __syncthreads();  // every stage consumed: the ring is free

  // Element acc[g][4 i + e] of a consumer thread: column n0 + nl of row
  // m0 + ml, nl = 64 wg + 16 warp + lane / 4 + 8 (e / 2) and
  // ml = 32 g + 8 i + 2 (lane % 4) + e % 2.
  auto each = [&](auto&& fn) {
    if (tid >= kConsumers * 128 || !active) return;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int nl = 64 * wg + 16 * warp + (lane >> 2) + 8 * (e >> 1);
          const int ml = kRows * g + 8 * i + 2 * (lane & 3) + (e & 1);
          if (g < groups && m0 + ml < p.M && n0 + nl < p.N) fn(acc[g][4 * i + e], ml, nl);
        }
  };
  if (p.splits == 1) {
    each([&](float v, int ml, int nl) {
      p.out[size_t(m0 + ml) * p.N + n0 + nl] = __float2bfloat16_rn(v);
    });
    return;
  }
  // The split's partial, staged row-major (kLdP floats a row) over the ring.
  float* part = reinterpret_cast<float*>(ring);
  hp::fence_proxy_async();
  each([&](float v, int ml, int nl) { part[ml * kLdP + nl] = v; });
  hp::cluster_sync();
  // This block adds rows split, split + splits, ... of the tile, four
  // columns a thread: p0 + p1 + ... in split order.
  const int rows = min(kRows * kGroups, p.M - m0);
  for (int i = tid; i < rows * (kTileN / 4); i += kThreads) {
    const int ml = split + p.splits * (i / (kTileN / 4));
    const int nl = 4 * (i % (kTileN / 4));
    if (ml >= rows || n0 + nl >= p.N) continue;
    const float* at = part + ml * kLdP + nl;
    float4 v[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < p.splits) v[r] = ld_cluster4(at, r);
    float4 sum = v[0];
#pragma unroll
    for (int r = 1; r < kMaxSplits; ++r)
      if (r < p.splits) {
        sum.x = __fadd_rn(sum.x, v[r].x);
        sum.y = __fadd_rn(sum.y, v[r].y);
        sum.z = __fadd_rn(sum.z, v[r].z);
        sum.w = __fadd_rn(sum.w, v[r].w);
      }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(sum.x, sum.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(sum.z, sum.w);
    uint2 pk;
    pk.x = *reinterpret_cast<const uint32_t*>(&lo);
    pk.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p.out + size_t(m0 + ml) * p.N + n0 + nl) = pk;
  }
  hp::cluster_sync();  // no block leaves while the others read its partial
}

// ---------------------------------------------------------------------------
// Norms
// ---------------------------------------------------------------------------

constexpr int kNormMaxThreads = 1024;

// Eight bf16 (a 16-byte chunk) as floats.
__device__ __forceinline__ void unpack8(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}

// Eight floats as bf16 (round to nearest even), packed for a 16-byte store.
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint32_t pk[4];
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    const __nv_bfloat162 y = __floats2bfloat162_rn(f[e], f[e + 1]);
    pk[e / 2] = *reinterpret_cast<const uint32_t*>(&y);
  }
  return make_uint4(pk[0], pk[1], pk[2], pk[3]);
}

// The block's sum of each thread's v in a fixed order: a shuffle tree in
// each warp (every lane ends with the same bits), then the warps in order
// through ``red`` (one slot a warp, not used by an earlier sum).
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
  for (int w = 1; w < int(blockDim.x >> 5); ++w) s = __fadd_rn(s, red[w]);
  return s;
}

// One row a block of blockDim.x threads (a whole number of warps, fixed by
// D alone): thread t holds the row's 16-byte chunks t, t + blockDim.x, ...
// (kPer of them, 8 values each) in registers, with the scale's and the
// bias's, all loaded before the first sum. kAdd: the row is first
// s = bf16(x + d), torch's bf16 add, written to s_out. kLN: LayerNorm
// (mean, then the mean square of s - mu, both over the registers, then
// ((s - mu) * r) * scale + bias); otherwise RMSNorm, one sum ((s * r) *
// scale with r = rsqrt(mean(s^2) + eps)). Each thread sums its values in
// order; chunks past the row add 0.
template <bool kLN, bool kAdd, int kPer>
__global__ void __launch_bounds__(kNormMaxThreads)
    row_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ d,
                    const bf16* __restrict__ scale, const bf16* __restrict__ bias,
                    bf16* __restrict__ s_out, bf16* __restrict__ out, int D, float eps) {
  __shared__ float red[2][kNormMaxThreads / 32];
  const size_t row = size_t(blockIdx.x) * D;
  const int chunks = D / 8;
  float f[kPer][8], g[kPer][8], sc[kPer][8], bi[kPer][8];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
#pragma unroll
    for (int e = 0; e < 8; ++e) f[i][e] = g[i][e] = sc[i][e] = bi[i][e] = 0.f;
    if (c < chunks) {
      load8(x + row + 8 * c, f[i]);
      if (kAdd) load8(d + row + 8 * c, g[i]);
      load8(scale + 8 * c, sc[i]);
      if (kLN) load8(bias + 8 * c, bi[i]);
    }
  }
  if (kAdd) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
#pragma unroll
      for (int e = 0; e < 8; ++e) f[i][e] = __fadd_rn(f[i][e], g[i][e]);
      const uint4 pk = pack8(f[i]);
      unpack8(pk, f[i]);  // the row is the rounded sum
      if (c < chunks) *reinterpret_cast<uint4*>(s_out + row + 8 * c) = pk;
    }
  }
  const float inv_d = __fdiv_rn(1.f, float(D));
  float mu = 0.f;
  if (kLN) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) s = __fadd_rn(s, f[i][e]);
    mu = __fmul_rn(block_sum(s, red[0]), inv_d);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = threadIdx.x + i * blockDim.x;
      const float dv = c < chunks ? __fsub_rn(f[i][e], mu) : 0.f;
      s = __fadd_rn(s, __fmul_rn(dv, dv));
    }
  const float r = rsqrtf(__fadd_rn(__fmul_rn(block_sum(s, red[1]), inv_d), eps));
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c >= chunks) continue;
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      y[e] = __fmul_rn(__fmul_rn(__fsub_rn(f[i][e], mu), r), sc[i][e]);
      if (kLN) y[e] = __fadd_rn(y[e], bi[i][e]);
    }
    *reinterpret_cast<uint4*>(out + row + 8 * c) = pack8(y);
  }
}

// Launch of one row a block: threads = the row's chunks (over kPer =
// 1 or 2 a thread) rounded up to whole warps, so the reduction order is
// fixed by D alone.
template <bool kAdd>
cudaError_t launch_norm(const void* x, const void* d, const void* scale, const void* bias,
                        void* s_out, void* out, int M, int D, float eps, cudaStream_t st) {
  if (M <= 0 || D <= 0 || D % 8 || D / 8 > 2 * kNormMaxThreads) return cudaErrorInvalidValue;
  const int chunks = D / 8;
  const int per = chunks > kNormMaxThreads ? 2 : 1;
  const int threads = ((chunks + per - 1) / per + 31) / 32 * 32;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* db = static_cast<const bf16*>(d);
  const bf16* sb = static_cast<const bf16*>(scale);
  const bf16* bb = static_cast<const bf16*>(bias);
  bf16* so = static_cast<bf16*>(s_out);
  bf16* ob = static_cast<bf16*>(out);
  const bool ln = bias != nullptr;
  if (ln && per == 1)
    row_norm_kernel<true, kAdd, 1><<<M, threads, 0, st>>>(xb, db, sb, bb, so, ob, D, eps);
  else if (ln)
    row_norm_kernel<true, kAdd, 2><<<M, threads, 0, st>>>(xb, db, sb, bb, so, ob, D, eps);
  else if (per == 1)
    row_norm_kernel<false, kAdd, 1><<<M, threads, 0, st>>>(xb, db, sb, bb, so, ob, D, eps);
  else
    row_norm_kernel<false, kAdd, 2><<<M, threads, 0, st>>>(xb, db, sb, bb, so, ob, D, eps);
  return cudaGetLastError();
}

}  // namespace

// Y = X @ W for bf16 X (M, K), W (K, N), Y (M, N), all contiguous; K and N
// multiples of 8, 16-byte aligned; ``splits`` (at most 8) from (N, K)
// alone. One launch, no scratch. Returns cudaGetLastError(), 0 on success.
extern "C" int lir_row_gemm(const void* x, const void* w, void* out, int M, int N, int K,
                            int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 || splits < 1 || splits > kMaxSplits)
    return int(cudaErrorInvalidValue);
  GemmParams p;
  p.M = M;
  p.N = N;
  p.nk = (K + kBK - 1) / kBK;
  p.cps = (p.nk + splits - 1) / splits;
  p.splits = (p.nk + p.cps - 1) / p.cps;  // every split has at least one chunk
  if (p.splits != splits) return int(cudaErrorInvalidValue);
  p.n_tiles = (N + kTileN - 1) / kTileN;
  p.m_blocks = (M + kRows * kGroups - 1) / (kRows * kGroups);
  p.groups_max = min(kGroups, (M + kRows - 1) / kRows);
  p.out = static_cast<bf16*>(out);
  const cuuint64_t wdims[2] = {cuuint64_t(N), cuuint64_t(K)};
  const cuuint64_t wstride[1] = {cuuint64_t(N) * 2};
  const cuuint32_t wbox[2] = {64, kBK};
  const cuuint64_t xdims[2] = {cuuint64_t(K), cuuint64_t(M)};
  const cuuint64_t xstride[1] = {cuuint64_t(K) * 2};
  const cuuint32_t xbox[2] = {kBK, kRows};
  if (!hp::encode_map(&p.wmap, w, 2, wdims, wstride, wbox) ||
      !hp::encode_map(&p.xmap, x, 2, xdims, xstride, xbox))
    return int(cudaErrorInvalidValue);
  // As many stages as two blocks an SM leave room for (the staged partial
  // of 128 rows fits in three).
  const int stage_bytes = kConsumers * kWBytes + p.groups_max * kXBytes;
  p.stages = min(kMaxStages, kSmemBudget / (stage_bytes + 16));
  const int smem = p.stages * (stage_bytes + 16);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(row_gemm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    if (e != cudaSuccess) return int(e);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(p.m_blocks * p.n_tiles * splits));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = size_t(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, row_gemm_kernel, p);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

// RMSNorm (bias null) or LayerNorm of M bf16 rows of width D (a multiple
// of 8, at most 16,384; 16-byte aligned), scale and bias bf16 (D,).
// Returns cudaGetLastError(), 0 on success.
extern "C" int lir_row_norm(const void* x, const void* scale, const void* bias, void* out,
                            int M, int D, float eps, void* stream) {
  return int(launch_norm<false>(x, nullptr, scale, bias, nullptr, out, M, D, eps,
                                static_cast<cudaStream_t>(stream)));
}

// The residual add and the norm of its sum in one pass: s = x + d (bf16,
// rounded as torch's bf16 add) and out = lir_row_norm of s, for M rows of
// width D as lir_row_norm takes them. Returns cudaGetLastError(), 0 on
// success.
extern "C" int lir_row_add_norm(const void* x, const void* d, const void* scale,
                                const void* bias, void* s_out, void* out, int M, int D,
                                float eps, void* stream) {
  return int(launch_norm<true>(x, d, scale, bias, s_out, out, M, D, eps,
                               static_cast<cudaStream_t>(stream)));
}
