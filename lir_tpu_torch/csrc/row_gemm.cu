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
//   sums, bf16 out. Each output element is one chain of mma.sync
//   m16n8k16 steps over k in order, from a zero accumulator, within each
//   of ``splits`` ranges of K; the ranges' float32 partials are then
//   added in split order (split_sum_kernel). The split count comes from
//   (N, K) alone (ops/row_gemm.py gemm_splits), never from M, and a
//   tensor-core product of a row depends on that row and the weights
//   only. So a row's bits are the same at M = 1, 32 or 128, in any place
//   among the rows. The rows a block takes (16 to 128: MT m16-tiles) and
//   the warps that take them vary with M; the chain does not.
// - row_norm_kernel: RMSNorm or LayerNorm of one row a block, the row's
//   sums in a fixed order (each thread's strided elements in order, then a
//   fixed shuffle tree, then the four warps in order).
//
// What bounds them on the H100: bytes. A decode step at llama-2-7b width
// streams 404 MB of bf16 weights a layer (wq, wk, wv, wo 4 x 34 MB;
// w_up, w_gate, w_down 3 x 90 MB) against 2 * M * 202 M FLOP: at
// M = 128 (B = 32, spec_k = 4) 52 GFLOP, 128 FLOP a byte, under the bf16
// ridge (~295 FLOP a byte). So the design streams each weight
// slice once: a block owns 64 output columns and one K range, and a
// 4-stage cp.async ring of 64-deep X and W tiles keeps three stages of
// copies in flight while one multiplies; W fragments come by
// ldmatrix.trans straight from its (K, N) row-major layout (the
// converter's layout, one copy of the weights). A verify window reads
// each weight once for all its B * spec_k rows (up to 128 a block).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace {

namespace am = attn_mma;
using am::bf16;

constexpr int kThreads = 128;  // four warps; warp w owns columns 16 w .. 16 w + 15
constexpr int kBN = 64;        // output columns a block
constexpr int kBK = 64;        // depth of one ring stage
constexpr int kStages = 4;     // ring stages
constexpr int kLdX = kBK + 8;  // X tile row stride (elements): 9 16-byte chunks
constexpr int kLdW = kBN + 8;  // W tile row stride (elements): 9 16-byte chunks

struct GemmArgs {
  const bf16* x;  // (M, K)
  const bf16* w;  // (K, N)
  bf16* out;      // (M, N)
  float* part;    // (splits, M, N) when splits > 1
  int M, N, K, splits, cps;  // cps: 64-deep chunks a split
};

template <int MT>
constexpr size_t gemm_smem() {
  return size_t(kStages) * (MT * 16 * kLdX + kBK * kLdW) * sizeof(bf16);
}

// Grid (ceil(N / kBN), splits, ceil(M / (16 MT))).
template <int MT>
__global__ void __launch_bounds__(kThreads) row_gemm_kernel(GemmArgs a) {
  extern __shared__ __align__(16) unsigned char row_gemm_smem[];
  bf16* xs = reinterpret_cast<bf16*>(row_gemm_smem);
  bf16* ws = xs + kStages * MT * 16 * kLdX;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kBN;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT * 16;
  const int nk = (a.K + kBK - 1) / kBK;
  const int c_lo = split * a.cps;
  const int nc = min(c_lo + a.cps, nk) - c_lo;

  // Copies of chunk c (k0 = 64 (c_lo + c)) into stage st; rows past M,
  // depths past K and columns past N are zero-filled by the copy.
  auto load = [&](int c, int st) {
    const int k0 = (c_lo + c) * kBK;
    bf16* xd = xs + st * MT * 16 * kLdX;
    bf16* wd = ws + st * kBK * kLdW;
    for (int i = tid; i < MT * 16 * 8; i += kThreads) {
      const int r = i >> 3;
      const int k = k0 + (i & 7) * 8;
      const bool ok = m0 + r < a.M && k < a.K;
      am::cp_async16(xd + r * kLdX + (i & 7) * 8,
                     ok ? a.x + size_t(m0 + r) * a.K + k : a.x, ok);
    }
    for (int i = tid; i < kBK * 8; i += kThreads) {
      const int r = i >> 3;
      const int n = n0 + (i & 7) * 8;
      const bool ok = k0 + r < a.K && n < a.N;
      am::cp_async16(wd + r * kLdW + (i & 7) * 8,
                     ok ? a.w + size_t(k0 + r) * a.N + n : a.w, ok);
    }
  };

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nc) load(s, s);
    am::cp_async_commit();
  }
  for (int c = 0; c < nc; ++c) {
    const int ahead = c + kStages - 1;
    if (ahead < nc) load(ahead, ahead % kStages);
    am::cp_async_commit();
    am::cp_async_wait<kStages - 1>();  // chunk c has landed
    __syncthreads();
    const bf16* xt = xs + (c % kStages) * MT * 16 * kLdX;
    const bf16* wt = ws + (c % kStages) * kBK * kLdW;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // B of k-step kk for the warp's two n-tiles: W rows (depths)
      // (lane & 7) + 8 ((lane / 8) & 1), column half lane / 16.
      uint32_t b[4];
      am::ldmatrix_x4_trans(
          b, wt + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * kLdW + warp * 16 +
                 (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[4];
        am::ldmatrix_x4(af, xt + (mt * 16 + (lane & 15)) * kLdX + kk * 16 + (lane >> 4) * 8);
        am::mma_bf16(acc[mt][0], af, b[0], b[1]);
        am::mma_bf16(acc[mt][1], af, b[2], b[3]);
      }
    }
    __syncthreads();  // the next copies reuse this stage
  }

  // Accumulator element {row g + 8 h, columns c, c + 1} of n-tile j.
  const int g = lane >> 2;
  const int cc = 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + mt * 16 + g + 8 * h;
        const int col = n0 + warp * 16 + j * 8 + cc;
        if (row >= a.M || col >= a.N) continue;
        const float v0 = acc[mt][j][2 * h];
        const float v1 = acc[mt][j][2 * h + 1];
        if (a.splits == 1) {
          *reinterpret_cast<__nv_bfloat162*>(a.out + size_t(row) * a.N + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(a.part + (size_t(split) * a.M + row) * a.N + col) =
              make_float2(v0, v1);
        }
      }
}

// out = bf16(((p_0 + p_1) + p_2) + ...), four elements a thread.
__global__ void split_sum_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                                 size_t total, int splits) {
  const size_t i = (size_t(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= total) return;
  float4 s = *reinterpret_cast<const float4*>(part + i);
  for (int sp = 1; sp < splits; ++sp) {
    const float4 p = *reinterpret_cast<const float4*>(part + size_t(sp) * total + i);
    s.x = __fadd_rn(s.x, p.x);
    s.y = __fadd_rn(s.y, p.y);
    s.z = __fadd_rn(s.z, p.z);
    s.w = __fadd_rn(s.w, p.w);
  }
  __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(s.z, s.w);
  uint2 pk;
  pk.x = am::as_u32(lo);
  pk.y = am::as_u32(hi);
  *reinterpret_cast<uint2*>(out + i) = pk;
}

template <int MT>
cudaError_t launch_gemm(const GemmArgs& a, cudaStream_t st) {
  constexpr size_t smem = gemm_smem<MT>();
  cudaError_t e = cudaFuncSetAttribute(row_gemm_kernel<MT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  dim3 grid(unsigned((a.N + kBN - 1) / kBN), unsigned(a.splits),
            unsigned((a.M + MT * 16 - 1) / (MT * 16)));
  row_gemm_kernel<MT><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Norms
// ---------------------------------------------------------------------------

constexpr int kNormThreads = 128;

__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The block's sum of each thread's v in a fixed order: a shuffle tree in
// each warp, then the warps in order.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(am::kFull, v, off));
  __syncthreads();  // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int w = 1; w < kNormThreads / 32; ++w) s = __fadd_rn(s, red[w]);
  return s;
}

// One row a block. kLN: LayerNorm (mean, then the mean square of x - mu,
// then ((x - mu) * r) * scale + bias); otherwise RMSNorm ((x * r) * scale
// with r = rsqrt(mean(x^2) + eps)). D a multiple of 8.
template <bool kLN>
__global__ void __launch_bounds__(kNormThreads)
    row_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                    const bf16* __restrict__ bias, bf16* __restrict__ out, int D, float eps) {
  __shared__ float red[kNormThreads / 32];
  const bf16* xr = x + size_t(blockIdx.x) * D;
  bf16* yr = out + size_t(blockIdx.x) * D;
  const float inv_d = __fdiv_rn(1.f, float(D));
  float mu = 0.f;
  if (kLN) {
    float s = 0.f;
    for (int c = threadIdx.x * 8; c < D; c += kNormThreads * 8) {
      float f[8];
      load8(xr + c, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) s = __fadd_rn(s, f[e]);
    }
    mu = __fmul_rn(block_sum(s, red), inv_d);
  }
  float s = 0.f;
  for (int c = threadIdx.x * 8; c < D; c += kNormThreads * 8) {
    float f[8];
    load8(xr + c, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = __fsub_rn(f[e], mu);
      s = __fadd_rn(s, __fmul_rn(d, d));
    }
  }
  const float r = rsqrtf(__fadd_rn(__fmul_rn(block_sum(s, red), inv_d), eps));
  for (int c = threadIdx.x * 8; c < D; c += kNormThreads * 8) {
    float f[8], sc[8], bi[8];
    load8(xr + c, f);
    load8(scale + c, sc);
    if (kLN) load8(bias + c, bi);
    uint32_t pk[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      float y0 = __fmul_rn(__fmul_rn(__fsub_rn(f[e], mu), r), sc[e]);
      float y1 = __fmul_rn(__fmul_rn(__fsub_rn(f[e + 1], mu), r), sc[e + 1]);
      if (kLN) {
        y0 = __fadd_rn(y0, bi[e]);
        y1 = __fadd_rn(y1, bi[e + 1]);
      }
      pk[e / 2] = am::as_u32(__floats2bfloat162_rn(y0, y1));
    }
    *reinterpret_cast<uint4*>(yr + c) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
  }
}

}  // namespace

// Y = X @ W for bf16 X (M, K), W (K, N), Y (M, N), all contiguous; K and N
// multiples of 8, rows 16-byte aligned. ``part`` is float32 scratch of
// splits * M * N elements (unused when splits == 1). The split count is
// the caller's, from (N, K) alone. Returns cudaGetLastError() of the
// launches, 0 on success.
extern "C" int lir_row_gemm(const void* x, const void* w, void* out, void* part, int M, int N,
                            int K, int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 || splits < 1)
    return int(cudaErrorInvalidValue);
  GemmArgs a;
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.out = static_cast<bf16*>(out);
  a.part = static_cast<float*>(part);
  a.M = M;
  a.N = N;
  a.K = K;
  const int nk = (K + kBK - 1) / kBK;
  a.cps = (nk + splits - 1) / splits;
  a.splits = (nk + a.cps - 1) / a.cps;  // every split has at least one chunk
  if (a.splits != splits) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = M <= 16   ? launch_gemm<1>(a, st)
                  : M <= 32 ? launch_gemm<2>(a, st)
                  : M <= 64 ? launch_gemm<4>(a, st)
                            : launch_gemm<8>(a, st);
  if (e != cudaSuccess || splits == 1) return int(e);
  const size_t total = size_t(M) * N;
  const unsigned blocks = unsigned((total / 4 + 255) / 256);
  split_sum_kernel<<<blocks, 256, 0, st>>>(a.part, a.out, total, splits);
  return int(cudaGetLastError());
}

// RMSNorm (bias null) or LayerNorm of M bf16 rows of width D (a multiple
// of 8, 16-byte aligned), scale and bias bf16 (D,). Returns
// cudaGetLastError(), 0 on success.
extern "C" int lir_row_norm(const void* x, const void* scale, const void* bias, void* out,
                            int M, int D, float eps, void* stream) {
  if (M <= 0 || D <= 0 || D % 8) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* sb = static_cast<const bf16*>(scale);
  const bf16* bb = static_cast<const bf16*>(bias);
  bf16* ob = static_cast<bf16*>(out);
  if (bias != nullptr)
    row_norm_kernel<true><<<M, kNormThreads, 0, st>>>(xb, sb, bb, ob, D, eps);
  else
    row_norm_kernel<false><<<M, kNormThreads, 0, st>>>(xb, sb, bb, ob, D, eps);
  return int(cudaGetLastError());
}
