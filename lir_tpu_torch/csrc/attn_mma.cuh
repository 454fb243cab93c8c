// Tensor-core tile code for the bf16 prefill kernels on Hopper (sm_90a):
// the fused cascade kernel and the two-leg route's trunk leg
// (cascade_prefill.cu, cascade_mma_kernel and prefix_mma_kernel) and the
// prefill flash kernel (flash_attention.cu, flash_mma_kernel).
//
// A block owns a query tile of 16 rows a warp (1 to kWarps warps) and
// walks key tiles of kKeys = 64 with an online softmax, as FlashAttention-2
// does with mma.sync:
//
// - Tiles live in shared memory as bf16 rows padded to HD + 8 elements (an
//   odd number of 16-byte chunks, so the eight row addresses of an
//   ldmatrix land on distinct banks). A ring of kSt K/V tiles (kStages = 3
//   in the cascade kernels, 2 in the flash kernel) is filled by cp.async.cg
//   16-byte copies: the copies of tiles i + 1 .. i + kSt - 1 are in flight
//   while tile i multiplies. Rows past the end of the
//   keys (or queries) are zero-filled by the copy itself (src-size 0), so
//   no garbage reaches a product. The Q tile is staged in the ring's last
//   stage and kept in registers as A fragments for the whole key walk.
// - S = Q K^T on tensor cores: mma.sync m16n8k16, raw bf16 q and k, float32
//   sums; the operands come from shared memory by ldmatrix. The caller's
//   fix-up then multiplies the float32 scores by sm_scale, adds ALiBi in
//   float32 and sets masked scores to -inf. q is never pre-scaled into
//   bf16: sm_scale is not a power of two, and bf16(q * sm_scale) would
//   lose bits the float32 reference keeps.
// - The online softmax runs in registers, per row: running max and sum in
//   float32 with the _rn intrinsics, as attn_tile::online_softmax has them
//   (the sums as pairwise trees); a row that has seen no valid key keeps
//   factor 0. exp(x - m) is taken as 2^((x - m) log2 e) by ex2.approx.ftz,
//   within ~1e-6 of expf relative and cheaper than its range handling.
// - P V with P as bf16, accumulating in float32 over V fragments read by
//   ldmatrix.trans. kSplitP (the cascade kernels) takes it in two passes:
//   P splits into hi = bf16(p) and lo = bf16(p - hi), both over the same V
//   fragments. A single bf16 P is off by up to ~3e-2 in the float32 trunk
//   partials at llama-2-7b width; the split keeps them within 1e-3 for
//   1.5x the tensor-core work of the model's FLOPs. The prefill flash
//   kernel writes bf16 and takes one pass: its single bf16 P stays under
//   0.6 of the 1e-2 bar of its plain version
//   (tests/test_torch_cascade_mma_numerics.py emulates every case).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): in a warp, lane l
// holds rows g = l / 4 and g + 8 of its 16-row tile and, of each 8-column
// n-tile, the columns 2 (l % 4) and 2 (l % 4) + 1. An accumulator of one
// n-tile is four floats: {row g, col c}, {g, c + 1}, {g + 8, c},
// {g + 8, c + 1}.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace attn_mma {

using bf16 = __nv_bfloat16;

constexpr int kKeys = 64;      // keys per tile
constexpr int kStages = 3;     // K/V tiles in the cp.async ring (by default)
constexpr int kWarps = 4;      // warps (16 query rows each) a block, at most
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Dims {
  static_assert(HD % 16 == 0 && HD <= 128, "head dim: a multiple of 16, <= 128");
  static constexpr int kLd = HD + 8;        // bf16 row stride in shared memory
  static constexpr int kChunks = HD / 8;    // 16-byte chunks a row
  static constexpr int kNT = HD / 8;        // 8-column n-tiles of the output
  static constexpr int kKS = HD / 16;       // 16-deep k-steps of Q K^T
  static constexpr int kTile = kKeys * kLd; // elements of one K or V tile
  // Shared memory of a block: a K/V ring of ``stages`` tiles. The Q tile
  // (at most 16 * kWarps rows) is staged in the ring's last stage and read
  // into registers before that stage takes its first key tile.
  static constexpr size_t ring_bytes(int stages) {
    return size_t(2) * stages * kTile * sizeof(bf16);
  }
};
static_assert(16 * kWarps <= 2 * kKeys, "the Q tile fits one ring stage");

// Where the caller stages its Q tile (row r of the block at r * kLd) in a
// ring of kSt stages.
template <int HD, int kSt = kStages>
__device__ __forceinline__ bf16* q_stage(bf16* ring) {
  return ring + (kSt - 1) * 2 * Dims<HD>::kTile;
}

// Source of one K/V row of a tile: its K and V rows, or ok == false for a
// row past the keys (zero-filled; k and v must still be valid addresses).
struct KVRow {
  const bf16* k;
  const bf16* v;
  bool ok;
};

// One warp's running state: the PV accumulator of its 16 rows and, per
// row half (0: row g, 1: row g + 8), the running max and sum.
template <int HD>
struct Acc {
  float o[Dims<HD>::kNT][4];
  float m[2];
  float l[2];
};

template <int HD>
__device__ __forceinline__ void acc_init(Acc<HD>& a) {
#pragma unroll
  for (int j = 0; j < Dims<HD>::kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a.o[j][e] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    a.m[h] = -CUDART_INF_F;
    a.l[h] = 0.f;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One 16-byte copy global -> shared; zero-fills the destination when !ok
// (src is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^y, flushing results under 2^-126 to 0 (probabilities that small do
// not move a float32 sum of ones).
__device__ __forceinline__ float exp2_ftz(float y) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(y));
  return r;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two probabilities (columns c, c + 1 of one row) as the bf16 pairs hi and
// lo with hi + lo = p to within 2^-16 of p.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(__fsub_rn(a, hf.x), __fsub_rn(b, hf.y)));
}

// Source of one Q row: its address, or ok == false for a row past the
// queries (zero-filled; p must still be a valid address).
struct Row {
  const bf16* p;
  bool ok;
};

// Copies of ``rows`` rows of HD bf16: row r from at(r) (a Row). Every
// thread of the block takes part.
template <int HD, typename At>
__device__ __forceinline__ void load_rows(bf16* dst, int rows, const At& at) {
  using D = Dims<HD>;
  for (int i = threadIdx.x; i < rows * D::kChunks; i += blockDim.x) {
    const int r = i / D::kChunks;
    const int c = i - r * D::kChunks;
    const Row row = at(r);
    cp_async16(dst + r * D::kLd + c * 8, row.p + c * 8, row.ok);
  }
}

// Copies of the K/V tile of keys k0 .. k0 + kKeys - 1: row r of each from
// key(k0 + r) (a KVRow). Every thread of the block takes part.
template <int HD, typename Key>
__device__ __forceinline__ void load_kv(bf16* kd, bf16* vd, const Key& key, int k0) {
  using D = Dims<HD>;
  for (int i = threadIdx.x; i < kKeys * D::kChunks; i += blockDim.x) {
    const int r = i / D::kChunks;
    const int c = i - r * D::kChunks;
    const KVRow row = key(k0 + r);
    cp_async16(kd + r * D::kLd + c * 8, row.k + c * 8, row.ok);
    cp_async16(vd + r * D::kLd + c * 8, row.v + c * 8, row.ok);
  }
}

// The A fragments of one warp's 16 Q rows for every k-step, by ldmatrix
// (row address lane & 15, column half lane / 16).
template <int HD>
__device__ __forceinline__ void load_q(const bf16* qw, uint32_t (&qf)[Dims<HD>::kKS][4]) {
  const int lane = threadIdx.x & 31;
  const bf16* qa = qw + (lane & 15) * Dims<HD>::kLd + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < Dims<HD>::kKS; ++kk) ldmatrix_x4(qf[kk], qa + kk * 16);
}

// S = Q K^T of one warp's 16 rows against a 64-key tile: s[j] is n-tile j
// (keys 8 j .. 8 j + 7) in the accumulator layout.
template <int HD>
__device__ __forceinline__ void qk_tile(const uint32_t (&qf)[Dims<HD>::kKS][4],
                                        const bf16* ks, float (&s)[8][4]) {
  constexpr int kLd = Dims<HD>::kLd;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // B from K rows (keys) (lane & 7) + 8 (lane / 16), column half (lane / 8) & 1.
  const bf16* ka = ks + ((lane & 7) + ((lane >> 4) << 3)) * kLd + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < Dims<HD>::kKS; ++kk) {
    uint32_t b[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) ldmatrix_x4(b[jj], ka + jj * 16 * kLd + kk * 16);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      mma_bf16(s[2 * jj], qf[kk], b[jj][0], b[jj][1]);
      mma_bf16(s[2 * jj + 1], qf[kk], b[jj][2], b[jj][3]);
    }
  }
}

// Online-softmax update of one warp's rows with a fixed-up score tile
// (-inf where masked): s becomes P = exp(s - m_new), m and l (per row
// half: 0 is row g, 1 is row g + 8) move on, and f[h] is the factor of the
// row's old accumulator.
__device__ __forceinline__ void online_rows(float (&s)[8][4], float (&m)[2], float (&l)[2],
                                            float (&f)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // Max and sum over the lane's 16 scores of the row as pairwise trees
    // (short dependency chains), then across the row's four lanes.
    float t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = fmaxf(s[j][2 * h], s[j][2 * h + 1]);
#pragma unroll
    for (int w = 4; w > 0; w >>= 1)
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
    float mx = t[0];
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_old = m[h];
    const float m_new = fmaxf(m_old, mx);
    // exp(x - m) as exp2((x - m) * log2 e); a masked x (-inf) gives 0, and
    // while the row has seen no valid key m is taken as 0 so that no
    // -inf - -inf reaches the exponential.
    const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e)
        s[j][e] = exp2_ftz(__fmul_rn(__fsub_rn(s[j][e], m_use), kLog2e));
      t[j] = __fadd_rn(s[j][2 * h], s[j][2 * h + 1]);
    }
#pragma unroll
    for (int w = 4; w > 0; w >>= 1)
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] = __fadd_rn(t[j], t[j + w]);
    float sum = t[0];
    sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, 1));
    sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, 2));
    f[h] = exp2_ftz(__fmul_rn(__fsub_rn(m_old, m_use), kLog2e));
    l[h] = __fadd_rn(__fmul_rn(l[h], f[h]), sum);
    m[h] = m_new;
  }
}

// The A fragments of P's keys 16 kk .. 16 kk + 15 (n-tiles 2 kk and
// 2 kk + 1 of the score tile), split as bf16 hi + lo.
__device__ __forceinline__ void p_fragments(const float (&s)[8][4], int kk, uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  split2(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
  split2(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
  split2(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
  split2(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
}

// Online-softmax update of one warp's rows with a fixed-up score tile
// (-inf where masked), then acc.o = acc.o * factor + P V, with P split in
// hi + lo over the same V fragments where kSplitP.
template <int HD, bool kSplitP>
__device__ __forceinline__ void softmax_pv(float (&s)[8][4], const bf16* vs, Acc<HD>& acc) {
  constexpr int kLd = Dims<HD>::kLd;
  const int lane = threadIdx.x & 31;
  float f[2];
  online_rows(s, acc.m, acc.l, f);
#pragma unroll
  for (int j = 0; j < Dims<HD>::kNT; ++j) {
    acc.o[j][0] = __fmul_rn(acc.o[j][0], f[0]);
    acc.o[j][1] = __fmul_rn(acc.o[j][1], f[0]);
    acc.o[j][2] = __fmul_rn(acc.o[j][2], f[1]);
    acc.o[j][3] = __fmul_rn(acc.o[j][3], f[1]);
  }
  // V (keys x HD, row-major) as the col-major B operand: ldmatrix.trans,
  // row addresses keys (lane & 7) + 8 ((lane / 8) & 1), column half lane / 16.
  const bf16* va = vs + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kLd + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // A operand of keys 16 kk .. 16 kk + 15: n-tiles 2 kk and 2 kk + 1 of P.
    uint32_t hi[4], lo[4];
    p_fragments(s, kk, hi, lo);
    // All V fragments of the k-step first, then the hi products, then the
    // lo ones: no product waits on the one just issued.
    uint32_t b[HD / 16][4];
#pragma unroll
    for (int dd = 0; dd < HD / 16; ++dd) ldmatrix_x4_trans(b[dd], va + kk * 16 * kLd + dd * 16);
#pragma unroll
    for (int dd = 0; dd < HD / 16; ++dd) {
      mma_bf16(acc.o[2 * dd], hi, b[dd][0], b[dd][1]);
      mma_bf16(acc.o[2 * dd + 1], hi, b[dd][2], b[dd][3]);
    }
    if (kSplitP) {
#pragma unroll
      for (int dd = 0; dd < HD / 16; ++dd) {
        mma_bf16(acc.o[2 * dd], lo, b[dd][0], b[dd][1]);
        mma_bf16(acc.o[2 * dd + 1], lo, b[dd][2], b[dd][3]);
      }
    }
  }
}

// The block's walk over n_tiles key tiles through a ring of kSt (2 or
// more) stages. The caller has issued (not committed) the cp.async copies
// of its Q tile into q_stage<HD, kSt>(ring); key(k)
// is the KVRow of key k of the block's key sequence; fix(t, s) turns one
// warp's raw Q K^T tile into scores (scale, ALiBi, -inf where masked). A
// warp whose rows all lie past the queries (!active) joins the copies and
// barriers only. kSplitP: P V from P = bf16 hi + lo (two passes) or from
// one bf16 P.
template <int HD, bool kSplitP = true, int kSt = kStages, typename Key, typename Fix>
__device__ __forceinline__ void key_loop(bf16* ring, int n_tiles, bool active,
                                         const Key& key, const Fix& fix, Acc<HD>& acc) {
  static_assert(kSt >= 2, "a ring of two stages or more");
  constexpr int kTile = Dims<HD>::kTile;
  auto stage = [ring](int t) { return ring + (t % kSt) * 2 * kTile; };
  // Tiles 0 .. kSt - 2 in flight (the Q copies join tile 0's group).
#pragma unroll
  for (int t = 0; t < kSt - 1; ++t) {
    if (t < n_tiles) load_kv<HD>(stage(t), stage(t) + kTile, key, t * kKeys);
    cp_async_commit();
  }
  cp_async_wait<kSt - 2>();
  __syncthreads();
  uint32_t qf[Dims<HD>::kKS][4];
  if (active) load_q<HD>(q_stage<HD, kSt>(ring) + (threadIdx.x >> 5) * 16 * Dims<HD>::kLd, qf);
  __syncthreads();  // Q's stage is free for key tiles
  for (int t = 0; t < n_tiles; ++t) {
    const int ahead = t + kSt - 1;
    if (ahead < n_tiles) load_kv<HD>(stage(ahead), stage(ahead) + kTile, key, ahead * kKeys);
    cp_async_commit();
    cp_async_wait<kSt - 1>();  // tile t has landed
    __syncthreads();
    if (active) {
      float s[8][4];
      qk_tile<HD>(qf, stage(t), s);
      fix(t, s);
      softmax_pv<HD, kSplitP>(s, stage(t) + kTile, acc);
    }
    __syncthreads();  // the next copies reuse this stage
  }
}

// The accumulator regrouped with the neighbouring lane so that each lane
// holds four consecutive columns of one row, then store(h, col, v) per
// n-tile: h 0 is row g, 1 is row g + 8, v is columns col .. col + 3.
template <int HD, typename Store>
__device__ __forceinline__ void store_rows(const Acc<HD>& acc, Store store) {
  const int lane = threadIdx.x & 31;
  const int odd = lane & 1;
  const int col0 = 2 * (lane & 2);
#pragma unroll
  for (int j = 0; j < Dims<HD>::kNT; ++j) {
    const float r0 = __shfl_xor_sync(kFull, odd ? acc.o[j][0] : acc.o[j][2], 1);
    const float r1 = __shfl_xor_sync(kFull, odd ? acc.o[j][1] : acc.o[j][3], 1);
    const float4 v = odd ? make_float4(r0, r1, acc.o[j][2], acc.o[j][3])
                         : make_float4(acc.o[j][0], acc.o[j][1], r0, r1);
    store(odd, 8 * j + col0, v);
  }
}

// Warps a block takes for ``rows`` query rows: as many 16-row warp tiles as
// cover them, spread evenly over the fewest blocks of at most kWarps warps.
inline int warps_for(long long rows) {
  if (rows <= 0) return 1;
  const long long tiles = (rows + 15) / 16;
  const long long blocks = (tiles + kWarps - 1) / kWarps;
  return int((tiles + blocks - 1) / blocks);
}

}  // namespace attn_mma
