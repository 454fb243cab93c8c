// The trunk walk of the bf16 cascade kernels on Hopper's wgmma and TMA
// (sm_90a): the two-leg route's trunk leg (prefix_wgmma_kernel) and step
// (1) of the fused kernel (cascade_mma_kernel) in cascade_prefill.cu; its
// tile step (tile_step) is also the suffix merge's window walk
// (suffix_merge_kernel, split P) and, with one bf16 P, the prefill flash
// kernel's (flash_wgmma_kernel in flash_attention.cu).
//
// A warpgroup owns 64 query rows and walks the trunk's 64-key tiles with
// an online softmax, FlashAttention-3 style:
//
// - The trunk's K and V tiles come by TMA (128-byte swizzle, 64-column
//   panels, keys past Tt and columns past hd zero-filled) into a ring of
//   kSt stages, one full-barrier each, kSt tiles ahead. A stage is
//   refilled once every warpgroup of the block is done with it: by thread
//   0 after a block barrier (one warpgroup), or by a producer warp that
//   waits on the stage's empty-barrier (two warpgroups, which then run
//   apart, one's softmax beside the other's products). The warpgroups of
//   a block share each tile, so a block of two reads the trunk from L2
//   once per 128 query rows.
// - The Q tile is copied once by cp.async into the same swizzled panel
//   layout (rows past the queries and columns past hd zero-filled).
// - S = Q K^T: wgmma m64n64k16 from shared memory (both K-major), raw bf16
//   q and k, float32 sums, hd / 16 k-steps. The accumulator is the m16n8
//   fragment layout of attn_mma's s[8][4], so the caller's fix-up (scale,
//   ALiBi, -inf past Tt) and attn_mma's online_rows run on it unchanged.
// - P V: wgmma m64nHDPk16 with P in registers (the A fragments of
//   attn_mma's p_fragments, bf16 hi then lo per 16-key step: the split
//   that keeps the float32 partials within 1e-3) against V from shared
//   memory (MN-major, the transpose bit); HDP is hd padded to 64 or 128.
//   Its accumulator holds each warp's 16 rows in the layout of
//   attn_mma::Acc<HD>, which the fused kernel stashes as o_t.
// A row's walk depends on its own Q row and the trunk only: the block's
// other rows, the number of warpgroups and the ring depth move no bit.

#pragma once

#include "attn_mma.cuh"
#include "hopper.cuh"

namespace attn_wgmma {

namespace am = attn_mma;
namespace hp = hopper;
using am::bf16;

template <int HD>
struct Dims {
  static_assert(HD % 16 == 0 && HD <= 128, "head dim: a multiple of 16, <= 128");
  static constexpr int kPanels = (HD + 63) / 64;    // 64-column panels of a row
  static constexpr int kHDP = 64 * kPanels;         // P V's n: hd padded
  static constexpr int kKS = HD / 16;               // 16-deep k-steps of Q K^T
  static constexpr int kPanel = 64 * 128;           // bytes of a 64-row panel
  static constexpr int kTile = kPanels * kPanel;    // bytes of a Q, K or V tile
  static constexpr int kStage = 2 * kTile;          // a K and a V tile
  static constexpr int kAcc = kHDP / 2;             // P V accumulator floats a thread
};

// Copies of ``rows`` Q rows (row r from at(r), an am::Row) into the
// swizzled panels of 64-row tiles at q. Every thread of the block takes
// part; the caller commits them.
template <int HD, typename At>
__device__ __forceinline__ void load_q(unsigned char* q, int rows, const At& at) {
  using D = Dims<HD>;
  constexpr int kChunks = D::kPanels * 8;  // 16-byte chunks of a padded row
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const am::Row row = at(r);
    const bool ok = row.ok && c * 8 < HD;
    unsigned char* dst = q + (r >> 6) * D::kTile + (c >> 3) * D::kPanel + (r & 63) * 128 +
                         (((c & 7) ^ (r & 7)) << 4);
    am::cp_async16(dst, ok ? row.p + c * 8 : row.p, ok);
  }
}

// Where a walk keeps its tiles and barriers, and the trunk it reads.
struct Trunk {
  unsigned char* ring;     // kSt stages of kStage bytes, 1024-aligned
  uint64_t* full;          // kSt barriers: a stage's tile has landed
  uint64_t* empty;         // kSt barriers: a stage is free (producer-warp rings)
  const CUtensorMap* k;    // trunk k (K, Tt, hd): dims {hd, Tt, K}, boxes {64, 64, 1}
  const CUtensorMap* v;    // trunk v, the same
  int kh, n_tiles;
};

// Barriers of the ring, by thread 0 (before the block's first barrier):
// empty ones, counting ``consumer_warps`` arrivals, where a producer warp
// refills the ring.
template <int kSt>
__device__ __forceinline__ void init_ring(const Trunk& tr, int consumer_warps) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kSt; ++s) {
      hp::mbar_init(&tr.full[s], 1);
      if (consumer_warps > 0) hp::mbar_init(&tr.empty[s], consumer_warps);
    }
    hp::fence_barrier_init();
  }
}

// TMA copies of trunk tile t (keys 64 t .. 64 t + 63) into stage s.
template <int HD>
__device__ __forceinline__ void issue_tile(const Trunk& tr, int s, int t) {
  using D = Dims<HD>;
  unsigned char* kt = tr.ring + s * D::kStage;
  hp::mbar_expect_tx(&tr.full[s], D::kStage);
#pragma unroll
  for (int p = 0; p < D::kPanels; ++p) {
    hp::tma_load_3d(kt + p * D::kPanel, tr.k, &tr.full[s], 64 * p, 64 * t, tr.kh);
    hp::tma_load_3d(kt + D::kTile + p * D::kPanel, tr.v, &tr.full[s], 64 * p, 64 * t, tr.kh);
  }
}

// D += P V for one 16-key step: n = 64 or 128 by the padded head dim.
template <int HD>
__device__ __forceinline__ void pv_step(float (&o)[Dims<HD>::kAcc], const uint32_t (&a)[4],
                                        uint64_t v) {
  if constexpr (Dims<HD>::kHDP == 128)
    hp::wgmma_rs_n128<1>(o, a, v);
  else
    hp::wgmma_rs_n64<1>(o, a, v);
}

// A walk's running state before its first tile: o = 0, m = -inf, l = 0.
template <int HD>
__device__ __forceinline__ void walk_init(float (&o)[Dims<HD>::kAcc], float (&m)[2],
                                          float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < Dims<HD>::kAcc; ++i) o[i] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = -CUDART_INF_F;
    l[h] = 0.f;
  }
}

// One 64-key tile of a warpgroup's walk, its K tile at kt and V tile at
// vt (landed, swizzled panels), its Q tile at q_wg: S = Q K^T by wgmma,
// fix(s) turns the raw tile into scores (scale, ALiBi, -inf where
// masked), the online softmax moves m and l on, then o = o * factor +
// P V with P as bf16 hi then lo in each 16-key step (kSplitP) or as one
// bf16 P.
template <int HD, bool kSplitP, typename Fix>
__device__ __forceinline__ void tile_step(const unsigned char* q_wg, const unsigned char* kt,
                                          const unsigned char* vt, const Fix& fix,
                                          float (&o)[Dims<HD>::kAcc], float (&m)[2],
                                          float (&l)[2]) {
  using D = Dims<HD>;
  float s[8][4];
  float(&sf)[32] = reinterpret_cast<float(&)[32]>(s);
#pragma unroll
  for (int i = 0; i < 32; ++i) sf[i] = 0.f;
  hp::fence_regs(sf);
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D::kKS; ++kk) {
    const int off = (kk >> 2) * D::kPanel + (kk & 3) * 32;
    hp::wgmma_ss_n64<0, 0>(sf, hp::desc_k(q_wg + off), hp::desc_k(kt + off));
  }
  hp::wgmma_commit();
  hp::wgmma_wait<0>();
  hp::fence_regs(sf);
  fix(s);
  float f[2];
  am::online_rows(s, m, l, f);
#pragma unroll
  for (int j = 0; j < D::kHDP / 8; ++j) {
    o[4 * j] = __fmul_rn(o[4 * j], f[0]);
    o[4 * j + 1] = __fmul_rn(o[4 * j + 1], f[0]);
    o[4 * j + 2] = __fmul_rn(o[4 * j + 2], f[1]);
    o[4 * j + 3] = __fmul_rn(o[4 * j + 3], f[1]);
  }
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) am::p_fragments(s, kk, hi[kk], lo[kk]);
  hp::fence_regs(o);
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t v = hp::desc_mn(vt + kk * 16 * 128, D::kPanel);
    pv_step<HD>(o, hi[kk], v);
    if constexpr (kSplitP) pv_step<HD>(o, lo[kk], v);
  }
  hp::wgmma_commit();
  hp::wgmma_wait<0>();
  hp::fence_regs(o);
}

// The consumer side of a walk over the trunk (kSt >= 2 stages; the ring's
// barriers initialised, the first tiles asked for, the Q tile in shared
// memory and visible to wgmma). Each warpgroup walks the rows of its Q
// tile q_wg; fix(t, s) turns its raw Q K^T tile into scores (scale,
// ALiBi, -inf past Tt); release(t) hands tile t's stage back once the
// warpgroup's products that read it are done. Leaves each warp's rows in
// o (Acc<HD>'s fragment layout, padded to kHDP columns), m and l (per row
// half, as Acc<HD>).
template <int HD, int kSt, typename Fix, typename Release>
__device__ __forceinline__ void trunk_walk(const Trunk& tr, const unsigned char* q_wg,
                                           const Fix& fix, const Release& release,
                                           float (&o)[Dims<HD>::kAcc], float (&m)[2],
                                           float (&l)[2]) {
  static_assert(kSt >= 2, "a ring of two stages or more");
  using D = Dims<HD>;
  walk_init<HD>(o, m, l);
  for (int t = 0; t < tr.n_tiles; ++t) {
    const int st = t % kSt;
    hp::mbar_wait(&tr.full[st], (t / kSt) & 1);
    const unsigned char* kt = tr.ring + st * D::kStage;
    tile_step<HD, true>(q_wg, kt, kt + D::kTile, [&](float (&s)[8][4]) { fix(t, s); }, o, m,
                        l);
    release(t);
  }
}

// Each warp's rows of a walk as attn_mma's accumulator (the first hd
// columns of o).
template <int HD>
__device__ __forceinline__ void to_acc(const float (&o)[Dims<HD>::kAcc], const float (&m)[2],
                                       const float (&l)[2], am::Acc<HD>& acc) {
#pragma unroll
  for (int j = 0; j < am::Dims<HD>::kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc.o[j][e] = o[4 * j + e];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    acc.m[h] = m[h];
    acc.l[h] = l[h];
  }
}

// The trunk's tensor map (k or v of (K, Tt, hd) bf16), host side.
inline bool trunk_map(CUtensorMap* map, const void* base, int K, int Tt, int hd) {
  const cuuint64_t dims[3] = {cuuint64_t(hd), cuuint64_t(Tt), cuuint64_t(K)};
  const cuuint64_t strides[2] = {cuuint64_t(hd) * 2, cuuint64_t(Tt) * hd * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  return hp::encode_map(map, base, 3, dims, strides, box);
}

}  // namespace attn_wgmma
