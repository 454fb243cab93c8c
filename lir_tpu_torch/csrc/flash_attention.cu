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
// bf16 inputs at head dims 64 and 128 (every full-size decoder family of
// models/registry.py: llama, mistral, qwen, baichuan, bloom, pythia and
// h2ogpt at 128; falcon-7b, opt-iml-1.3b and gpt2 at 64) take
// flash_wgmma_kernel, on Hopper's TMA and wgmma (attn_wgmma.cuh's tile
// step, hopper.cuh's ring). Its bound at llama-2-7b width, B = 32, is
// bytes: 0.0200 ms at bucket 64, 0.0401 at 128, 0.160 at 512. What held
// its predecessor (flash_mma_kernel, below) at 29-37 % of that bound, and
// what this design does about each:
// - 2,048 short-lived blocks at bucket 128, each one serial chain (Q copy,
//   mask scan, 1-2 key tiles, store) whose ramp and tail nothing overlaps.
//   Here as many blocks an SM as shared memory allows stay resident and
//   walk a static list: block x takes the (batch row, head) groups x,
//   x + gridDim.x, ..., each group's items (kWG 64-row query tiles, one a
//   consumer warpgroup) from the last one down (the longest walk first).
//   A producer warp asks by TMA for the next item's Q tiles (two Q slots)
//   and key tiles (a K/V ring, mbarriers) while the consumers compute this
//   one, and a group's key tiles, read from device memory for its first
//   item, come from L2 for the rest (8 % faster at bucket 128 than the
//   list taken head-fastest item by item; 2-3 % slower at mistral's GQA
//   and falcon's MQA, whose kv heads neighbouring blocks share anyway).
// - Every block repeated the scan of its batch row's key mask for the
//   first valid key, on the consumers' path. Here the producer warp scans
//   it once an item (a warp-wide min), issuing the next item's mask loads
//   before this item's tile loop and reading them after it, and hands
//   (first tile, tiles) over with the Q slot.
// - Loads were cp.async by the consumers. Here TMA reads (B, S, N, hd) by
//   4-D tensor maps (boxes of 64 rows of one head, 64-column panels with
//   the 128-byte swizzle that wgmma reads); zero fill covers rows past S.
// - S = Q K^T is wgmma m64n64k16 from shared memory (both K-major), the
//   online softmax runs in registers in key_loop's arithmetic (x sm_scale
//   in float32, ALiBi, -inf mask, exp as ex2 of (x - m) log2 e), and P V
//   is wgmma with one bf16 P from registers against V read MN-major; each
//   lane's key mask and positions of a tile are read before its products.
// - The Q slot is handed back as soon as the item's products are done; the
//   result goes into a staging tile of the warpgroup's own and out by TMA
//   stores, which skip the rows past S (the next item's result waits only
//   for their reads of the tile).
// - Every key tile was read from L2 by each 64-row query tile that walks
//   it. At four query tiles or more (bucket 512) a block is two consumer
//   warpgroups over one 4-stage ring, an item two neighbouring query
//   tiles, so a key tile comes to the SM once for both (7 % faster there
//   than one warpgroup; at bucket 128 20 % slower: their walks, 1 and 2
//   tiles, leave one idle, and a block takes the whole SM). Shorter
//   prompts keep one warpgroup a block with a 2-stage ring, two blocks
//   an SM at hd 128.
// - GQA / MQA: a kv head's query heads are neighbouring groups, walked at
//   the same time by neighbouring blocks, so its tiles come from device
//   memory once. Stacking a GQA group's heads on the warpgroups over one
//   ring instead was not built.
// What still holds it back (kernel_variants.py: source variants timed in
// one process, NVIDIA H100 80GB HBM3, 700.00 W): at bucket 64 and 128 it
// is as fast as its tiles arrive. With the products skipped it takes as
// long (0.057 and 0.107 ms, against 0.063 and 0.097 whole and SDPA's
// 0.049 and 0.073). Variants that put more bytes in flight or fewer (a
// third Q slot, deeper or shallower rings, an L2 prefetch of the next
// item, 256-byte L2 promotion) or skip the mask scan were tried while
// this kernel was brought up and did not help; they were not kept.
// The other head dims (32, 80, 96: only the tiny test configs) are not
// whole 64-column panels; they keep flash_mma_kernel, by shape, as
// lir_flash_route states. float32 keeps flash_kernel.
//
// flash_mma_kernel (bf16 at head dims 32, 80 and 96), on attn_mma.cuh as
// the cascade kernels' window walk:
// - A block owns 64 query rows (four warps of 16) of one (batch row, query
//   head) and reads kv head h / G.
// - The key walk starts at the tile of the batch row's first valid key (a
//   scan of the key mask) and stops at the causal diagonal; key_loop feeds
//   it through a 2-stage cp.async ring. Rows with no valid key walk
//   nothing and write 0. Two stages and a cap of 168 registers let three
//   blocks share an SM.
// - S = Q K^T by mma.sync from raw bf16 q and k, summed in float32, then
//   x sm_scale in float32 (q is never pre-scaled into bf16), + ALiBi
//   slope_h * kpos in float32, -inf where the key mask is 0 or kj > qi.
// - P V from one bf16 P: the output is bf16, and the CPU emulation of this
//   arithmetic (tests/test_torch_cascade_mma_numerics.py, which holds both
//   bf16 kernels' order) stays under 0.6 of the card's 1e-2 bar of
//   flash_attention_plain, so the cascade kernels' hi + lo split, which
//   their float32 partials need, is not taken.
// - The grid's slowest axis is the query tile, reversed: the tiles nearest
//   the end of the prompt walk the most keys and are scheduled first.
// The key tiles are summed in another order than the plain version's
// single softmax, so the kernels match it within bf16 tolerance, not
// bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <cmath>

#include "attn_mma.cuh"
#include "attn_tile.cuh"
#include "attn_wgmma.cuh"

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

// A lane's 16 key columns of a 64-key tile (n-tile j, column c: key
// k0 + 8 j + c0 + c): whether each is a valid key, and its position for
// ALiBi. Read before the tile's Q K^T is issued, so that the loads'
// latency hides behind the products.
struct FlashCols {
  uint32_t live;  // bit 2 j + c
  float kp[16];
};

// Scores of one warp's tile: x sm_scale, ALiBi on the key's mask-aware
// position, -inf where the key is masked, past S or after the row's query
// (apply), from the lane's key columns of the tile (load).
struct FlashFix {
  const int* mask;  // the batch row's (S,)
  const int* kpos;  // the batch row's (S,), or null (no ALiBi)
  float sm_scale, slope;
  int S, lower, c0;
  int qi[2];        // the lane's two query rows (row g, row g + 8)
  __device__ __forceinline__ FlashCols load(int t) const {
    FlashCols c;
    c.live = 0;
    const int k0 = lower + t * am::kKeys;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * j + c0 + e;
        const bool in = kj < S;
        c.live |= uint32_t(in && __ldg(mask + kj) > 0) << (2 * j + e);
        c.kp[2 * j + e] = (kpos != nullptr && in) ? float(__ldg(kpos + kj)) : 0.f;
      }
    return c;
  }
  __device__ __forceinline__ void apply(int t, const FlashCols& c, float (&s)[8][4]) const {
    const int k0 = lower + t * am::kKeys;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * j + c0 + e;
        const bool live = (c.live >> (2 * j + e)) & 1u;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x = __fmul_rn(s[j][2 * h + e], sm_scale);
          if (kpos != nullptr) x = __fadd_rn(x, __fmul_rn(slope, c.kp[2 * j + e]));
          s[j][2 * h + e] = (live && kj <= qi[h]) ? x : -CUDART_INF_F;
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
  am::key_loop<HD, false, kFlashStages>(
      ring, n_tiles, active, key,
      [&](int t, float (&s)[8][4]) { fix.apply(t, fix.load(t), s); }, acc);
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

// ---------------------------------------------------------------------------
// bf16 at head dims 64 and 128: persistent, TMA + wgmma
// ---------------------------------------------------------------------------

namespace aw = attn_wgmma;
namespace hp = hopper;

constexpr int kQSlots = 2;                  // Q slots: this item's and the next one's

// K/V tiles in the ring of a block of kWG consumer warpgroups.
template <int kWG>
constexpr int wg_stages() {
  return kWG == 1 ? 2 : 4;
}

// The consumer warpgroup wg's own barrier (ids 1 and 2; 0 is the block's),
// with a constant id so that the kernel takes only the barriers it names.
__device__ __forceinline__ void wg_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// Registers a thread of the kernel may take: at hd 64 with one consumer
// warpgroup, 128, so that three blocks of five warps fit an SM (each of
// its four quarters holds 16,384 registers: four warps of 128); 129 or
// more would leave room for two. The compiler's own choice otherwise.
template <int HD, int kWG>
constexpr int wg_max_registers() {
  return HD == 64 && kWG == 1 ? 128 : 255;
}

// Threads of a block of kWG consumer warpgroups and the producer warp.
template <int kWG>
constexpr int wg_threads() {
  return 128 * kWG + 32;
}

struct WgParams {
  CUtensorMap q;      // (B, S, H, hd): dims {hd, H, S, B}, boxes {64, 1, 64, 1}
  CUtensorMap k;      // (B, S, K, hd): dims {hd, K, S, B}, the same boxes
  CUtensorMap v;
  const int* mask;    // (B, S)
  const int* kpos;    // (B, S) or null (no ALiBi)
  const float* slopes;
  CUtensorMap o;      // the output (B, S, H, hd), as q
  int B, S, H, K, n_qt;
  float sm_scale;
};

// A work item: the kWG 64-row query tiles from row i0 of head h of batch
// row b, one a consumer warpgroup.
struct Item {
  int b, h, i0;
};
// The block's j-th item, false past its last. Block x takes the (batch
// row, head) groups x, x + gridDim.x, ... (head fastest), each group's
// items one after another from the last one down (the longest walk
// first): the group's key tiles, read from device memory for its first
// item, come from L2 for the others, and a GQA group's query heads are
// neighbouring groups that neighbouring blocks walk at the same time, so
// their kv head's tiles come from device memory once.
template <int kWG>
__device__ __forceinline__ bool item_at(const WgParams& p, int j, Item& it) {
  const int per = (p.n_qt + kWG - 1) / kWG;  // items of a group
  const int g = blockIdx.x + (j / per) * gridDim.x;
  if (g >= p.B * p.H) return false;
  it = {g / p.H, g % p.H, (per - 1 - j % per) * kWG * am::kKeys};
  return true;
}

// Dynamic shared memory: the Q slots (kWG tiles each), the output's
// staging tiles (one a warpgroup), the K/V ring, the barriers, then each
// Q slot's walk (first tile, tiles) as the producer found it.
template <int HD, int kWG>
struct WgSmem {
  using D = aw::Dims<HD>;
  static constexpr int kSlot = kWG * D::kTile;
  static constexpr int kOut = kQSlots * kSlot;
  static constexpr int kRing = kOut + kSlot;
  static constexpr int kStages = wg_stages<kWG>();
  static constexpr int kBars = kRing + kStages * D::kStage;
  static constexpr int kWalk = kBars + 8 * 2 * (kQSlots + kStages);
  static constexpr int kBytes = kWalk + 4 * 2 * kQSlots;
};

// The first valid key of a batch row's key mask, found by a warp: start()
// loads the first 128 slots (four a lane) into registers, finish() reads
// them (and scans any slots after them only if none is valid).
struct MaskScan {
  const int* mask;
  int v[4];
  __device__ __forceinline__ void start(const WgParams& p, int b, int lane) {
    mask = p.mask + size_t(b) * p.S;
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = lane + 32 * u < p.S ? __ldg(mask + lane + 32 * u) : 0;
  }
  __device__ __forceinline__ int finish(const WgParams& p, int lane) const {
    int first = p.S;
#pragma unroll
    for (int u = 3; u >= 0; --u)
      if (v[u] > 0) first = lane + 32 * u;
    first = __reduce_min_sync(am::kFull, first);
    if (first == p.S) {
      for (int x = 128 + lane; x < p.S; x += 32)
        if (__ldg(mask + x) > 0) {
          first = x;
          break;
        }
      first = __reduce_min_sync(am::kFull, first);
    }
    return first;
  }
};

// Grid: as many blocks an SM as fit, each walking its items (item_at).
// Block: kWG consumer warpgroups (threads 0 .. 128 kWG - 1), warpgroup w
// owning query tile w of each item, then the producer warp. The
// warpgroups share each key tile: the producer walks the union of their
// walks, and a warpgroup whose diagonal comes earlier (or whose rows lie
// past S) waits for and hands back the tiles it does not multiply.
template <int HD, int kWG>
__global__ void __launch_bounds__(wg_threads<kWG>()) __maxnreg__((wg_max_registers<HD, kWG>()))
    flash_wgmma_kernel(const __grid_constant__ WgParams p) {
  using D = aw::Dims<HD>;
  using Sm = WgSmem<HD, kWG>;
  static_assert(D::kHDP == HD, "head dims 64 and 128: whole panels");
  constexpr int kConsumers = 128 * kWG;
  extern __shared__ unsigned char flash_wgmma_smem_raw[];
  unsigned char* smem = hp::aligned_smem(flash_wgmma_smem_raw);
  unsigned char* ring = smem + Sm::kRing;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + Sm::kBars);
  uint64_t* qempty = qfull + kQSlots;
  uint64_t* full = qempty + kQSlots;
  uint64_t* empty = full + Sm::kStages;
  int* walk = reinterpret_cast<int*>(smem + Sm::kWalk);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kQSlots; ++s) {
      hp::mbar_init(&qfull[s], 1);
      hp::mbar_init(&qempty[s], 4 * kWG);
    }
    for (int s = 0; s < Sm::kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 4 * kWG);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer warp: lane 0 asks for each item's Q tiles as soon as a Q
    // slot is free, then for its key tiles as stages free up, so the next
    // items' loads run while the consumers compute this one. The whole
    // warp finds the next item's first valid key meanwhile: its mask loads
    // are issued before this item's tile loop and read after it.
    Item it, next;
    bool more = item_at<kWG>(p, 0, next);
    MaskScan scan;
    if (more) scan.start(p, next.b, lane);
    int kv = 0;
    for (int j = 0; more; ++j) {
      it = next;
      const int first = scan.finish(p, lane);
      more = item_at<kWG>(p, j + 1, next);
      if (more) scan.start(p, next.b, lane);
      const int lower = first / am::kKeys * am::kKeys;
      const int upper = min(p.S, it.i0 + kWG * am::kKeys);  // the last diagonal
      const int n_tiles =
          first < p.S && upper > lower ? (upper - lower + am::kKeys - 1) / am::kKeys : 0;
      if (lane == 0) {
        const int slot = j % kQSlots;
        hp::mbar_wait(&qempty[slot], ((j / kQSlots) & 1) ^ 1);
        walk[2 * slot] = lower;
        walk[2 * slot + 1] = n_tiles;
        unsigned char* q = smem + slot * Sm::kSlot;
        const int tiles_q = min(kWG, (p.S - it.i0 + am::kKeys - 1) / am::kKeys);
        hp::mbar_expect_tx(&qfull[slot], tiles_q * D::kTile);
        for (int w = 0; w < tiles_q; ++w)
#pragma unroll
          for (int pn = 0; pn < D::kPanels; ++pn)
            hp::tma_load_4d(q + w * D::kTile + pn * D::kPanel, &p.q, &qfull[slot], 64 * pn,
                            it.h, it.i0 + w * am::kKeys, it.b);
        const int kh = it.h / (p.H / p.K);
        for (int t = 0; t < n_tiles; ++t, ++kv) {
          const int st = kv % Sm::kStages;
          hp::mbar_wait(&empty[st], ((kv / Sm::kStages) & 1) ^ 1);
          unsigned char* kt = ring + st * D::kStage;
          hp::mbar_expect_tx(&full[st], D::kStage);
          const int k0 = lower + t * am::kKeys;
#pragma unroll
          for (int pn = 0; pn < D::kPanels; ++pn) {
            hp::tma_load_4d(kt + pn * D::kPanel, &p.k, &full[st], 64 * pn, kh, k0, it.b);
            hp::tma_load_4d(kt + D::kTile + pn * D::kPanel, &p.v, &full[st], 64 * pn, kh, k0,
                            it.b);
          }
        }
      }
      __syncwarp();
    }
    return;
  }

  // Consumer warpgroup wg: warp w of it owns rows 16 w .. 16 w + 15 of
  // query tile wg of each item.
  const int wg = kWG == 1 ? 0 : tid >> 7;
  const int warp = (tid >> 5) & 3;
  const bool leader = (tid & 127) == 0;
  unsigned char* out = smem + Sm::kOut + wg * D::kTile;
  int kv = 0;
  Item it;
  for (int j = 0; item_at<kWG>(p, j, it); ++j) {
    const int slot = j % kQSlots;
    hp::mbar_wait(&qfull[slot], (j / kQSlots) & 1);
    const int lower = walk[2 * slot];
    const int n_tiles = walk[2 * slot + 1];
    const unsigned char* q = smem + slot * Sm::kSlot + wg * D::kTile;
    const int i0 = it.i0 + wg * am::kKeys;  // this warpgroup's tile
    const int upper = min(p.S, i0 + am::kKeys);
    const int mine = i0 < p.S && upper > lower
                         ? min(n_tiles, (upper - lower + am::kKeys - 1) / am::kKeys) : 0;
    const int qi = i0 + 16 * warp + (lane >> 2);
    const FlashFix fix{p.mask + size_t(it.b) * p.S,
                         p.kpos != nullptr ? p.kpos + size_t(it.b) * p.S : nullptr, p.sm_scale,
                         p.slopes != nullptr ? p.slopes[it.h] : 0.f, p.S, lower, 2 * (lane & 3),
                         {qi, qi + 8}};
    float o[D::kAcc], m[2], l[2];
    aw::walk_init<HD>(o, m, l);
    for (int t = 0; t < n_tiles; ++t, ++kv) {
      const int st = kv % Sm::kStages;
      if (kWG == 1 || t < mine) {
        const FlashCols cols = fix.load(t);
        hp::mbar_wait(&full[st], (kv / Sm::kStages) & 1);
        const unsigned char* kt = ring + st * D::kStage;
        aw::tile_step<HD, false>(q, kt, kt + D::kTile,
                                 [&](float (&s)[8][4]) { fix.apply(t, cols, s); }, o, m, l);
      } else {
        hp::mbar_wait(&full[st], (kv / Sm::kStages) & 1);
      }
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty[st]);
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&qempty[slot]);  // its products are done
    if (i0 >= p.S) continue;                        // no rows: nothing to write
    // The normalized rows into the warpgroup's staging tile (once its last
    // stores have read it), in the Q tile's swizzle, then out by TMA
    // stores, which skip the rows past S. A row with no valid key gives 0
    // (o = 0 over the 1e-30 floor).
    if (leader) hp::bulk_wait_read<0>();
    wg_sync(wg);  // the staging tile is free
    const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + (lane >> 2) + 8 * h;
        const __nv_bfloat162 y = __floats2bfloat162_rn(__fdiv_rn(o[4 * c + 2 * h], den[h]),
                                                       __fdiv_rn(o[4 * c + 2 * h + 1], den[h]));
        *reinterpret_cast<__nv_bfloat162*>(out + (c >> 3) * D::kPanel + r * 128 +
                                           (((c & 7) ^ (r & 7)) << 4) + 4 * (lane & 3)) = y;
      }
    hp::fence_proxy_async();
    wg_sync(wg);  // its rows are written
    if (leader) {
#pragma unroll
      for (int pn = 0; pn < D::kPanels; ++pn)
        hp::tma_store_4d(&p.o, out + pn * D::kPanel, 64 * pn, it.h, i0, it.b);
      hp::bulk_commit();
    }
  }
  if (leader) hp::bulk_wait_all();  // the last stores have landed
}

// A (B, S, N, hd) bf16 tensor's map: dims {hd, N, S, B}, boxes of one
// 64-column panel of 64 rows of one head.
bool bshd_map(CUtensorMap* map, const void* base, int B, int S, int N, int hd) {
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(N), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(hd) * 2, cuuint64_t(N) * hd * 2,
                                 cuuint64_t(S) * N * hd * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  return hp::encode_map(map, base, 4, dims, strides, box);
}

template <int HD, int kWG>
cudaError_t launch_wgmma(const FlashArgs& a, cudaStream_t st) {
  const int smem = WgSmem<HD, kWG>::kBytes;
  // Blocks an SM and SMs, asked once per instantiation. A refusal is
  // returned and taken off the runtime's last error, so that it is not
  // reported again by the next launch's check.
  static int grid_max = 0;
  if (grid_max == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaFuncSetAttribute(flash_wgmma_kernel<HD, kWG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_wgmma_kernel<HD, kWG>,
                                                        wg_threads<kWG>(), smem);
    if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
    if (e != cudaSuccess) {
      cudaGetLastError();
      return e;
    }
    grid_max = sms * per_sm;
  }
  WgParams p;
  if (!bshd_map(&p.q, a.q, a.B, a.S, a.H, HD) || !bshd_map(&p.k, a.k, a.B, a.S, a.K, HD) ||
      !bshd_map(&p.v, a.v, a.B, a.S, a.K, HD) || !bshd_map(&p.o, a.out, a.B, a.S, a.H, HD))
    return cudaErrorInvalidValue;
  p.mask = a.mask;
  p.kpos = a.kpos;
  p.slopes = a.slopes;
  p.B = a.B;
  p.S = a.S;
  p.H = a.H;
  p.K = a.K;
  p.n_qt = (a.S + am::kKeys - 1) / am::kKeys;
  p.sm_scale = a.sm_scale;
  const int grid = a.B * a.H < grid_max ? a.B * a.H : grid_max;
  flash_wgmma_kernel<HD, kWG><<<grid, wg_threads<kWG>(), smem, st>>>(p);
  return cudaGetLastError();
}

// Two warpgroups a block over one key ring at prompts of four query tiles
// or more (bucket 512: 7 % faster than one, with half the key tiles read
// from L2), one otherwise (bucket 128: two are 20 % slower, their walks
// 1 and 2 tiles long on one block an SM).
template <int HD>
cudaError_t wgmma_by_length(const FlashArgs& a, cudaStream_t st) {
  return a.S > 3 * am::kKeys ? launch_wgmma<HD, 2>(a, st) : launch_wgmma<HD, 1>(a, st);
}

// Head dims 64 and 128 take the wgmma kernel (lir_flash_route), so the
// mma.sync kernel is built for the others only.
cudaError_t mma_by_hd(const FlashArgs& a, int hd, cudaStream_t st) {
  switch (hd) {
    case 32: return launch_mma<32>(a, st);
    case 80: return launch_mma<80>(a, st);
    case 96: return launch_mma<96>(a, st);
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

// The kernel a call takes, by dtype (0 = float32, 1 = bfloat16) and head
// dim: 0 = flash_kernel (float32, CUDA cores), 1 = flash_mma_kernel (bf16
// at head dims 32, 80 and 96), 2 = flash_wgmma_kernel (bf16 at head dims
// 64 and 128); -1 for any other pair. The one place this rule is kept: the
// entry below dispatches by it and the wrapper counts launches by it.
extern "C" int lir_flash_route(int dtype, int hd) {
  const bool built = hd == 32 || hd == 64 || hd == 80 || hd == 96 || hd == 128;
  if (!built || (dtype != 0 && dtype != 1)) return -1;
  if (dtype == 0) return 0;
  return hd == 64 || hd == 128 ? 2 : 1;
}

// dtype: 0 = float32, 1 = bfloat16; the kernel by lir_flash_route.
// Returns cudaGetLastError() (or the error of a refused attribute or
// tensor map), 0 on success.
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
  switch (lir_flash_route(dtype, hd)) {
    case 0: return int(by_hd<float>(a, hd, st));
    case 1: return int(mma_by_hd(a, hd, st));
    case 2: return int(hd == 64 ? wgmma_by_length<64>(a, st) : wgmma_by_length<128>(a, st));
    default: return int(cudaErrorInvalidValue);
  }
}
