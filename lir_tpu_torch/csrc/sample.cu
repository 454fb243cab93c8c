// Temperature sampling by the Gumbel-max trick with JAX's threefry draws:
// one launch picks each row's next token.
//
// No Pallas original: this stands in for the JAX package's XLA
// `jax.random.categorical` in `sample_decode`
// (lir_tpu/engine/generate.py:1442-1447), which is
// argmax(gumbel(key, shape) + logits / temperature).
//
// The bit contract with the plain twin (ops/sample.py,
// `gumbel_scores_plain` / `gumbel_argmax_plain`). Per row b and vocab
// index v:
//   - the counter is offsets[b] + v (64 bits: one key over (B, V) counts
//     the flat index, per-row keys count from 0);
//   - bits = x0 ^ x1 of threefry2x32(keys[b], (hi, lo) of the counter),
//     20 rounds, rotations (13, 15, 26, 6) and (17, 29, 16, 24), the
//     third key word k0 ^ k1 ^ 0x1BD11BDA;
//   - u = max(tiny, f + tiny), f = float((bits >> 9) | 0x3F800000) - 1
//     (the span 1 - tiny rounds to 1, so XLA's f * span + tiny is this
//     sum exactly);
//   - score = -logf(-logf(u)) + logits[b, v] / temperature;
//   - the id is the argmax, lowest index on ties, NaN above all (as
//     jnp.argmax and torch.argmax take it).
// Built without --use_fast_math: logf and the division are the accurate
// ones, and every add and divide is written with its _rn intrinsic so no
// contraction changes a rounding. Each score is the twin's bit for bit;
// the argmax under `better` is a total order on (score, index), so any
// split of the row and any reduction order give the twin's id.
//
// The design on the H100: one thread-block cluster a row.
//   - The row's entries are split across the cluster's blocks (the launch
//     plan, ops/sample.py's `plan`): up to 4 blocks an SM over the grid
//     (B <= 33 at V = 32,000 on 132 SMs) a row takes 16 blocks, the
//     non-portable size; past that a row takes sms // B blocks, one block
//     an SM. The card's scheduler puts a cluster of 9 or more blocks on a
//     GPC of its own and doubles up the 8th, so at B = 8 16 of the SMs
//     hold two rows' blocks; many small blocks, or one an SM, even that
//     out.
//   - A thread takes kPerThread (4) consecutive entries at a time from
//     one 16-byte load, the next unit's load issued before the current
//     unit's arithmetic, and runs their threefry chains interleaved (a
//     chain is ~60 dependent INT32 operations); its running best takes
//     its entries in index order without a branch. A row's entries before
//     its first 16-byte boundary and after its last whole unit are rank
//     0's, one a thread, so a row view of any stride takes this kernel.
//   - Each warp reduces its (score, index) with shuffles and sends it to
//     rank 0's shared memory by an asynchronous remote store
//     (st.async) that counts its 8 bytes on an mbarrier there; rank 0's
//     first warp waits on that barrier, reduces the cluster's slots and
//     writes the id. The one cluster barrier is split: every block arrives
//     (relaxed) as it starts and waits just before its remote store, so
//     rank 0's slots and barrier exist by then and the wait costs nothing.
//     A full cluster barrier at the end would be a GPU-scope fence (its
//     release half compiles to MEMBAR.ALL.GPU) and measured ~0.4 us
//     slower. No global scratch, no atomics, nothing kept between
//     launches: any stream may launch it at any time.
//
// What bounds it on the H100: instruction issue, then the load latency
// and the reduction. An entry reads 4 bytes and costs, in the built
// loop's SASS (chip_smoke.py's `sample_sass_counts`), ~152 instructions:
// ~68 INT32 operations (threefry's adds, rotates and xors, the counter,
// the bits, the exponent work of logf), ~24 IMAD (adds the compiler
// moves to the FP32 pipe), ~46 FP32 (the two accurate logf, the
// division's fast path), ~10 compares. Over 132 SMs at 128 instructions
// a cycle that is ~1.2 cycles an entry an SM; the kernel reaches ~1.7 at
// one block of 8 warps an SM. A launch also waits ~1 us for its first
// loads (the L2 cold, as chip_smoke times it) and ~1 us for the
// cluster's reduction, so at B = 8 (2,000 entries a block, 4,000 on the
// doubled SMs) its time above an empty kernel's is several times its
// bound (PERF.md, section 6).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace hp = hopper;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Consecutive entries a thread takes at a time: one unit, that many
// threefry chains in flight.
constexpr int kPerThread = 4;
// A unit in 16-byte loads where the row's address allows it; otherwise
// kPerThread scalar loads.
constexpr bool kVectorLoads = true;
constexpr int kAlign = !kVectorLoads ? 1 : kPerThread < 4 ? kPerThread : 4;
// The warps' slots reach rank 0 by asynchronous remote stores that
// count their bytes on an mbarrier there (else: stores, then a cluster
// barrier).
constexpr bool kAsyncSlots = true;
// Blocks a cluster: 16 is the H100's non-portable size.
constexpr int kMaxCluster = 16;
constexpr float kTiny = 1.17549435082228750797e-38f;   // FLT_MIN

__device__ __forceinline__ int rotation(int group, int r) {
  if (group % 2 == 0) return r == 0 ? 13 : r == 1 ? 15 : r == 2 ? 26 : 6;
  return r == 0 ? 17 : r == 1 ? 29 : r == 2 ? 16 : 24;
}

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint64_t counter) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = (uint32_t)(counter >> 32) + ks[0];
  uint32_t x1 = (uint32_t)counter + ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rotation(g, r));
      x1 ^= x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + (uint32_t)(g + 1);
  }
  return x0 ^ x1;
}

// -log(-log(u)) of the threefry uniform of this counter.
__device__ __forceinline__ float gumbel_noise(uint32_t k0, uint32_t k1,
                                              uint64_t counter) {
  const uint32_t bits = threefry_bits(k0, k1, counter);
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(kTiny, __fadd_rn(f, kTiny));
  return -logf(-logf(u));
}

__device__ __forceinline__ float score(float logit, float temp, uint32_t k0,
                                       uint32_t k1, uint64_t counter) {
  return __fadd_rn(gumbel_noise(k0, k1, counter), __fdiv_rn(logit, temp));
}

// (v, i) beats (bv, bi): a larger score, NaN above every number, the
// lower index on ties; an index < 0 is an empty slot.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  if (i < 0) return false;
  if (bi < 0) return true;
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void take(float s, int v, float& bv, int& bi) {
  if (better(s, v, bv, bi)) { bv = s; bi = v; }
}

// `take` for an index above every index taken so far (a thread's own
// entries, in order): a tie keeps the held one. No branch.
__device__ __forceinline__ void take_next(float s, int v, float& bv, int& bi) {
  const bool up = (bi < 0) | (s > bv) | (isnan(s) & !isnan(bv));
  bv = up ? s : bv;
  bi = up ? v : bi;
}

// The warp's best (value, index), left in lane 0.
__device__ __forceinline__ void warp_best(float& bv, int& bi) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, s);
    const int oi = __shfl_down_sync(0xffffffffu, bi, s);
    take(ov, oi, bv, bi);
  }
}

__device__ __forceinline__ void load_unit(const float* p, float (&x)[kPerThread]) {
  if constexpr (kVectorLoads && kPerThread % 4 == 0) {
#pragma unroll
    for (int j = 0; j < kPerThread; j += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + j);
      x[j] = t.x; x[j + 1] = t.y; x[j + 2] = t.z; x[j + 3] = t.w;
    }
  } else if constexpr (kVectorLoads && kPerThread == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) x[e] = p[e];
  }
}

// This thread's best of units [u0, u1) of the row's body (unit u holds
// entries head + kPerThread u ...), a unit every kThreads, the next
// unit's load in flight while the current one's chains run.
__device__ __forceinline__ void scan_units(const float* row, int head, int u0,
                                           int u1, float temp, uint32_t k0,
                                           uint32_t k1, uint64_t off,
                                           float& bv, int& bi) {
  const float* body = row + head;
  int u = u0 + threadIdx.x;
  float x[kPerThread];
  if (u < u1) load_unit(body + (int64_t)u * kPerThread, x);
  while (u < u1) {
    const int un = u + kThreads;
    float xn[kPerThread];
    if (un < u1) load_unit(body + (int64_t)un * kPerThread, xn);
    const int v0 = head + u * kPerThread;
    float noise[kPerThread];
#pragma unroll
    for (int e = 0; e < kPerThread; ++e)
      noise[e] = gumbel_noise(k0, k1, off + (uint64_t)(v0 + e));
#pragma unroll
    for (int e = 0; e < kPerThread; ++e)
      take_next(__fadd_rn(noise[e], __fdiv_rn(x[e], temp)), v0 + e, bv, bi);
    u = un;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) x[e] = xn[e];
  }
}

// The warps' slots in rank 0: (score bits, index) pairs, and the
// mbarrier that counts their bytes.
struct Slots {
  alignas(8) int pair[kMaxCluster * kWarps][2];
  alignas(8) uint64_t full;
};

// Each warp's best into rank 0's slots; rank 0's first warp then writes
// the best of the cluster's slots to *id.
__device__ __forceinline__ void cluster_best(float bv, int bi, int rank,
                                             Slots& sl, int* id) {
  warp_best(bv, bi);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = gridDim.x * kWarps;
  hp::cluster_wait();   // every block has started: rank 0's slots exist
  if (lane == 0) {
    const uint32_t dst = hp::cluster_addr(sl.pair[rank * kWarps + warp], 0u);
    if constexpr (kAsyncSlots) {
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.s32 [%0], {%1, %2}, [%3];\n"
          ::"r"(dst), "r"(__float_as_int(bv)), "r"(bi), "r"(hp::cluster_addr(&sl.full, 0u))
          : "memory");
    } else {
      asm volatile("st.shared::cluster.v2.s32 [%0], {%1, %2};\n" ::"r"(dst),
                   "r"(__float_as_int(bv)), "r"(bi)
                   : "memory");
    }
  }
  if constexpr (!kAsyncSlots) hp::cluster_sync();
  if (rank != 0 || warp != 0) return;
  if constexpr (kAsyncSlots) {
    if (lane == 0) hp::mbar_expect_tx(&sl.full, uint32_t(n) * 8u);
    hp::mbar_wait(&sl.full, 0);
  }
  bv = 0.0f;
  bi = -1;
  for (int j = lane; j < n; j += 32) take(__int_as_float(sl.pair[j][0]), sl.pair[j][1], bv, bi);
  warp_best(bv, bi);
  if (lane == 0) *id = bi;
}

// Grid (cluster, B), clusters of gridDim.x blocks along x: block rank c
// (= blockIdx.x) of row b = blockIdx.y takes units [c * slice /
// kPerThread, (c + 1) * slice / kPerThread) of the row's body, cut at
// its last whole unit; rank 0 also takes the row's head (the entries
// before its first kAlign-float boundary) and tail (after its last whole
// unit), thread t the head's and the tail's entry t.
__global__ void __launch_bounds__(kThreads) gumbel_argmax_kernel(
    const float* __restrict__ logits, int64_t row_stride, int V,
    const int64_t* __restrict__ keys, const int64_t* __restrict__ offsets,
    float temp, int slice, int* __restrict__ ids) {
  __shared__ Slots sl;
  const int rank = blockIdx.x;
  if (kAsyncSlots && rank == 0 && threadIdx.x == 0) {
    hp::mbar_init(&sl.full, 1);
    hp::fence_barrier_init();
  }
  hp::cluster_arrive_relaxed();
  const int b = blockIdx.y;
  const uint32_t k0 = (uint32_t)keys[2 * b];
  const uint32_t k1 = (uint32_t)keys[2 * b + 1];
  const uint64_t off = (uint64_t)offsets[b];
  const float* row = logits + (int64_t)b * row_stride;
  const int head = min(V, (int)((0 - (reinterpret_cast<uintptr_t>(row) >> 2)) &
                                (uintptr_t)(kAlign - 1)));
  const int units = (V - head) / kPerThread;
  const int tail = V - head - units * kPerThread;
  const int per = slice / kPerThread;
  const int u0 = rank * per;
  const int t = threadIdx.x;
  float bv = 0.0f;
  int bi = -1;
  if (rank == 0 && t < head)
    take_next(score(row[t], temp, k0, k1, off + (uint64_t)t), t, bv, bi);
  scan_units(row, head, u0, min(units, u0 + per), temp, k0, k1, off, bv, bi);
  if (rank == 0 && t < tail) {
    const int v = head + units * kPerThread + t;
    take_next(score(row[v], temp, k0, k1, off + (uint64_t)v), v, bv, bi);
  }
  cluster_best(bv, bi, rank, sl, ids + b);
}

}  // namespace

// The launch plan (ops/sample.py's `plan`): `cluster` blocks a row (1 to
// 16), each of `slice` entries (a multiple of the unit, cluster * slice >=
// V).
extern "C" int lir_gumbel_argmax(const float* logits, int64_t row_stride,
                                 int B, int V, const int64_t* keys,
                                 const int64_t* offsets, float temp,
                                 int cluster, int slice, int* ids,
                                 cudaStream_t stream) {
  if (B <= 0) return 0;
  if (V <= 0 || cluster < 1 || cluster > kMaxCluster || slice <= 0 ||
      slice % kPerThread != 0 || (int64_t)cluster * slice < V || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (cluster > 8) {   // the non-portable size, allowed once a device
    static bool allowed[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && (dev >= 64 || !allowed[dev]))
      err = cudaFuncSetAttribute(gumbel_argmax_kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) allowed[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(cluster), unsigned(B), 1);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gumbel_argmax_kernel, logits,
                                             row_stride, V, keys, offsets, temp,
                                             slice, ids);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The kernel's constants, for the planner's checks: threads a block,
// entries a thread takes at a time, blocks a cluster at most.
extern "C" int lir_sample_threads() { return kThreads; }
extern "C" int lir_sample_per_thread() { return kPerThread; }
extern "C" int lir_sample_max_cluster() { return kMaxCluster; }
