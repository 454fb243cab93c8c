// Temperature sampling by the Gumbel-max trick with JAX's threefry draws:
// one launch picks each row's next token.
//
// No Pallas original: this stands in for the JAX package's XLA
// `jax.random.categorical` in `sample_decode`
// (lir_tpu/engine/generate.py:1442-1447), which is
// argmax(gumbel(key, shape) + logits / temperature). Per row b and vocab
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
// contraction changes a rounding; the plain twin (ops/sample.py) runs
// the same chain in torch.
//
// What bounds it on the H100: integer operations. Each element costs ~77
// INT32 operations (the 20 rounds' add, rotate and xor, the five key
// injections, the counter, the bits) and reads 4 bytes; at V = 32,000
// that is ~2.5 M operations against 128 KB a row. One block per row
// would leave most SMs idle at B = 8, so each row is cut into chunks, a
// block a chunk (about two blocks per SM over the whole grid): each
// block reduces its chunk to one (score, index) with warp shuffles, and
// the last block of a row to finish (a ticket counter) reduces the
// row's partials, writes the id and clears the ticket for the next
// launch. One launch a step, no memset.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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

__device__ __forceinline__ float gumbel_score(float logit, float temp,
                                              uint32_t k0, uint32_t k1,
                                              uint64_t counter) {
  const uint32_t bits = threefry_bits(k0, k1, counter);
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(kTiny, __fadd_rn(f, kTiny));
  const float noise = -logf(-logf(u));
  return __fadd_rn(noise, __fdiv_rn(logit, temp));
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

// The block's best (value, index), left in thread 0.
__device__ __forceinline__ void block_best(float& bv, int& bi) {
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, s);
    const int oi = __shfl_down_sync(0xffffffffu, bi, s);
    if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { warp_v[warp] = bv; warp_i[warp] = bi; }
  __syncthreads();
  if (warp == 0) {
    bv = lane < kWarps ? warp_v[lane] : 0.0f;
    bi = lane < kWarps ? warp_i[lane] : -1;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, s);
      const int oi = __shfl_down_sync(0xffffffffu, bi, s);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
  }
}

__global__ void __launch_bounds__(kThreads) gumbel_argmax_kernel(
    const float* __restrict__ logits, int64_t row_stride, int V,
    const int64_t* __restrict__ keys, const int64_t* __restrict__ offsets,
    float temp, int chunk, float* __restrict__ part_v,
    int* __restrict__ part_i, unsigned int* __restrict__ tickets,
    int* __restrict__ ids) {
  const int b = blockIdx.y;
  const int c = blockIdx.x;
  const int nchunks = gridDim.x;
  const uint32_t k0 = (uint32_t)keys[2 * b];
  const uint32_t k1 = (uint32_t)keys[2 * b + 1];
  const uint64_t off = (uint64_t)offsets[b];
  const float* row = logits + (int64_t)b * row_stride;
  const int end = min(V, (c + 1) * chunk);
  float bv = 0.0f;
  int bi = -1;
  for (int v = c * chunk + threadIdx.x; v < end; v += kThreads) {
    const float s = gumbel_score(row[v], temp, k0, k1, off + (uint64_t)v);
    if (better(s, v, bv, bi)) { bv = s; bi = v; }
  }
  block_best(bv, bi);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    part_v[b * nchunks + c] = bv;
    part_i[b * nchunks + c] = bi;
    __threadfence();
    last = atomicAdd(&tickets[b], 1u) == (unsigned int)(nchunks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  bv = 0.0f;
  bi = -1;
  for (int j = threadIdx.x; j < nchunks; j += kThreads) {
    const float v = __ldcg(part_v + b * nchunks + j);
    const int i = __ldcg(part_i + b * nchunks + j);
    if (better(v, i, bv, bi)) { bv = v; bi = i; }
  }
  __syncthreads();   // block_best's shared slots are reused
  block_best(bv, bi);
  if (threadIdx.x == 0) {
    ids[b] = bi;
    tickets[b] = 0u;
  }
}

}  // namespace

extern "C" int lir_gumbel_argmax(const float* logits, int64_t row_stride,
                                 int B, int V, const int64_t* keys,
                                 const int64_t* offsets, float temp,
                                 int nchunks, int chunk, float* part_v,
                                 int* part_i, unsigned int* tickets, int* ids,
                                 cudaStream_t stream) {
  if (B <= 0) return 0;
  const dim3 grid(nchunks, B);
  gumbel_argmax_kernel<<<grid, kThreads, 0, stream>>>(
      logits, row_stride, V, keys, offsets, temp, chunk, part_v, part_i,
      tickets, ids);
  return (int)cudaGetLastError();
}

extern "C" int lir_sample_threads() { return kThreads; }
