// The streaming-statistics fold: one dispatch's position-0 readouts
// scattered into the sweep's (P, R) accumulator lattice, in place.
//
// No Pallas original: this is the counterpart of the JAX package's
// XLA-fused `fold_update` (lir_tpu/engine/stream_stats.py:114), one
// launch per scoring dispatch.
//
// The bit contract with the plain twin (ops/stream_fold.py,
// `stream_fold_plain`), per row:
//   - the validity predicate of `_row_ok` (stream_stats.py:101-111,
//     itself the numerics guard's check_values): yes and no finite in
//     [-1e-4, 1 + 1e-4], yes + no <= 1 + 1e-3, wconf finite in
//     [-1e-3, 100 + 1e-3], the row's K log-probs free of NaN and none
//     above 1e-4; every bound the float32 rounding of the double
//     constant, as JAX compares a float32 array with a Python float;
//     `guard` = 0 accepts every row;
//   - rel = yes / (yes + no) where valid with mass, else NaN; conf =
//     wconf where valid, else NaN; dec = (yes > no) where valid with
//     mass, else -1; filled = 1. Built without --use_fast_math, so the
//     division is correctly rounded: bitwise the plain twin's;
//   - the four stores at (pidx, ridx), skipped for a slot outside the
//     lattice: pad rows carry ridx = R (the counterpart of the JAX
//     scatter's mode="drop"), so no host sync drops them. No two real
//     rows of one dispatch share a slot (the sweep's cells are
//     distinct), so the stores' order does not matter.
// Inputs are read through their element strides (the grouped dispatch's
// readouts are every other row of a view).
//
// The design on the H100: one warp a row, B warps a block up to 32 (more
// blocks past B = 32). Every load is issued before any test: the slot,
// the three readouts and the row's log-probs (a lane each, coalesced
// where the columns are contiguous), so the kernel makes one round trip
// to memory; the lanes' log-prob tests are joined with __all_sync, and
// lane 0 tests the rest and makes the four stores.
//
// What bounds it on the H100: neither bytes (B * (20 + 4K) read, B * 16
// written: ~4 KB at B = 32, K = 20, a microsecond's thousandth at 3.35
// TB/s) nor operations; it is one launch and one round trip to memory,
// the time of an empty kernel plus that round trip.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kPLo = -(float)1e-4;
constexpr float kPHi = (float)(1.0 + 1e-4);
constexpr float kSumHi = (float)(1.0 + 1e-3);
constexpr float kConfLo = -(float)1e-3;
constexpr float kConfHi = (float)(100.0 + 1e-3);
constexpr float kLpHi = (float)1e-4;
constexpr int kMaxWarps = 32;   // rows a block

__device__ __forceinline__ bool in_range(float v, float lo, float hi) {
  return isfinite(v) && v >= lo && v <= hi;
}

__device__ __forceinline__ bool lp_ok(float v) {
  return !isnan(v) && !(v > kLpHi);
}

__global__ void __launch_bounds__(kMaxWarps * 32) stream_fold_kernel(
    const float* __restrict__ yes, int64_t s_yes,
    const float* __restrict__ no, int64_t s_no,
    const float* __restrict__ wconf, int64_t s_wc,
    const float* __restrict__ lp, int64_t s_lp_row, int64_t s_lp_col, int K,
    const int* __restrict__ pidx, const int* __restrict__ ridx, int B,
    int* __restrict__ filled, float* __restrict__ rel,
    float* __restrict__ conf, int* __restrict__ dec, int P, int R,
    int guard) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;   // the whole warp
  // Every load first: one round trip.
  const int p = pidx[b];
  const int r = ridx[b];
  const float y = yes[b * s_yes];
  const float n = no[b * s_no];
  const float w = wconf[b * s_wc];
  const float* row = lp + b * s_lp_row;
  bool lanes_ok = true;
  if (guard) {
    const float v = lane < K ? row[lane * s_lp_col] : 0.0f;
    lanes_ok = lp_ok(v);
    for (int k = lane + 32; k < K; k += 32) lanes_ok &= lp_ok(row[k * s_lp_col]);
  }
  const bool all_lp = __all_sync(0xffffffffu, lanes_ok);
  if (lane != 0 || p < 0 || p >= P || r < 0 || r >= R) return;   // pad row: dropped
  bool ok = true;
  if (guard)
    ok = in_range(y, kPLo, kPHi) && in_range(n, kPLo, kPHi) &&
         (y + n) <= kSumHi && in_range(w, kConfLo, kConfHi) && all_lp;
  const float total = y + n;
  const bool mass = ok && total > 0.0f;
  const float qnan = __int_as_float(0x7fc00000);
  const int64_t at = (int64_t)p * R + r;
  filled[at] = 1;
  rel[at] = mass ? __fdiv_rn(y, total) : qnan;
  conf[at] = ok ? w : qnan;
  dec[at] = mass ? (y > n ? 1 : 0) : -1;
}

}  // namespace

extern "C" int lir_stream_fold(
    const float* yes, int64_t s_yes, const float* no, int64_t s_no,
    const float* wconf, int64_t s_wc, const float* lp, int64_t s_lp_row,
    int64_t s_lp_col, int K, const int* pidx, const int* ridx, int B,
    int* filled, float* rel, float* conf, int* dec, int P, int R, int guard,
    cudaStream_t stream) {
  if (B <= 0) return 0;
  const int warps = B < kMaxWarps ? B : kMaxWarps;
  const int blocks = (B + warps - 1) / warps;
  stream_fold_kernel<<<blocks, warps * 32, 0, stream>>>(
      yes, s_yes, no, s_no, wconf, s_wc, lp, s_lp_row, s_lp_col, K, pidx,
      ridx, B, filled, rel, conf, dec, P, R, guard);
  return (int)cudaGetLastError();
}
