// Batched Gittins index of bucketized cost distributions, conditioned on
// X > attained: the scheduler's batched priority refresh.
//
// Replaces src/repro/kernels/gittins/kernel.py::gittins_kernel (its
// pl.pallas_call at kernel.py:55) together with the conditioning that
// src/repro/kernels/gittins/ops.py::_attained_op (ops.py:57-78) does in jnp
// around it.  Per row, with c the support, p the probabilities and
// a = max(attained, 0):
//
//   alive_j  = p_j > 0 and (a == 0 or c_j > a)
//   p'_j     = alive_j ? p_j / sum(alive p) : 0     (no division if a == 0)
//   c'_j     = alive_j ? c_j - a : PAD_SUPPORT
//   index    = min_j E[min(X', c'_j)] / P(X' <= c'_j)   over live j
//            = min_j (S_j + c'_j (1 - M_j)) / M_j,  M, S prefix sums of
//              p' and c' p'
//   exhausted rows (a > 0, no live mass) return max(max valid c, 1).
//
// What bounds it on the H100: bytes and launch latency.  A row reads 8k
// bytes and does ~10k flops, far under the card's 295 flop/byte ridge, and
// at scheduler batch sizes (n up to a few thousand, k <= 256) the whole
// call moves a few MB: it is over in a few microseconds, so the launch and
// the host copies around it dominate.
//
// Design: one warp per row, 8 rows per 256-thread block.  Lane l holds the
// contiguous columns [l*per, (l+1)*per), per = ceil(k/32) <= 8, in
// registers; the row is read once.  One warp sum gives the live mass, each
// lane then takes sequential prefix sums over its own columns and a warp
// exclusive scan of the lane totals gives each lane its base, so both prefix
// sums cost one shuffle scan each.  A warp min gives the index and a warp max
// the exhausted-row tail.  f32 throughout.  Dead columns are zeroed before
// any product (the Pallas kernel's guard, kernel.py:27-30): 1e30 * 0 is 0,
// but inf * 0 is NaN.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxPerLane = 8;  // k <= 256 (BatchState max_k)
constexpr int kRowsPerBlock = 8;
constexpr float kPadSupport = 1e30f;

__global__ void gittins_attained_kernel(const float* __restrict__ support,
                                        const float* __restrict__ probs,
                                        const float* __restrict__ attained,
                                        float* __restrict__ out, int n,
                                        int k) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // uniform across the warp
  const float* c_row = support + static_cast<size_t>(row) * k;
  const float* p_row = probs + static_cast<size_t>(row) * k;
  const int per = (k + 31) / 32;
  const int j0 = lane * per;

  const float att = fmaxf(attained[row], 0.0f);
  const bool cond = att > 0.0f;
  float c[kMaxPerLane], p[kMaxPerLane];
  float live_mass = 0.0f;
  float valid_max = -INFINITY;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int j = j0 + i;
    const bool in = i < per && j < k;
    const float cj = in ? c_row[j] : 0.0f;
    const float pj = in ? p_row[j] : 0.0f;
    const bool valid = pj > 0.0f;
    const bool alive = valid && (!cond || cj > att);
    if (valid) valid_max = fmaxf(valid_max, cj);
    p[i] = alive ? pj : 0.0f;
    c[i] = alive ? cj - (cond ? att : 0.0f) : kPadSupport;
    live_mass += p[i];
  }
  const float psum = warp_sum(live_mass);
  const bool exhausted = cond && psum <= 0.0f;
  const float safe = psum > 0.0f ? psum : 1.0f;

  float lane_mass = 0.0f, lane_spent = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const float pn = cond ? p[i] / safe : p[i];
    const float cz = pn > 0.0f ? c[i] : 0.0f;  // zero dead columns first
    p[i] = pn;
    c[i] = cz;
    lane_mass += pn;
    lane_spent += cz * pn;
  }
  float mass = warp_exclusive_scan(lane_mass, lane);
  float spent = warp_exclusive_scan(lane_spent, lane);
  float best = INFINITY;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    mass += p[i];
    spent += c[i] * p[i];
    const float num = spent + c[i] * (1.0f - mass);
    if (p[i] > 0.0f && mass > 1e-12f)
      best = fminf(best, num / fmaxf(mass, 1e-12f));
  }
  best = warp_min(best);
  const float tail = fmaxf(warp_max(valid_max), 1.0f);
  if (lane == 0) out[row] = exhausted ? tail : best;
}

}  // namespace

// support, probs: (n, k) f32 row-major; attained: (n,) f32; out: (n,) f32.
REPRO_EXPORT int gittins_attained(const void* support, const void* probs,
                                  const void* attained, void* out, int n,
                                  int k, void* stream) {
  if (n <= 0 || k <= 0 || k > 32 * kMaxPerLane)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  gittins_attained_kernel<<<blocks, 32 * kRowsPerBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(support), static_cast<const float*>(probs),
      static_cast<const float*>(attained), static_cast<float*>(out), n, k);
  return static_cast<int>(cudaGetLastError());
}
