// The fused decode step's sampled draw: JAX's threefry2x32 fold_in and
// Gumbel-max categorical, bit for bit up to the two logarithms.
//
// Replaces the draw the reference's fused step makes through XLA
// (src/repro/serving/engine.py:304-316; no Pallas kernel):
//
//   key  = fold_in(fold_in(PRNGKey(engine seed), request seed), position)
//   tok  = categorical(key, logits.astype(f32) / temperature)
//
// per lane, over the columns offset .. offset + n - 1 of the whole row (a
// vocab shard of a plan draws exactly its columns).  The bits follow
// kernels/categorical/ref.py, which states the JAX settings they follow:
// column j's 32 bits are word 0 XOR word 1 of threefry2x32(key, (0, offset
// + j)); u = max(tiny, ((bits >> 9) | 0x3F800000) as f32 - 1 + tiny); the
// noise -logf(-logf(u)) with IEEE logf (the library's, not __logf; the
// build has no --use_fast_math); a sampled lane scores __fdiv_rn(x, t) +
// noise, a greedy lane its raw logit x (no noise drawn).  The winner is
// the largest score, NaN the largest, ties to the lowest column, as
// torch.argmax picks.
//
// What bounds it on the H100: integer operations.  A sampled column costs
// about 73 of them in the source (20 rounds of add, funnel-shift rotate and
// xor, 10 key injections, the uniform's xor, shift and or) for 2 or 4 bytes
// of logits, far
// above the card's operations-per-byte ridge; wgmma has nothing to offer.
//
// Design.  Launch 1: a (blocks, lanes) grid; each block takes one fixed
// slice of ceil(n / blocks) columns of its lane (the caller's block count,
// kernels/categorical/ops.py::COLUMN_BLOCKS, depends neither on the batch
// nor on the table width), thread 0 derives
// the lane's key (two fold_ins) into shared memory, each thread streams
// its columns with the counters in registers, and the block reduces to one
// (value, column) partial.  Launch 2: one warp a lane merges the lane's
// blocks partials.  No atomics; the reduction is exact (a max with
// a total tie order), so the pick never depends on the split.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr float kTiny = 1.17549435e-38f;  // FLT_MIN, finfo(f32).tiny
constexpr int kNoColumn = 0x7fffffff;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

// Threefry-2x32, 20 rounds, of the counter (x0, x1) under the key (k0, k1).
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0; x1 += k1;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1; x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2; x1 += k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0; x1 += k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1; x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

// Whether (v, i) wins over (w, j): the larger value, NaN the largest, ties
// (and two NaNs) to the lower column.
__device__ __forceinline__ bool wins(float v, int i, float w, int j) {
  const bool vn = isnan(v), wn = isnan(w);
  if (vn || wn) return vn && (!wn || i < j);
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(kFullMask, v, o);
    const int j = __shfl_xor_sync(kFullMask, i, o);
    if (wins(w, j, v, i)) { v = w; i = j; }
  }
}

__device__ __forceinline__ float load_logit(const float* p) { return *p; }
__device__ __forceinline__ float load_logit(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The noise of the column whose 32 random bits are `bits`.
__device__ __forceinline__ float gumbel_of(uint32_t bits) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  // f * (1 - tiny) + tiny: 1 - tiny is 1.0f, so the product is f exactly
  const float u = fmaxf(kTiny, __fadd_rn(f, kTiny));
  return -logf(-logf(u));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    categorical_partial_kernel(const T* __restrict__ logits, long long ld,
                               const float* __restrict__ temps,
                               const bool* __restrict__ greedy,
                               const long long* __restrict__ seeds,
                               const long long* __restrict__ counters,
                               uint32_t base0, uint32_t base1, int n,
                               long long offset, float* __restrict__ part_v,
                               int* __restrict__ part_i) {
  __shared__ uint32_t key[2];
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  const int lane_row = blockIdx.y;
  const int blocks = gridDim.x;
  const int per = (n + blocks - 1) / blocks;
  const int lo = blockIdx.x * per;
  const int hi = min(n, lo + per);
  const bool is_greedy = greedy[lane_row];
  if (threadIdx.x == 0 && !is_greedy) {
    // fold_in(fold_in(base, seed), counter): threefry of (0, data)
    const uint2 k = threefry2x32(base0, base1, 0u,
                                 static_cast<uint32_t>(seeds[lane_row]));
    const uint2 kk = threefry2x32(k.x, k.y, 0u,
                                  static_cast<uint32_t>(counters[lane_row]));
    key[0] = kk.x;
    key[1] = kk.y;
  }
  __syncthreads();
  const T* row = logits + lane_row * ld;
  float best_v = -INFINITY;
  int best_i = kNoColumn;
  if (is_greedy) {
    for (int j = lo + threadIdx.x; j < hi; j += kThreads) {
      const float x = load_logit(row + j);
      if (wins(x, j, best_v, best_i)) { best_v = x; best_i = j; }
    }
  } else {
    const uint32_t k0 = key[0], k1 = key[1];
    const float t = temps[lane_row];
    for (int j = lo + threadIdx.x; j < hi; j += kThreads) {
      const uint2 b = threefry2x32(
          k0, k1, 0u, static_cast<uint32_t>(offset + j));
      const float s =
          __fadd_rn(__fdiv_rn(load_logit(row + j), t), gumbel_of(b.x ^ b.y));
      if (wins(s, j, best_v, best_i)) { best_v = s; best_i = j; }
    }
  }
  warp_best(best_v, best_i);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    red_v[warp] = best_v;
    red_i[warp] = best_i;
  }
  __syncthreads();
  if (warp == 0) {
    best_v = (threadIdx.x < kThreads / 32) ? red_v[threadIdx.x] : -INFINITY;
    best_i = (threadIdx.x < kThreads / 32) ? red_i[threadIdx.x] : kNoColumn;
    warp_best(best_v, best_i);
    if (threadIdx.x == 0) {
      part_v[lane_row * blocks + blockIdx.x] = best_v;
      part_i[lane_row * blocks + blockIdx.x] = best_i;
    }
  }
}

// One warp a lane: the lane's `blocks` partials to its winner.
__global__ void __launch_bounds__(32)
    categorical_merge_kernel(const float* __restrict__ part_v,
                             const int* __restrict__ part_i, int blocks,
                             float* __restrict__ value,
                             long long* __restrict__ index) {
  const int lane_row = blockIdx.x;
  float best_v = -INFINITY;
  int best_i = kNoColumn;
  for (int b = threadIdx.x; b < blocks; b += 32) {
    const float v = part_v[lane_row * blocks + b];
    const int i = part_i[lane_row * blocks + b];
    if (wins(v, i, best_v, best_i)) { best_v = v; best_i = i; }
  }
  warp_best(best_v, best_i);
  if (threadIdx.x == 0) {
    value[lane_row] = best_v;
    index[lane_row] = best_i;
  }
}

}  // namespace

// Each lane's row is split into `blocks` column slices; scratch part_v (f32)
// and part_i (int32) hold lanes * blocks partials.  logits: (lanes, n) rows
// ld elements apart, bf16 (is_bf16) or
// f32; temps f32, greedy bool, seeds and counters int64 (their low 32 bits
// are the uint32 data folded in), one a lane; base0, base1 the words of
// PRNGKey(engine seed).  Writes value (f32) and index (int64, the column
// within these n) a lane.
REPRO_EXPORT int categorical_sample(const void* logits, int is_bf16,
                                    long long ld, const void* temps,
                                    const void* greedy, const void* seeds,
                                    const void* counters, unsigned base0,
                                    unsigned base1, void* part_v,
                                    void* part_i, int blocks, void* value,
                                    void* index, int lanes, int n,
                                    long long offset, void* stream) {
  if (lanes <= 0 || n <= 0 || ld < n || lanes > 65535 || offset < 0 ||
      offset + n > (1LL << 32) || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, lanes);
  const auto* t = static_cast<const float*>(temps);
  const auto* g = static_cast<const bool*>(greedy);
  const auto* s = static_cast<const long long*>(seeds);
  const auto* c = static_cast<const long long*>(counters);
  auto* pv = static_cast<float*>(part_v);
  auto* pi = static_cast<int*>(part_i);
  if (is_bf16)
    categorical_partial_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), ld, t, g, s, c, base0,
        base1, n, offset, pv, pi);
  else
    categorical_partial_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(logits), ld, t, g, s, c, base0, base1, n,
        offset, pv, pi);
  categorical_merge_kernel<<<lanes, 32, 0, st>>>(
      pv, pi, blocks, static_cast<float*>(value),
      static_cast<long long*>(index));
  return static_cast<int>(cudaGetLastError());
}
