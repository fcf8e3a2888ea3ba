// Variant of src/repro_torch/csrc/gittins.cu (not part of the package):
// the same rows, lanes and arithmetic, but the warps walk the row groups
// with a grid stride over a grid of the blocks the card holds at once,
// instead of one row group a warp.  It lost on the H100 (PERF.md, row 1);
// tools/gittins_variants.py builds and times it beside the package's.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr float kPadSupport = 1e30f;

// Reductions over aligned segments of W lanes (W a power of two <= 32).
// A xor butterfly leaves the same bits in every lane of the segment.
template <int W>
__device__ __forceinline__ float seg_sum(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o, W);
  return v;
}

template <int W>
__device__ __forceinline__ float seg_min(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(kFullMask, v, o, W));
  return v;
}

template <int W>
__device__ __forceinline__ float seg_max(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o, W));
  return v;
}

// Exclusive scans of V independent values over a segment of W lanes (sl is
// the lane's index in its segment); total[v] gets the segment's sum of v.
template <int W, int V>
__device__ __forceinline__ void seg_exclusive_scan(float (&x)[V],
                                                   float (&total)[V],
                                                   int sl) {
#pragma unroll
  for (int o = 1; o < W; o <<= 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float up = __shfl_up_sync(kFullMask, x[v], o, W);
      if (sl >= o) x[v] += up;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    total[v] = __shfl_sync(kFullMask, x[v], W - 1, W);
    const float exc = __shfl_up_sync(kFullMask, x[v], 1, W);
    x[v] = sl == 0 ? 0.0f : exc;
  }
}

// One row's index from its (already loaded) columns: lane sl of the row's
// segment holds c[v][i], p[v][i] at columns v * 4 L + 4 sl + i.
template <int K, int L, int V>
__device__ __forceinline__ float row_index(float (&c)[V][4], float (&p)[V][4],
                                           float att, int sl) {
  att = fmaxf(att, 0.0f);
  const bool cond = att > 0.0f;
  float live = 0.0f, valid_max = -INFINITY;
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float cj = c[v][i], pj = p[v][i];
      const bool valid = pj > 0.0f;
      const bool alive = valid && (!cond || cj > att);
      if (valid) valid_max = fmaxf(valid_max, cj);
      p[v][i] = alive ? pj : 0.0f;
      c[v][i] = alive ? cj - (cond ? att : 0.0f) : kPadSupport;
      live += p[v][i];
    }
  }
  const float psum = seg_sum<L>(live);
  const bool exhausted = cond && psum <= 0.0f;
  const float safe = psum > 0.0f ? psum : 1.0f;

  float mass[V], spent[V], mass_total[V], spent_total[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    mass[v] = 0.0f;
    spent[v] = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float pn = cond ? __fdiv_rn(p[v][i], safe) : p[v][i];
      const float cz = pn > 0.0f ? c[v][i] : 0.0f;  // zero dead columns
      p[v][i] = pn;
      c[v][i] = cz;
      mass[v] += pn;
      spent[v] += cz * pn;
    }
  }
  seg_exclusive_scan<L, V>(mass, mass_total, sl);
  seg_exclusive_scan<L, V>(spent, spent_total, sl);
#pragma unroll
  for (int v = 1; v < V; ++v) {  // the second half follows the first
    mass[v] += mass_total[v - 1];
    spent[v] += spent_total[v - 1];
  }
  float best = INFINITY;
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mass[v] += p[v][i];
      spent[v] += c[v][i] * p[v][i];
      const float num = spent[v] + c[v][i] * (1.0f - mass[v]);
      if (p[v][i] > 0.0f && mass[v] > 1e-12f)
        best = fminf(best, __fdiv_rn(num, fmaxf(mass[v], 1e-12f)));
    }
  }
  best = seg_min<L>(best);
  const float tail = fmaxf(seg_max<L>(valid_max), 1.0f);
  return exhausted ? tail : best;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    gittins_rows_kernel(const float* __restrict__ support,
                        const float* __restrict__ probs,
                        const float* __restrict__ attained,
                        float* __restrict__ out, int n) {
  constexpr int L = (K < 128 ? K : 128) / 4;  // lanes a row
  constexpr int R = 32 / L;                   // rows a warp
  constexpr int V = K / (4 * L);              // float4 a lane per array
  const int lane = threadIdx.x & 31;
  const int sl = lane % L;
  const int groups = (n + R - 1) / R;
  const int stride = gridDim.x * kWarps;
  for (int g = blockIdx.x * kWarps + (threadIdx.x >> 5); g < groups;
       g += stride) {  // uniform across the warp
    const int row = g * R + lane / L;
    const int r = row < n ? row : n - 1;  // a ragged group's spare rows
    const float4* c_row =
        reinterpret_cast<const float4*>(support + static_cast<size_t>(r) * K);
    const float4* p_row =
        reinterpret_cast<const float4*>(probs + static_cast<size_t>(r) * K);
    float c[V][4], p[V][4];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float4 cv = __ldcs(c_row + v * L + sl);
      const float4 pv = __ldcs(p_row + v * L + sl);
      c[v][0] = cv.x, c[v][1] = cv.y, c[v][2] = cv.z, c[v][3] = cv.w;
      p[v][0] = pv.x, p[v][1] = pv.y, p[v][2] = pv.z, p[v][3] = pv.w;
    }
    const float idx = row_index<K, L, V>(c, p, __ldcs(attained + r), sl);
    if (row < n && sl == 0) out[row] = idx;
  }
}

// Blocks of the kernel the card holds at once (cached per device): the
// grid-stride variant's grid (tools/gittins_variants.py).
template <int K>
int resident_blocks() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gittins_rows_kernel<K>, kThreads, 0);
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

template <int K>
int launch(const float* support, const float* probs, const float* attained,
           float* out, int n, cudaStream_t stream) {
  constexpr int R = 32 / ((K < 128 ? K : 128) / 4);
  const int groups = (n + R - 1) / R;
  int blocks = (groups + kWarps - 1) / kWarps;
  const int resident = resident_blocks<K>();
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (blocks > resident) blocks = resident;
  gittins_rows_kernel<K><<<blocks, kThreads, 0, stream>>>(
      support, probs, attained, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// support, probs: (n, k) f32 row-major, 16-byte aligned, k a power of two
// in [8, 256] (the op pads the columns); attained: (n,) f32; out: (n,) f32.
REPRO_EXPORT int gittins_attained(const void* support, const void* probs,
                                  const void* attained, void* out, int n,
                                  int k, void* stream) {
  if (n <= 0 || (reinterpret_cast<uintptr_t>(support) |
                 reinterpret_cast<uintptr_t>(probs)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* s = static_cast<const float*>(support);
  const auto* p = static_cast<const float*>(probs);
  const auto* a = static_cast<const float*>(attained);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 8: return launch<8>(s, p, a, o, n, st);
    case 16: return launch<16>(s, p, a, o, n, st);
    case 32: return launch<32>(s, p, a, o, n, st);
    case 64: return launch<64>(s, p, a, o, n, st);
    case 128: return launch<128>(s, p, a, o, n, st);
    case 256: return launch<256>(s, p, a, o, n, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
