// The flash backward kernel of the port before its redesign on wgmma
// (src/repro_torch/csrc/flash_attention_bwd.cu), kept unchanged so that
// tools/flash_bwd_variants.py and chip_smoke.py can time it beside the
// package's kernel in one call.  The same C entry point.
//
// The backward of the prefill flash attention (csrc/flash_attention.cu):
// dq, dk and dv of causal, windowed or bidirectional GQA attention with
// explicit query and key positions, for training.
//
// The JAX package has no twin: it trains through the jnp function
// src/repro/models/attention.py::gqa_attention by XLA autodiff, and its
// Pallas flash kernel (src/repro/kernels/flash_attention/kernel.py:73) has
// no backward.  The function is that autodiff's, by the explicit formula
// (kernels/flash_attention/ref.py::attention_backward_reference): with the
// forward's output O and its natural-log log-sum-exp per row (the
// flash_attention_prefill_lse instance),
//   P = exp(S scale - lse)  (0 where the key is not visible),
//   D = rowsum(dO * O),  dS = P * (dO V^T - D),
//   dV = P^T dO,  dK = dS^T Q scale,  dQ = dS K scale,
// dk and dv of a kv head summed over its H / KV query heads.  A key j is
// visible to query i iff kv_pos[j] >= 0 and (if causal) pos[i] >= kv_pos[j]
// and (if window > 0) pos[i] - kv_pos[j] < window, the forward's masks.  P
// is recomputed as exp2(s * scale log2 e - lse log2 e) and set to exactly 0
// for a key that is not visible.
//
// One C call, three kernels on the given stream:
//   1. flash_bwd_dsum_kernel: D per (batch, head, query) in f32, one warp a
//      row;
//   2. flash_bwd_dkdv_kernel: a block per (64-row key tile, 64-column block
//      of dh, kv head, batch row).  It loops over the kv head's query heads
//      and, for each, over the 64-row query tiles that the masks let see the
//      key tile (by the position ranges, as the forward skips tiles),
//      accumulating dK and dV of its rows and columns in f32 registers: no
//      atomics, one fixed order, so the result is deterministic;
//   3. flash_bwd_dq_kernel: a block per (64-row query tile, 64-column block
//      of dh, query head, batch row), looping over the visible key tiles.
// Four warps a block, each owning 16 rows of the block's tile.  Every
// product is mma.sync m16n8k16 (bf16 in, f32 accumulate) from shared rows
// padded by 16 bytes (ldmatrix rows on distinct banks): S^T = K Q^T and
// dP^T = V dO^T in the dK/dV kernel (so P^T and dS^T land in the
// accumulator layout that is the next product's A fragment), S = Q K^T
// and dP = dO V^T in the dQ kernel.  P and dS are f32 and enter their
// products as two bf16 parts, hi + lo (to ~2^-16 relative), as the forward
// takes p; q, k, v and dO are bf16 already.  A block of a column block
// recomputes S and dP over the full dh (at dh 128 and 192 that work is
// done two and three times): the accumulators stay 64 floats a thread at
// every head dim, and the kernel stays simple.  A first kernel: no
// pipelining of the tile loads, no wgmma (later work, ROADMAP Queue B).
//
// Ragged edges: query rows past Sq and key rows past Sk are loaded as zeros
// and count as not visible; their gradients are not stored.  A key row at a
// negative position gets dk = dv = 0.
#include <climits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kT = 64;         // rows of a query or key tile
constexpr int kDC = 64;        // output columns a block
constexpr int kThreads = 128;  // four warps, 16 tile rows each
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Smem {
  static constexpr int kLd = DH + 8;  // bf16 row stride of a staged tile
  static constexpr int kTile = kT * kLd;
  // four tiles (dK/dV: K, V, Q, dO; dQ: Q, dO, K, V), then per-row ints
  // and floats
  static constexpr size_t kBytes = 4 * kTile * 2 + 4 * kT * 4;
};

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  return kp >= 0 && (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
}

// Stage `rows` rows of DH bf16 (row stride `gstride` elements) into shared
// rows of kLd; rows at or past `valid` are zero.
template <int DH>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           size_t gstride, int valid,
                                           int tid) {
  constexpr int kVec = DH / 8, kLd = Smem<DH>::kLd;
  for (int i = tid; i < kT * kVec; i += kThreads) {
    const int r = i / kVec, c = i % kVec;
    const int rr = r < valid ? r : 0;  // a readable address either way
    cp_async16(dst + r * kLd + c * 8, src + rr * gstride + c * 8,
               r < valid ? 16 : 0);
  }
}

// A fragment (m16k16) of a row-major bf16 tile (row stride ld), rows r0 ..
// r0 + 15, columns k0 .. k0 + 15.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* base, int ld,
                                       int r0, int k0, int lane) {
  const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = k0 + (lane >> 4) * 8;
  ldmatrix_x4(a, smem_u32(base + r * ld + c));
}

// B fragments (k16n8) of the n8 tiles n0 and n0 + 8 from a tile stored
// [n][k]: b[0], b[1] of tile n0, b[2], b[3] of n0 + 8.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4],
                                          const __nv_bfloat16* base, int ld,
                                          int n0, int k0, int lane) {
  const int r = n0 + (lane & 7) + (lane >> 4) * 8;
  const int c = k0 + ((lane >> 3) & 1) * 8;
  ldmatrix_x4(b, smem_u32(base + r * ld + c));
}

// The same from a tile stored [k][n] (transposed on the way in).
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4],
                                          const __nv_bfloat16* base, int ld,
                                          int n0, int k0, int lane) {
  const int r = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = n0 + (lane >> 4) * 8;
  ldmatrix_x4_trans(b, smem_u32(base + r * ld + c));
}

// acc (16 x 64, eight n8 tiles) = A rows r0 .. r0 + 15 of tile `a` times
// the 64 rows of tile `b` (stored [n][k]), contracted over DH.
template <int DH>
__device__ __forceinline__ void product_nk(float (&acc)[8][4],
                                           const __nv_bfloat16* a,
                                           const __nv_bfloat16* b, int r0,
                                           int lane) {
  constexpr int kLd = Smem<DH>::kLd;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t af[4];
    load_a(af, a, kLd, r0, ks * 16, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t r[4];
      load_b_nk(r, b, kLd, np * 16, ks * 16, lane);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_m16n8k16_bf16(acc[2 * np], af, b0);
      mma_m16n8k16_bf16(acc[2 * np + 1], af, b1);
    }
  }
}

// acc (16 x 64) += X (16 x 64, f32 in the accumulator layout of eight n8
// tiles, the A operand: its columns are the contraction) times columns c0
// .. c0 + 63 of tile `b` (stored [k][n], 64 rows), X in two bf16 parts.
template <int DH>
__device__ __forceinline__ void product_acc(float (&acc)[8][4],
                                            const float (&x)[8][4],
                                            const __nv_bfloat16* b, int c0,
                                            int lane) {
  constexpr int kLd = Smem<DH>::kLd;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // accumulator tiles 2kk and 2kk + 1 are the A fragment's columns
    // 16kk .. 16kk + 7 and + 8 .. + 15
    uint32_t p0[2], p1[2], p2[2], p3[2];
    split_bf16x2_parts<2>(x[2 * kk][0], x[2 * kk][1], p0);
    split_bf16x2_parts<2>(x[2 * kk][2], x[2 * kk][3], p1);
    split_bf16x2_parts<2>(x[2 * kk + 1][0], x[2 * kk + 1][1], p2);
    split_bf16x2_parts<2>(x[2 * kk + 1][2], x[2 * kk + 1][3], p3);
    const uint32_t hi[4] = {p0[0], p1[0], p2[0], p3[0]};
    const uint32_t lo[4] = {p0[1], p1[1], p2[1], p3[1]};
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t r[4];
      load_b_kn(r, b, kLd, c0 + np * 16, kk * 16, lane);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_m16n8k16_bf16(acc[2 * np], hi, b0);
      mma_m16n8k16_bf16(acc[2 * np], lo, b0);
      mma_m16n8k16_bf16(acc[2 * np + 1], hi, b1);
      mma_m16n8k16_bf16(acc[2 * np + 1], lo, b1);
    }
  }
}

// The smallest and largest of the valid positions among the tile's rows
// r0 .. r0 + 63 (rows below n), over the warp; (INT_MAX, INT_MIN) if none.
// With `keys`, a negative position is not valid.
__device__ __forceinline__ void tile_range(const int* __restrict__ pos, int r0,
                                           int n, bool keys, int lane,
                                           int& lo, int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = r0 + lane + 32 * j;
    if (r < n) {
      const int p = pos[r];
      if (!keys || p >= 0) {
        lo = min(lo, p);
        hi = max(hi, p);
      }
    }
  }
  lo = __reduce_min_sync(kFullMask, lo);
  hi = __reduce_max_sync(kFullMask, hi);
}

// Whether some (query, key) pair of two tiles, by their position ranges,
// can be visible.
__device__ __forceinline__ bool tiles_meet(int qmin, int qmax, int kmin,
                                           int kmax, int causal, int window) {
  if (qmin > qmax || kmin > kmax) return false;
  if (causal && qmax < kmin) return false;
  if (window > 0 && qmin - kmax >= window) return false;
  return true;
}

// ------------------------------------------------------- 1. D = rowsum

template <int DH>
__global__ void __launch_bounds__(256)
    flash_bwd_dsum_kernel(const __nv_bfloat16* __restrict__ out,
                          const __nv_bfloat16* __restrict__ dout,
                          float* __restrict__ dsum, int B, int Sq, int H) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);  // (b, i, h)
  const int lane = threadIdx.x & 31;
  if (row >= B * Sq * H) return;
  const size_t base = static_cast<size_t>(row) * DH;
  float acc = 0.0f;
#pragma unroll
  for (int c = 2 * lane; c < DH; c += 64) {
    const float2 o = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(out + base + c));
    const float2 d = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(dout + base + c));
    acc = fmaf(o.x, d.x, acc);
    acc = fmaf(o.y, d.y, acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = row % H, i = (row / H) % Sq, b = row / (H * Sq);
    dsum[(static_cast<size_t>(b) * H + h) * Sq + i] = acc;
  }
}

// --------------------------------------------------------- 2. dK and dV

template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          const int* __restrict__ qpos,
                          const int* __restrict__ kpos,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int Sq, int Sk,
                          int H, int KV, int causal, int window, float scale,
                          float scale_log2) {
  using S = Smem<DH>;
  constexpr int kChunks = DH / kDC;
  const int kt = blockIdx.x / kChunks, c0 = (blockIdx.x % kChunks) * kDC;
  const int g = blockIdx.y, b = blockIdx.z, rep = H / KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, c2 = (lane & 3) * 2;
  const int k0 = kt * kT, r0 = warp * 16;

  extern __shared__ __align__(16) unsigned char bwd_smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* v_s = k_s + S::kTile;
  __nv_bfloat16* q_s = v_s + S::kTile;
  __nv_bfloat16* do_s = q_s + S::kTile;
  int* qpos_s = reinterpret_cast<int*>(do_s + S::kTile);
  int* kpos_s = qpos_s + kT;
  float* lse_s = reinterpret_cast<float*>(kpos_s + kT);
  float* d_s = lse_s + kT;

  const size_t kv_stride = static_cast<size_t>(KV) * DH;
  const size_t kv_off = (static_cast<size_t>(b) * Sk + k0) * kv_stride +
                        static_cast<size_t>(g) * DH;
  stage_rows<DH>(k_s, k + kv_off, kv_stride, Sk - k0, tid);
  stage_rows<DH>(v_s, v + kv_off, kv_stride, Sk - k0, tid);
  cp_async_commit();
  if (tid < kT) kpos_s[tid] = k0 + tid < Sk ? kpos[k0 + tid] : -1;
  int kmin, kmax;
  tile_range(kpos, k0, Sk, true, lane, kmin, kmax);

  float acc_dk[8][4], acc_dv[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[i][e] = acc_dv[i][e] = 0.0f;

  const size_t q_stride = static_cast<size_t>(H) * DH;
  const int n_qt = (Sq + kT - 1) / kT;
  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const float* lse_bh = lse + (static_cast<size_t>(b) * H + h) * Sq;
    const float* d_bh = dsum + (static_cast<size_t>(b) * H + h) * Sq;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kT;
      int qmin, qmax;
      tile_range(qpos, q0, Sq, false, lane, qmin, qmax);
      if (!tiles_meet(qmin, qmax, kmin, kmax, causal, window)) continue;
      __syncthreads();  // the previous query tile is read
      const size_t q_off = (static_cast<size_t>(b) * Sq + q0) * q_stride +
                           static_cast<size_t>(h) * DH;
      stage_rows<DH>(q_s, q + q_off, q_stride, Sq - q0, tid);
      stage_rows<DH>(do_s, dout + q_off, q_stride, Sq - q0, tid);
      cp_async_commit();
      if (tid < kT) {
        const bool ok = q0 + tid < Sq;
        qpos_s[tid] = ok ? qpos[q0 + tid] : INT_MIN;
        lse_s[tid] = ok ? lse_bh[q0 + tid] : 0.0f;
        d_s[tid] = ok ? d_bh[q0 + tid] : 0.0f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // S^T (this warp's 16 keys x 64 queries) and dP^T
      float st[8][4], dpt[8][4];
      product_nk<DH>(st, k_s, q_s, r0, lane);
      product_nk<DH>(dpt, v_s, do_s, r0, lane);
      // P^T and dS^T: element (key r0 + gr (+8), query 8 nt + c2 (+1))
      const int kp0 = kpos_s[r0 + gr], kp1 = kpos_s[r0 + gr + 8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * nt + c2 + (e & 1);
          const int qp = qpos_s[qi];
          const bool vis = q0 + qi < Sq &&
                           visible(qp, e < 2 ? kp0 : kp1, causal, window);
          const float p =
              vis ? exp2f(fmaf(st[nt][e], scale_log2, -lse_s[qi] * kLog2e))
                  : 0.0f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - d_s[qi]);
        }
      product_acc<DH>(acc_dv, st, do_s, c0, lane);
      product_acc<DH>(acc_dk, dpt, q_s, c0, lane);
    }
  }

  cp_async_wait<0>();  // the tiles' copies, when no query tile met them
  const int kr0 = k0 + r0 + gr, kr1 = kr0 + 8;
  __nv_bfloat16* dk0 = dk + (static_cast<size_t>(b) * Sk + kr0) * kv_stride +
                       static_cast<size_t>(g) * DH + c0 + c2;
  __nv_bfloat16* dv0 = dv + (static_cast<size_t>(b) * Sk + kr0) * kv_stride +
                       static_cast<size_t>(g) * DH + c0 + c2;
  const size_t down = 8 * kv_stride;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (kr0 < Sk) {
      *reinterpret_cast<__nv_bfloat162*>(dk0 + 8 * nt) = __floats2bfloat162_rn(
          acc_dk[nt][0] * scale, acc_dk[nt][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv0 + 8 * nt) =
          __floats2bfloat162_rn(acc_dv[nt][0], acc_dv[nt][1]);
    }
    if (kr1 < Sk) {
      *reinterpret_cast<__nv_bfloat162*>(dk0 + down + 8 * nt) =
          __floats2bfloat162_rn(acc_dk[nt][2] * scale, acc_dk[nt][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv0 + down + 8 * nt) =
          __floats2bfloat162_rn(acc_dv[nt][2], acc_dv[nt][3]);
    }
  }
}

// ---------------------------------------------------------------- 3. dQ

template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        const int* __restrict__ qpos,
                        const int* __restrict__ kpos,
                        __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H,
                        int KV, int causal, int window, float scale,
                        float scale_log2) {
  using S = Smem<DH>;
  constexpr int kChunks = DH / kDC;
  const int qt = blockIdx.x / kChunks, c0 = (blockIdx.x % kChunks) * kDC;
  const int h = blockIdx.y, b = blockIdx.z, g = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, c2 = (lane & 3) * 2;
  const int q0 = qt * kT, r0 = warp * 16;

  extern __shared__ __align__(16) unsigned char bwd_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* do_s = q_s + S::kTile;
  __nv_bfloat16* k_s = do_s + S::kTile;
  __nv_bfloat16* v_s = k_s + S::kTile;
  int* kpos_s = reinterpret_cast<int*>(v_s + S::kTile);

  const size_t q_stride = static_cast<size_t>(H) * DH;
  const size_t q_off = (static_cast<size_t>(b) * Sq + q0) * q_stride +
                       static_cast<size_t>(h) * DH;
  stage_rows<DH>(q_s, q + q_off, q_stride, Sq - q0, tid);
  stage_rows<DH>(do_s, dout + q_off, q_stride, Sq - q0, tid);
  cp_async_commit();

  // this thread's two query rows
  const int qi0 = q0 + r0 + gr, qi1 = qi0 + 8;
  const bool ok0 = qi0 < Sq, ok1 = qi1 < Sq;
  const float* lse_bh = lse + (static_cast<size_t>(b) * H + h) * Sq;
  const float* d_bh = dsum + (static_cast<size_t>(b) * H + h) * Sq;
  const int qp0 = ok0 ? qpos[qi0] : 0, qp1 = ok1 ? qpos[qi1] : 0;
  const float ls0 = ok0 ? lse_bh[qi0] * kLog2e : 0.0f;
  const float ls1 = ok1 ? lse_bh[qi1] * kLog2e : 0.0f;
  const float dd0 = ok0 ? d_bh[qi0] : 0.0f, dd1 = ok1 ? d_bh[qi1] : 0.0f;
  int qmin, qmax;
  tile_range(qpos, q0, Sq, false, lane, qmin, qmax);

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

  const size_t kv_stride = static_cast<size_t>(KV) * DH;
  const int n_kt = (Sk + kT - 1) / kT;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kT;
    int kmin, kmax;
    tile_range(kpos, k0, Sk, true, lane, kmin, kmax);
    if (!tiles_meet(qmin, qmax, kmin, kmax, causal, window)) continue;
    __syncthreads();  // the previous key tile is read
    const size_t kv_off = (static_cast<size_t>(b) * Sk + k0) * kv_stride +
                          static_cast<size_t>(g) * DH;
    stage_rows<DH>(k_s, k + kv_off, kv_stride, Sk - k0, tid);
    stage_rows<DH>(v_s, v + kv_off, kv_stride, Sk - k0, tid);
    cp_async_commit();
    if (tid < kT) kpos_s[tid] = k0 + tid < Sk ? kpos[k0 + tid] : -1;
    cp_async_wait<0>();
    __syncthreads();

    float s[8][4], dp[8][4];
    product_nk<DH>(s, q_s, k_s, r0, lane);
    product_nk<DH>(dp, do_s, v_s, r0, lane);
    // P and dS: element (query r0 + gr (+8), key 8 nt + c2 (+1))
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = kpos_s[8 * nt + c2 + (e & 1)];
        const bool vis = e < 2 ? ok0 && visible(qp0, kp, causal, window)
                               : ok1 && visible(qp1, kp, causal, window);
        const float p =
            vis ? exp2f(fmaf(s[nt][e], scale_log2, e < 2 ? -ls0 : -ls1))
                : 0.0f;
        s[nt][e] = p * (dp[nt][e] - (e < 2 ? dd0 : dd1));
      }
    product_acc<DH>(acc, s, k_s, c0, lane);
  }

  cp_async_wait<0>();  // the tiles' copies, when no key tile met them
  __nv_bfloat16* o0 = dq + (static_cast<size_t>(b) * Sq + qi0) * q_stride +
                      static_cast<size_t>(h) * DH + c0 + c2;
  const size_t down = 8 * q_stride;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (ok0)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * nt) =
          __floats2bfloat162_rn(acc[nt][0] * scale, acc[nt][1] * scale);
    if (ok1)
      *reinterpret_cast<__nv_bfloat162*>(o0 + down + 8 * nt) =
          __floats2bfloat162_rn(acc[nt][2] * scale, acc[nt][3] * scale);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const void* lse, const void* qpos,
           const void* kpos, void* dq, void* dk, void* dv, void* dsum, int B,
           int Sq, int Sk, int H, int KV, int causal, int window, float scale,
           cudaStream_t stream) {
  using S = Smem<DH>;
  const auto* bq = static_cast<const __nv_bfloat16*>(q);
  const auto* bk = static_cast<const __nv_bfloat16*>(k);
  const auto* bv = static_cast<const __nv_bfloat16*>(v);
  const auto* bdo = static_cast<const __nv_bfloat16*>(dout);
  const auto* fl = static_cast<const float*>(lse);
  auto* fd = static_cast<float*>(dsum);
  const auto* qp = static_cast<const int*>(qpos);
  const auto* kp = static_cast<const int*>(kpos);
  const float scale_log2 = scale * kLog2e;

  const int rows = B * Sq * H;
  flash_bwd_dsum_kernel<DH><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(out), bdo, fd, B, Sq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // above 48 KB a block's dynamic shared memory must be allowed first (per
  // device, so on every launch)
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(S::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(S::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kChunks = DH / kDC;
  dim3 grid_kv(((Sk + kT - 1) / kT) * kChunks, KV, B);
  flash_bwd_dkdv_kernel<DH><<<grid_kv, kThreads, S::kBytes, stream>>>(
      bq, bk, bv, bdo, fl, fd, qp, kp, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Sq, Sk, H, KV, causal, window, scale,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_q(((Sq + kT - 1) / kT) * kChunks, H, B);
  flash_bwd_dq_kernel<DH><<<grid_q, kThreads, S::kBytes, stream>>>(
      bq, bk, bv, bdo, fl, fd, qp, kp, static_cast<__nv_bfloat16*>(dq), Sq,
      Sk, H, KV, causal, window, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dq: (B, Sq, H, dh) bf16; k, v, dk, dv: (B, Sk, KV, dh) bf16; out,
// dout: (B, Sq, H, dh) bf16, the forward's output and its gradient; lse:
// (B, H, Sq) f32 from flash_attention_prefill_lse; qpos (Sq,), kpos (Sk,)
// i32; dsum: (B, H, Sq) f32 scratch (D).  All contiguous, the bf16 tensors
// 16-byte aligned.  dh is 64, 128 or 192; scale is the forward's.
REPRO_EXPORT int flash_attention_backward(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, const void* qpos, const void* kpos,
    void* dq, void* dk, void* dv, void* dsum, int B, int Sq, int Sk, int H,
    int KV, int dh, int causal, int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64)
    return launch<64>(q, k, v, out, dout, lse, qpos, kpos, dq, dk, dv, dsum,
                      B, Sq, Sk, H, KV, causal, window, scale, s);
  if (dh == 128)
    return launch<128>(q, k, v, out, dout, lse, qpos, kpos, dq, dk, dv, dsum,
                       B, Sq, Sk, H, KV, causal, window, scale, s);
  if (dh == 192)
    return launch<192>(q, k, v, out, dout, lse, qpos, kpos, dq, dk, dv, dsum,
                       B, Sq, Sk, H, KV, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
