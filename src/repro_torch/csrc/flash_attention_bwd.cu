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
//   D = rowsum(dO * O),  dS = P * (dP - D),  dP = dO V^T,
//   dV = P^T dO,  dK = dS^T Q scale,  dQ = dS K scale,
// dk and dv of a kv head summed over its H / KV query heads.  A key j is
// visible to query i iff kv_pos[j] >= 0 and (if causal) pos[i] >= kv_pos[j]
// and (if window > 0) pos[i] - kv_pos[j] < window, the forward's masks.  P
// is recomputed as exp2(s * scale log2 e - lse log2 e) and set to exactly 0
// for a key that is not visible.
//
// What bounds it on the H100: bytes and operations about equally at the
// path's shapes.  llama3.2-1b's B 8 x S 512 call needs 21 GFLOP (five
// products of 2 dh flop a visible pair a head) over 84 MB of q, k, v, O,
// dO and gradients: 0.022 ms at the bf16 rate, 0.025 ms at the memory
// rate; nemotron-4-340b's dh 192 is bound by operations.  Only the tensor
// cores come near either bound.
//
// One C call, three kernels (four with the head split), each call's work
// ordered on the given stream:
//   1. flash_bwd_dsum_kernel: D per (batch, head, query) in f32, eight
//      lanes a row;
//   2. flash_bwd_dkdv_kernel: a block per (64-row key tile, kv head, batch
//      row) owns dK and dV of its keys over all of dh.  Producer warps (one
//      at dh 64, two at 128 and 192) stream the (query head, 64-row query
//      tile) pairs that the masks let see the key tile (by the position
//      ranges, as the forward skips tiles) through an mbarrier ring of Q
//      and dO tiles (cp.async with zero fill; three stages at dh 64, two
//      at 128 and 192), each with its rows' positions, LSE and D and a flag
//      for a pair of tiles that is visible throughout.  Two consumer
//      warpgroups share the 64 key rows: the first computes S^T = K Q^T
//      (wgmma m64n64k16 from the swizzled shared tiles), P^T, and dV +=
//      P^T dO (wgmma with P^T from registers, dO read N-major through the
//      transpose bit); the second computes dP^T = V dO^T, takes P^T (f32)
//      from the first through a double-buffered shared exchange with its
//      own mbarriers, and dK += dS^T Q, dS^T = P^T (dP^T - D).  So each
//      warpgroup holds one dh-wide accumulator (dh / 2 floats a thread)
//      beside one 64 x 64 score tile: 96 + 32 at dh 192, where one
//      warpgroup holding both would not fit.  P^T and dS^T land in the
//      accumulator layout that is the next product's A fragment.  Where
//      the grid is small (the op's rule: under two blocks an SM of the
//      H100, and an even number of query heads a kv head), two blocks
//      share a key tile, each taking half of the kv head's query heads,
//      and write f32 partials that flash_bwd_dkdv_sum_kernel adds in a
//      fixed order: a causal grid of one wave is as slow as its longest
//      block, the key tile that every query tile sees (nemotron-4-340b:
//      192 tiles against a mean of 102);
//   3. flash_bwd_dq_kernel, beside pass 2 on a second stream (forked from
//      and joined back to the caller's): a block per (64-row query tile,
//      query head, batch row), the forward's shape: producer warps stream
//      the visible K/V tiles, one consumer warpgroup computes S = Q K^T and
//      dP = dO V^T (wgmma from shared memory, both issued before the first
//      is waited on), P and dS in registers, and dQ += dS K (dS from
//      registers, K N-major).
// The masks are applied in loops of their own, only to tile pairs that are
// not visible throughout, to the exponent (exp2 of -1e30 is 0) and with no
// load under a short-circuit test: a per-element test of the flag, and a
// branch around exp2f, each cost more than the rest of a tile's work (a
// clock64 trace of the dK/dV loop).
// Tried and lost (tools/flash_bwd_variants.py): issuing the next tile's
// products while the last value product ran (6-13% slower), two consumer
// warpgroups on a 128-row query tile sharing each K/V stage of the dQ pass
// (1.2-1.6x slower at dh 64 and 128, spilled at dh 192).
// No atomics: every block owns its outputs and sums in one fixed order, so
// the result is deterministic (two calls bit-identical).  P and dS enter
// the value products as two bf16 parts each, hi + lo (to ~2^-16), as the
// forward takes p: with one part each, as SDPA's backward takes them,
// chip_smoke.py's peaked draws put elements past attn_check's bar (dS at
// llama3.2-1b's shape: 18 elements of dk; then P at nemotron-4-340b's:
// dv).  q, k, v and dO are bf16 already.  Barrier waits trap after some
// seconds (hopper.cuh), never hang.
//
// Ragged edges: query rows past Sq and key rows past Sk are loaded as zeros
// and count as not visible; their gradients are not stored.  A key row at a
// negative position gets dk = dv = 0.
#include <climits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kT = 64;  // rows of a query or key tile
// producer warps a block: one at dh 64 (two cost the dK/dV pass its
// registers at two blocks an SM), more where one warp could not issue a
// stage's copies as fast as the consumers took them
template <int DH>
constexpr int kProducers = DH == 64 ? 1 : DH == 128 ? 2 : 3;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  return (kp >= 0) & (!causal | (qp >= kp)) &
         ((window <= 0) | (qp - kp < window));
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

// The smallest and largest position among 64 rows, two a lane, over the
// warp; (INT_MAX, INT_MIN) where no row is valid.
__device__ __forceinline__ void warp_range(int p0, bool ok0, int p1, bool ok1,
                                           int& lo, int& hi) {
  lo = __reduce_min_sync(kFullMask, min(ok0 ? p0 : INT_MAX,
                                        ok1 ? p1 : INT_MAX));
  hi = __reduce_max_sync(kFullMask, max(ok0 ? p0 : INT_MIN,
                                        ok1 ? p1 : INT_MIN));
}

// acc (m64n64 f32) = A (64 rows of a swizzled [DH/64][64][64] tile) times
// B^T (the same of another tile), contracted over DH: both K-major.
template <int DH>
__device__ __forceinline__ void product_ss(float (&acc)[32], uint32_t a_addr,
                                           uint32_t b_addr) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
    wgmma_m64n64k16_ss(
        acc, sw128_desc(a_addr + (ks / 4) * kT * 128 + (ks % 4) * 32, 16, 1024),
        sw128_desc(b_addr + (ks / 4) * kT * 128 + (ks % 4) * 32, 16, 1024),
        ks > 0);
  wgmma_commit();
}

// The A fragments (m64k16, one per 16 columns) of a 64 x 64 f32 tile held
// in the m64n64 accumulator layout (x[4i + 0/1]: row r, columns 8i + c2 +
// 0/1; x[4i + 2/3]: row r + 8), as two bf16 parts, hi + lo
// (split_bf16x2_parts: to ~2^-16 of each value).
__device__ __forceinline__ void acc_to_a2(const float (&x)[32],
                                          uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t part[2];
      split_bf16x2_parts<2>(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1], part);
      hi[kk][j] = part[0];
      lo[kk][j] = part[1];
    }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      asm volatile("" : "+r"(hi[kk][j]), "+r"(lo[kk][j])::"memory");
}

template <int DH>
__device__ __forceinline__ void wgmma_rs(float (&acc)[DH / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  if constexpr (DH == 64)
    wgmma_m64n64k16_rs_tb(acc, a, desc);
  else if constexpr (DH == 128)
    wgmma_m64n128k16_rs_tb(acc, a, desc);
  else
    wgmma_m64n192k16_rs_tb(acc, a, desc);
}

// acc (m64 x DH f32) += A (m64k64 in two bf16 parts, four fragments each,
// one product a part) times the 64 rows of a swizzled [DH/64][64][64] tile
// read N-major (the transpose bit).
template <int DH>
__device__ __forceinline__ void product_rs2(float (&acc)[DH / 2],
                                            const uint32_t (&hi)[4][4],
                                            const uint32_t (&lo)[4][4],
                                            uint32_t b_addr) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = sw128_desc(b_addr + kk * 16 * 128, kT * 128, 1024);
    wgmma_rs<DH>(acc, hi[kk], desc);
    wgmma_rs<DH>(acc, lo[kk], desc);
  }
  wgmma_commit();
}

// Stage 64 rows of DH bf16 (row stride `gstride` elements; rows at or past
// `valid` zero) into a swizzled [DH/64][64][64] tile, the block's producer
// warps sharing it: lane 8 r + c of warp w copies 16-byte chunk c of rows
// r + 4 (w + kProducers j) of each 64-column block, so a copy's two
// addresses step by constants (one warp issuing a whole stage, with a
// division by DH / 8 a copy, bound the dK/dV pass at dh 128 and 192).
template <int DH>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const __nv_bfloat16* src,
                                          size_t gstride, int valid,
                                          int lane, int w) {
  const int c = lane & 7, r0 = lane >> 3;
#pragma unroll
  for (int cb = 0; cb < DH / 64; ++cb)
#pragma unroll 4
    for (int k = w; k < kT / 4; k += kProducers<DH>) {
      const int r = r0 + 4 * k;
      const bool ok = r < valid;
      cp_async16(dst + cb * kT * 128 + r * 128 + ((c ^ (r & 7)) << 4),
                 src + static_cast<size_t>(ok ? r : 0) * gstride + cb * 64 +
                     c * 8,
                 ok ? 16 : 0);
    }
}

// Stores a 64 x DH f32 accumulator (rows r0, r0 + 8 of this thread) times
// `scale` as bf16 rows of stride `stride`, rows at or past `valid` skipped.
template <int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[DH / 2],
                                           size_t stride, int r0, int valid,
                                           int c2, float scale) {
  __nv_bfloat16* o0 = out + static_cast<size_t>(r0) * stride + c2;
  __nv_bfloat16* o1 = o0 + 8 * stride;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    if (r0 < valid)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 0] * scale, acc[4 * j + 1] * scale);
    if (r0 + 8 < valid)
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

// The same as f32, unscaled (a partial sum of the dK/dV pass's head
// split).
template <int DH>
__device__ __forceinline__ void store_rows_f32(float* out,
                                               const float (&acc)[DH / 2],
                                               size_t stride, int r0,
                                               int valid, int c2) {
  float* o0 = out + static_cast<size_t>(r0) * stride + c2;
  float* o1 = o0 + 8 * stride;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    if (r0 < valid)
      *reinterpret_cast<float2*>(o0 + 8 * j) =
          make_float2(acc[4 * j + 0], acc[4 * j + 1]);
    if (r0 + 8 < valid)
      *reinterpret_cast<float2*>(o1 + 8 * j) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ------------------------------------------------------- 1. D = rowsum

template <int DH>
__global__ void __launch_bounds__(256)
    flash_bwd_dsum_kernel(const __nv_bfloat16* __restrict__ out,
                          const __nv_bfloat16* __restrict__ dout,
                          float* __restrict__ dsum, int B, int Sq, int H) {
  // eight lanes a row (b, i, h), 16 bytes of O and dO a lane a step
  const int row = blockIdx.x * 32 + (threadIdx.x >> 3);
  const int sub = threadIdx.x & 7;
  const bool ok = row < B * Sq * H;
  const size_t base = static_cast<size_t>(ok ? row : 0) * DH;
  float acc = 0.0f;
#pragma unroll
  for (int c = 8 * sub; c < DH; c += 64) {
    const uint4 o = *reinterpret_cast<const uint4*>(out + base + c);
    const uint4 d = *reinterpret_cast<const uint4*>(dout + base + c);
    const unsigned ow[4] = {o.x, o.y, o.z, o.w};
    const unsigned dw[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 of = bf16x2_to_float2(ow[k]), df = bf16x2_to_float2(dw[k]);
      acc = fmaf(of.x, df.x, acc);
      acc = fmaf(of.y, df.y, acc);
    }
  }
  acc += __shfl_xor_sync(kFullMask, acc, 1);
  acc += __shfl_xor_sync(kFullMask, acc, 2);
  acc += __shfl_xor_sync(kFullMask, acc, 4);
  if (ok && sub == 0) {
    const int h = row % H, i = (row / H) % Sq, b = row / (H * Sq);
    dsum[(static_cast<size_t>(b) * H + h) * Sq + i] = acc;
  }
}

// --------------------------------------------------------- 2. dK and dV

// Shared-memory layout of the dK/dV kernel, byte offsets from a 1024-byte
// aligned base.
template <int DH>
struct KvLayout {
  static constexpr int kStages = DH == 64 ? 3 : 2;  // Q/dO ring depth
  static constexpr int kTile = kT * DH * 2;         // one bf16 tile
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTile;
  static constexpr int kRing = kV + kTile;          // [stage][Q, dO]
  static constexpr int kP = kRing + kStages * 2 * kTile;  // f32 [2][32][128]
  static constexpr int kRows = kP + 2 * 32 * 128 * 4;  // [stage][qpos, lse, D]
  static constexpr int kMeta = kRows + kStages * 3 * kT * 4;  // [stage][2]
  static constexpr int kBars = kMeta + kStages * 2 * 4;
  // full[kStages], empty[kStages], kv, p_full[2], p_empty[2]
  static constexpr int kBytes = kBars + (2 * kStages + 5) * 8 + 1024;
  // two consumer warpgroups, the producer warps
  static constexpr int kThreads = 256 + 32 * kProducers<DH>;
  static_assert(kBars % 8 == 0, "barriers must be 8-byte aligned");
};

// A consumer's dK (which 0) or dV (which 1) rows of this block: bf16 into
// the output (times scale) without a head split, else f32 into the split's
// partial part[split half][which] (B, Sk, KV, DH), unscaled.
template <int DH>
__device__ __forceinline__ void store_kv(__nv_bfloat16* __restrict__ out,
                                         float* __restrict__ part, int which,
                                         const float (&acc)[DH / 2], int B,
                                         int Sk, int KV, int split, int row0,
                                         int c2, float scale) {
  const int k0 = blockIdx.x / split * kT, g = blockIdx.y, b = blockIdx.z;
  const size_t kv_stride = static_cast<size_t>(KV) * DH;
  const size_t off = (static_cast<size_t>(b) * Sk + k0) * kv_stride +
                     static_cast<size_t>(g) * DH;
  if (split == 1) {
    store_rows<DH>(out + off, acc, kv_stride, row0, Sk - k0, c2, scale);
  } else {
    const size_t plane = static_cast<size_t>(B) * Sk * kv_stride;
    store_rows_f32<DH>(part + (blockIdx.x % split * 2 + which) * plane + off,
                       acc, kv_stride, row0, Sk - k0, c2);
  }
}

template <int DH>
__device__ __forceinline__ void kv_producer(
    unsigned char* base, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dsum, const int* __restrict__ qpos,
    const int* __restrict__ kpos, int Sq, int Sk, int H, int KV, int causal,
    int window, int split) {
  using L = KvLayout<DH>;
  const int lane = threadIdx.x & 31, w = (threadIdx.x - 256) >> 5;
  const int k0 = blockIdx.x / split * kT, g = blockIdx.y, b = blockIdx.z;
  // this block's query heads: the kv head's, or one half of them
  const int rep = H / KV / split;
  const int h0 = g * (H / KV) + blockIdx.x % split * rep;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* kv_full = empty + L::kStages;
  int* meta = reinterpret_cast<int*>(base + L::kMeta);

  const size_t kv_stride = static_cast<size_t>(KV) * DH;
  const size_t kv_off = (static_cast<size_t>(b) * Sk + k0) * kv_stride +
                        static_cast<size_t>(g) * DH;
  load_tile<DH>(base + L::kK, k + kv_off, kv_stride, Sk - k0, lane, w);
  load_tile<DH>(base + L::kV, v + kv_off, kv_stride, Sk - k0, lane, w);
  mbar_arrive_on_cp_async(kv_full);

  const int kp0 = k0 + lane < Sk ? kpos[k0 + lane] : -1;
  const int kp1 = k0 + lane + 32 < Sk ? kpos[k0 + lane + 32] : -1;
  int kmin, kmax;
  warp_range(kp0, kp0 >= 0, kp1, kp1 >= 0, kmin, kmax);
  const bool all_keys = __all_sync(kFullMask, kp0 >= 0 && kp1 >= 0);

  const size_t q_stride = static_cast<size_t>(H) * DH;
  const int n_qt = (Sq + kT - 1) / kT;
  const int n_units = kmin <= kmax ? rep * n_qt : 0;   // (head, query tile)
  // the positions of a unit's rows, loaded one unit ahead
  auto positions = [&](int u, int& p0, int& p1) {
    const int q0 = (u % n_qt) * kT;
    p0 = q0 + lane < Sq ? qpos[q0 + lane] : 0;
    p1 = q0 + lane + 32 < Sq ? qpos[q0 + lane + 32] : 0;
  };
  int np0 = 0, np1 = 0;
  if (n_units) positions(0, np0, np1);
  int stage = 0, phase = 1;  // the first pass finds every slot free
  for (int u = 0; u < n_units; ++u) {
    const int qp0 = np0, qp1 = np1;
    if (u + 1 < n_units) positions(u + 1, np0, np1);
    const int q0 = (u % n_qt) * kT, h = h0 + u / n_qt;
    const bool ok0 = q0 + lane < Sq, ok1 = q0 + lane + 32 < Sq;
    int qmin, qmax;
    warp_range(qp0, ok0, qp1, ok1, qmin, qmax);
    if (!tiles_meet(qmin, qmax, kmin, kmax, causal, window)) continue;
    const int every = all_keys && q0 + kT <= Sq &&
                      (!causal || qmin >= kmax) &&
                      (window <= 0 || qmax - kmin < window);

    mbar_wait(&empty[stage], phase);
    if (w == 0) {
      // the rows' positions, LSE and D (zero past Sq), by cp.async
      int* qpos_s = reinterpret_cast<int*>(base + L::kRows) + stage * 3 * kT;
      float* lse_s = reinterpret_cast<float*>(qpos_s + kT);
      float* d_s = lse_s + kT;
      const size_t bh = static_cast<size_t>(b) * H + h;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = lane + 32 * j, i = q0 + r;
        const int ok = i < Sq ? 4 : 0, ii = i < Sq ? i : 0;
        cp_async4(qpos_s + r, qpos + ii, ok);
        cp_async4(lse_s + r, lse + bh * Sq + ii, ok);
        cp_async4(d_s + r, dsum + bh * Sq + ii, ok);
      }
      if (lane == 0) {
        meta[2 * stage] = q0;
        meta[2 * stage + 1] = every;
      }
    }
    const size_t q_off = (static_cast<size_t>(b) * Sq + q0) * q_stride +
                         static_cast<size_t>(h) * DH;
    unsigned char* q_s = base + L::kRing + stage * 2 * L::kTile;
    load_tile<DH>(q_s, q + q_off, q_stride, Sq - q0, lane, w);
    load_tile<DH>(q_s + L::kTile, dout + q_off, q_stride, Sq - q0, lane, w);
    if (w == 0) mbar_arrive(&full[stage]);  // releases the header
    mbar_arrive_on_cp_async(&full[stage]);  // once this lane's copies land
    if (++stage == L::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  mbar_wait(&empty[stage], phase);  // end of stream
  if (w == 0) {
    if (lane == 0) meta[2 * stage] = -1;
    mbar_arrive(&full[stage]);
  }
  mbar_arrive_on_cp_async(&full[stage]);
}

// The first warpgroup: S^T, P^T (handed to the second), dV += P^T dO.
template <int DH>
__device__ __forceinline__ void p_consumer(
    unsigned char* base, const int* __restrict__ kpos,
    __nv_bfloat16* __restrict__ dv, float* __restrict__ part, int B, int Sq,
    int Sk, int KV, int causal, int window, int split, float scale_log2) {
  using L = KvLayout<DH>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = warp * 16 + (lane >> 2), c2 = (lane & 3) * 2;
  const int k0 = blockIdx.x / split * kT, g = blockIdx.y, b = blockIdx.z;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* kv_full = empty + L::kStages;
  uint64_t* p_full = kv_full + 1;
  uint64_t* p_empty = p_full + 2;
  const int* meta = reinterpret_cast<const int*>(base + L::kMeta);
  float* pbuf = reinterpret_cast<float*>(base + L::kP);
  const int kp0 = k0 + row0 < Sk ? kpos[k0 + row0] : -1;
  const int kp1 = k0 + row0 + 8 < Sk ? kpos[k0 + row0 + 8] : -1;

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
  const uint32_t k_addr = smem_u32(base + L::kK);
  mbar_wait(kv_full, 0);
  int stage = 0, phase = 0;
  for (int it = 0;; ++it) {
    mbar_wait(&full[stage], phase);
    const int q0 = meta[2 * stage];
    if (q0 < 0) break;
    const int every = meta[2 * stage + 1];
    fence_proxy_async_shared();
    const uint32_t q_addr = smem_u32(base + L::kRing + stage * 2 * L::kTile);
    float s[32];
    product_ss<DH>(s, k_addr, q_addr);
    wgmma_wait<0>();
    fence_regs(s);

    // P^T: s[4i + 0/1] is key row0's query 8i + c2 + 0/1, s[4i + 2/3] key
    // row0 + 8's.  The mask only where the stage is not all visible, in a
    // loop of its own (a per-element test of the flag cost more than the
    // rest of the tile)
    const int* qpos_s =
        reinterpret_cast<const int*>(base + L::kRows) + stage * 3 * kT;
    const float* lse_s = reinterpret_cast<const float*>(qpos_s + kT);
    if (every) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * i + e] = exp2f(fmaf(s[4 * i + e], scale_log2,
                                    -lse_s[8 * i + c2 + (e & 1)] * kLog2e));
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // the exponent, not the result, masked (exp2 of -1e30 is 0): a
          // branch around exp2f, or a load under &&, diverged an element
          const int qi = 8 * i + c2 + (e & 1), qp = qpos_s[qi];
          const bool vis = (q0 + qi < Sq) &
                           visible(qp, e < 2 ? kp0 : kp1, causal, window);
          const float x = fmaf(s[4 * i + e], scale_log2, -lse_s[qi] * kLog2e);
          s[4 * i + e] = exp2f(vis ? x : kNeg);
        }
    }
    const int buf = it & 1;
    mbar_wait(&p_empty[buf], ((it >> 1) & 1) ^ 1);  // the use before is read
    float* pb = pbuf + buf * 32 * 128;
#pragma unroll
    for (int e = 0; e < 32; ++e) pb[e * 128 + tid] = s[e];
    mbar_arrive(&p_full[buf]);
    uint32_t phi[4][4], plo[4][4];
    acc_to_a2(s, phi, plo);
    product_rs2<DH>(acc, phi, plo, q_addr + L::kTile);  // dO
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == L::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  store_kv<DH>(dv, part, 1, acc, B, Sk, KV, split, row0, c2, 1.0f);
}

// The second warpgroup: dP^T, dS^T = P^T (dP^T - D), dK += dS^T Q.
template <int DH>
__device__ __forceinline__ void ds_consumer(unsigned char* base,
                                            __nv_bfloat16* __restrict__ dk,
                                            float* __restrict__ part, int B,
                                            int Sk, int KV, int split,
                                            float scale) {
  using L = KvLayout<DH>;
  const int tid = threadIdx.x - 128, warp = tid >> 5, lane = tid & 31;
  const int row0 = warp * 16 + (lane >> 2), c2 = (lane & 3) * 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* kv_full = empty + L::kStages;
  uint64_t* p_full = kv_full + 1;
  uint64_t* p_empty = p_full + 2;
  const int* meta = reinterpret_cast<const int*>(base + L::kMeta);
  const float* pbuf = reinterpret_cast<const float*>(base + L::kP);

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
  const uint32_t v_addr = smem_u32(base + L::kV);
  mbar_wait(kv_full, 0);
  int stage = 0, phase = 0;
  for (int it = 0;; ++it) {
    mbar_wait(&full[stage], phase);
    if (meta[2 * stage] < 0) break;
    fence_proxy_async_shared();
    const uint32_t q_addr = smem_u32(base + L::kRing + stage * 2 * L::kTile);
    float dp[32];
    product_ss<DH>(dp, v_addr, q_addr + L::kTile);  // V dO^T
    wgmma_wait<0>();
    fence_regs(dp);

    const float* d_s = reinterpret_cast<const float*>(base + L::kRows) +
                       stage * 3 * kT + 2 * kT;
    const int buf = it & 1;
    mbar_wait(&p_full[buf], (it >> 1) & 1);
    const float* pb = pbuf + buf * 32 * 128;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * i + c2 + (e & 1);
        dp[4 * i + e] = pb[(4 * i + e) * 128 + tid] * (dp[4 * i + e] - d_s[qi]);
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(&p_empty[buf]);
    uint32_t dhi[4][4], dlo[4][4];
    acc_to_a2(dp, dhi, dlo);
    product_rs2<DH>(acc, dhi, dlo, q_addr);  // Q
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == L::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  store_kv<DH>(dk, part, 0, acc, B, Sk, KV, split, row0, c2, scale);
}

template <int DH>
__global__ void __launch_bounds__(KvLayout<DH>::kThreads, DH == 64 ? 2 : 1)
    flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          const int* __restrict__ qpos,
                          const int* __restrict__ kpos,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv,
                          float* __restrict__ part, int B, int Sq, int Sk,
                          int H, int KV, int causal, int window, int split,
                          float scale, float scale_log2) {
  using L = KvLayout<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::kBars);
    for (int s = 0; s < L::kStages; ++s) {
      // full: the first producer warp's lanes, and every producer lane
      // once its copies land
      mbar_init(&bars[s], 32 * (1 + kProducers<DH>));
      mbar_init(&bars[L::kStages + s], 8);     // empty: every consumer warp
    }
    mbar_init(&bars[2 * L::kStages], 32 * kProducers<DH>);  // kv
    for (int i = 0; i < 2; ++i) {
      mbar_init(&bars[2 * L::kStages + 1 + i], 128);  // p_full
      mbar_init(&bars[2 * L::kStages + 3 + i], 4);    // p_empty
    }
    mbar_init_fence();
  }
  __syncthreads();
  // the roles never meet again at a block-wide barrier
  if (threadIdx.x >= 256)
    kv_producer<DH>(base, q, k, v, dout, lse, dsum, qpos, kpos, Sq, Sk, H,
                    KV, causal, window, split);
  else if (threadIdx.x < 128)
    p_consumer<DH>(base, kpos, dv, part, B, Sq, Sk, KV, causal, window,
                   split, scale_log2);
  else
    ds_consumer<DH>(base, dk, part, B, Sk, KV, split, scale);
}

// ---------------------------------------------------------------- 3. dQ

// Shared-memory layout of the dQ kernel (the forward's, with dO beside Q).
template <int DH>
struct QLayout {
  static constexpr int kStages = DH == 64 ? 3 : 2;  // K/V ring depth
  static constexpr int kTile = kT * DH * 2;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kTile;
  static constexpr int kKV = kDO + kTile;                 // [stage][K, V]
  static constexpr int kKpos = kKV + kStages * 2 * kTile;  // int [stage][64]
  static constexpr int kMeta = kKpos + kStages * kT * 4;   // int [stage][2]
  static constexpr int kBars = kMeta + kStages * 2 * 4;    // full, empty, q
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
  static constexpr int kThreads = 128 + 32 * kProducers<DH>;  // + producers
  static_assert(kBars % 8 == 0, "barriers must be 8-byte aligned");
};

template <int DH>
__device__ __forceinline__ void q_producer(
    unsigned char* base, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const int* __restrict__ qpos,
    const int* __restrict__ kpos, int Sq, int Sk, int H, int KV, int causal,
    int window) {
  using L = QLayout<DH>;
  const int lane = threadIdx.x & 31, w = (threadIdx.x - 128) >> 5;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* q_full = empty + L::kStages;
  int* kpos_s = reinterpret_cast<int*>(base + L::kKpos);
  int* meta = reinterpret_cast<int*>(base + L::kMeta);

  const size_t q_stride = static_cast<size_t>(H) * DH;
  const size_t q_off = (static_cast<size_t>(b) * Sq + q0) * q_stride +
                       static_cast<size_t>(h) * DH;
  load_tile<DH>(base + L::kQ, q + q_off, q_stride, Sq - q0, lane, w);
  load_tile<DH>(base + L::kDO, dout + q_off, q_stride, Sq - q0, lane, w);
  mbar_arrive_on_cp_async(q_full);

  const bool ok0 = q0 + lane < Sq, ok1 = q0 + lane + 32 < Sq;
  int qmin, qmax;
  warp_range(ok0 ? qpos[q0 + lane] : 0, ok0,
             ok1 ? qpos[q0 + lane + 32] : 0, ok1, qmin, qmax);

  const size_t kv_stride = static_cast<size_t>(KV) * DH;
  const size_t kv_b = static_cast<size_t>(b) * Sk * kv_stride +
                      static_cast<size_t>(g) * DH;
  const int n_tiles = (Sk + kT - 1) / kT;
  // the positions of a key tile's rows, loaded one tile ahead
  auto positions = [&](int kt, int& p0, int& p1) {
    const int k0 = kt * kT;
    p0 = k0 + lane < Sk ? kpos[k0 + lane] : -1;
    p1 = k0 + lane + 32 < Sk ? kpos[k0 + lane + 32] : -1;
  };
  int np0, np1;
  positions(0, np0, np1);
  int stage = 0, phase = 1;  // the first pass finds every slot free
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kT;
    const int kp0 = np0, kp1 = np1;
    if (kt + 1 < n_tiles) positions(kt + 1, np0, np1);
    int kmin, kmax;
    warp_range(kp0, kp0 >= 0, kp1, kp1 >= 0, kmin, kmax);
    if (!tiles_meet(qmin, qmax, kmin, kmax, causal, window)) continue;
    const int every = __all_sync(kFullMask, kp0 >= 0 && kp1 >= 0) &&
                      (!causal || qmin >= kmax) &&
                      (window <= 0 || qmax - kmin < window);

    mbar_wait(&empty[stage], phase);
    if (w == 0) {
      kpos_s[stage * kT + lane] = kp0;
      kpos_s[stage * kT + lane + 32] = kp1;
      if (lane == 0) {
        meta[2 * stage] = k0;
        meta[2 * stage + 1] = every;
      }
    }
    unsigned char* k_s = base + L::kKV + stage * 2 * L::kTile;
    const size_t kv_off = kv_b + static_cast<size_t>(k0) * kv_stride;
    load_tile<DH>(k_s, k + kv_off, kv_stride, Sk - k0, lane, w);
    load_tile<DH>(k_s + L::kTile, v + kv_off, kv_stride, Sk - k0, lane, w);
    if (w == 0) mbar_arrive(&full[stage]);  // releases the positions, header
    mbar_arrive_on_cp_async(&full[stage]);  // once this lane's copies land
    if (++stage == L::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  mbar_wait(&empty[stage], phase);  // end of stream
  if (w == 0) {
    if (lane == 0) meta[2 * stage] = -1;
    mbar_arrive(&full[stage]);
  }
  mbar_arrive_on_cp_async(&full[stage]);
}

template <int DH>
__device__ __forceinline__ void q_consumer(
    unsigned char* base, const float* __restrict__ lse,
    const float* __restrict__ dsum, const int* __restrict__ qpos,
    __nv_bfloat16* __restrict__ dq, int Sq, int H, int causal, int window,
    float scale, float scale_log2) {
  using L = QLayout<DH>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16 + (lane >> 2), c2 = (lane & 3) * 2;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* q_full = empty + L::kStages;
  const int* kpos_s = reinterpret_cast<const int*>(base + L::kKpos);
  const int* meta = reinterpret_cast<const int*>(base + L::kMeta);

  // this thread's two query rows
  const int qi0 = q0 + row0, qi1 = qi0 + 8;
  const bool ok0 = qi0 < Sq, ok1 = qi1 < Sq;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int qp0 = ok0 ? qpos[qi0] : 0, qp1 = ok1 ? qpos[qi1] : 0;
  const float ls0 = ok0 ? lse[bh * Sq + qi0] * kLog2e : 0.0f;
  const float ls1 = ok1 ? lse[bh * Sq + qi1] * kLog2e : 0.0f;
  const float dd0 = ok0 ? dsum[bh * Sq + qi0] : 0.0f;
  const float dd1 = ok1 ? dsum[bh * Sq + qi1] : 0.0f;

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
  const uint32_t q_addr = smem_u32(base + L::kQ);
  const uint32_t do_addr = smem_u32(base + L::kDO);
  mbar_wait(q_full, 0);
  int stage = 0, phase = 0;
  while (true) {
    mbar_wait(&full[stage], phase);
    if (meta[2 * stage] < 0) break;
    const int every = meta[2 * stage + 1];
    fence_proxy_async_shared();
    const uint32_t k_addr = smem_u32(base + L::kKV + stage * 2 * L::kTile);
    float s[32], dp[32];
    product_ss<DH>(s, q_addr, k_addr);               // Q K^T
    product_ss<DH>(dp, do_addr, k_addr + L::kTile);  // dO V^T
    wgmma_wait<1>();
    fence_regs(s);
    // P: s[4i + 0/1] is query row0's key 8i + c2 + 0/1, s[4i + 2/3] query
    // row0 + 8's; the mask only where the stage is not all visible
    if (every) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x =
              fmaf(s[4 * i + e], scale_log2, e < 2 ? -ls0 : -ls1);
          s[4 * i + e] = exp2f((e < 2 ? ok0 : ok1) ? x : kNeg);
        }
    } else {
      const int* kp_s = kpos_s + stage * kT;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int2 kp = *reinterpret_cast<const int2*>(kp_s + 8 * i + c2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool vis =
              e < 2 ? ok0 & visible(qp0, e == 0 ? kp.x : kp.y, causal,
                                    window)
                    : ok1 & visible(qp1, e == 2 ? kp.x : kp.y, causal,
                                    window);
          const float x =
              fmaf(s[4 * i + e], scale_log2, e < 2 ? -ls0 : -ls1);
          s[4 * i + e] = exp2f(vis ? x : kNeg);
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * i + e] = s[4 * i + e] * (dp[4 * i + e] - (e < 2 ? dd0 : dd1));
    uint32_t dhi[4][4], dlo[4][4];
    acc_to_a2(dp, dhi, dlo);
    product_rs2<DH>(acc, dhi, dlo, k_addr);  // K
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == L::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  const size_t q_stride = static_cast<size_t>(H) * DH;
  store_rows<DH>(dq + (static_cast<size_t>(b) * Sq + q0) * q_stride +
                     static_cast<size_t>(h) * DH,
                 acc, q_stride, row0, Sq - q0, c2, scale);
}

template <int DH>
__global__ void __launch_bounds__(QLayout<DH>::kThreads)
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
  using L = QLayout<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::kBars);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&bars[s], 32 * (1 + kProducers<DH>));  // full
      mbar_init(&bars[L::kStages + s], 4);              // empty
    }
    mbar_init(&bars[2 * L::kStages], 32 * kProducers<DH>);  // q
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= 128)
    q_producer<DH>(base, q, k, v, dout, qpos, kpos, Sq, Sk, H, KV, causal,
                   window);
  else
    q_consumer<DH>(base, lse, dsum, qpos, dq, Sq, H, causal, window, scale,
                   scale_log2);
}

// ----------------------------------- 2'. dK and dV of a head split, summed

// dk = (part[0][0] + part[1][0]) scale, dv = part[0][1] + part[1][1], four
// elements a thread: the two halves' partials in one fixed order.
__global__ void __launch_bounds__(256)
    flash_bwd_dkdv_sum_kernel(const float* __restrict__ part,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, size_t n,
                              float scale) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i >= n) return;
  const float4 k0 = *reinterpret_cast<const float4*>(part + i);
  const float4 v0 = *reinterpret_cast<const float4*>(part + n + i);
  const float4 k1 = *reinterpret_cast<const float4*>(part + 2 * n + i);
  const float4 v1 = *reinterpret_cast<const float4*>(part + 3 * n + i);
  __nv_bfloat162* kk = reinterpret_cast<__nv_bfloat162*>(dk + i);
  __nv_bfloat162* vv = reinterpret_cast<__nv_bfloat162*>(dv + i);
  kk[0] = __floats2bfloat162_rn((k0.x + k1.x) * scale, (k0.y + k1.y) * scale);
  kk[1] = __floats2bfloat162_rn((k0.z + k1.z) * scale, (k0.w + k1.w) * scale);
  vv[0] = __floats2bfloat162_rn(v0.x + v1.x, v0.y + v1.y);
  vv[1] = __floats2bfloat162_rn(v0.z + v1.z, v0.w + v1.w);
}

// The dQ pass runs beside the dK/dV pass (both read only q, k, v, dO, the
// LSE and D): on a second stream of the device, forked from and joined
// back to the caller's stream through two events (a CUDA graph captures
// the fork and the join like any launch).  Created at the first call, one
// set a device.
struct SideStream {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};

cudaError_t side_stream(SideStream** out) {
  constexpr int kMaxDevices = 64;
  static SideStream per_device[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  SideStream& side = per_device[dev];
  if (side.stream == nullptr) {
    err = cudaStreamCreateWithFlags(&side.stream, cudaStreamNonBlocking);
    if (err == cudaSuccess)
      err = cudaEventCreateWithFlags(&side.fork, cudaEventDisableTiming);
    if (err == cudaSuccess)
      err = cudaEventCreateWithFlags(&side.join, cudaEventDisableTiming);
    if (err != cudaSuccess) return err;
  }
  *out = &side;
  return cudaSuccess;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const void* lse, const void* qpos,
           const void* kpos, void* dq, void* dk, void* dv, void* dsum,
           void* part, int B, int Sq, int Sk, int H, int KV, int causal,
           int window, float scale, cudaStream_t stream) {
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
  flash_bwd_dsum_kernel<DH><<<(rows + 31) / 32, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(out), bdo, fd, B, Sq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // above 48 KB a block's dynamic shared memory must be allowed first (per
  // device, so on every launch)
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             KvLayout<DH>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             QLayout<DH>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  SideStream* side = nullptr;
  err = side_stream(&side);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dQ on the side stream once D is written
  err = cudaEventRecord(side->fork, stream);
  if (err == cudaSuccess)
    err = cudaStreamWaitEvent(side->stream, side->fork, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_q((Sq + kT - 1) / kT, H, B);
  flash_bwd_dq_kernel<DH>
      <<<grid_q, QLayout<DH>::kThreads, QLayout<DH>::kBytes, side->stream>>>(
          bq, bk, bv, bdo, fl, fd, qp, kp, static_cast<__nv_bfloat16*>(dq),
          Sq, Sk, H, KV, causal, window, scale, scale_log2);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaEventRecord(side->join, side->stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int split = part ? 2 : 1;
  dim3 grid_kv((Sk + kT - 1) / kT * split, KV, B);
  flash_bwd_dkdv_kernel<DH>
      <<<grid_kv, KvLayout<DH>::kThreads, KvLayout<DH>::kBytes, stream>>>(
          bq, bk, bv, bdo, fl, fd, qp, kp, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), static_cast<float*>(part), B, Sq,
          Sk, H, KV, causal, window, split, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (split == 2) {
    const size_t n = static_cast<size_t>(B) * Sk * KV * DH;
    flash_bwd_dkdv_sum_kernel<<<static_cast<unsigned>((n / 4 + 255) / 256),
                                256, 0, stream>>>(
        static_cast<const float*>(part), static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), n, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the caller's stream waits for dQ: the call ends with both passes
  return static_cast<int>(cudaStreamWaitEvent(stream, side->join, 0));
}

}  // namespace

// q, dq: (B, Sq, H, dh) bf16; k, v, dk, dv: (B, Sk, KV, dh) bf16; out,
// dout: (B, Sq, H, dh) bf16, the forward's output and its gradient; lse:
// (B, H, Sq) f32 from flash_attention_prefill_lse; qpos (Sq,), kpos (Sk,)
// i32; dsum: (B, H, Sq) f32 scratch (D); part: null, or (2, 2, B, Sk, KV,
// dh) f32 scratch that splits each kv head's query heads over two blocks of
// the dK/dV pass (H / KV even), summed after it.  All contiguous, the bf16
// tensors 16-byte aligned.  dh is 64, 128 or 192; scale is the forward's.
REPRO_EXPORT int flash_attention_backward(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, const void* qpos, const void* kpos,
    void* dq, void* dk, void* dv, void* dsum, void* part, int B, int Sq,
    int Sk, int H, int KV, int dh, int causal, int window, float scale,
    void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      (part && (H / KV) % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64)
    return launch<64>(q, k, v, out, dout, lse, qpos, kpos, dq, dk, dv, dsum,
                      part, B, Sq, Sk, H, KV, causal, window, scale, s);
  if (dh == 128)
    return launch<128>(q, k, v, out, dout, lse, qpos, kpos, dq, dk, dv, dsum,
                       part, B, Sq, Sk, H, KV, causal, window, scale, s);
  if (dh == 192)
    return launch<192>(q, k, v, out, dout, lse, qpos, kpos, dq, dk, dv, dsum,
                       part, B, Sq, Sk, H, KV, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
