// Experiment, not part of the package: the package's flash prefill kernel
// (csrc/flash_attention.cu, one consumer warpgroup a 64-row query tile)
// with kWG consumer warpgroups a block (64 kWG query rows) sharing each
// K/V tile, and with kRR a token ring of named barriers through which the
// warpgroups take turns issuing their products (S, then P V, round robin),
// so that the tensor cores take one warpgroup's products while the others
// run their softmax.  tools/flash_variants.py times it beside the
// package's kernel (PERF.md, PR 17).  Entry points as the package's
// flash_attention_prefill, plus flash_attention_prefill_instance(...,
// wg, stream): wg consumer warpgroups, negative for the token ring.
//
// Prefill flash attention with explicit query and key positions: causal,
// sliding window, GQA, and key rows at a negative position masked.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::
// flash_attention_kernel (its pl.pallas_call at kernel.py:101).  The
// function is src/repro/models/attention.py::gqa_attention: f32 scores
// scaled by dh^-1/2, key j visible to query i iff kv_pos[j] >= 0 and (if
// causal) pos[i] >= kv_pos[j] and (if window > 0) pos[i] - kv_pos[j] <
// window, masked scores at -1e30, online softmax in f32, one late divide by
// max(l, 1e-30).  The value product takes p in two bf16 parts, p = hi +
// lo, one tensor-core product each, so p enters it to ~2^-16 relative
// (the Pallas kernel rounds p to bf16, kernel.py:62; with that rounding the
// teacher-forced check of a generate drive on the card fails, see PERF.md);
// the row sum l keeps the f32 p.
// The Pallas kernel knows only an iota and seq_len; the chunked prefill
// (transformer.py:629-650) needs the query offset and the -1e9 prefix rows,
// so the masks here come from the two position arrays.
//
// What bounds it on the H100: operations.  A 512-token chunk of
// llama3.2-1b over a 512-row prefix does 3.2 GFLOP of attention per layer
// over ~6 MB of q/k/v/o, well above the 295 flop/byte ridge, so only the
// tensor cores (989 TFLOP/s bf16) come near the bound.  The first kernel of
// this file did both products with scalar f32 FMAs and ran at 43-65x its
// bound.
//
// Design, for sm_90a: one block per (64-row query tile, query head, batch
// row): one consumer warpgroup owns the tile's 64 rows, one producer warp
// keeps a ring of K/V tiles (64 key rows; three stages at dh 64, two at dh
// 128 and 192) in flight with cp.async while the consumers compute.  Three
// blocks fit an SM at dh 64 (127 registers a thread, 58 KB of shared
// memory), two at dh 128, and their warpgroups take turns on the tensor
// cores; one fits at dh 192 (Q 24 KB and two 48 KB K/V stages, 121 KB; the
// O accumulator alone is 96 f32 registers a thread).  (128-row
// tiles, two consumer warpgroups sharing each K/V load, were dropped: with
// the split of P a 288-thread block needs 120 registers a thread, which
// leaves one block per SM, and chip_smoke.py timed the seamless encoder at
// 0.39-0.41 ms with them against 0.35 ms with 64-row tiles on the H100; no
// path's dh-128 call has enough rows to fill the card with them.)  Tiles
// are stored in the 128-byte swizzle that the wgmma descriptors name: a
// bf16 row of 64 is one swizzle row, dh 128 and 192 are two and three
// 64-column blocks.  S = Q K^T is wgmma m64n64k16 from shared memory
// (both operands K-major); the online softmax runs in f32 registers in the
// accumulator layout (row max and sum over the four lanes that share a row);
// P's two bf16 parts are packed in registers and are the A operands of
// O += P_hi V + P_lo V (wgmma m64n{dh}k16, V read N-major through the
// transpose bit), O in f32 registers.
//
// The ring: cp.async rather than TMA.  A tensor map per operand would be
// encoded on the host at every call (the base pointers change), the ragged
// key edge of each batch row would need a four-dimensional map, and the
// tile's key positions and skip decision still need the producer's own
// loads; cp.async with a zero fill takes the same pointers and strides as
// before and keeps the C interface.  Each stage has a full barrier (64
// arrivals: every producer lane arrives once for its position and header
// stores and once more, through cp.async.mbarrier.arrive.noinc, when its
// copies have landed) and an empty barrier (one arrival per consumer warp
// after its value product has finished reading the stage).  Consumers fence
// the generic-proxy writes before the async-proxy wgmma reads.
//
// Tile skipping: the producer reads each key tile's positions before it
// loads the tile and skips the tile when, by the position ranges, no
// (query, key) pair of the block can be visible: no key at a position >= 0
// (the chunked prefill's -1e9 prefix rows, keys past Sk), the largest query
// position below the smallest key position (causal), or the smallest query
// position at least window past the largest key position.  For the path's
// monotone positions this skips exactly the tiles the first kernel skipped.
// It also flags tiles where every pair is visible, which the consumers take
// without masking; the consumers just follow the stream of tiles the
// producer hands them, ended by a header of -1.
//
// Ragged edges: query rows past Sq are loaded as zeros and not stored; key
// rows past Sk are zero-filled and carry position -1 (masked).
//
// Differs from the reference only for a query row that sees no key at all:
// the reference averages V uniformly; this kernel's output there is not
// defined.  No caller makes one: every query sees its own key.
#include <climits>

#include "common.cuh"
#include "hopper.cuh"

__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

namespace {

constexpr int kBc = 64;  // key rows per tile
constexpr float kLog2e = 1.4426950408889634f;
// a running max (log2 domain) below this comes from masked scores alone:
// -1e30 times the scale, 0.18 at dh 64, 0.13 at dh 128 and 0.10 at dh 192
constexpr float kMaskedMax = -1e28f;

// Shared-memory layout, byte offsets from a 1024-byte aligned base.
template <int DH, int kWG>
struct Layout {
  static constexpr int kBr = 64 * kWG;                    // query rows
  static constexpr int kStages = DH == 64 ? 4 : DH == 128 ? 3 : 2;
  static constexpr int kTile = kBc * DH * 2;              // one K or V tile
  static constexpr int kQ = 0;                            // [DH/64][kBr][64]
  static constexpr int kKV = kQ + kBr * DH * 2;           // [stage][K, V]
  static constexpr int kKpos = kKV + kStages * 2 * kTile; // int [stage][kBc]
  static constexpr int kMeta = kKpos + kStages * kBc * 4; // int [stage][2]
  static constexpr int kBars = kMeta + kStages * 2 * 4;   // u64 full, empty, q
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
  static constexpr int kThreads = 128 * kWG + 32;  // consumers, producer
  static_assert(kBars % 8 == 0, "barriers must be 8-byte aligned");
};

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  return kp >= 0 && (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
}

// Two f32 values as packed bf16 pairs hi + lo (hi the nearest bf16, lo
// the nearest bf16 to the remainder): a and b are the first and second
// column, in the low and high halves.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFullMask, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFullMask, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFullMask, v, 1);
  return v + __shfl_xor_sync(kFullMask, v, 2);
}

template <int DH, int kWG>
__device__ __forceinline__ void producer(
    unsigned char* base, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ qpos, const int* __restrict__ kpos, int Sq,
    int Sk, int H, int KV, int causal, int window) {
  using L = Layout<DH, kWG>;
  constexpr int kVec = DH / 8;  // 16-byte chunks per row
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * L::kBr, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* q_full = empty + L::kStages;
  int* kpos_s = reinterpret_cast<int*>(base + L::kKpos);
  int* meta = reinterpret_cast<int*>(base + L::kMeta);

  const size_t q_stride = static_cast<size_t>(H) * DH;
  const __nv_bfloat16* q_b = q + static_cast<size_t>(b) * Sq * q_stride +
                             static_cast<size_t>(h) * DH;
  for (int i = lane; i < L::kBr * kVec; i += 32) {
    const int r = i / kVec, c = i % kVec;
    const bool ok = q0 + r < Sq;
    cp_async16(base + L::kQ + sw128_offset(r, c * 8, L::kBr),
               q_b + static_cast<size_t>(ok ? q0 + r : 0) * q_stride + c * 8,
               ok ? 16 : 0);
  }
  mbar_arrive_on_cp_async(q_full);

  int qmin = INT_MAX, qmax = INT_MIN;
  for (int r = lane; r < L::kBr && q0 + r < Sq; r += 32) {
    const int p = qpos[q0 + r];
    qmin = min(qmin, p);
    qmax = max(qmax, p);
  }
  qmin = __reduce_min_sync(kFullMask, qmin);
  qmax = __reduce_max_sync(kFullMask, qmax);

  const size_t kv_stride = static_cast<size_t>(KV) * DH;
  const size_t kv_b = static_cast<size_t>(b) * Sk * kv_stride +
                      static_cast<size_t>(g) * DH;
  int stage = 0, phase = 1;  // the first pass finds every slot free
  const int n_tiles = (Sk + kBc - 1) / kBc;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBc;
    const int kp0 = k0 + lane < Sk ? kpos[k0 + lane] : -1;
    const int kp1 = k0 + lane + 32 < Sk ? kpos[k0 + lane + 32] : -1;
    const int kmin = __reduce_min_sync(
        kFullMask, min(kp0 >= 0 ? kp0 : INT_MAX, kp1 >= 0 ? kp1 : INT_MAX));
    const int kmax = __reduce_max_sync(
        kFullMask, max(kp0 >= 0 ? kp0 : INT_MIN, kp1 >= 0 ? kp1 : INT_MIN));
    const bool all_valid = __all_sync(kFullMask, kp0 >= 0 && kp1 >= 0);
    if (kmin > kmax) continue;                           // no key at all
    if (causal && qmax < kmin) continue;                 // above the diagonal
    if (window > 0 && qmin - kmax >= window) continue;   // behind the window
    const int every = all_valid && (!causal || qmin >= kmax) &&
                      (window <= 0 || qmax - kmin < window);

    mbar_wait(&empty[stage], phase);
    kpos_s[stage * kBc + lane] = kp0;
    kpos_s[stage * kBc + lane + 32] = kp1;
    if (lane == 0) {
      meta[2 * stage] = k0;
      meta[2 * stage + 1] = every;
    }
    unsigned char* k_s = base + L::kKV + stage * 2 * L::kTile;
    unsigned char* v_s = k_s + L::kTile;
    for (int i = lane; i < kBc * kVec; i += 32) {
      const int r = i / kVec, c = i % kVec;
      const bool ok = k0 + r < Sk;
      const size_t off =
          kv_b + static_cast<size_t>(ok ? k0 + r : 0) * kv_stride + c * 8;
      const uint32_t so = sw128_offset(r, c * 8, kBc);
      cp_async16(k_s + so, k + off, ok ? 16 : 0);
      cp_async16(v_s + so, v + off, ok ? 16 : 0);
    }
    mbar_arrive(&full[stage]);             // releases the positions, header
    mbar_arrive_on_cp_async(&full[stage]); // once this lane's copies land
    if (++stage == L::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  mbar_wait(&empty[stage], phase);         // end of stream
  if (lane == 0) meta[2 * stage] = -1;
  mbar_arrive(&full[stage]);
  mbar_arrive_on_cp_async(&full[stage]);
}

template <int DH, int kWG, bool kRR>
__device__ __forceinline__ void consumer(
    unsigned char* base, const int* __restrict__ qpos,
    __nv_bfloat16* __restrict__ out, int Sq, int H, int causal, int window,
    float scale_log2) {
  using L = Layout<DH, kWG>;
  constexpr int kO = DH / 2;  // O accumulator floats per thread
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * L::kBr, h = blockIdx.y, b = blockIdx.z;
  // this thread's two rows (block-local) and its column pair in each n8
  const int row0 = wg * 64 + warp * 16 + (lane >> 2);
  // the token ring: warpgroup w waits at barrier 1 + w for its turn and
  // passes the token to the next
  const int my_turn = 1 + wg, next_turn = 1 + (wg + 1) % kWG;
  const int c2 = (lane & 3) * 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* q_full = empty + L::kStages;
  const int* kpos_s = reinterpret_cast<const int*>(base + L::kKpos);
  const int* meta = reinterpret_cast<const int*>(base + L::kMeta);

  const int qp0 = qpos[min(q0 + row0, Sq - 1)];
  const int qp1 = qpos[min(q0 + row0 + 8, Sq - 1)];
  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.0f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;
  const uint32_t q_addr = smem_u32(base + L::kQ) + wg * 64 * 128;
  if (kRR && wg == kWG - 1) named_bar_arrive(1, 256);  // warpgroup 0 first
  mbar_wait(q_full, 0);

  int stage = 0, phase = 0;
  while (true) {
    mbar_wait(&full[stage], phase);
    const int k0 = meta[2 * stage];
    if (k0 < 0) break;
    const int every = meta[2 * stage + 1];
    fence_proxy_async_shared();
    const uint32_t k_addr = smem_u32(base + L::kKV + stage * 2 * L::kTile);
    const uint32_t v_addr = k_addr + L::kTile;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    fence_regs(s);
    if (kRR) named_bar_sync(my_turn, 256);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      wgmma_m64n64k16_ss(
          s,
          sw128_desc(q_addr + (ks / 4) * L::kBr * 128 + (ks % 4) * 32, 16,
                     1024),
          sw128_desc(k_addr + (ks / 4) * kBc * 128 + (ks % 4) * 32, 16, 1024),
          ks > 0);
    wgmma_commit();
    if (kRR) named_bar_arrive(next_turn, 256);
    wgmma_wait<0>();
    fence_regs(s);

    // mask the raw scores: s[4i + 0/1] are row0's columns 8i + c2 + 0/1,
    // s[4i + 2/3] row0 + 8's; a masked score is -1e30 (times the positive
    // scale below, still far below any real one)
    if (!every) {
      const int* kp_s = kpos_s + stage * kBc;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int2 kp = *reinterpret_cast<const int2*>(kp_s + 8 * i + c2);
        if (!visible(qp0, kp.x, causal, window)) s[4 * i + 0] = kNeg;
        if (!visible(qp0, kp.y, causal, window)) s[4 * i + 1] = kNeg;
        if (!visible(qp1, kp.x, causal, window)) s[4 * i + 2] = kNeg;
        if (!visible(qp1, kp.y, causal, window)) s[4 * i + 3] = kNeg;
      }
    }

    // the running max in the log2 domain (scale * log2 e > 0 keeps order)
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * i + 0], s[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    mx0 = fmaxf(m0, quad_max(mx0) * scale_log2);
    mx1 = fmaxf(m1, quad_max(mx1) * scale_log2);
    const float corr0 = exp2f(m0 - mx0), corr1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    // a row that has seen only masked keys so far takes p = 0 for them
    // (2^(-1e30 c + 0)); subtracting its masked-level max instead would
    // leave the product's rounding residual, ~1e22, in the exponent.  Its
    // l and O stay 0 until a visible key arrives.
    const float mu0 = mx0 < kMaskedMax ? 0.0f : mx0;
    const float mu1 = mx1 < kMaskedMax ? 0.0f : mx1;

    // p = 2^(s * scale log2 e - m), its f32 row sums, and its A fragments
    // in two bf16 parts, p = hi + lo to ~2^-16 relative: for key step kk,
    // a[0] = row0 cols 16kk + c2, a[1] = row0 + 8 there, a[2] and a[3]
    // the same 8 columns on
    uint32_t pa[4][4], pb[4][4];
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float p00 = exp2f(fmaf(s[4 * i + 0], scale_log2, -mu0));
      const float p01 = exp2f(fmaf(s[4 * i + 1], scale_log2, -mu0));
      const float p10 = exp2f(fmaf(s[4 * i + 2], scale_log2, -mu1));
      const float p11 = exp2f(fmaf(s[4 * i + 3], scale_log2, -mu1));
      rs0 += p00 + p01;
      rs1 += p10 + p11;
      split_bf16(p00, p01, pa[i / 2][(i % 2) * 2 + 0],
                 pb[i / 2][(i % 2) * 2 + 0]);
      split_bf16(p10, p11, pa[i / 2][(i % 2) * 2 + 1],
                 pb[i / 2][(i % 2) * 2 + 1]);
    }
    l0 = l0 * corr0 + rs0;
    l1 = l1 * corr1 + rs1;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[4 * j + 0] *= corr0;
      o[4 * j + 1] *= corr0;
      o[4 * j + 2] *= corr1;
      o[4 * j + 3] *= corr1;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        asm volatile("" : "+r"(pa[kk][j]), "+r"(pb[kk][j])::"memory");
    fence_regs(o);
    if (kRR) named_bar_sync(my_turn, 256);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t desc_v =
          sw128_desc(v_addr + kk * 16 * 128, kBc * 128, 1024);
      if constexpr (DH == 64) {
        wgmma_m64n64k16_rs_tb(o, pa[kk], desc_v);
        wgmma_m64n64k16_rs_tb(o, pb[kk], desc_v);
      } else if constexpr (DH == 128) {
        wgmma_m64n128k16_rs_tb(o, pa[kk], desc_v);
        wgmma_m64n128k16_rs_tb(o, pb[kk], desc_v);
      } else {
        wgmma_m64n192k16_rs_tb(o, pa[kk], desc_v);
        wgmma_m64n192k16_rs_tb(o, pb[kk], desc_v);
      }
    }
    wgmma_commit();
    if (kRR) named_bar_arrive(next_turn, 256);
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == L::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
  const int r0 = q0 + row0, r1 = r0 + 8;
  const size_t q_stride = static_cast<size_t>(H) * DH;
  __nv_bfloat16* o0 = out + (static_cast<size_t>(b) * Sq + r0) * q_stride +
                      static_cast<size_t>(h) * DH + c2;
  __nv_bfloat16* o1 = o0 + 8 * q_stride;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 0] * inv0, o[4 * j + 1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

template <int DH, int kWG, bool kRR>
__global__ void __launch_bounds__(Layout<DH, kWG>::kThreads)
    flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const int* __restrict__ qpos,
                         const int* __restrict__ kpos,
                         __nv_bfloat16* __restrict__ out, int Sq, int Sk,
                         int H, int KV, int causal, int window,
                         float scale_log2) {
  using L = Layout<DH, kWG>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::kBars);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&bars[s], 64);                         // full
      mbar_init(&bars[L::kStages + s], 4 * kWG);       // empty
    }
    mbar_init(&bars[2 * L::kStages], 32);              // q
    mbar_init_fence();
  }
  __syncthreads();
  // the roles never meet again at a block-wide barrier
  if (threadIdx.x >= 128 * kWG)
    producer<DH, kWG>(base, q, k, v, qpos, kpos, Sq, Sk, H, KV, causal,
                      window);
  else
    consumer<DH, kWG, kRR>(base, qpos, out, Sq, H, causal, window,
                           scale_log2);
}

template <int DH, int kWG = 1, bool kRR = false>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           const void* kpos, void* out, int B, int Sq, int Sk, int H, int KV,
           int causal, int window, float scale, cudaStream_t stream) {
  using L = Layout<DH, kWG>;
  // above 48 KB a block's dynamic shared memory must be allowed first (per
  // device, so on every launch)
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_prefill_kernel<DH, kWG, kRR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((Sq + L::kBr - 1) / L::kBr, H, B);
  flash_prefill_kernel<DH, kWG, kRR><<<grid, L::kThreads, L::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kpos), static_cast<__nv_bfloat16*>(out), Sq, Sk,
      H, KV, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Sq, H, dh) bf16; k, v: (B, Sk, KV, dh) bf16; qpos: (Sq,) i32;
// kpos: (Sk,) i32; out: (B, Sq, H, dh) bf16.  All contiguous, q, k and v
// 16-byte aligned.  dh is 64, 128 or 192.
REPRO_EXPORT int flash_attention_prefill(const void* q, const void* k,
                                         const void* v, const void* qpos,
                                         const void* kpos, void* out, int B,
                                         int Sq, int Sk, int H, int KV,
                                         int dh, int causal, int window,
                                         float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64)
    return launch<64>(q, k, v, qpos, kpos, out, B, Sq, Sk, H, KV, causal,
                      window, scale, s);
  if (dh == 128)
    return launch<128>(q, k, v, qpos, kpos, out, B, Sq, Sk, H, KV, causal,
                       window, scale, s);
  if (dh == 192)
    return launch<192>(q, k, v, qpos, kpos, out, B, Sq, Sk, H, KV, causal,
                       window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The instance of |wg| consumer warpgroups, with the token ring where wg
// is negative; cudaErrorInvalidValue where there is none.
REPRO_EXPORT int flash_attention_prefill_instance(
    const void* q, const void* k, const void* v, const void* qpos,
    const void* kpos, void* out, int B, int Sq, int Sk, int H, int KV, int dh,
    int causal, int window, float scale, int wg, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_WIDE(DH_, WG_, RR_, CODE_)                                      \
  if (dh == DH_ && wg == CODE_)                                               \
    return launch<DH_, WG_, RR_>(q, k, v, qpos, kpos, out, B, Sq, Sk, H, KV,  \
                                 causal, window, scale, s);
  REPRO_WIDE(64, 1, false, 1)
  REPRO_WIDE(64, 2, false, 2)
  REPRO_WIDE(64, 3, false, 3)
  REPRO_WIDE(64, 2, true, -2)
  REPRO_WIDE(64, 3, true, -3)
  REPRO_WIDE(128, 1, false, 1)
  REPRO_WIDE(128, 2, false, 2)
  REPRO_WIDE(128, 2, true, -2)
  REPRO_WIDE(192, 1, false, 1)
#undef REPRO_WIDE
  return static_cast<int>(cudaErrorInvalidValue);
}
