// Experiment, not part of the package: the flash prefill kernel with the
// softmax overlapped with the tensor cores (tile j + 1's QK^T issued with
// tile j's value product, its softmax run under that product) and, at dh
// 64 and 128, two consumer warpgroups a block in a named-barrier
// ping-pong; tools/flash_variants.py builds it beside the package's
// csrc/flash_attention.cu and times both (PERF.md, PR 17: slower than the
// package's kernel at every path shape on an H100, so the package keeps
// one warpgroup a block).  Entry points as the package's
// flash_attention_prefill, plus flash_attention_prefill_instance(...,
// wg, stream) for 1 or 2 consumer warpgroups.
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
// Design, for sm_90a: one block per (query tile, query head, batch row)
// (kWG consumer warpgroups of 64 query rows each) with a producer warp that
// keeps a ring of K/V tiles (kBc = 64 key rows) in flight with cp.async while
// the consumers compute.  Tiles are stored in the 128-byte swizzle that
// the wgmma descriptors name: a bf16 row of 64 is one swizzle row, dh 128
// and 192 are two and three 64-column blocks.  S = Q K^T is wgmma
// m64n64k16 from shared memory (both operands K-major); the online
// softmax runs in f32 registers in the accumulator layout (row max and sum
// over the four lanes that share a row); P's two bf16 parts are packed in
// registers and are the A operands of O += P_hi V + P_lo V (wgmma
// m64n{dh}k16, V read N-major through the transpose bit), O in f32
// registers.
//
// Long prefills (the seamless encoder, every chunk) overlap the softmax
// with the tensor cores two ways:
//  - inside a warpgroup, tile j + 1's S = Q K^T is issued together with
//    tile j's value product, and the softmax of tile j + 1 runs in place
//    in the score registers while the value product is still on the
//    tensor cores (wgmma_wait<1>); P's registers stay pinned until that
//    product has been waited for, and only then does p become tile j + 1's
//    A fragments (holding a second P beside the first made ptxas serialize
//    every wgmma, C7513);
//  - at dh 64 and 128, two consumer warpgroups a block (128 query rows)
//    share each K/V tile and ping-pong through two named barriers: a
//    warpgroup issues its two products only after the other has issued
//    its own and then lets the other go, so the tensor cores take one
//    warpgroup's products while the other runs its softmax.
// A 288-thread block compiles within 168 registers a thread, which holds
// the two-warpgroup consumer at dh 64 and 128 (tools/flash_variants.py
// prints each instance's registers); at dh 192 (the O accumulator alone
// is 96 f32 a thread) the instance has one consumer warpgroup a block,
// pipelined but without the ping-pong.  Every instance uses 64-row key
// tiles.  The ring holds three or four stages, so that the producer keeps
// a tile in flight while the consumers hold two (the S tile and the
// value-product tile).
//
// Short queries (Sq <= kSplitMaxSq: the seamless decode step's
// cross-attention, one query over 4096 frames) split the keys instead: one
// block per (key range, head, row) over fixed kSplitKeys-key ranges from
// key 0 (so a row's rounding follows Sk alone, never the batch or the
// card), one warpgroup of 64 rows, each writing f32 partials (m in the
// log2 domain, l, the unnormalised acc) per (query row, head); a merge
// kernel in the same call writes M = max m, L = sum l 2^(m - M), out = sum
// acc 2^(m - M) / max(L, 1e-30).  A range with no visible key leaves m at
// the masked level and l = acc = 0, which the merge weighs exactly 0.
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

// Waits at named barrier ``id`` (1..15; 0 is __syncthreads) until
// ``count`` threads (a multiple of 32) have arrived, this one included.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Arrives at named barrier ``id`` without waiting.
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

namespace {

constexpr float kLog2e = 1.4426950408889634f;
// a running max (log2 domain) below this comes from masked scores alone:
// -1e30 times the scale, 0.18 at dh 64, 0.13 at dh 128 and 0.10 at dh 192
constexpr float kMaskedMax = -1e28f;
constexpr int kBc = 64;  // key rows per tile
// the key split for short queries: at most this many query rows, keys cut
// into ranges of this many from key 0
constexpr int kSplitMaxSq = 16;
constexpr int kSplitKeys = 512;
constexpr int kSmemBudget = 200 * 1024;  // the ring's share of 227 KB

// Shared-memory layout, byte offsets from a 1024-byte aligned base: kWG
// consumer warpgroups of 64 query rows, as many ring stages (3 or 4) as
// the budget takes.
template <int DH, int kWG>
struct Layout {
  static constexpr int kBr = 64 * kWG;                    // query rows
  static constexpr int kTile = kBc * DH * 2;              // one K or V tile
  static constexpr int kQ = 0;                            // [DH/64][kBr][64]
  static constexpr int kStages =
      (kSmemBudget - kBr * DH * 2) / (2 * kTile) >= 4 ? 4 : 3;
  static constexpr int kKV = kQ + kBr * DH * 2;           // [stage][K, V]
  static constexpr int kKpos = kKV + kStages * 2 * kTile; // int [stage][kBc]
  static constexpr int kMeta = kKpos + kStages * kBc * 4; // int [stage][2]
  static constexpr int kBars = kMeta + kStages * 2 * 4;   // u64 full, empty, q
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 32;        // + producer warp
  static_assert(kBars % 8 == 0, "barriers must be 8-byte aligned");
  static_assert(kBytes <= 232448, "over the block's shared memory");
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

template <int N>
__device__ __forceinline__ void fence_u32(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// The producer warp: the block's Q tile, then the key tiles [kt_begin,
// kt_end) that some (query, key) pair of the block can see, each with its
// positions and header, ended by a header of -1.
template <int DH, int kWG>
__device__ __forceinline__ void producer(
    unsigned char* base, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ qpos, const int* __restrict__ kpos, int q0,
    int kt_begin, int kt_end, int Sq, int Sk, int H, int KV, int causal,
    int window) {
  using L = Layout<DH, kWG>;
  constexpr int kVec = DH / 8;   // 16-byte chunks per row
  constexpr int kKp = kBc / 32;  // key positions per lane
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* q_full = empty + L::kStages;
  int* kpos_s = reinterpret_cast<int*>(base + L::kKpos);
  int* meta = reinterpret_cast<int*>(base + L::kMeta);

  const size_t q_stride = static_cast<size_t>(H) * DH;
  const __nv_bfloat16* q_b = q + static_cast<size_t>(b) * Sq * q_stride +
                             static_cast<size_t>(h) * DH;
  // lane's chunks (r, c) of the row-major [rows][kVec] chunk grid, 32
  // apart, stepped without a division
  auto step = [](int& r, int& c) {
    c += 32 % kVec;
    r += 32 / kVec;
    if (c >= kVec) {
      c -= kVec;
      ++r;
    }
  };
#pragma unroll 1
  for (int r = lane / kVec, c = lane % kVec; r < L::kBr; step(r, c)) {
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
  // a tile's key positions, loaded one tile ahead
  auto load_kpos = [&](int kt, int (&kp)[kKp]) {
#pragma unroll
    for (int u = 0; u < kKp; ++u) {
      const int key = kt * kBc + lane + 32 * u;
      kp[u] = kt < kt_end && key < Sk ? kpos[key] : -1;
    }
  };
  int kp_next[kKp];
  load_kpos(kt_begin, kp_next);
  int stage = 0, phase = 1;  // the first pass finds every slot free
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBc;
    int kp[kKp];
#pragma unroll
    for (int u = 0; u < kKp; ++u) kp[u] = kp_next[u];
    load_kpos(kt + 1, kp_next);
    int lo = INT_MAX, hi = INT_MIN;
    bool all_valid = true;
#pragma unroll
    for (int u = 0; u < kKp; ++u) {
      lo = min(lo, kp[u] >= 0 ? kp[u] : INT_MAX);
      hi = max(hi, kp[u] >= 0 ? kp[u] : INT_MIN);
      all_valid = all_valid && kp[u] >= 0;
    }
    const int kmin = __reduce_min_sync(kFullMask, lo);
    const int kmax = __reduce_max_sync(kFullMask, hi);
    all_valid = __all_sync(kFullMask, all_valid);
    if (kmin > kmax) continue;                           // no key at all
    if (causal && qmax < kmin) continue;                 // above the diagonal
    if (window > 0 && qmin - kmax >= window) continue;   // behind the window
    const int every = all_valid && (!causal || qmin >= kmax) &&
                      (window <= 0 || qmax - kmin < window);

    mbar_wait(&empty[stage], phase);
#pragma unroll
    for (int u = 0; u < kKp; ++u) kpos_s[stage * kBc + lane + 32 * u] = kp[u];
    if (lane == 0) {
      meta[2 * stage] = k0;
      meta[2 * stage + 1] = every;
    }
    unsigned char* k_s = base + L::kKV + stage * 2 * L::kTile;
    unsigned char* v_s = k_s + L::kTile;
#pragma unroll 4
    for (int r = lane / kVec, c = lane % kVec; r < kBc; step(r, c)) {
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

// S = Q K^T for one warpgroup's 64 rows over a kBc-row key tile.
template <int DH, int kWG>
__device__ __forceinline__ void issue_scores(float (&s)[kBc / 2],
                                             uint32_t q_addr,
                                             uint32_t k_addr) {
  using L = Layout<DH, kWG>;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    const uint64_t da =
        sw128_desc(q_addr + (ks / 4) * L::kBr * 128 + (ks % 4) * 32, 16, 1024);
    const uint64_t db =
        sw128_desc(k_addr + (ks / 4) * kBc * 128 + (ks % 4) * 32, 16, 1024);
    wgmma_m64n64k16_ss(s, da, db, ks > 0);
  }
}

// O += P_hi V + P_lo V over a kBc-row value tile.
template <int DH>
__device__ __forceinline__ void issue_values(float (&o)[DH / 2],
                                             const uint32_t (&pa)[kBc / 16][4],
                                             const uint32_t (&pb)[kBc / 16][4],
                                             uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < kBc / 16; ++kk) {
    const uint64_t desc_v = sw128_desc(v_addr + kk * 16 * 128, kBc * 128, 1024);
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
}

// The online softmax of one tile's raw scores s (this thread's rows row0
// and row0 + 8 at positions qp0, qp1): masks them (unless every pair is
// visible), updates the running max m and sum l, returns the correction
// of the earlier tiles' O, and leaves p = 2^(s * scale log2 e - m) in s.
// s[4i + 0/1] are row0's columns 8i + c2 + 0/1, s[4i + 2/3] row0 + 8's.
__device__ __forceinline__ void softmax_tile(
    float (&s)[kBc / 2], const int* __restrict__ kp_s, int every, int qp0,
    int qp1, int c2, int causal, int window, float scale_log2, float& m0,
    float& m1, float& l0, float& l1, float& corr0, float& corr1) {
  constexpr int kN8 = kBc / 8;
  // a masked score is -1e30 (times the positive scale below, still far
  // below any real one)
  if (!every) {
#pragma unroll
    for (int i = 0; i < kN8; ++i) {
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
  for (int i = 0; i < kN8; ++i) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * i + 0], s[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  mx0 = fmaxf(m0, quad_max(mx0) * scale_log2);
  mx1 = fmaxf(m1, quad_max(mx1) * scale_log2);
  corr0 = exp2f(m0 - mx0);
  corr1 = exp2f(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  // a row that has seen only masked keys so far takes p = 0 for them
  // (2^(-1e30 c + 0)); subtracting its masked-level max instead would
  // leave the product's rounding residual, ~1e22, in the exponent.  Its
  // l and O stay 0 until a visible key arrives.
  const float mu0 = mx0 < kMaskedMax ? 0.0f : mx0;
  const float mu1 = mx1 < kMaskedMax ? 0.0f : mx1;
  float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
  for (int i = 0; i < kN8; ++i) {
    s[4 * i + 0] = exp2f(fmaf(s[4 * i + 0], scale_log2, -mu0));
    s[4 * i + 1] = exp2f(fmaf(s[4 * i + 1], scale_log2, -mu0));
    s[4 * i + 2] = exp2f(fmaf(s[4 * i + 2], scale_log2, -mu1));
    s[4 * i + 3] = exp2f(fmaf(s[4 * i + 3], scale_log2, -mu1));
    rs0 += s[4 * i + 0] + s[4 * i + 1];
    rs1 += s[4 * i + 2] + s[4 * i + 3];
  }
  l0 = l0 * corr0 + rs0;
  l1 = l1 * corr1 + rs1;
}

// p's A fragments in two bf16 parts, p = hi + lo to ~2^-16 relative: for
// key step kk, a[0] = row0 cols 16kk + c2, a[1] = row0 + 8 there, a[2] and
// a[3] the same 8 columns on.
__device__ __forceinline__ void split_p(const float (&p)[kBc / 2],
                                        uint32_t (&pa)[kBc / 16][4],
                                        uint32_t (&pb)[kBc / 16][4]) {
#pragma unroll
  for (int i = 0; i < kBc / 8; ++i) {
    split_bf16(p[4 * i + 0], p[4 * i + 1], pa[i / 2][(i % 2) * 2 + 0],
               pb[i / 2][(i % 2) * 2 + 0]);
    split_bf16(p[4 * i + 2], p[4 * i + 3], pa[i / 2][(i % 2) * 2 + 1],
               pb[i / 2][(i % 2) * 2 + 1]);
  }
}

// One consumer warpgroup: its 64 query rows over the producer's tile
// stream, tile j + 1's scores in flight with tile j's value product (p
// stays f32 in the score registers until that product has retired, then
// becomes tile j + 1's A fragments), and, with two warpgroups, the
// ping-pong of their products.  Writes the rows' output, or with kSplit
// the key range's f32 partials.
template <int DH, int kWG, bool kSplit>
__device__ __forceinline__ void consumer(
    unsigned char* base, const int* __restrict__ qpos,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part, int q0,
    int Sq, int H, int causal, int window, float scale_log2) {
  using L = Layout<DH, kWG>;
  constexpr int kO = DH / 2;  // O accumulator floats per thread
  constexpr int kK = kBc / 16;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  // this thread's two rows (block-local) and its column pair in each n8
  const int row0 = wg * 64 + warp * 16 + (lane >> 2);
  const int c2 = (lane & 3) * 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* q_full = empty + L::kStages;
  const int* kpos_s = reinterpret_cast<const int*>(base + L::kKpos);
  const int* meta = reinterpret_cast<const int*>(base + L::kMeta);
  // named barriers 1 and 2: warpgroup w waits at 1 + w for its turn
  const int my_turn = 1 + wg, their_turn = 2 - wg;

  const int qp0 = qpos[min(q0 + row0, Sq - 1)];
  const int qp1 = qpos[min(q0 + row0 + 8, Sq - 1)];
  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.0f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;
  const uint32_t q_addr = smem_u32(base + L::kQ) + wg * 64 * 128;
  if (kWG == 2 && wg == 1) named_bar_arrive(1, 256);  // warpgroup 0 first
  mbar_wait(q_full, 0);

  int stage = 0, phase = 0;
  mbar_wait(&full[stage], phase);
  if (meta[2 * stage] >= 0) {
    float s[kBc / 2];
    uint32_t pa[kK][4], pb[kK][4];
    float corr0, corr1;
    fence_proxy_async_shared();
    if (kWG == 2) named_bar_sync(my_turn, 256);
    fence_regs(s);
    wgmma_fence();
    issue_scores<DH, kWG>(
        s, q_addr, smem_u32(base + L::kKV + stage * 2 * L::kTile));
    wgmma_commit();
    if (kWG == 2) named_bar_arrive(their_turn, 256);
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(s, kpos_s + stage * kBc, meta[2 * stage + 1], qp0, qp1,
                      c2, causal, window, scale_log2, m0, m1, l0, l1, corr0,
                      corr1);
    split_p(s, pa, pb);
    int pv_stage = stage;  // the tile whose value product is pending
    if (++stage == L::kStages) {
      stage = 0;
      phase ^= 1;
    }
    while (true) {
      mbar_wait(&full[stage], phase);
      if (meta[2 * stage] < 0) break;
      fence_proxy_async_shared();
      const uint32_t k_addr = smem_u32(base + L::kKV + stage * 2 * L::kTile);
      const uint32_t v_addr =
          smem_u32(base + L::kKV + pv_stage * 2 * L::kTile) + L::kTile;
      if (kWG == 2) named_bar_sync(my_turn, 256);
      fence_regs(s);
      fence_regs(o);
      fence_u32(pa);
      fence_u32(pb);
      wgmma_fence();
      issue_scores<DH, kWG>(s, q_addr, k_addr);
      wgmma_commit();
      issue_values<DH>(o, pa, pb, v_addr);
      wgmma_commit();
      if (kWG == 2) named_bar_arrive(their_turn, 256);
      wgmma_wait<1>();  // the scores; the value product may still run
      fence_regs(s);
      softmax_tile(s, kpos_s + stage * kBc, meta[2 * stage + 1], qp0,
                        qp1, c2, causal, window, scale_log2, m0, m1, l0, l1,
                        corr0, corr1);
      wgmma_wait<0>();
      fence_regs(o);
      fence_u32(pa);  // the product has read them: only now reusable
      fence_u32(pb);
      if (lane == 0) mbar_arrive(&empty[pv_stage]);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        o[4 * j + 0] *= corr0;
        o[4 * j + 1] *= corr0;
        o[4 * j + 2] *= corr1;
        o[4 * j + 3] *= corr1;
      }
      split_p(s, pa, pb);
      pv_stage = stage;
      if (++stage == L::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    fence_regs(o);
    fence_u32(pa);
    fence_u32(pb);
    wgmma_fence();
    issue_values<DH>(
        o, pa, pb, smem_u32(base + L::kKV + pv_stage * 2 * L::kTile) + L::kTile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_u32(pa);
    fence_u32(pb);
    if (lane == 0) mbar_arrive(&empty[pv_stage]);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int r0 = q0 + row0, r1 = r0 + 8;
  const size_t q_stride = static_cast<size_t>(H) * DH;
  if constexpr (kSplit) {
    // part: m [n_ranges][B Sq H], l [n_ranges][B Sq H], acc [n_ranges][B Sq
    // H][DH]; range blockIdx.x
    const size_t rows = static_cast<size_t>(gridDim.z) * Sq * H;
    const size_t z = blockIdx.x;
    const size_t i0 = (static_cast<size_t>(b) * Sq + r0) * H + h;
    const size_t i1 = i0 + 8 * static_cast<size_t>(H);
    float* acc = part + 2 * gridDim.x * rows;
    if (r0 < Sq) {
      if (c2 == 0) {
        part[z * rows + i0] = m0;
        part[(gridDim.x + z) * rows + i0] = l0;
      }
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<float2*>(acc + (z * rows + i0) * DH + 8 * j + c2) =
            make_float2(o[4 * j + 0], o[4 * j + 1]);
    }
    if (r1 < Sq) {
      if (c2 == 0) {
        part[z * rows + i1] = m1;
        part[(gridDim.x + z) * rows + i1] = l1;
      }
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<float2*>(acc + (z * rows + i1) * DH + 8 * j + c2) =
            make_float2(o[4 * j + 2], o[4 * j + 3]);
    }
  } else {
    const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
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
}

// The block: kWG consumer warpgroups (warps 0 .. 4 kWG - 1) and the
// producer after them.  Without kSplit, query tile blockIdx.x over every
// key tile; with kSplit, the one query tile over key range blockIdx.x
// (kSplitKeys keys).
template <int DH, int kWG, bool kSplit>
__global__ void __launch_bounds__(Layout<DH, kWG>::kThreads, 1)
    flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const int* __restrict__ qpos,
                         const int* __restrict__ kpos,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ part, int Sq, int Sk, int H,
                         int KV, int causal, int window, float scale_log2) {
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
  const int n_tiles = (Sk + kBc - 1) / kBc;
  const int q0 = kSplit ? 0 : blockIdx.x * L::kBr;
  constexpr int kRange = kSplitKeys / kBc;             // tiles a key range
  const int kt0 = kSplit ? blockIdx.x * kRange : 0;
  const int kt1 = kSplit ? min(n_tiles, kt0 + kRange) : n_tiles;
  // the roles never meet again at a block-wide barrier
  if (threadIdx.x >= L::kConsumers)
    producer<DH, kWG>(base, q, k, v, qpos, kpos, q0, kt0, kt1, Sq, Sk, H, KV,
                      causal, window);
  else
    consumer<DH, kWG, kSplit>(base, qpos, out, part, q0, Sq, H, causal,
                              window, scale_log2);
}

// The key ranges' f32 partials merged into out: one block per (row, query,
// head), one thread per output column; the log2-domain max.
template <int DH>
__global__ void __launch_bounds__(DH) flash_merge_kernel(
    const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
    int rows, int n_ranges) {
  const int r = blockIdx.x, d = threadIdx.x;
  const float* pm = part;
  const float* pl = part + static_cast<size_t>(n_ranges) * rows;
  const float* pa = part + 2 * static_cast<size_t>(n_ranges) * rows;
  float mx = kNeg;
  for (int z = 0; z < n_ranges; ++z) mx = fmaxf(mx, pm[z * rows + r]);
  float l = 0.0f, a = 0.0f;
  for (int z = 0; z < n_ranges; ++z) {
    const float w = exp2f(pm[z * rows + r] - mx);
    l += pl[z * rows + r] * w;
    a += pa[(static_cast<size_t>(z) * rows + r) * DH + d] * w;
  }
  out[static_cast<size_t>(r) * DH + d] = __float2bfloat16(a / fmaxf(l, 1e-30f));
}

template <int DH, int kWG, bool kSplit>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           const void* kpos, void* out, float* part, int B, int Sq, int Sk,
           int H, int KV, int causal, int window, float scale,
           cudaStream_t stream) {
  using L = Layout<DH, kWG>;
  auto kernel = flash_prefill_kernel<DH, kWG, kSplit>;
  // above 48 KB a block's dynamic shared memory must be allowed first (per
  // device, so on every launch)
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_ranges = (Sk + kSplitKeys - 1) / kSplitKeys;
  dim3 grid(kSplit ? n_ranges : (Sq + L::kBr - 1) / L::kBr, H, B);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kpos), static_cast<__nv_bfloat16*>(out), part,
      Sq, Sk, H, KV, causal, window, scale * kLog2e);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !kSplit) return static_cast<int>(e);
  flash_merge_kernel<DH><<<B * Sq * H, DH, 0, stream>>>(
      part, static_cast<__nv_bfloat16*>(out), B * Sq * H, n_ranges);
  return static_cast<int>(cudaGetLastError());
}

// Every instance by (head dim, consumer warpgroups, key split);
// cudaErrorInvalidValue where there is none.  wg 0 picks by shape: one
// warpgroup for at most 64 query rows (one tile fills it) and at dh 192,
// else two.
int dispatch(int dh, int wg, bool split, const void* q, const void* k,
             const void* v, const void* qpos, const void* kpos, void* out,
             float* part, int B, int Sq, int Sk, int H, int KV, int causal,
             int window, float scale, cudaStream_t s) {
  if (wg == 0) wg = split || Sq <= 64 || dh == 192 ? 1 : 2;
#define REPRO_FLASH(DH_, WG_, SPLIT_)                                         \
  if (dh == DH_ && wg == WG_ && split == SPLIT_)                              \
    return launch<DH_, WG_, SPLIT_>(q, k, v, qpos, kpos, out, part, B, Sq,    \
                                    Sk, H, KV, causal, window, scale, s);
  REPRO_FLASH(64, 2, false)
  REPRO_FLASH(128, 2, false)
  REPRO_FLASH(64, 1, false)
  REPRO_FLASH(128, 1, false)
  REPRO_FLASH(192, 1, false)
  REPRO_FLASH(64, 1, true)
  REPRO_FLASH(128, 1, true)
  REPRO_FLASH(192, 1, true)
#undef REPRO_FLASH
  return static_cast<int>(cudaErrorInvalidValue);
}

bool valid_shapes(int B, int Sq, int Sk, int H, int KV) {
  return B > 0 && Sq > 0 && Sk > 0 && KV > 0 && H % KV == 0;
}

}  // namespace

// q: (B, Sq, H, dh) bf16; k, v: (B, Sk, KV, dh) bf16; qpos: (Sq,) i32;
// kpos: (Sk,) i32; out: (B, Sq, H, dh) bf16.  All contiguous, q, k and v
// 16-byte aligned.  dh is 64, 128 or 192.  The instance for the shape,
// every key tile of a query tile in one block.
REPRO_EXPORT int flash_attention_prefill(const void* q, const void* k,
                                         const void* v, const void* qpos,
                                         const void* kpos, void* out, int B,
                                         int Sq, int Sk, int H, int KV,
                                         int dh, int causal, int window,
                                         float scale, void* stream) {
  if (!valid_shapes(B, Sq, Sk, H, KV))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dh, 0, false, q, k, v, qpos, kpos, out, nullptr, B, Sq,
                  Sk, H, KV, causal, window, scale,
                  static_cast<cudaStream_t>(stream));
}

// As flash_attention_prefill for Sq <= 16, with the keys split into
// ceil(Sk / 512) ranges of 512 from key 0, one block per (range, head,
// row); part is f32 scratch of n_ranges * B * Sq * H * (dh + 2) floats,
// and a merge kernel after the split kernel (launched here, on the same
// stream) writes out.
REPRO_EXPORT int flash_attention_prefill_split(
    const void* q, const void* k, const void* v, const void* qpos,
    const void* kpos, void* out, void* part, int B, int Sq, int Sk, int H,
    int KV, int dh, int causal, int window, float scale, void* stream) {
  if (!valid_shapes(B, Sq, Sk, H, KV) || Sq > kSplitMaxSq)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dh, 0, true, q, k, v, qpos, kpos, out,
                  static_cast<float*>(part), B, Sq, Sk, H, KV, causal, window,
                  scale, static_cast<cudaStream_t>(stream));
}

// As flash_attention_prefill through the instance of wg consumer
// warpgroups (1 or 2; at dh 192 only 1), for holding and timing the
// instances against each other (chip_smoke.py).
REPRO_EXPORT int flash_attention_prefill_instance(
    const void* q, const void* k, const void* v, const void* qpos,
    const void* kpos, void* out, int B, int Sq, int Sk, int H, int KV, int dh,
    int causal, int window, float scale, int wg, void* stream) {
  if (!valid_shapes(B, Sq, Sk, H, KV) || wg < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dh, wg, false, q, k, v, qpos, kpos, out, nullptr, B,
                  Sq, Sk, H, KV, causal, window, scale,
                  static_cast<cudaStream_t>(stream));
}
