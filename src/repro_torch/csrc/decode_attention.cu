// Decode attention: one query token per batch row, in four entry points
// that share this file's helpers.  decode_attention_paged reads the shared
// (n_pages, page, KV, dh) KV pool through (B, P) block tables;
// decode_attention_dense reads dense per-row (B, S_max, KV, dh) caches,
// which may be ring buffers; attention_short_queries takes the flash op's
// few bidirectional queries (one decode step's cross-attention) over
// (B, Sk, KV, dh) keys whose positions mask them; the three are one
// split-KV kernel template (below) with three row-address policies, in an
// f32 instance and, where a kv head serves many query heads, a
// tensor-core one.  decode_attention_paged_lse (further down) computes the
// partial softmax over a stripe of the block tables and has its own
// header.
//
// The paged kernel replaces src/repro/kernels/decode_attention/kernel.py::
// decode_attention_paged_kernel (its pl.pallas_call at kernel.py:266); the
// function is src/repro/models/attention.py::decode_attention_paged with
// n_splits = 1: f32 scores scaled by dh^-1/2, positions >= cache_len (and,
// with a window, < cache_len - window) masked to -1e30, unnormalised exp,
// f32 p into the value sum, one late divide by max(l, 1e-30).
//
// The dense kernel replaces src/repro/kernels/decode_attention/kernel.py::
// decode_attention_kernel (its pl.pallas_call at kernel.py:113); the
// function is src/repro/models/attention.py::decode_attention, which
// Model.decode_step runs in every attention layer: the same arithmetic,
// slot idx valid iff idx < cache_len or (window > 0 and cache_len >=
// S_max).  That ring rule is over physical slots (once a ring has wrapped
// every slot holds one of the last S_max tokens), unlike the paged
// kernel's logical window: for any window it reduces to "the first
// min(cache_len, S_max) slots", so the dense kernel takes no window.
//
// What bounds both on the H100: bytes.  Each (row, kv head) reads its live
// K and V rows once (2 * dh * 2 bytes each) and does 4 flops a head per
// element read: about rep flops per byte, under the f32 cores' ~20 flops
// per byte (67 TFLOP/s over 3.35 TB/s) below 8 query heads a kv head, so
// there the limit is bytes in flight and the arithmetic stays in f32 on
// the CUDA cores; from 8 (nemotron's 12, granite's 48) the f32 dots pass
// that ridge and the tensor-core instance takes them (further down).  The first kernels of this file ran one block per
// (kv head, row) -- 64 blocks on 132 SMs at llama3.2-1b's 8 lanes -- each
// walking its whole cache with no load in flight across tiles: 37x
// (paged) and 27x (dense ring) their byte bounds.
//
// Design: a split across blocks with a cp.async ring.  The grid is
// (KV * n_groups, B, n_sub).  A kv head's rep = H / KV query heads share
// every K/V tile a block loads; in the f32 instance, where rep * dh > 1024
// they are split into the fewest equal groups of at most 1024 / dh heads,
// one block each (the tensor-core instance takes up to 64 heads a
// block).  Sub-split z takes the contiguous rows [z * per, (z + 1) *
// per) of the row's cache, intersected with the row's live rows (a
// sub-split with no live row visits no tile), with per a fixed number of
// 64-row units (the op's SPLIT_UNITS, 4) and n_sub = ceil(rows / per): a
// row's partition, and so its rounding, is the same whatever the batch or
// the table's padded width (the engine's fused step pads tables to a pow2
// of the pages in use, its orchestrated step passes them whole; a count
// chosen from those shapes made the two steps' greedy streams part).
// Trailing sub-splits with no live row add exact zeros in the merge.
//
// A block walks its rows in tiles of 64 (32 at dh 192; 24 KB of K and V)
// held in a ring of three stages in shared memory, filled with 16-byte
// cp.async: two tiles are in flight while one is used.  The paged policy
// gathers each tile row by row through the block table (any page size;
// rows outside the live range are not loaded, never scratch page 0); the
// dense policy reads rows KV * dh apart.  Per tile, with the query heads
// taken in quads (a thread works for several heads at once, so each K or
// V element it reads is converted to f32 once per quad, not per head):
// scores by groups of 8 lanes, an item being 8 rows x kQS heads, each lane
// holding its 8-column chunks of the quad's q in registers and reading 16
// bytes of K a chunk, the partial dots reduced over the 8 lanes by a
// butterfly of shuffles that leaves row j's dots on lane j (kQS is the
// widest of 4, 2, 1 that still gives all 16 groups an item); one warp per
// head takes the tile max, rescales the head's running max and sum and
// writes p = exp(s - m) back once; then each thread adds p times 8 columns
// of V (one 16-byte load) into the kQP x 8 f32 accumulators of one (quad,
// chunk), threads beyond the block's chunks taking every R-th row (their
// partial sums added at the end, through the freed ring).  Per-tile
// latency (three block-wide barriers, the softmax's shuffle chains) on
// top of the copies still sets the time above the byte bound (PERF.md
// §6).  With n_sub = 1 the block writes out itself; otherwise it
// writes f32 partials (m, l and the unnormalised acc per (row, head)) to
// the op's scratch and merge_kernel writes out: M = max m, L = sum l
// exp(m - M), out = sum acc exp(m - M) / max(L, 1e-30).  A sub-split with
// no live row leaves m = -1e30, l = 0, acc = 0, which the merge weighs
// exactly 0 (exp(-1e30 - M) = 0 for a live M).
//
// Differs from the reference only for a row with cache_len == 0 (every
// position masked): the reference averages all values uniformly
// (exp(-1e30 - -1e30) = 1), these kernels visit no tile and write 0.  Every
// caller passes cache_len + 1 >= 1 (transformer.py _attn_decode and the
// paged decode step).
//
// Key positions (the kDenseKeyPos policy, attention_short_queries): every
// row sees all Sk keys, a key with a negative position is masked for every
// query (score -1e30, p = 0 even while the running max is still at that
// level), and a query whose keys are all masked gets 0 where the flash
// reference averages them.  The flash op folds a row's (query, head) pairs
// into the kv head's query heads, so short queries ride the same sub-splits
// (fixed 64-row units from key 0) and merge as a decode step does.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxOutPerThread = 8;
constexpr int kMaxOutputs = kThreads * kMaxOutPerThread;  // heads * dh a block
constexpr int kSplitUnit = 64;  // a sub-split's rows are a multiple of this
constexpr float kMaskedS = -1e29f;  // a score at or below this is masked
// The split-KV kernels' row-address policies: a dense per-row cache, the
// paged pool through block tables, and a dense cache whose key rows carry
// positions (a negative one masks the key; the flash op's short queries)
constexpr int kDenseRows = 0, kPagedRows = 1, kDenseKeyPos = 2;

// A kv head's query heads split into the fewest equal groups of at most
// kMaxOutputs / dh heads: n_groups blocks of up to hpb heads each.
struct HeadGroups {
  int n_groups, hpb;
};

inline HeadGroups head_groups(int rep, int dh) {
  const int max_heads = kMaxOutputs / dh;
  const int n = (rep + max_heads - 1) / max_heads;
  return {n, (rep + n - 1) / n};
}

// One bf16 of a packed pair, exactly, as an f32.
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// ------------------------------------------------- the split-KV decode

template <int DH>
struct Split {
  static constexpr int kRows = DH == 192 ? 32 : 64;  // K/V rows a tile
  static constexpr int kStages = 3;                  // ring depth
  static constexpr int kVec = DH / 8;                // 16-byte chunks a row
  static constexpr int kTile = kRows * DH;           // bf16 of one K or V tile
  static_assert(kSplitUnit % kRows == 0, "a sub-split is whole tiles");
  static_assert(kRows * kVec % kThreads == 0, "whole chunks a thread");
  // the end-of-block reduction ([replicas][heads][DH] <= 4096 floats)
  // reuses the ring
  static_assert(kStages * 2 * kTile * 2 >= 4096 * 4, "ring too small");
};
constexpr int kMaxQuad = 4;  // query heads a thread takes at once, at most

// Dynamic shared memory: the ring [stage][K, V][kRows][DH] bf16 (after
// the last tile, the end-of-block reduction), then f32 q [hpb][DH], p
// [kRows][hpb | 1] and the running max, sum and tile correction [hpb]
// each.
template <int DH>
size_t split_smem_bytes(int hpb) {
  using C = Split<DH>;
  return static_cast<size_t>(C::kStages) * 2 * C::kTile * 2 +
         (static_cast<size_t>(hpb) * DH + C::kRows * (hpb | 1) + 3 * hpb) *
             sizeof(float);
}

template <int DH, int kPolicy, int kQS, int kQP>
__global__ void __launch_bounds__(kThreads) split_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ tables,
    const int* __restrict__ cache_len, const int* __restrict__ kpos,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part, int B, int H,
    int KV, int hpb, int n_groups, int S, int per, int page, int P,
    int window, float scale) {
  using C = Split<DH>;
  constexpr bool kPaged = kPolicy == kPagedRows;
  constexpr bool kKeyPos = kPolicy == kDenseKeyPos;
  const int g = blockIdx.x / n_groups;  // kv head
  const int grp = blockIdx.x % n_groups;
  const int b = blockIdx.y;             // batch row
  const int z = blockIdx.z;             // sub-split
  const int n_sub = gridDim.z;
  const int rep = H / KV;
  const int h_first = g * rep + grp * hpb;
  const int nh = min(hpb, rep - grp * hpb);  // query heads of this block
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sp = hpb | 1;  // p row stride: odd, so the softmax warp's
                           // column reads hit 32 banks

  extern __shared__ __align__(16) unsigned char split_smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(split_smem);
  float* q_s = reinterpret_cast<float*>(ring + C::kStages * 2 * C::kTile);
  float* p_s = q_s + hpb * DH;
  float* m_s = p_s + C::kRows * sp;
  float* l_s = m_s + hpb;
  float* c_s = l_s + hpb;
  for (int r = tid; r < hpb; r += kThreads) {
    m_s[r] = kNeg;
    l_s[r] = 0.0f;
  }
  {
    const __nv_bfloat16* q_row = q + (static_cast<size_t>(b) * H + h_first) * DH;
    for (int i = tid; i < nh * DH; i += kThreads)
      q_s[i] = __bfloat162float(q_row[i]);
  }

  // the row's live rows (every row with key positions), and this
  // sub-split's share of them
  const int len = kKeyPos ? S : cache_len[b];
  const int hi = max(0, min(len, S));
  const int lo = kPaged && window > 0 ? max(0, len - window) : 0;
  const int r0 = max(lo, z * per), r1 = min(hi, (z + 1) * per);
  const int n_tiles = r1 > r0 ? (r1 - r0 + C::kRows - 1) / C::kRows : 0;

  // Query heads go in quads: a thread computes scores for kQS heads at
  // once and sums values for kQP (4, 2 or 1 each; the launch picks kQS
  // so that every lane group has a score item), so each K or V element it
  // reads is converted to f32 once per quad, not once per head.
  // scores: the tile's rows in blocks of 8; an item is (row block, quad),
  // and group sg of 8 lanes takes the items sg, sg + 16, ...; lane j
  // holds q's chunks j, j + 8, ... of the quad's heads in registers,
  // loaded from q_s when the quad changes
  const int s_quads = (nh + kQS - 1) / kQS;
  const int sg = tid >> 3, j = tid & 7;
  const int n_items = C::kRows / 8 * s_quads;
  float qv[kQS][DH / 64][8];
  int q_quad = -1;
  // value sums: thread tid owns 8 columns (chunk pc) of quad pq for the
  // rows prho + R_pv i
  const int n_pv = (nh + kQP - 1) / kQP * C::kVec;
  const int r_pv = kThreads / n_pv;
  const int pidx = tid % n_pv, prho = tid / n_pv;
  const bool pv_on = prho < r_pv;
  const int pq = pidx / C::kVec, pc = pidx % C::kVec;
  float acc[kQP][8];
#pragma unroll
  for (int hh = 0; hh < kQP; ++hh)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[hh][e] = 0.0f;

  // a tile's copies: every source offset first (the paged policy's table
  // reads all in flight together), then the 16-byte copies
  auto load_tile = [&](int i, int stage) {
    constexpr int kPer = C::kRows * C::kVec / kThreads;  // chunks a thread
    const int t0 = r0 + i * C::kRows;
    const int rows = min(C::kRows, r1 - t0);
    __nv_bfloat16* k_s = ring + stage * 2 * C::kTile;
    __nv_bfloat16* v_s = k_s + C::kTile;
    size_t off[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int x = tid + u * kThreads;
      const int pos = t0 + min(x / C::kVec, rows - 1);
      if constexpr (kPaged) {
        const int phys = __ldg(tables + static_cast<size_t>(b) * P + pos / page);
        off[u] = ((static_cast<size_t>(phys) * page + pos % page) * KV + g) * DH;
      } else {
        off[u] = ((static_cast<size_t>(b) * S + pos) * KV + g) * DH;
      }
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int x = tid + u * kThreads;
      const int t = x / C::kVec, c = x % C::kVec;
      if (t < rows) {
        cp_async16(k_s + t * DH + c * 8, k + off[u] + c * 8, 16);
        cp_async16(v_s + t * DH + c * 8, v + off[u] + c * 8, 16);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<C::kStages - 2>();
    __syncthreads();  // tile i has landed for every thread; tile i - 1's
                      // stage, p and corrections are free
    if (i + C::kStages - 1 < n_tiles)
      load_tile(i + C::kStages - 1, (i + C::kStages - 1) % C::kStages);
    cp_async_commit();
    const int rows = min(C::kRows, r1 - (r0 + i * C::kRows));
    const __nv_bfloat16* k_s = ring + (i % C::kStages) * 2 * C::kTile;
    const __nv_bfloat16* v_s = k_s + C::kTile;

    // 8 rows x kQS heads at a time: 8 kQS independent partial dots a
    // lane, then a butterfly over the group's 8 lanes (7 kQS shuffles)
    // leaves row j's full dots on lane j.  The trip count is the warp's (its 4 groups
    // take items base .. base + 3), so that every lane takes part in each
    // shuffle and a warp with no item skips the phase; a row past the
    // tile, or a head past the block's, sums only with itself and is not
    // stored.
    for (int base = sg & ~3; base < n_items; base += 16) {
      const int it = base + (sg & 3);
      const bool on = it < n_items;
      const int rb = on ? it / s_quads : 0, hq = on ? it % s_quads : 0;
      if (hq != q_quad) {
#pragma unroll
        for (int hh = 0; hh < kQS; ++hh) {
          const int r = min(hq * kQS + hh, nh - 1);
#pragma unroll
          for (int c = 0; c < DH / 64; ++c) {
            const float4* qr = reinterpret_cast<const float4*>(q_s + r * DH) +
                               2 * (j + 8 * c);
            const float4 a = qr[0], e = qr[1];
            qv[hh][c][0] = a.x; qv[hh][c][1] = a.y;
            qv[hh][c][2] = a.z; qv[hh][c][3] = a.w;
            qv[hh][c][4] = e.x; qv[hh][c][5] = e.y;
            qv[hh][c][6] = e.z; qv[hh][c][7] = e.w;
          }
        }
        q_quad = hq;
      }
      float d[8][kQS];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const uint4* kr = reinterpret_cast<const uint4*>(k_s + (rb * 8 + u) * DH);
#pragma unroll
        for (int hh = 0; hh < kQS; ++hh) d[u][hh] = 0.0f;
#pragma unroll
        for (int c = 0; c < DH / 64; ++c) {
          const uint4 w = kr[j + 8 * c];
          const float kf[8] = {bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y),
                               bf16_hi(w.y), bf16_lo(w.z), bf16_hi(w.z),
                               bf16_lo(w.w), bf16_hi(w.w)};
#pragma unroll
          for (int e = 0; e < 8; ++e)
#pragma unroll
            for (int hh = 0; hh < kQS; ++hh)
              d[u][hh] = fmaf(qv[hh][c][e], kf[e], d[u][hh]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)  // lanes with j & 4 keep rows 4..7
#pragma unroll
        for (int hh = 0; hh < kQS; ++hh) {
          const bool up = j & 4;
          d[u][hh] = (up ? d[u + 4][hh] : d[u][hh]) +
                     __shfl_xor_sync(kFullMask, up ? d[u][hh] : d[u + 4][hh], 4);
        }
#pragma unroll
      for (int u = 0; u < 2; ++u)  // then j & 2: rows + 2, 3
#pragma unroll
        for (int hh = 0; hh < kQS; ++hh) {
          const bool up = j & 2;
          d[u][hh] = (up ? d[u + 2][hh] : d[u][hh]) +
                     __shfl_xor_sync(kFullMask, up ? d[u][hh] : d[u + 2][hh], 2);
        }
#pragma unroll
      for (int hh = 0; hh < kQS; ++hh) {
        const bool up = j & 1;
        d[0][hh] = (up ? d[1][hh] : d[0][hh]) +
                   __shfl_xor_sync(kFullMask, up ? d[0][hh] : d[1][hh], 1);
      }
      const int t = rb * 8 + j;
      if (on && t < rows) {
        const bool dead = kKeyPos && kpos[r0 + i * C::kRows + t] < 0;
#pragma unroll
        for (int hh = 0; hh < kQS; ++hh)
          if (hq * kQS + hh < nh)
            p_s[t * sp + hq * kQS + hh] = dead ? kNeg : d[0][hh] * scale;
      }
    }
    __syncthreads();
    for (int r = warp; r < nh; r += kThreads / 32) {
      float* col = p_s + r;
      const float s0 = lane < rows ? col[lane * sp] : kNeg;
      const float s1 = lane + 32 < rows ? col[(lane + 32) * sp] : kNeg;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      // a masked key (kpos < 0) takes p = 0 even while the running max is
      // still at the masked level
      const float p0 = lane < rows && (!kKeyPos || s0 > kMaskedS)
                           ? expf(s0 - m_new) : 0.0f;
      const float p1 = lane + 32 < rows && (!kKeyPos || s1 > kMaskedS)
                           ? expf(s1 - m_new) : 0.0f;
      if (lane < rows) col[lane * sp] = p0;
      if (lane + 32 < rows) col[(lane + 32) * sp] = p1;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    if (pv_on) {
      const int h0 = pq * kQP;
#pragma unroll
      for (int hh = 0; hh < kQP; ++hh) {
        const float corr = c_s[min(h0 + hh, nh - 1)];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[hh][e] *= corr;
      }
      // two rows' loads issued together, then their products in order; a
      // head past the block's reads its neighbour's p and is not stored
      for (int t = prho; t < rows; t += 2 * r_pv) {
        float p[2][kQP];
        uint4 w[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const bool ok = t + u * r_pv < rows;
          const int tu = ok ? t + u * r_pv : t;
#pragma unroll
          for (int hh = 0; hh < kQP; ++hh)
            p[u][hh] = ok ? p_s[tu * sp + min(h0 + hh, nh - 1)] : 0.0f;
          w[u] = reinterpret_cast<const uint4*>(v_s + tu * DH)[pc];
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float vf[8] = {bf16_lo(w[u].x), bf16_hi(w[u].x),
                               bf16_lo(w[u].y), bf16_hi(w[u].y),
                               bf16_lo(w[u].z), bf16_hi(w[u].z),
                               bf16_lo(w[u].w), bf16_hi(w[u].w)};
#pragma unroll
          for (int hh = 0; hh < kQP; ++hh)
#pragma unroll
            for (int e = 0; e < 8; ++e)
              acc[hh][e] = fmaf(p[u][hh], vf[e], acc[hh][e]);
        }
      }
    }
  }

  // the row replicas' partial sums, added in replica order, through the
  // ring (free once every copy has landed and every thread is done)
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // [r_pv][nh][DH]
  if (pv_on) {
#pragma unroll
    for (int hh = 0; hh < kQP; ++hh) {
      const int h = pq * kQP + hh;
      if (h < nh) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          red[(prho * nh + h) * DH + pc * 8 + e] = acc[hh][e];
      }
    }
  }
  __syncthreads();
  const size_t bh_n = static_cast<size_t>(B) * H;
  const size_t bh0 = static_cast<size_t>(b) * H + h_first;  // first head
  for (int o = tid; o < nh * DH; o += kThreads) {
    const int r = o / DH;
    float a = 0.0f;
    for (int x = 0; x < r_pv; ++x) a += red[x * nh * DH + o];
    if (n_sub == 1) {
      out[bh0 * DH + o] = __float2bfloat16(a / fmaxf(l_s[r], 1e-30f));
    } else {
      // part: m [n_sub][B * H], l [n_sub][B * H], acc [n_sub][B * H][DH]
      part[2 * n_sub * bh_n + (z * bh_n + bh0) * DH + o] = a;
      if (o % DH == 0) {
        part[z * bh_n + bh0 + r] = m_s[r];
        part[bh_n * n_sub + z * bh_n + bh0 + r] = l_s[r];
      }
    }
  }
}

// ---------------------------- the split-KV decode on the tensor cores
//
// Where one kv head serves many query heads (H / KV >= kMmaMinRep: granite's
// 48, nemotron's 12) the f32 score dots above run past the f32 cores'
// ridge (~48 flops a byte of K at 48 heads, against ~20).  This instance
// takes the scores and the value sums to the tensor cores with
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), and one block takes all of
// a kv head's query heads (up to kMmaMaxHeads), so every K/V tile is read
// once per (kv head, row, sub-split), not once per head group.  The same
// sub-splits (fixed 64-row units from the row's first), ring, masks and
// merge as split_decode_kernel.
//
// Per tile of kRows keys held in the ring (rows padded by 16 bytes, so
// the ldmatrix rows of a warp hit distinct banks; rows past the sub-split
// zero-filled): the query heads, zero-padded to kMT tiles of 16, are the M
// dimension and q (bf16, in shared memory) the A operand; warp w takes the
// keys [w kRows / 4, (w + 1) kRows / 4) as N, its K rows as the B operand
// through ldmatrix.  Each row's tile max goes through shared memory (one
// partial a warp), so every thread holds the same running max for the
// rows of its fragments, and p = exp(s - m) in f32 is written to shared
// memory in two bf16 parts, p = hi + lo (p to ~2^-16, as the flash
// kernel's value product; a bf16 p moves the rounding).  Then warp w sums
// O[:, w dh / 4 .. (w + 1) dh / 4) += (P_hi + P_lo) V over the tile's keys,
// V through ldmatrix.trans, O in the mma fragments (48 x 128 f32 over 128
// threads: 48 registers a thread at granite's shape).  Each thread keeps
// the row sums of its own keys; they are added over the quad and then the
// warps, in a fixed order, at the end.
constexpr int kMmaMinRep = 8;     // query heads a kv head from which
constexpr int kMmaMaxHeads = 64;  // query heads a block, at most

template <int DH>
struct MmaSplit {
  static constexpr int kRows = Split<DH>::kRows;  // K/V rows a tile
  static constexpr int kStages = 3;
  static constexpr int kVec = DH / 8;             // 16-byte chunks a row
  static constexpr int kLd = DH + 8;              // bf16 a K/V or q row
  static constexpr int kPld = kRows + 8;          // bf16 a P row
  static constexpr int kTile = kRows * kLd;       // bf16 of one K or V tile
  static constexpr int kNT = kRows / 32;          // score n8 tiles a warp
  static constexpr int kVT = DH / 32;             // value n8 tiles a warp
  static_assert(kRows * kVec % kThreads == 0, "whole chunks a thread");
};

// Dynamic shared memory: the ring [stage][K, V][kRows][kLd] bf16, q
// [16 kMT][kLd] bf16, P hi and lo [16 kMT][kPld] bf16 each, then f32
// [4 warps][16 kMT] row partials (the tile max, and at the end the sums).
template <int DH, int kMT>
constexpr size_t mma_smem_bytes() {
  using C = MmaSplit<DH>;
  return (static_cast<size_t>(C::kStages) * 2 * C::kTile +
          16 * kMT * C::kLd + 2 * 16 * kMT * C::kPld) * 2 +
         4 * 16 * kMT * sizeof(float);
}

template <int DH, int kPolicy, int kMT>
__global__ void __launch_bounds__(kThreads) split_decode_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ tables,
    const int* __restrict__ cache_len, const int* __restrict__ kpos,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part, int B, int H,
    int KV, int hpb, int n_groups, int S, int per, int page, int P,
    int window, float scale) {
  using C = MmaSplit<DH>;
  constexpr bool kPaged = kPolicy == kPagedRows;
  constexpr bool kKeyPos = kPolicy == kDenseKeyPos;
  constexpr int kM = 16 * kMT;
  const int g = blockIdx.x / n_groups;  // kv head
  const int grp = blockIdx.x % n_groups;
  const int b = blockIdx.y;             // batch row
  const int z = blockIdx.z;             // sub-split
  const int n_sub = gridDim.z;
  const int rep = H / KV;
  const int h_first = g * rep + grp * hpb;
  const int nh = min(hpb, rep - grp * hpb);  // query heads of this block
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int fr = lane >> 2, fc = (lane & 3) * 2;  // fragment row, column

  extern __shared__ __align__(16) unsigned char split_smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(split_smem);
  __nv_bfloat16* q_s = ring + C::kStages * 2 * C::kTile;
  __nv_bfloat16* ph_s = q_s + kM * C::kLd;
  __nv_bfloat16* pl_s = ph_s + kM * C::kPld;
  float* red = reinterpret_cast<float*>(pl_s + kM * C::kPld);  // [4][kM]
  {
    const uint4* q_row = reinterpret_cast<const uint4*>(
        q + (static_cast<size_t>(b) * H + h_first) * DH);
    for (int i = tid; i < kM * C::kVec; i += kThreads) {
      const int r = i / C::kVec, c = i % C::kVec;
      *reinterpret_cast<uint4*>(q_s + r * C::kLd + c * 8) =
          r < nh ? q_row[r * C::kVec + c] : make_uint4(0, 0, 0, 0);
    }
  }

  const int len = kKeyPos ? S : cache_len[b];
  const int hi = max(0, min(len, S));
  const int lo = kPaged && window > 0 ? max(0, len - window) : 0;
  const int r0 = max(lo, z * per), r1 = min(hi, (z + 1) * per);
  const int n_tiles = r1 > r0 ? (r1 - r0 + C::kRows - 1) / C::kRows : 0;

  // rows past the sub-split are zero-filled: their p is 0, and 0 times
  // a stale (possibly non-finite) V row would not be
  auto load_tile = [&](int i, int stage) {
    constexpr int kPer = C::kRows * C::kVec / kThreads;  // chunks a thread
    const int t0 = r0 + i * C::kRows;
    const int rows = min(C::kRows, r1 - t0);
    __nv_bfloat16* k_s = ring + stage * 2 * C::kTile;
    __nv_bfloat16* v_s = k_s + C::kTile;
    size_t off[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int x = tid + u * kThreads;
      const int pos = t0 + min(x / C::kVec, rows - 1);
      if constexpr (kPaged) {
        const int phys = __ldg(tables + static_cast<size_t>(b) * P + pos / page);
        off[u] = ((static_cast<size_t>(phys) * page + pos % page) * KV + g) * DH;
      } else {
        off[u] = ((static_cast<size_t>(b) * S + pos) * KV + g) * DH;
      }
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int x = tid + u * kThreads;
      const int t = x / C::kVec, c = x % C::kVec;
      const int n = t < rows ? 16 : 0;
      cp_async16(k_s + t * C::kLd + c * 8, k + off[u] + c * 8, n);
      cp_async16(v_s + t * C::kLd + c * 8, v + off[u] + c * 8, n);
    }
  };

  float o[kMT][C::kVT][4];
  float m_run[kMT][2], l_run[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int j = 0; j < C::kVT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.0f;
    m_run[mt][0] = m_run[mt][1] = kNeg;
    l_run[mt][0] = l_run[mt][1] = 0.0f;
  }
  // ldmatrix lane addresses: x4 row r of matrix lane / 8 (A: rows + 8 for
  // odd matrices, columns + 8 for the upper two); x2 rows of lanes 0..15
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = lane & 7, b_col = ((lane >> 3) & 1) * 8;
  const int key0 = warp * (C::kRows / 4);  // this warp's first score key
  const int col0 = warp * (DH / 4);        // its first value column

#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<C::kStages - 2>();
    __syncthreads();  // tile i has landed (and q_s, at i = 0); tile i - 1's
                      // stage, P and row partials are free
    if (i + C::kStages - 1 < n_tiles)
      load_tile(i + C::kStages - 1, (i + C::kStages - 1) % C::kStages);
    cp_async_commit();
    const int rows = min(C::kRows, r1 - (r0 + i * C::kRows));
    const __nv_bfloat16* k_s = ring + (i % C::kStages) * 2 * C::kTile;
    const __nv_bfloat16* v_s = k_s + C::kTile;

    // S = q K^T over this warp's keys
    float sc[kMT][C::kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      uint32_t bk[C::kNT][2];
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt)
        ldmatrix_x2(bk[nt], smem_u32(k_s + (key0 + nt * 8 + b_row) * C::kLd +
                                     ks * 16 + b_col));
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        uint32_t aq[4];
        ldmatrix_x4(aq, smem_u32(q_s + (mt * 16 + a_row) * C::kLd + ks * 16 +
                                 a_col));
#pragma unroll
        for (int nt = 0; nt < C::kNT; ++nt) mma_m16n8k16_bf16(sc[mt][nt], aq,
                                                              bk[nt]);
      }
    }
    // scale, mask the keys past the tile's rows, and this warp's row max
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = key0 + nt * 8 + fc + (e & 1);
          const bool live =
              t < rows && !(kKeyPos && kpos[r0 + i * C::kRows + t] < 0);
          const float x = live ? sc[mt][nt][e] * scale : kNeg;
          sc[mt][nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float x = mx[hh];
        x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
        x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
        if ((lane & 3) == 0) red[warp * kM + mt * 16 + fr + 8 * hh] = x;
      }
    }
    __syncthreads();
    // the tile max over the warps, p = exp(s - m) in two bf16 parts
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = mt * 16 + fr + 8 * hh;
        const float tm = fmaxf(fmaxf(red[r], red[kM + r]),
                               fmaxf(red[2 * kM + r], red[3 * kM + r]));
        const float m_new = fmaxf(m_run[mt][hh], tm);
        corr[hh] = expf(m_run[mt][hh] - m_new);
        m_run[mt][hh] = m_new;
      }
      float ps[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          // a masked key takes p = 0 even at a masked-level running max
          const float s0 = sc[mt][nt][2 * hh], s1 = sc[mt][nt][2 * hh + 1];
          const float p0 = !kKeyPos || s0 > kMaskedS
                               ? expf(s0 - m_run[mt][hh]) : 0.0f;
          const float p1 = !kKeyPos || s1 > kMaskedS
                               ? expf(s1 - m_run[mt][hh]) : 0.0f;
          ps[hh] += p0 + p1;
          __nv_bfloat162 h2 = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(h2);
          __nv_bfloat162 l2 = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
          const int off = (mt * 16 + fr + 8 * hh) * C::kPld + key0 + nt * 8 +
                          fc;
          *reinterpret_cast<__nv_bfloat162*>(ph_s + off) = h2;
          *reinterpret_cast<__nv_bfloat162*>(pl_s + off) = l2;
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        l_run[mt][hh] = l_run[mt][hh] * corr[hh] + ps[hh];
#pragma unroll
      for (int j = 0; j < C::kVT; ++j) {
        o[mt][j][0] *= corr[0];
        o[mt][j][1] *= corr[0];
        o[mt][j][2] *= corr[1];
        o[mt][j][3] *= corr[1];
      }
    }
    __syncthreads();
    // O[:, this warp's columns] += (P_hi + P_lo) V over the tile's keys
#pragma unroll
    for (int ks = 0; ks < C::kRows / 16; ++ks) {
      uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int off = (mt * 16 + a_row) * C::kPld + ks * 16 + a_col;
        ldmatrix_x4(ah[mt], smem_u32(ph_s + off));
        ldmatrix_x4(al[mt], smem_u32(pl_s + off));
      }
#pragma unroll
      for (int j = 0; j < C::kVT; ++j) {
        uint32_t bv[2];
        ldmatrix_x2_trans(bv, smem_u32(v_s + (ks * 16 + b_col + b_row) *
                                                 C::kLd + col0 + j * 8));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_m16n8k16_bf16(o[mt][j], ah[mt], bv);
          mma_m16n8k16_bf16(o[mt][j], al[mt], bv);
        }
      }
    }
  }

  // the row sums: over the quad, then the warps in order
  cp_async_wait<0>();
  __syncthreads();  // every warp is past its last read of red
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float x = l_run[mt][hh];
      x += __shfl_xor_sync(kFullMask, x, 1);
      x += __shfl_xor_sync(kFullMask, x, 2);
      if ((lane & 3) == 0) red[warp * kM + mt * 16 + fr + 8 * hh] = x;
    }
  __syncthreads();
  const size_t bh_n = static_cast<size_t>(B) * H;
  const size_t bh0 = static_cast<size_t>(b) * H + h_first;  // first head
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = mt * 16 + fr + 8 * hh;
      if (r >= nh) continue;
      const float l = ((red[r] + red[kM + r]) + red[2 * kM + r]) +
                      red[3 * kM + r];
      if (n_sub == 1) {
        const float inv = 1.0f / fmaxf(l, 1e-30f);
        __nv_bfloat16* orow = out + (bh0 + r) * DH + col0 + fc;
#pragma unroll
        for (int j = 0; j < C::kVT; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
              __floats2bfloat162_rn(o[mt][j][2 * hh] * inv,
                                    o[mt][j][2 * hh + 1] * inv);
      } else {
        // part: m [n_sub][B * H], l [n_sub][B * H], acc [n_sub][B * H][DH]
        float* arow = part + 2 * n_sub * bh_n + (z * bh_n + bh0 + r) * DH +
                      col0 + fc;
#pragma unroll
        for (int j = 0; j < C::kVT; ++j)
          *reinterpret_cast<float2*>(arow + j * 8) =
              make_float2(o[mt][j][2 * hh], o[mt][j][2 * hh + 1]);
        if (warp == 0 && (lane & 3) == 0) {
          part[z * bh_n + bh0 + r] = m_run[mt][hh];
          part[bh_n * n_sub + z * bh_n + bh0 + r] = l;
        }
      }
    }
}

// The sub-splits' f32 partials merged into out (and, for the partial
// kernel, lse): one block per (row, head), one thread per output column.
template <int DH, bool kLse>
__global__ void __launch_bounds__(DH) merge_kernel(
    const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int BH, int n_sub) {
  const int bh = blockIdx.x, d = threadIdx.x;
  const float* pm = part;
  const float* pl = part + static_cast<size_t>(n_sub) * BH;
  const float* pa = part + 2 * static_cast<size_t>(n_sub) * BH;
  float mx = kNeg;
  for (int z = 0; z < n_sub; ++z) mx = fmaxf(mx, pm[z * BH + bh]);
  float l = 0.0f, a = 0.0f;
  for (int z = 0; z < n_sub; ++z) {
    const float w = expf(pm[z * BH + bh] - mx);
    l += pl[z * BH + bh] * w;
    a += pa[(static_cast<size_t>(z) * BH + bh) * DH + d] * w;
  }
  out[static_cast<size_t>(bh) * DH + d] = __float2bfloat16(a / fmaxf(l, 1e-30f));
  if constexpr (kLse) {
    if (d == 0) lse[bh] = mx + logf(fmaxf(l, 1e-30f));
  }
}

// The heads a thread takes at once in the value sums (kQP: 4, or the
// block's 1 or 2 heads) and in the scores (kQS: the widest of 4, 2, 1 not
// above kQP that still gives all 16 lane groups a score item, so that no
// warp idles in that phase; else 1).
template <int DH, int kPolicy>
auto split_kernel_for(int hpb) {
  constexpr int kBlocks = Split<DH>::kRows / 8;  // row blocks a tile
  const int qp = hpb >= kMaxQuad ? 4 : hpb >= 2 ? 2 : 1;
  auto busy = [&](int qs) { return kBlocks * ((hpb + qs - 1) / qs) >= 16; };
  const int qs = qp == 4 && busy(4) ? 4 : qp >= 2 && busy(2) ? 2 : 1;
  if (qp == 4)
    return qs == 4 ? split_decode_kernel<DH, kPolicy, 4, 4>
         : qs == 2 ? split_decode_kernel<DH, kPolicy, 2, 4>
                   : split_decode_kernel<DH, kPolicy, 1, 4>;
  if (qp == 2)
    return qs == 2 ? split_decode_kernel<DH, kPolicy, 2, 2>
                   : split_decode_kernel<DH, kPolicy, 1, 2>;
  return split_decode_kernel<DH, kPolicy, 1, 1>;
}

// A kv head's query heads on the tensor-core path: the fewest equal groups
// of at most kMmaMaxHeads, one block each (one group up to 64 heads).
inline HeadGroups mma_head_groups(int rep) {
  const int n = (rep + kMmaMaxHeads - 1) / kMmaMaxHeads;
  return {n, (rep + n - 1) / n};
}

template <int DH, int kPolicy>
auto mma_kernel_for(int hpb) {
  const int mt = (hpb + 15) / 16;
  return mt == 1   ? split_decode_mma_kernel<DH, kPolicy, 1>
         : mt == 2 ? split_decode_mma_kernel<DH, kPolicy, 2>
         : mt == 3 ? split_decode_mma_kernel<DH, kPolicy, 3>
                   : split_decode_mma_kernel<DH, kPolicy, 4>;
}

template <int DH>
size_t mma_smem_for(int hpb) {
  const int mt = (hpb + 15) / 16;
  return mt == 1   ? mma_smem_bytes<DH, 1>()
         : mt == 2 ? mma_smem_bytes<DH, 2>()
         : mt == 3 ? mma_smem_bytes<DH, 3>()
                   : mma_smem_bytes<DH, 4>();
}

// S: the rows a table or cache spans (P * page, or S_max); each sub-split
// takes per_units 64-row units of them, n_sub = ceil(S / (64 per_units)).
// H / KV >= kMmaMinRep takes the tensor-core instance, one block a kv head
// (up to 64 query heads); below, the f32 instance with its head groups.
template <int DH, int kPolicy>
int launch_split(const void* q, const void* k, const void* v,
                 const void* tables, const void* cache_len, const int* kpos,
                 void* out, float* part, int B, int H, int KV, int S,
                 int page, int P, int per_units, int window, float scale,
                 cudaStream_t stream) {
  if (per_units < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int rep = H / KV;
  const bool mma = rep >= kMmaMinRep;
  const HeadGroups hg = mma ? mma_head_groups(rep) : head_groups(rep, DH);
  const int per = per_units * kSplitUnit;
  const int n_sub = (S + per - 1) / per;
  const size_t smem = mma ? mma_smem_for<DH>(hg.hpb)
                          : split_smem_bytes<DH>(hg.hpb);
  auto kernel = mma ? mma_kernel_for<DH, kPolicy>(hg.hpb)
                    : split_kernel_for<DH, kPolicy>(hg.hpb);
  // above 48 KB a block's dynamic shared memory must be allowed first (per
  // device, so on every launch)
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(KV * hg.n_groups, B, n_sub);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(cache_len), kpos,
      static_cast<__nv_bfloat16*>(out), part, B, H, KV, hg.hpb, hg.n_groups,
      S, per, page, P, window, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_sub == 1) return static_cast<int>(e);
  merge_kernel<DH, false><<<B * H, DH, 0, stream>>>(
      part, static_cast<__nv_bfloat16*>(out), nullptr, B * H, n_sub);
  return static_cast<int>(cudaGetLastError());
}

template <int kPolicy>
int dispatch_split(int dh, const void* q, const void* k, const void* v,
                   const void* tables, const void* cache_len,
                   const void* kpos, void* out, void* part, int B, int H,
                   int KV, int S, int page, int P, int per_units, int window,
                   float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  const int* kp = static_cast<const int*>(kpos);
  if (dh == 64)
    return launch_split<64, kPolicy>(q, k, v, tables, cache_len, kp, out, pt,
                                    B, H, KV, S, page, P, per_units, window,
                                    scale, s);
  if (dh == 128)
    return launch_split<128, kPolicy>(q, k, v, tables, cache_len, kp, out, pt,
                                     B, H, KV, S, page, P, per_units, window,
                                     scale, s);
  if (dh == 192)
    return launch_split<192, kPolicy>(q, k, v, tables, cache_len, kp, out, pt,
                                     B, H, KV, S, page, P, per_units, window,
                                     scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: (B, H, dh) bf16; k_pool, v_pool: (n_pages, page, KV, dh) bf16, 16-byte
// aligned; tables: (B, P) i32; cache_len: (B,) i32; out: (B, H, dh) bf16.
// All contiguous.  dh is 64, 128 or 192.  The P * page rows are split
// into n_sub = ceil(P * page / (64 per_units)) sub-splits of per_units
// 64-row units each; with n_sub > 1, part is f32 scratch of n_sub * B * H *
// (dh + 2) floats and a second kernel merges the partials (launched here,
// on the same stream).
REPRO_EXPORT int decode_attention_paged(const void* q, const void* k_pool,
                                        const void* v_pool,
                                        const void* tables,
                                        const void* cache_len, void* out,
                                        void* part, int B, int H, int KV,
                                        int dh, int page, int P,
                                        int per_units, int window,
                                        float scale, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || page <= 0 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_split<kPagedRows>(dh, q, k_pool, v_pool, tables,
                                    cache_len, nullptr, out, part, B, H, KV,
                                    P * page, page, P, per_units, window,
                                    scale, stream);
}

// q: (B, H, dh) bf16; k_cache, v_cache: (B, S_max, KV, dh) bf16, 16-byte
// aligned; cache_len: (B,) i32; out: (B, H, dh) bf16.  All contiguous.  dh
// is 64, 128 or 192; any S_max >= 1 (no padding); per_units and part as
// for decode_attention_paged, over the S_max rows.
REPRO_EXPORT int decode_attention_dense(const void* q, const void* k_cache,
                                        const void* v_cache,
                                        const void* cache_len, void* out,
                                        void* part, int B, int H, int KV,
                                        int dh, int S_max, int per_units,
                                        float scale, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || S_max <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_split<kDenseRows>(dh, q, k_cache, v_cache, nullptr,
                                    cache_len, nullptr, out, part, B, H, KV,
                                    S_max, 1, 1, per_units, 0, scale, stream);
}

// Bidirectional attention of a few queries over their row's keys, through
// the dense policy with key positions: q: (B, Hq, dh) bf16, the queries of
// kv head g being Hq / KV consecutive rows (the flash op folds (query,
// head) pairs into them); k, v: (B, Sk, KV, dh) bf16, 16-byte aligned;
// kpos: (Sk,) i32, a negative position masking its key for every query;
// out: (B, Hq, dh) bf16.  Every row sees all Sk keys (no cache_len), cut
// into sub-splits of per_units 64-row units from key 0, merged by a second
// kernel as decode_attention_dense does.  A query whose keys are all
// masked gets 0.
REPRO_EXPORT int attention_short_queries(const void* q, const void* k,
                                         const void* v, const void* kpos,
                                         void* out, void* part, int B,
                                         int Hq, int KV, int dh, int Sk,
                                         int per_units, float scale,
                                         void* stream) {
  if (B <= 0 || KV <= 0 || Hq % KV != 0 || Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_split<kDenseKeyPos>(dh, q, k, v, nullptr, nullptr, kpos, out,
                                      part, B, Hq, KV, Sk, 1, 1, per_units, 0,
                                      scale, stream);
}

// ---------------------------------------------------------------------------
// The partial (LSE) paged kernel.
//
// Replaces src/repro/kernels/decode_attention/kernel.py::
// decode_attention_paged_lse_kernel (its pl.pallas_call at kernel.py:314,
// body _paged_kernel_lse at :175): the same masked scores over only the
// pages of this call's tables, flushing out = acc / max(l, 1e-30) (bf16,
// normalised over those pages) and lse = m + log(max(l, 1e-30)) (f32), the
// partial that models/attention.py::combine_lse_partials merges across the
// stripes of the logical page axis (tensor-parallel serving's LSE split,
// when the kv heads do not divide the mesh: one call per stripe).
//
// What bounds it on the H100: bytes, as the paged kernel.  A stripe is
// short (qwen2-1.5b at tp 4: 8 rows x 2 kv heads, 32 pages of 16), so one
// block per (kv head, row) gave 16 blocks on 132 SMs, each walking up to 32
// pages with no load in flight across pages: 133x its byte bound.
//
// Design: a split across blocks.  The grid is (KV * n_groups, B, n_sub):
// the rep = H / KV query heads of a kv head share every page load, split,
// where rep * dh > 1024, into the fewest equal groups of at most 1024 / dh
// heads, one block each, as the split-KV kernel above does; sub-split z
// takes the rows [z * per, (z + 1) * per) of the call's table, per a fixed
// number of 64-row units (the op's LSE_SPLIT_UNITS, 1: a stripe is short)
// and n_sub = ceil(P * page / per), intersected with the row's live rows:
// fixed boundaries, as the split-KV kernel's, so a row's partition, and
// with it its rounding,
// never follows the batch, the table's padded width or the card (the
// engine's fused step pads tables to a pow2, its orchestrated step passes
// them whole; a count chosen from those shapes and the SM count rounded
// one row two ways).  A sub-split visits the pages its rows touch and
// masks the rows outside it, so a page need not divide the 64-row unit.
// The pages are double-buffered with cp.async: the next page's K and V are
// in flight while the current page is scored and summed.  Per page: scores
// into shared memory (one thread a (head, slot)), one warp per head takes
// the page max, rescales the head's running max and sum and writes p back
// (one exp per (head, slot)), then each thread updates its up to 8 (head,
// dh) accumulators.  With n_sub = 1 the block writes out and lse itself;
// otherwise each block writes f32 partials to the op's scratch and
// merge_kernel merges them, lse = M + log(max(L, 1e-30)) besides out.
//
// A fully masked row is the normal case here, not an edge case: a short
// row has no positions in the later stripes (the caller passes cache_len
// clipped at 0 there) or sub-splits (trailing ones past its rows, or past
// a padded table's live width).  Such a block visits no page and
// leaves m = -1e30, l = 0, acc = 0, which the merge weighs exactly 0
// (exp(-1e30 - M) = 0 for a live M); with no live sub-split at all it
// writes out 0 and lse = -1e30 + log(1e-30), which f32 rounds to -1e30:
// finite and far below any real lse, so combine_lse_partials gives the
// stripe weight exactly 0.  It never writes NaN or -inf.  The reference
// writes the same lse but the uniform average of the row's values as out;
// the merge weighs either by 0.
//
// A stripe is a column slice of the block tables; the op makes it
// contiguous (it is B * P / n int32 entries) and passes it as a table of
// width P / n.

namespace {

constexpr int kLseWarps = kThreads / 32;
constexpr int kLseMaxPage = 64;      // the softmax warp takes two slots a lane

// Shared K/V rows padded by 16 bytes: cp.async needs 16-byte aligned rows,
// and rows 4 words apart spread a warp's reads of 8 rows over 32 banks.
template <int DH>
__host__ __device__ constexpr int lse_row_words() { return DH / 2 + 4; }

template <int DH>
size_t lse_smem_bytes(int hpb, int page) {
  return (static_cast<size_t>(hpb) * DH + hpb * page + 3 * hpb) *
             sizeof(float) +
         4 * static_cast<size_t>(page) * lse_row_words<DH>() * sizeof(unsigned);
}

template <int DH>
__global__ void __launch_bounds__(kThreads) paged_lse_split_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ cache_len, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, float* __restrict__ part, int B, int H, int KV,
    int hpb, int n_groups, int page, int P, int per, int window,
    float scale) {
  constexpr int kRowWords = lse_row_words<DH>();
  constexpr int kVecPerRow = DH / 8;  // 16-byte vectors per K/V row
  const int g = blockIdx.x / n_groups;  // kv head
  const int grp = blockIdx.x % n_groups;
  const int b = blockIdx.y;           // batch row
  const int z = blockIdx.z;           // sub-split
  const int n_sub = gridDim.z;
  const int rep = H / KV;
  const int h_first = g * rep + grp * hpb;
  const int nh = min(hpb, rep - grp * hpb);  // query heads of this block
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  extern __shared__ unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);   // [hpb][DH]
  float* s_s = q_s + hpb * DH;                       // [hpb][page]
  float* m_s = s_s + hpb * page;                     // [hpb] running max
  float* l_s = m_s + hpb;                            // [hpb] running sum
  float* c_s = l_s + hpb;                            // [hpb] page correction
  // [buf][K, V][page][kRowWords] at the next 16-byte aligned address
  // (cp.async's destinations)
  const uint32_t kv_at = smem_u32(c_s + hpb);
  unsigned* kv_s = reinterpret_cast<unsigned*>(
      reinterpret_cast<unsigned char*>(c_s + hpb) + ((16 - (kv_at & 15)) & 15));

  const __nv_bfloat16* q_row = q + (static_cast<size_t>(b) * H + h_first) * DH;
  for (int i = tid; i < nh * DH; i += kThreads)
    q_s[i] = __bfloat162float(q_row[i]);
  for (int r = tid; r < nh; r += kThreads) {
    m_s[r] = kNeg;
    l_s[r] = 0.0f;
  }

  // this sub-split's live rows [r0, r1) and the pages they touch
  const int len = cache_len[b];
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int r0 = max(lo, z * per);
  const int r1 = min(min(len, P * page), (z + 1) * per);
  const int p_begin = r0 / page;
  const int p_end = r1 > r0 ? (r1 + page - 1) / page : p_begin;

  auto load_page = [&](int pg, int buf) {
    const int phys = tables[static_cast<size_t>(b) * P + pg];
    unsigned* k_s = kv_s + buf * 2 * page * kRowWords;
    unsigned* v_s = k_s + page * kRowWords;
    for (int i = tid; i < page * kVecPerRow; i += kThreads) {
      const int t = i / kVecPerRow, c = i % kVecPerRow;
      const size_t off =
          ((static_cast<size_t>(phys) * page + t) * KV + g) * DH + c * 8;
      cp_async16(k_s + t * kRowWords + c * 4, k_pool + off, 16);
      cp_async16(v_s + t * kRowWords + c * 4, v_pool + off, 16);
    }
    cp_async_commit();
  };

  float acc[kMaxOutPerThread];
#pragma unroll
  for (int j = 0; j < kMaxOutPerThread; ++j) acc[j] = 0.0f;
  const int n_out = nh * DH;

  if (p_begin < p_end) load_page(p_begin, 0);
  __syncthreads();  // q_s, m_s, l_s
  for (int pg = p_begin; pg < p_end; ++pg) {
    const int buf = (pg - p_begin) & 1;
    if (pg + 1 < p_end) {
      load_page(pg + 1, buf ^ 1);  // its buffer was released at the last sync
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this page's K and V have landed for every thread
    const unsigned* k_s = kv_s + buf * 2 * page * kRowWords;
    const unsigned* v_s = k_s + page * kRowWords;
    for (int i = tid; i < nh * page; i += kThreads) {
      const int r = i / page, t = i % page;
      const float* qr = q_s + r * DH;
      const unsigned* kr = k_s + t * kRowWords;
      float dot = 0.0f;
#pragma unroll 8
      for (int d2 = 0; d2 < DH / 2; ++d2) {
        const float2 kk = bf16x2_to_float2(kr[d2]);
        dot += qr[2 * d2] * kk.x + qr[2 * d2 + 1] * kk.y;
      }
      const int pos = pg * page + t;
      const bool valid = pos >= r0 && pos < r1;
      s_s[r * page + t] = valid ? dot * scale : kNeg;
    }
    __syncthreads();
    for (int r = warp; r < nh; r += kLseWarps) {
      float* sr = s_s + r * page;
      const float s0 = lane < page ? sr[lane] : kNeg;
      const float s1 = lane + 32 < page ? sr[lane + 32] : kNeg;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = lane < page ? expf(s0 - m_new) : 0.0f;
      const float p1 = lane + 32 < page ? expf(s1 - m_new) : 0.0f;
      if (lane < page) sr[lane] = p0;
      if (lane + 32 < page) sr[lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxOutPerThread; ++j) {
      const int idx = tid + j * kThreads;
      if (idx >= n_out) break;
      const int r = idx / DH, d = idx % DH;
      const float* pr = s_s + r * page;
      float pv = 0.0f;
      for (int t = 0; t < page; ++t) {
        const float2 vv = bf16x2_to_float2(v_s[t * kRowWords + (d >> 1)]);
        pv += pr[t] * ((d & 1) ? vv.y : vv.x);
      }
      acc[j] = acc[j] * c_s[r] + pv;
    }
    __syncthreads();  // the buffer and s_s are free for the next page
  }

  const size_t bh0 = static_cast<size_t>(b) * H + h_first;  // first head
#pragma unroll
  for (int j = 0; j < kMaxOutPerThread; ++j) {
    const int idx = tid + j * kThreads;
    if (idx >= n_out) break;
    const int r = idx / DH;
    if (n_sub == 1) {
      out[bh0 * DH + idx] = __float2bfloat16(acc[j] / fmaxf(l_s[r], 1e-30f));
      if (idx % DH == 0) lse[bh0 + r] = m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
    } else {
      // part: m [n_sub][B * H], l [n_sub][B * H], acc [n_sub][B * H][DH]
      const size_t bh_n = static_cast<size_t>(B) * H;
      part[2 * n_sub * bh_n + (z * bh_n + bh0) * DH + idx] = acc[j];
      if (idx % DH == 0) {
        part[z * bh_n + bh0 + r] = m_s[r];
        part[bh_n * n_sub + z * bh_n + bh0 + r] = l_s[r];
      }
    }
  }
}

template <int DH>
int launch_lse(const void* q, const void* k_pool, const void* v_pool,
               const void* tables, const void* cache_len, void* out,
               float* lse, float* part, int B, int H, int KV, int page, int P,
               int per_units, int window, float scale, cudaStream_t stream) {
  const HeadGroups hg = head_groups(H / KV, DH);
  const size_t smem = lse_smem_bytes<DH>(hg.hpb, page) + 16;
  if (page > kLseMaxPage || per_units < 1 || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = per_units * kSplitUnit;
  const int n_sub = (P * page + per - 1) / per;
  dim3 grid(KV * hg.n_groups, B, n_sub);
  paged_lse_split_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(tables), static_cast<const int*>(cache_len),
      static_cast<__nv_bfloat16*>(out), lse, part, B, H, KV, hg.hpb,
      hg.n_groups, page, P, per, window, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_sub == 1) return static_cast<int>(e);
  merge_kernel<DH, true><<<B * H, DH, 0, stream>>>(
      part, static_cast<__nv_bfloat16*>(out), lse, B * H, n_sub);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// As decode_attention_paged, plus lse: (B, H) f32.  tables is the (B, P)
// table of this call's pages (a stripe, made contiguous by the caller),
// its P * page rows split into n_sub = ceil(P * page / (64 per_units))
// sub-splits of per_units 64-row units each; with n_sub > 1, part is f32
// scratch of n_sub * B * H * (dh + 2) floats and a second kernel merges
// the partials (launched here, on the same stream).  The page is at most
// 64 slots.
REPRO_EXPORT int decode_attention_paged_lse(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* cache_len, void* out, void* lse, void* part, int B, int H,
    int KV, int dh, int page, int P, int per_units, int window, float scale,
    void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || page <= 0 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* pt = static_cast<float*>(part);
  if (dh == 64)
    return launch_lse<64>(q, k_pool, v_pool, tables, cache_len, out, l, pt, B,
                          H, KV, page, P, per_units, window, scale, s);
  if (dh == 128)
    return launch_lse<128>(q, k_pool, v_pool, tables, cache_len, out, l, pt,
                           B, H, KV, page, P, per_units, window, scale, s);
  if (dh == 192)
    return launch_lse<192>(q, k_pool, v_pool, tables, cache_len, out, l, pt,
                           B, H, KV, page, P, per_units, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
