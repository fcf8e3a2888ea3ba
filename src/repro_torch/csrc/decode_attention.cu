// Decode attention: one query token per batch row, in three entry points
// that share this file's helpers.  decode_attention_paged (below) reads the
// shared (n_pages, page, KV, dh) KV pool through (B, P) block tables;
// decode_attention_paged_lse (after it) computes the partial softmax over
// a stripe of those tables, split across blocks; decode_attention_dense
// (further down) reads dense per-row (B, S_max, KV, dh) caches and has its
// own header.
//
// The paged kernel.
//
// Replaces src/repro/kernels/decode_attention/kernel.py::
// decode_attention_paged_kernel (its pl.pallas_call at kernel.py:266); the
// function is src/repro/models/attention.py::decode_attention_paged with
// n_splits = 1: f32 scores scaled by dh^-1/2, positions >= cache_len (and,
// with a window, < cache_len - window) masked to -1e30, unnormalised exp,
// f32 p into the value sum, one late divide by max(l, 1e-30).
//
// What bounds it on the H100: bytes.  Each (row, kv head) reads its
// cache_len K and V rows once (2 * dh * 2 bytes each) and does 4 flops per
// element read, about 1 flop per byte, so the pool read is the whole cost;
// at serving batch sizes the B * KV blocks (64 for llama3.2-1b at 8 lanes)
// leave half the 132 SMs idle and one block walks its pages in sequence,
// so the simple kernel is latency bound well above the byte bound.
//
// Design: one block per (kv head, batch row); the block's rep = H / KV query
// heads share every K/V page it loads.  The block reads its own row of the
// block table and walks only the logical pages that hold unmasked positions
// (cache_len and the window bound the loop), loading one physical page of K
// and V into shared memory per step with 16-byte loads.  Scores go to shared
// memory; each thread owns up to 8 (head, dh) outputs and keeps their
// running max, sum and accumulator in registers (the online softmax of the
// Pallas kernel).  Shared rows are padded by one word so the score loop's
// threads, which read different token rows, hit different banks.
//
// Differs from the reference only for a row with cache_len == 0 (every
// position masked): the reference averages all P * page values uniformly
// (exp(-1e30 - -1e30) = 1), this kernel visits no page and writes 0.  The
// engine always passes cache_len + 1 >= 1 (transformer.py:500).
//
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
// Design: a split across blocks.  The grid is (KV, B, n_sub): sub-split z
// takes the contiguous logical pages [z * per, (z + 1) * per) of the call's
// table (per = ceil(P / n_sub); the op's lse_sub_splits chooses n_sub so
// that the blocks fill the SMs), intersected with the row's live pages.
// Inside a block the rep = H / KV query heads share every page load, and
// the pages are double-buffered with cp.async: the next page's K and V are
// in flight while the current page is scored and summed.  Per page: scores
// into shared memory (one thread a (head, slot)), one warp per head takes
// the page max, rescales the head's running max and sum and writes p back
// (one exp per (head, slot)), then each thread updates its up to 8 (head,
// dh) accumulators.  With n_sub = 1 the block writes out and lse itself;
// otherwise each block writes f32 partials (m, l and the unnormalised acc
// per (row, head)) to the op's scratch and a second, short kernel merges
// them: M = max m, L = sum l exp(m - M), out = sum acc exp(m - M) /
// max(L, 1e-30), lse = M + log(max(L, 1e-30)).
//
// A fully masked row is the normal case here, not an edge case: a short
// row has no positions in the later stripes (the caller passes cache_len
// clipped at 0 there) or sub-splits.  Such a block visits no page and
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
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxOutPerThread = 8;  // rep * dh <= 1024

template <int DH>
__global__ void paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                                    const __nv_bfloat16* __restrict__ k_pool,
                                    const __nv_bfloat16* __restrict__ v_pool,
                                    const int* __restrict__ tables,
                                    const int* __restrict__ cache_len,
                                    __nv_bfloat16* __restrict__ out, int H,
                                    int KV, int page, int P, int window,
                                    float scale) {
  constexpr int kRowWords = DH / 2 + 1;  // padded row of bf16 pairs
  const int g = blockIdx.x;              // kv head
  const int b = blockIdx.y;              // batch row
  const int rep = H / KV;
  const int tid = threadIdx.x;

  extern __shared__ unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);            // [rep][DH]
  float* s_s = q_s + rep * DH;                                 // [rep][page]
  unsigned* k_s = reinterpret_cast<unsigned*>(s_s + rep * page);  // [page][kRowWords]
  unsigned* v_s = k_s + page * kRowWords;                      // [page][kRowWords]

  const __nv_bfloat16* q_row = q + (static_cast<size_t>(b) * H + g * rep) * DH;
  for (int i = tid; i < rep * DH; i += kThreads)
    q_s[i] = __bfloat162float(q_row[i]);

  const int len = cache_len[b];
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int p_begin = lo / page;
  const int p_end = min(P, (len + page - 1) / page);

  float m[kMaxOutPerThread], l[kMaxOutPerThread], acc[kMaxOutPerThread];
#pragma unroll
  for (int j = 0; j < kMaxOutPerThread; ++j) {
    m[j] = kNeg;
    l[j] = 0.0f;
    acc[j] = 0.0f;
  }
  const int n_out = rep * DH;
  constexpr int kVecPerRow = DH / 8;  // 16-byte vectors per K/V row

  for (int pg = p_begin; pg < p_end; ++pg) {
    const int phys = tables[static_cast<size_t>(b) * P + pg];
    __syncthreads();  // the previous page's smem reads are done
    for (int i = tid; i < page * kVecPerRow; i += kThreads) {
      const int t = i / kVecPerRow, c = i % kVecPerRow;
      const size_t off = ((static_cast<size_t>(phys) * page + t) * KV + g) * DH;
      const uint4 kv4 = reinterpret_cast<const uint4*>(k_pool + off)[c];
      const uint4 vv4 = reinterpret_cast<const uint4*>(v_pool + off)[c];
      unsigned* kd = k_s + t * kRowWords + c * 4;
      unsigned* vd = v_s + t * kRowWords + c * 4;
      kd[0] = kv4.x; kd[1] = kv4.y; kd[2] = kv4.z; kd[3] = kv4.w;
      vd[0] = vv4.x; vd[1] = vv4.y; vd[2] = vv4.z; vd[3] = vv4.w;
    }
    __syncthreads();
    for (int i = tid; i < rep * page; i += kThreads) {
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
      const bool valid = pos < len && (window <= 0 || pos >= len - window);
      s_s[r * page + t] = valid ? dot * scale : kNeg;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxOutPerThread; ++j) {
      const int idx = tid + j * kThreads;
      if (idx >= n_out) break;
      const int r = idx / DH, d = idx % DH;
      const float* sr = s_s + r * page;
      float mx = m[j];
      for (int t = 0; t < page; ++t) mx = fmaxf(mx, sr[t]);
      const float corr = expf(m[j] - mx);
      float psum = 0.0f, pv = 0.0f;
      for (int t = 0; t < page; ++t) {
        const float pt = expf(sr[t] - mx);
        const float2 vv = bf16x2_to_float2(v_s[t * kRowWords + (d >> 1)]);
        psum += pt;
        pv += pt * ((d & 1) ? vv.y : vv.x);
      }
      l[j] = l[j] * corr + psum;
      acc[j] = acc[j] * corr + pv;
      m[j] = mx;
    }
  }
  __nv_bfloat16* o_row = out + (static_cast<size_t>(b) * H + g * rep) * DH;
#pragma unroll
  for (int j = 0; j < kMaxOutPerThread; ++j) {
    const int idx = tid + j * kThreads;
    if (idx >= n_out) break;
    o_row[idx] = __float2bfloat16(acc[j] / fmaxf(l[j], 1e-30f));
  }
}

template <int DH>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* cache_len, void* out, int B,
           int H, int KV, int page, int P, int window, float scale,
           cudaStream_t stream) {
  const int rep = H / KV;
  const size_t smem = (static_cast<size_t>(rep) * DH + rep * page) *
                          sizeof(float) +
                      2 * static_cast<size_t>(page) * (DH / 2 + 1) *
                          sizeof(unsigned);
  if (rep * DH > kThreads * kMaxOutPerThread || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(KV, B);
  paged_decode_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(tables), static_cast<const int*>(cache_len),
      static_cast<__nv_bfloat16*>(out), H, KV, page, P, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- the partial (LSE) split

constexpr int kLseWarps = kThreads / 32;
constexpr int kLseMaxPage = 64;      // the softmax warp takes two slots a lane

// Shared K/V rows padded by 16 bytes: cp.async needs 16-byte aligned rows,
// and rows 4 words apart spread a warp's reads of 8 rows over 32 banks.
template <int DH>
__host__ __device__ constexpr int lse_row_words() { return DH / 2 + 4; }

template <int DH>
size_t lse_smem_bytes(int rep, int page) {
  return (static_cast<size_t>(rep) * DH + rep * page + 3 * rep) *
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
    int page, int P, int window, float scale) {
  constexpr int kRowWords = lse_row_words<DH>();
  constexpr int kVecPerRow = DH / 8;  // 16-byte vectors per K/V row
  const int g = blockIdx.x;           // kv head
  const int b = blockIdx.y;           // batch row
  const int z = blockIdx.z;           // sub-split
  const int n_sub = gridDim.z;
  const int rep = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  extern __shared__ unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);   // [rep][DH]
  float* s_s = q_s + rep * DH;                       // [rep][page]
  float* m_s = s_s + rep * page;                     // [rep] running max
  float* l_s = m_s + rep;                            // [rep] running sum
  float* c_s = l_s + rep;                            // [rep] page correction
  // [buf][K, V][page][kRowWords] at the next 16-byte aligned address
  // (cp.async's destinations)
  const uint32_t kv_at = smem_u32(c_s + rep);
  unsigned* kv_s = reinterpret_cast<unsigned*>(
      reinterpret_cast<unsigned char*>(c_s + rep) + ((16 - (kv_at & 15)) & 15));

  const __nv_bfloat16* q_row = q + (static_cast<size_t>(b) * H + g * rep) * DH;
  for (int i = tid; i < rep * DH; i += kThreads)
    q_s[i] = __bfloat162float(q_row[i]);
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kNeg;
    l_s[r] = 0.0f;
  }

  const int len = cache_len[b];
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int per = (P + n_sub - 1) / n_sub;
  const int p_begin = max(lo / page, z * per);
  const int p_end = min(min(P, (len + page - 1) / page), (z + 1) * per);

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
  const int n_out = rep * DH;

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
    for (int i = tid; i < rep * page; i += kThreads) {
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
      const bool valid = pos < len && (window <= 0 || pos >= len - window);
      s_s[r * page + t] = valid ? dot * scale : kNeg;
    }
    __syncthreads();
    for (int r = warp; r < rep; r += kLseWarps) {
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

  const size_t bh0 = static_cast<size_t>(b) * H + g * rep;  // first head
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

// One block per (row, head), one thread per output dim.
template <int DH>
__global__ void __launch_bounds__(DH) lse_merge_kernel(
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
  if (d == 0) lse[bh] = mx + logf(fmaxf(l, 1e-30f));
}

template <int DH>
int launch_lse(const void* q, const void* k_pool, const void* v_pool,
               const void* tables, const void* cache_len, void* out,
               float* lse, float* part, int B, int H, int KV, int page, int P,
               int n_sub, int window, float scale, cudaStream_t stream) {
  const int rep = H / KV;
  const size_t smem = lse_smem_bytes<DH>(rep, page) + 16;
  if (rep * DH > kThreads * kMaxOutPerThread || page > kLseMaxPage ||
      n_sub < 1 || n_sub > P || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(KV, B, n_sub);
  paged_lse_split_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(tables), static_cast<const int*>(cache_len),
      static_cast<__nv_bfloat16*>(out), lse, part, B, H, KV, page, P, window,
      scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_sub == 1) return static_cast<int>(e);
  lse_merge_kernel<DH><<<B * H, DH, 0, stream>>>(
      part, static_cast<__nv_bfloat16*>(out), lse, B * H, n_sub);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, H, dh) bf16; k_pool, v_pool: (n_pages, page, KV, dh) bf16;
// tables: (B, P) i32; cache_len: (B,) i32; out: (B, H, dh) bf16.  All
// contiguous.  dh is 64 or 128.
REPRO_EXPORT int decode_attention_paged(const void* q, const void* k_pool,
                                        const void* v_pool,
                                        const void* tables,
                                        const void* cache_len, void* out,
                                        int B, int H, int KV, int dh,
                                        int page, int P, int window,
                                        float scale, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || page <= 0 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64)
    return launch<64>(q, k_pool, v_pool, tables, cache_len, out, B, H, KV,
                      page, P, window, scale, s);
  if (dh == 128)
    return launch<128>(q, k_pool, v_pool, tables, cache_len, out, B, H, KV,
                       page, P, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As decode_attention_paged, plus lse: (B, H) f32.  tables is the (B, P)
// table of this call's pages (a stripe, made contiguous by the caller),
// split into n_sub sub-splits of ceil(P / n_sub) pages; with n_sub > 1,
// part is f32 scratch of n_sub * B * H * (dh + 2) floats and a second
// kernel merges the partials (launched here, on the same stream).
REPRO_EXPORT int decode_attention_paged_lse(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* cache_len, void* out, void* lse, void* part, int B, int H,
    int KV, int dh, int page, int P, int n_sub, int window, float scale,
    void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || page <= 0 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64)
    return launch_lse<64>(q, k_pool, v_pool, tables, cache_len, out,
                          static_cast<float*>(lse), static_cast<float*>(part),
                          B, H, KV, page, P, n_sub, window, scale, s);
  if (dh == 128)
    return launch_lse<128>(q, k_pool, v_pool, tables, cache_len, out,
                           static_cast<float*>(lse), static_cast<float*>(part),
                           B, H, KV, page, P, n_sub, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// Dense-cache decode attention: one query token per batch row over dense
// per-row (B, S_max, KV, dh) K and V caches, which may be ring buffers.
//
// Replaces src/repro/kernels/decode_attention/kernel.py::
// decode_attention_kernel (its pl.pallas_call at kernel.py:113); the
// function is src/repro/models/attention.py::decode_attention, which
// Model.decode_step runs in every attention layer: f32 scores of q.k scaled
// by dh^-1/2, slot idx valid iff idx < cache_len or (window > 0 and
// cache_len >= S_max), invalid slots at -1e30, unnormalised exp, f32 p into
// the value sum, one late divide by max(l, 1e-30).  The ring rule is over
// physical slots (once a ring has wrapped every slot holds one of the last
// S_max tokens), unlike the paged kernel's logical window: for any window
// it reduces to "the first min(cache_len, S_max) slots", so the kernel
// takes no window at all and walks exactly those rows.
//
// What bounds it on the H100: bytes.  Each (row, kv head) reads its
// min(cache_len, S_max) K and V rows once (2 * dh * 2 bytes each) and does
// 4 flops per element read, about 1 flop per byte, so the cache read is the
// whole cost.  This first kernel walks a row's cache in one block, in
// sequence, one tile at a time with no loads in flight across tiles, so at
// decode batch sizes (B * KV blocks: 128 for seamless-m4t-medium at 8 rows,
// 64 for llama3.2-1b) it is latency bound well above the byte bound.
// Split-KV and cp.async double buffering are later work.
//
// Design: one block per (kv head, query-head group, batch row).  The
// rep = H / KV query heads of a kv head share every K/V tile the block
// loads; where rep * dh > 1024 (granite's MQA: 48 heads of 128) they are
// split into the fewest equal groups of at most 1024 / dh heads, one block
// each, which re-read the same K/V (from L2 where it fits).  64-row tiles of
// K and V go to shared memory with 16-byte loads.  Each tile: scores into
// shared memory (one thread a (head, slot)); one warp per head takes the
// tile max, rescales the head's running max and sum and writes p = exp(s -
// m) back once (one exp per (head, slot), not per output); then each thread
// updates its up to 8 (head, dh) accumulators in registers.  Shared rows are
// padded by one word so threads reading different rows hit different banks.
//
// Differs from the reference only for a row with cache_len == 0 (every
// slot masked): the reference averages all S_max values uniformly
// (exp(-1e30 - -1e30) = 1), this kernel visits no slot and writes 0.  Every
// caller passes cache_len + 1 >= 1 (transformer.py _attn_decode).

namespace {

constexpr int kDenseTile = 64;                 // cache rows per tile
constexpr int kDenseWarps = kThreads / 32;

template <int DH>
__global__ void dense_decode_kernel(const __nv_bfloat16* __restrict__ q,
                                    const __nv_bfloat16* __restrict__ k_cache,
                                    const __nv_bfloat16* __restrict__ v_cache,
                                    const int* __restrict__ cache_len,
                                    __nv_bfloat16* __restrict__ out, int H,
                                    int KV, int S_max, int hpb, float scale) {
  constexpr int kRowWords = DH / 2 + 1;  // padded row of bf16 pairs
  constexpr int kVecPerRow = DH / 8;     // 16-byte vectors per K/V row
  const int rep = H / KV;
  const int n_groups = (rep + hpb - 1) / hpb;
  const int g = blockIdx.x / n_groups;   // kv head
  const int h_first = g * rep + (blockIdx.x % n_groups) * hpb;
  const int nh = min(hpb, g * rep + rep - h_first);  // query heads here
  const int b = blockIdx.y;              // batch row
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  extern __shared__ unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);   // [hpb][DH]
  float* s_s = q_s + hpb * DH;                       // [hpb][kDenseTile]
  float* m_s = s_s + hpb * kDenseTile;               // [hpb] running max
  float* l_s = m_s + hpb;                            // [hpb] running sum
  float* c_s = l_s + hpb;                            // [hpb] tile correction
  unsigned* k_s = reinterpret_cast<unsigned*>(c_s + hpb);  // [tile][kRowWords]
  unsigned* v_s = k_s + kDenseTile * kRowWords;            // [tile][kRowWords]

  const __nv_bfloat16* q_row = q + (static_cast<size_t>(b) * H + h_first) * DH;
  for (int i = tid; i < nh * DH; i += kThreads)
    q_s[i] = __bfloat162float(q_row[i]);
  for (int r = tid; r < nh; r += kThreads) {
    m_s[r] = kNeg;
    l_s[r] = 0.0f;
  }
  __syncthreads();

  // the ring rule over physical slots: the first min(cache_len, S_max)
  const int n_valid = max(0, min(cache_len[b], S_max));
  const size_t row_stride = static_cast<size_t>(KV) * DH;
  const size_t base = (static_cast<size_t>(b) * S_max * KV + g) * DH;
  const __nv_bfloat16* k_row0 = k_cache + base;
  const __nv_bfloat16* v_row0 = v_cache + base;
  const int n_out = nh * DH;

  float acc[kMaxOutPerThread];
#pragma unroll
  for (int j = 0; j < kMaxOutPerThread; ++j) acc[j] = 0.0f;

  for (int t0 = 0; t0 < n_valid; t0 += kDenseTile) {
    const int rows = min(kDenseTile, n_valid - t0);
    __syncthreads();  // the previous tile's smem reads are done
    for (int i = tid; i < rows * kVecPerRow; i += kThreads) {
      const int t = i / kVecPerRow, c = i % kVecPerRow;
      const size_t off = static_cast<size_t>(t0 + t) * row_stride;
      const uint4 kv4 = reinterpret_cast<const uint4*>(k_row0 + off)[c];
      const uint4 vv4 = reinterpret_cast<const uint4*>(v_row0 + off)[c];
      unsigned* kd = k_s + t * kRowWords + c * 4;
      unsigned* vd = v_s + t * kRowWords + c * 4;
      kd[0] = kv4.x; kd[1] = kv4.y; kd[2] = kv4.z; kd[3] = kv4.w;
      vd[0] = vv4.x; vd[1] = vv4.y; vd[2] = vv4.z; vd[3] = vv4.w;
    }
    __syncthreads();
    for (int i = tid; i < nh * kDenseTile; i += kThreads) {
      const int r = i / kDenseTile, t = i % kDenseTile;
      if (t >= rows) continue;
      const float* qr = q_s + r * DH;
      const unsigned* kr = k_s + t * kRowWords;
      float dot = 0.0f;
#pragma unroll 8
      for (int d2 = 0; d2 < DH / 2; ++d2) {
        const float2 kk = bf16x2_to_float2(kr[d2]);
        dot += qr[2 * d2] * kk.x + qr[2 * d2 + 1] * kk.y;
      }
      s_s[r * kDenseTile + t] = dot * scale;
    }
    __syncthreads();
    for (int r = warp; r < nh; r += kDenseWarps) {
      float* sr = s_s + r * kDenseTile;
      const float s0 = lane < rows ? sr[lane] : kNeg;
      const float s1 = lane + 32 < rows ? sr[lane + 32] : kNeg;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = lane < rows ? expf(s0 - m_new) : 0.0f;
      const float p1 = lane + 32 < rows ? expf(s1 - m_new) : 0.0f;
      if (lane < rows) sr[lane] = p0;
      if (lane + 32 < rows) sr[lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      __syncwarp();
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
      const float* pr = s_s + r * kDenseTile;
      float pv = 0.0f;
      for (int t = 0; t < rows; ++t) {
        const float2 vv = bf16x2_to_float2(v_s[t * kRowWords + (d >> 1)]);
        pv += pr[t] * ((d & 1) ? vv.y : vv.x);
      }
      acc[j] = acc[j] * c_s[r] + pv;
    }
  }
  __nv_bfloat16* o_row = out + (static_cast<size_t>(b) * H + h_first) * DH;
#pragma unroll
  for (int j = 0; j < kMaxOutPerThread; ++j) {
    const int idx = tid + j * kThreads;
    if (idx >= n_out) break;
    o_row[idx] = __float2bfloat16(acc[j] / fmaxf(l_s[idx / DH], 1e-30f));
  }
}

template <int DH>
int launch_dense(const void* q, const void* k_cache, const void* v_cache,
                 const void* cache_len, void* out, int B, int H, int KV,
                 int S_max, float scale, cudaStream_t stream) {
  constexpr int kMaxHeads = kThreads * kMaxOutPerThread / DH;
  const int rep = H / KV;
  const int n_groups = (rep + kMaxHeads - 1) / kMaxHeads;
  const int hpb = (rep + n_groups - 1) / n_groups;  // <= kMaxHeads
  const size_t smem = (static_cast<size_t>(hpb) * DH + hpb * kDenseTile +
                       3 * hpb) * sizeof(float) +
                      2 * static_cast<size_t>(kDenseTile) * (DH / 2 + 1) *
                          sizeof(unsigned);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(KV * n_groups, B);
  dense_decode_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache),
      static_cast<const int*>(cache_len), static_cast<__nv_bfloat16*>(out), H,
      KV, S_max, hpb, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, H, dh) bf16; k_cache, v_cache: (B, S_max, KV, dh) bf16, 16-byte
// aligned; cache_len: (B,) i32; out: (B, H, dh) bf16.  All contiguous.  dh
// is 64 or 128; any S_max >= 1 (no padding).
REPRO_EXPORT int decode_attention_dense(const void* q, const void* k_cache,
                                        const void* v_cache,
                                        const void* cache_len, void* out,
                                        int B, int H, int KV, int dh,
                                        int S_max, float scale,
                                        void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || S_max <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64)
    return launch_dense<64>(q, k_cache, v_cache, cache_len, out, B, H, KV,
                            S_max, scale, s);
  if (dh == 128)
    return launch_dense<128>(q, k_cache, v_cache, cache_len, out, B, H, KV,
                             S_max, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
