// Paged decode attention: one query token per batch row over the shared
// (n_pages, page, KV, dh) KV pool, through (B, P) block tables.
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
#include "common.cuh"

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
