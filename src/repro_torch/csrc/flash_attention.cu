// Prefill flash attention with explicit query and key positions: causal,
// sliding window, GQA, and key rows at a negative position masked.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::
// flash_attention_kernel (its pl.pallas_call at kernel.py:101).  The
// function is src/repro/models/attention.py::gqa_attention: f32 scores
// scaled by dh^-1/2, key j visible to query i iff kv_pos[j] >= 0 and (if
// causal) pos[i] >= kv_pos[j] and (if window > 0) pos[i] - kv_pos[j] <
// window, masked scores at -1e30, online softmax in f32 with f32 p into the
// value sum, one late divide by max(l, 1e-30).  The Pallas kernel knows
// only an iota and seq_len; the chunked prefill (transformer.py:629-650)
// needs the query offset and the -1e9 prefix rows, so the masks here come
// from the two position arrays.
//
// What bounds it on the H100: operations.  A 1024-token chunk of
// llama3.2-1b does ~4 GFLOP of attention per layer over ~12 MB of q/k/v/o,
// well above the 295 flop/byte ridge; this first kernel does its products
// with scalar f32 FMAs from shared memory (no tensor cores), so it runs far
// below the 989 TFLOP/s bf16 peak.  wgmma and TMA are for a later PR.
//
// Design: one block per (64-row query tile, query head, batch row), 128
// threads as 8 x 16 (ty, tx).  The block keeps its Q tile in shared memory
// and loops over 64-row key tiles of its kv head (h / rep: GQA without
// repeated heads in memory).  Before loading a key tile it loads the tile's
// positions and skips the tile when no (query, key) pair of the block is
// visible (__syncthreads_or), which drops the causal upper triangle and the
// masked prefix rows.  Thread (ty, tx) owns query rows ty + 8i (i < 8) and
// key columns / output dims tx + 16j (j < 4): 32 scores, then the row max
// and sum reduce over the 16 lanes of its half warp, p goes to shared
// memory, and the thread accumulates its 32 outputs in registers.  Q and K
// rows are padded by one word so the 16 lanes of a row group, which read 16
// different key rows, hit 16 different banks.
//
// Differs from the reference only for a query row that sees no key at all:
// the reference averages V uniformly; this kernel's output there is not
// defined.  No caller makes one: every query sees its own key.
#include "common.cuh"

namespace {

constexpr int kTile = 64;      // query rows and key rows per tile
constexpr int kDh = 64;        // head dim (llama3.2-1b, and every reduced config)
constexpr int kThreads = 128;  // 8 x 16
constexpr int kRowWords = kDh / 2 + 1;  // padded row of bf16 pairs
constexpr int kPStride = kTile + 1;

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  return kp >= 0 && (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
}

// Copy `rows` rows of kDh bf16 (row r at src + r * stride elements) into a
// padded shared tile; rows past `valid` are zero.
__device__ __forceinline__ void load_tile(unsigned* dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int valid, int tid) {
  constexpr int kVec = kDh / 8;
  for (int i = tid; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec, c = i % kVec;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < valid) v = reinterpret_cast<const uint4*>(src + r * stride)[c];
    unsigned* d = dst + r * kRowWords + c * 4;
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
}

__global__ void flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                                     const __nv_bfloat16* __restrict__ k,
                                     const __nv_bfloat16* __restrict__ v,
                                     const int* __restrict__ qpos,
                                     const int* __restrict__ kpos,
                                     __nv_bfloat16* __restrict__ out, int Sq,
                                     int Sk, int H, int KV, int causal,
                                     int window, float scale) {
  __shared__ unsigned q_s[kTile * kRowWords];
  __shared__ unsigned k_s[kTile * kRowWords];
  __shared__ unsigned v_s[kTile * kRowWords];
  __shared__ float p_s[kTile * kPStride];
  __shared__ int qp_s[kTile];
  __shared__ int kp_s[kTile];

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int q_valid = min(kTile, Sq - q0);

  const size_t q_stride = static_cast<size_t>(H) * kDh;
  const size_t kv_stride = static_cast<size_t>(KV) * kDh;
  load_tile(q_s, q + (static_cast<size_t>(b) * Sq + q0) * q_stride + h * kDh,
            q_stride, q_valid, tid);
  if (tid < kTile) qp_s[tid] = tid < q_valid ? qpos[q0 + tid] : 0;

  float m[8], l[8], acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  const int n_tiles = (Sk + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    const int k_valid = min(kTile, Sk - k0);
    __syncthreads();  // the previous tile's smem reads are done
    if (tid < kTile) kp_s[tid] = tid < k_valid ? kpos[k0 + tid] : -1000000000;
    __syncthreads();
    bool any = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i;
      if (r >= q_valid) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        any |= visible(qp_s[r], kp_s[tx + 16 * j], causal, window);
    }
    if (!__syncthreads_or(any)) continue;

    const size_t kv_base = (static_cast<size_t>(b) * Sk + k0) * kv_stride + g * kDh;
    load_tile(k_s, k + kv_base, kv_stride, k_valid, tid);
    load_tile(v_s, v + kv_base, kv_stride, k_valid, tid);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d2 = 0; d2 < kDh / 2; ++d2) {
      float2 kk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kk[j] = bf16x2_to_float2(k_s[(tx + 16 * j) * kRowWords + d2]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 qq = bf16x2_to_float2(q_s[(ty + 8 * i) * kRowWords + d2]);
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qq.x * kk[j].x + qq.y * kk[j].y;
      }
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(qp_s[r], kp_s[tx + 16 * j], causal, window);
        s[i][j] = ok ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = expf(s[i][j] - m_new);
        p_s[r * kPStride + tx + 16 * j] = pj;
        rs += pj;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_warp_sum(rs);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

    const __nv_bfloat16* v_bf = reinterpret_cast<const __nv_bfloat16*>(v_s);
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        vv[j] = __bfloat162float(v_bf[c * 2 * kRowWords + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float pc = p_s[(ty + 8 * i) * kPStride + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += pc * vv[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i;
    if (r >= q_valid) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* o = out + (static_cast<size_t>(b) * Sq + q0 + r) * q_stride +
                       h * kDh;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[tx + 16 * j] = __float2bfloat16(acc[i][j] * inv);
  }
}

}  // namespace

// q: (B, Sq, H, 64) bf16; k, v: (B, Sk, KV, 64) bf16; qpos: (Sq,) i32;
// kpos: (Sk,) i32; out: (B, Sq, H, 64) bf16.  All contiguous.
REPRO_EXPORT int flash_attention_prefill(const void* q, const void* k,
                                         const void* v, const void* qpos,
                                         const void* kpos, void* out, int B,
                                         int Sq, int Sk, int H, int KV,
                                         int dh, int causal, int window,
                                         float scale, void* stream) {
  if (dh != kDh || B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((Sq + kTile - 1) / kTile, H, B);
  flash_prefill_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kpos), static_cast<__nv_bfloat16*>(out), Sq, Sk,
      H, KV, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}
