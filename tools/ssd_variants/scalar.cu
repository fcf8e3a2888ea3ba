// The SSD scan kernel of the port before its redesign for the H100 (one
// block per (batch row, head), every product as scalar f32 FMAs from
// shared memory, C.B^T recomputed for each head), kept unchanged so that
// tools/ssd_variants.py and chip_smoke.py can time it beside the package's
// kernel (src/repro_torch/csrc/ssd_scan.cu) in one call.  The same
// function and entry point signature as that kernel had then: x (B, S, H,
// P) bf16, dt and a (B, S, H) f32, B and C (B, S, N) bf16, an optional
// initial state; y and the final state out.
//
// Design: one block per (batch row, head), 256 threads as 16 x 16 (ty, tx).
// The TPU grid's sequential chunk axis becomes a loop inside the block, and
// the block keeps its (P, N) f32 state in shared memory for the whole scan.
// Per chunk, warp 0 scans the log-decays into cum (shared).  The Pallas
// kernel held (q, q, H) weights in VMEM; a 256 x 256 f32 tile alone would
// exceed a block's shared memory, so the intra-chunk term is tiled over
// 64-row sub-tiles of i and j: for each i tile the block stages C_i, and for
// each j tile <= i it stages B_j and x_j dt_j, forms the 64 x 64 weights
// (C_i . B_j) exp(cum_i - cum_j) on the fly (zero above the diagonal) and
// accumulates W x dt into registers.  The carried state is read out once
// per i tile, and the state update runs over the chunk's j tiles at the
// end.  Every sum runs in a fixed order over j and n, so rows past the true
// length (dt = 0, a = 1: log a = 0 and x dt = 0) leave the valid rows' y and
// the final state bit-unchanged, as long as the chunking is the same.
// Shared rows of B, C and the state are padded by one word, so the 16 lanes
// that read 16 different rows hit 16 different banks.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kT = 64;          // sub-tile rows (i and j)
constexpr int kMaxChunk = 256;

template <int P, int N>
struct Smem {
  static constexpr int kNS = N + 1;  // padded row of B, C and the state
  static constexpr int kWS = kT + 1;
  static constexpr size_t floats =
      kMaxChunk + P * kNS + 2 * kT * kNS + kT * P + kT * kWS;
  static constexpr size_t bytes = floats * sizeof(float);
};

// Stage rows [r0, r0 + kT) of a (S, N) bf16 matrix (row stride N) as f32,
// rows at or past `valid` as zero.
template <int N>
__device__ __forceinline__ void stage_bc(float* dst, const __nv_bfloat16* src,
                                         int valid, int tid) {
  for (int i = tid; i < kT * N; i += kThreads) {
    const int r = i / N, n = i % N;
    dst[r * (N + 1) + n] = r < valid ? __bfloat162float(src[r * N + n]) : 0.0f;
  }
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ dt, const float* __restrict__ a,
                const __nv_bfloat16* __restrict__ bm,
                const __nv_bfloat16* __restrict__ cm,
                const float* __restrict__ init_state,
                __nv_bfloat16* __restrict__ y, float* __restrict__ final_state,
                int S, int H, int q) {
  static_assert(P % 16 == 0 && P <= 64 && N % 16 == 0 && N <= 128, "shape");
  constexpr int kNS = Smem<P, N>::kNS;
  constexpr int kWS = Smem<P, N>::kWS;
  constexpr int kPC = P / 16;   // output columns (p) per thread
  constexpr int kNC = N / 16;   // state columns (n) per thread

  extern __shared__ float smem[];
  float* cum_s = smem;                   // [kMaxChunk]
  float* st_s = cum_s + kMaxChunk;       // [P][kNS]
  float* c_s = st_s + P * kNS;           // [kT][kNS]
  float* b_s = c_s + kT * kNS;           // [kT][kNS]
  float* xdt_s = b_s + kT * kNS;         // [kT][P]
  float* w_s = xdt_s + kT * P;           // [kT][kWS]

  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31;

  const size_t state_base = (static_cast<size_t>(b) * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i % N;
    st_s[p * kNS + n] = init_state ? init_state[state_base + i] : 0.0f;
  }

  // x dt for rows [r0, r0 + kT) of the chunk starting at c0, times
  // `scale_by` (exp(cum_last - cum_j)) when asked; rows past q are zero
  auto stage_xdt = [&](int c0, int r0, int valid, bool decay_out) {
    for (int i = tid; i < kT * P; i += kThreads) {
      const int r = i / P, p = i % P;
      float v = 0.0f;
      if (r < valid) {
        const size_t row = static_cast<size_t>(b) * S + c0 + r0 + r;
        v = __bfloat162float(x[(row * H + h) * P + p]) * dt[row * H + h];
        if (decay_out) v *= expf(cum_s[q - 1] - cum_s[r0 + r]);
      }
      xdt_s[r * P + p] = v;
    }
  };

  const int n_tiles = (q + kT - 1) / kT;
  for (int c0 = 0; c0 < S; c0 += q) {
    __syncthreads();  // the previous chunk's reads of cum_s are done
    if (tid < 32) {
      float carry = 0.0f;
      for (int base = 0; base < q; base += 32) {
        const int i = base + lane;
        float v = 0.0f;
        if (i < q) {
          const size_t row = static_cast<size_t>(b) * S + c0 + i;
          v = logf(fmaxf(a[row * H + h], 1e-20f));
        }
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float up = __shfl_up_sync(kFullMask, v, o);
          if (lane >= o) v += up;
        }
        if (i < q) cum_s[i] = carry + v;
        carry += __shfl_sync(kFullMask, v, 31);
      }
    }
    __syncthreads();

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kT;
      const int i_valid = min(kT, q - i0);
      stage_bc<N>(c_s, cm + (static_cast<size_t>(b) * S + c0 + i0) * N,
                  i_valid, tid);
      float acc[4][kPC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kPC; ++c) acc[r][c] = 0.0f;

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        const int j_valid = min(kT, q - j0);
        __syncthreads();  // previous readers of b_s / xdt_s / w_s are done
        stage_bc<N>(b_s, bm + (static_cast<size_t>(b) * S + c0 + j0) * N,
                    j_valid, tid);
        stage_xdt(c0, j0, j_valid, false);
        __syncthreads();

        // W[i][j] = (C_i . B_j) exp(cum_i - cum_j) for j <= i, else 0
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float bb[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) bb[c] = b_s[(tx + 16 * c) * kNS + n];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float cc = c_s[(ty + 16 * r) * kNS + n];
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] += cc * bb[c];
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            w_s[(ty + 16 * r) * kWS + tx + 16 * c] =
                (j <= i && i < q) ? s[r][c] * expf(cum_s[i] - cum_s[j]) : 0.0f;
          }
        }
        __syncthreads();

#pragma unroll 4
        for (int j = 0; j < kT; ++j) {
          float xv[kPC];
#pragma unroll
          for (int c = 0; c < kPC; ++c) xv[c] = xdt_s[j * P + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float w = w_s[(ty + 16 * r) * kWS + j];
#pragma unroll
            for (int c = 0; c < kPC; ++c) acc[r][c] += w * xv[c];
          }
        }
      }

      // read-out of the carried-in state: exp(cum_i) C_i . state[p]
      float inter[4][kPC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kPC; ++c) inter[r][c] = 0.0f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float sv[kPC];
#pragma unroll
        for (int c = 0; c < kPC; ++c) sv[c] = st_s[(tx + 16 * c) * kNS + n];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float cc = c_s[(ty + 16 * r) * kNS + n];
#pragma unroll
          for (int c = 0; c < kPC; ++c) inter[r][c] += cc * sv[c];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        if (i >= i_valid) continue;
        const float din = expf(cum_s[i0 + i]);
        __nv_bfloat16* yrow =
            y + ((static_cast<size_t>(b) * S + c0 + i0 + i) * H + h) * P;
#pragma unroll
        for (int c = 0; c < kPC; ++c)
          yrow[tx + 16 * c] = __float2bfloat16(acc[r][c] + inter[r][c] * din);
      }
      __syncthreads();  // c_s is restaged by the next i tile
    }

    // state <- state exp(cum_last) + sum_j exp(cum_last - cum_j) xdt_j B_j^T
    constexpr int kPR = P / 16;   // state rows (p) per thread
    float ds[kPR][kNC];
#pragma unroll
    for (int r = 0; r < kPR; ++r)
#pragma unroll
      for (int c = 0; c < kNC; ++c) ds[r][c] = 0.0f;
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * kT;
      const int j_valid = min(kT, q - j0);
      __syncthreads();
      stage_bc<N>(b_s, bm + (static_cast<size_t>(b) * S + c0 + j0) * N,
                  j_valid, tid);
      stage_xdt(c0, j0, j_valid, true);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kT; ++j) {
        float bb[kNC];
#pragma unroll
        for (int c = 0; c < kNC; ++c) bb[c] = b_s[j * kNS + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < kPR; ++r) {
          const float xv = xdt_s[j * P + ty + 16 * r];
#pragma unroll
          for (int c = 0; c < kNC; ++c) ds[r][c] += xv * bb[c];
        }
      }
    }
    const float total = expf(cum_s[q - 1]);
#pragma unroll
    for (int r = 0; r < kPR; ++r)
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        float* st = &st_s[(ty + 16 * r) * kNS + tx + 16 * c];
        *st = *st * total + ds[r][c];
      }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i % N;
    final_state[state_base + i] = st_s[p * kNS + n];
  }
}

template <int P, int N>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, const void* init_state, void* y, void* final_state,
           int B, int S, int H, int q, cudaStream_t stream) {
  constexpr size_t smem = Smem<P, N>::bytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  ssd_scan_kernel<P, N><<<B * H, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm),
      static_cast<const float*>(init_state), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(final_state), S, H, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, S, H, P) bf16; dt, a: (B, S, H) f32; bm, cm: (B, S, N) bf16;
// init_state: (B, H, P, N) f32 or null (zeros); y: (B, S, H, P) bf16;
// final_state: (B, H, P, N) f32.  All contiguous; S a multiple of the
// chunk q <= 256.  (P, N) one of (64, 128), (64, 64), (32, 16).
REPRO_EXPORT int ssd_scan(const void* x, const void* dt, const void* a,
                          const void* bm, const void* cm,
                          const void* init_state, void* y, void* final_state,
                          int B, int S, int H, int P, int N, int q,
                          void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || q <= 0 || q > kMaxChunk || S % q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P == 64 && N == 128)
    return launch<64, 128>(x, dt, a, bm, cm, init_state, y, final_state, B, S,
                           H, q, st);
  if (P == 64 && N == 64)
    return launch<64, 64>(x, dt, a, bm, cm, init_state, y, final_state, B, S,
                          H, q, st);
  if (P == 32 && N == 16)
    return launch<32, 16>(x, dt, a, bm, cm, init_state, y, final_state, B, S,
                          H, q, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
