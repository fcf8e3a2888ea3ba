// The SSD scan backward kernel of the port before its redesign on the
// tensor cores (src/repro_torch/csrc/ssd_scan_bwd.cu), kept unchanged so
// that tools/ssd_variants.py and chip_smoke.py can time it beside the
// package's kernel in one call.  The same C entry point, with its own
// scratch (per-head dB and dC partials).
//
// Mamba2 SSD chunked scan, backward: the gradients dx (B, S, H, P), ddt and
// da (B, S, H), dB and dC (B, S, N) and d init_state (B, H, P, N) of
// csrc/ssd_scan.cu's (y, final state) for dy (B, S, H, P) and d final_state
// (absent: zeros).
//
// The Pallas package has no backward kernel: the reference differentiates
// src/repro/models/ssm.py::ssd_chunked (the function of src/repro/kernels/
// ssd_scan/kernel.py::ssd_scan_kernel) through XLA, and that gradient is NaN
// once a chunk's masked segment sums overflow exp.  Here exp is only ever
// taken of cum_i - cum_j for j <= i.  In a chunk of q rows, with S the state
// carried in, dS_out the gradient of the state leaving it, E_ij = exp(cum_i -
// cum_j) (j <= i, else 0), G = C B^T, W = G E, xdt_j = x_j dt_j, g_j =
// exp(cum_last - cum_j) and e_i = exp(cum_i):
//   dS (into the chunk) = exp(cum_last) dS_out + sum_i e_i dy_i C_i^T
//   dxdt_j = sum_{i>=j} W_ij dy_i + g_j dS_out B_j; dx = dxdt dt,
//            ddt = <dxdt, x>
//   dG_ij = <dy_i, xdt_j> E_ij; dC_i = sum_j dG_ij B_j + e_i S^T dy_i,
//   dB_j = sum_i dG_ij C_i + g_j dS_out^T xdt_j, each summed over heads
//   dcum = row sums - column sums of <dy_i, xdt_j> W_ij, + e_i <dy_i, S C_i>,
//          - g_j <dS_out, xdt_j B_j^T>, and on the last row the sum of the
//          latter and exp(cum_last) <dS_out, S>; da = (reverse cumsum of
//          dcum) / a where a > 1e-20, else 0.
// ref.py::ssd_backward_reference is the same in plain torch.
//
// Design: a simple kernel, f32 on the CUDA cores throughout (x, B, C, dy
// enter as their bf16 values), six launches on one stream, each grid a
// function of (B, S, H, P, N, q) alone:
//   1. bwd_state_kernel, one block per (chunk, head, row): cum (a warp's
//      scan of log a), and the chunk's own state sum_j g_j xdt_j B_j^T and
//      own state gradient sum_i e_i dy_i C_i^T, over 32-row tiles;
//   2. bwd_cb_kernel: C B^T of each chunk at and below the diagonal (one
//      group, shared by the heads);
//   3. bwd_state_pass_kernel, elementwise over (P N, head, row): the
//      forward state from chunk to chunk (the state carried into each chunk,
//      recomputed in f32 rather than kept by the forward), then the state
//      gradient in reverse chunk order (dS_out of each chunk) and d init;
//   4. bwd_main_kernel, one block per (chunk, head, row): the row terms and
//      the quadratic terms, tile pair by tile pair (32 x 32), twice: once by
//      j tiles (dxdt, dx, ddt, dB's head partial, the column sums), once by
//      i tiles (dC's head partial, the row sums); then dcum, its reverse
//      cumsum and da;
//   5. bwd_reduce_kernel: dB and dC summed over the heads in head order.
// Determinism: no atomics; every sum runs in an order fixed by the tiling,
// so two calls give the same bits.  Padded rows (x, B, C = 0, dt = 0, a =
// 1, dy = 0) get dx, ddt, dB and dC of exactly zero.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kR = 32;            // tile rows
constexpr int kMaxChunk = 256;

template <int P, int N>
struct Cfg {
  static constexpr int kPld = P + 1;   // padded f32 rows in shared memory
  static constexpr int kNld = N + 1;
  static constexpr int kRld = kR + 1;
  static constexpr int kXP = kR * P / kThreads;   // (row, p) a thread
  static constexpr int kXN = kR * N / kThreads;   // (row, n) a thread
  static constexpr int kPN = P * N / kThreads;    // (p, n) a thread
  static_assert(kXP * kThreads == kR * P && kXN * kThreads == kR * N &&
                    kPN * kThreads == P * N && P >= 32,
                "shape");
  // pass 1: cum, g_j dt_j and e_i, then a tile of rows and one of vectors
  static constexpr size_t state_smem =
      3 * kMaxChunk * 4 + kR * (P + N) * 4;
  // pass 4: seven per-row arrays, S and dS_out, five row tiles, three
  // pair tiles and a reduction buffer
  static constexpr size_t main_smem =
      (7 * kMaxChunk + 2 * P * kNld + 2 * kR * kPld + 3 * kR * kNld +
       3 * kR * kRld + kThreads) * 4;
};

__device__ __forceinline__ float bf(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}

// s[k] += sum over m < M of a(k, m) b(k, m), for k < K, each sum in m
// order: the K chains interleaved (m outer), so that a thread keeps K
// independent FMAs in flight instead of one dependent chain at a time.
template <int K, int M, typename FA, typename FB>
__device__ __forceinline__ void fma_chains(float (&s)[K], FA a, FB b) {
#pragma unroll 4
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] = fmaf(a(k, m), b(k, m), s[k]);
  }
}

// Inclusive scan of cum_s[0 .. n) in place by warp 0 (n a multiple of 32).
__device__ __forceinline__ void warp_scan(float* cum_s, int n, int warp,
                                          int lane) {
  if (warp != 0) return;
  float carry = 0.0f;
  for (int base = 0; base < n; base += 32) {
    float v = cum_s[base + lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(kFullMask, v, o);
      if (lane >= o) v += up;
    }
    cum_s[base + lane] = carry + v;
    carry += __shfl_sync(kFullMask, v, 31);
  }
}

// ------------------------------------ 1. cum and each chunk's own states

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
bwd_state_kernel(const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ dt, const float* __restrict__ a,
                 const __nv_bfloat16* __restrict__ bm,
                 const __nv_bfloat16* __restrict__ cm,
                 const __nv_bfloat16* __restrict__ dy,
                 float* __restrict__ cumg, float* __restrict__ st,
                 float* __restrict__ du, int S, int H, int q) {
  using C = Cfg<P, N>;
  const int h = blockIdx.x % H, c = blockIdx.x / H, b = blockIdx.y;
  const int nc = S / q;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  extern __shared__ __align__(16) float state_sm[];
  float* cum_s = state_sm;              // [kMaxChunk]
  float* f_s = cum_s + kMaxChunk;       // g_j dt_j
  float* e_s = f_s + kMaxChunk;         // exp(cum_i)
  float* xs = e_s + kMaxChunk;          // [kR][P]
  float* vs = xs + kR * P;              // [kR][N]

  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * q;
  const size_t bch = (static_cast<size_t>(b) * nc + c) * H + h;
  const int q32 = (q + 31) & ~31;
  for (int j = tid; j < q32; j += kThreads)
    cum_s[j] = j < q ? logf(fmaxf(a[(row0 + j) * H + h], 1e-20f)) : 0.0f;
  __syncthreads();
  warp_scan(cum_s, q32, warp, lane);
  __syncthreads();
  const float last = cum_s[q - 1];
  for (int j = tid; j < q; j += kThreads) {
    const float cj = cum_s[j];
    f_s[j] = dt[(row0 + j) * H + h] * expf(last - cj);
    e_s[j] = expf(cj);
    cumg[bch * q + j] = cj;
  }
  // pass 0: sum_j x_j (g_j dt_j) B_j^T; pass 1: sum_i dy_i e_i C_i^T
  for (int pass = 0; pass < 2; ++pass) {
    const __nv_bfloat16* rows = pass == 0 ? x : dy;
    const __nv_bfloat16* vecs = pass == 0 ? bm : cm;
    const float* scale = pass == 0 ? f_s : e_s;
    float acc[C::kPN];
#pragma unroll
    for (int k = 0; k < C::kPN; ++k) acc[k] = 0.0f;
    for (int r0 = 0; r0 < q; r0 += kR) {
      __syncthreads();   // the last tile is consumed (f_s, e_s written)
      for (int i = tid; i < kR * P; i += kThreads) {
        const int r = i / P, p = i % P, j = r0 + r;
        xs[i] = j < q ? bf(rows[((row0 + j) * H + h) * P + p]) * scale[j]
                      : 0.0f;
      }
      for (int i = tid; i < kR * N; i += kThreads) {
        const int r = i / N, n = i % N, j = r0 + r;
        vs[i] = j < q ? bf(vecs[(row0 + j) * N + n]) : 0.0f;
      }
      __syncthreads();
      fma_chains<C::kPN, kR>(
          acc, [&](int k, int r) { return xs[r * P + (tid + k * kThreads) / N]; },
          [&](int k, int r) { return vs[r * N + (tid + k * kThreads) % N]; });
    }
    float* out = (pass == 0 ? st : du) + bch * P * N;
#pragma unroll
    for (int k = 0; k < C::kPN; ++k) out[tid + k * kThreads] = acc[k];
  }
}

// ---------------------------------------------------- 2. C B^T per chunk

template <int N>
__global__ void __launch_bounds__(kThreads)
bwd_cb_kernel(const __nv_bfloat16* __restrict__ bm,
              const __nv_bfloat16* __restrict__ cm, float* __restrict__ cb,
              int S, int q) {
  constexpr int kNld = N + 1;
  int jt = blockIdx.x, it = 0;          // the pair (it, jt <= it)
  while (jt > it) jt -= ++it;
  const int c = blockIdx.y, b = blockIdx.z, nc = S / q;
  const int tid = threadIdx.x;
  __shared__ float cs[kR * kNld], bs[kR * kNld];
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * q;
  const int i0 = it * kR, j0 = jt * kR;
  for (int i = tid; i < kR * N; i += kThreads) {
    const int r = i / N, n = i % N;
    cs[r * kNld + n] = i0 + r < q ? bf(cm[(row0 + i0 + r) * N + n]) : 0.0f;
    bs[r * kNld + n] = j0 + r < q ? bf(bm[(row0 + j0 + r) * N + n]) : 0.0f;
  }
  __syncthreads();
  float* out = cb + (static_cast<size_t>(b) * nc + c) * q * q;
#pragma unroll
  for (int k = 0; k < kR * kR / kThreads; ++k) {
    const int e = tid + k * kThreads, ii = e / kR, jj = e % kR;
    float s = 0.0f;
#pragma unroll 8
    for (int n = 0; n < N; ++n)
      s = fmaf(cs[ii * kNld + n], bs[jj * kNld + n], s);
    if (i0 + ii < q && j0 + jj < q)
      out[static_cast<size_t>(i0 + ii) * q + j0 + jj] = s;
  }
}

// ------------------- 3. the states from chunk to chunk, both directions

__global__ void __launch_bounds__(kThreads)
bwd_state_pass_kernel(const float* __restrict__ init,
                      const float* __restrict__ dstate,
                      const float* __restrict__ cumg, float* __restrict__ st,
                      float* __restrict__ du, float* __restrict__ dinit,
                      int H, int PN, int nc, int q) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const size_t bh = static_cast<size_t>(b) * H + h;
  // forward: st[c] becomes the state carried into chunk c
  float s = init ? init[bh * PN + e] : 0.0f;
  for (int c = 0; c < nc; ++c) {
    const size_t bch = (static_cast<size_t>(b) * nc + c) * H + h;
    const float own = st[bch * PN + e];
    st[bch * PN + e] = s;
    s = s * expf(cumg[bch * q + q - 1]) + own;
  }
  // backward: du[c] becomes dS_out of chunk c; what is left is d init
  float g = dstate ? dstate[bh * PN + e] : 0.0f;
  for (int c = nc - 1; c >= 0; --c) {
    const size_t bch = (static_cast<size_t>(b) * nc + c) * H + h;
    const float own = du[bch * PN + e];
    du[bch * PN + e] = g;
    g = g * expf(cumg[bch * q + q - 1]) + own;
  }
  if (dinit) dinit[bh * PN + e] = g;
}

// ------------------------------------ 4. the gradients of one (chunk, head)

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
bwd_main_kernel(const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ dt, const float* __restrict__ a,
                const __nv_bfloat16* __restrict__ bm,
                const __nv_bfloat16* __restrict__ cm,
                const __nv_bfloat16* __restrict__ dy,
                const float* __restrict__ cumg, const float* __restrict__ stg,
                const float* __restrict__ dsg, const float* __restrict__ cbg,
                __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
                float* __restrict__ da, float* __restrict__ pb,
                float* __restrict__ pc, int S, int H, int q) {
  using C = Cfg<P, N>;
  constexpr int kPld = C::kPld, kNld = C::kNld, kRld = C::kRld;
  const int h = blockIdx.x % H, c = blockIdx.x / H, b = blockIdx.y;
  const int nc = S / q, nt = (q + kR - 1) / kR;
  const int tid = threadIdx.x;
  // this thread's k-th (row, p) of a kR x P tile and (row, n) of kR x N
  auto xp_r = [&](int k) { return (tid + k * kThreads) / P; };
  auto xp_p = [&](int k) { return (tid + k * kThreads) % P; };
  auto xn_r = [&](int k) { return (tid + k * kThreads) / N; };
  auto xn_n = [&](int k) { return (tid + k * kThreads) % N; };

  extern __shared__ __align__(16) float main_sm[];
  float* cum_s = main_sm;               // [kMaxChunk] each
  float* dt_s = cum_s + kMaxChunk;
  float* a_s = dt_s + kMaxChunk;
  float* g_s = a_s + kMaxChunk;         // exp(cum_last - cum_j)
  float* e_s = g_s + kMaxChunk;         // exp(cum_i)
  float* dcum_s = e_s + kMaxChunk;
  float* gdg_s = dcum_s + kMaxChunk;    // g_j <dS_out, xdt_j B_j^T>
  float* s_s = gdg_s + kMaxChunk;       // S [P][kNld]
  float* d_s = s_s + P * kNld;          // dS_out [P][kNld]
  float* tx = d_s + P * kNld;           // xdt_j rows [kR][kPld]
  float* ty = tx + kR * kPld;           // dy_i rows [kR][kPld]
  float* tb = ty + kR * kPld;           // B_j [kR][kNld]
  float* tc = tb + kR * kNld;           // C_i [kR][kNld]
  float* tw = tc + kR * kNld;           // dS_out^T xdt_j [kR][kNld]
  float* pw = tw + kR * kNld;           // W [kR][kRld]
  float* pg = pw + kR * kRld;           // dG
  float* ps = pg + kR * kRld;           // <dy_i, xdt_j> W_ij
  float* red = ps + kR * kRld;          // [kThreads]

  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * q;
  const size_t bch = (static_cast<size_t>(b) * nc + c) * H + h;
  for (int j = tid; j < kMaxChunk; j += kThreads) {
    const bool in = j < q;
    const float cj = in ? cumg[bch * q + j] : 0.0f;
    cum_s[j] = cj;
    dt_s[j] = in ? dt[(row0 + j) * H + h] : 0.0f;
    a_s[j] = in ? a[(row0 + j) * H + h] : 1.0f;
    e_s[j] = in ? expf(cj) : 0.0f;
    g_s[j] = 0.0f;
    dcum_s[j] = 0.0f;
    gdg_s[j] = 0.0f;
  }
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i % N;
    s_s[p * kNld + n] = stg[bch * P * N + i];
    d_s[p * kNld + n] = dsg[bch * P * N + i];
  }
  __syncthreads();
  const float last = cum_s[q - 1];
  for (int j = tid; j < q; j += kThreads) g_s[j] = expf(last - cum_s[j]);

  // rows r0 .. r0 + kR - 1 of x dt (times_dt) or dy into a [kR][kPld] tile
  auto stage_p = [&](float* dst, const __nv_bfloat16* src, int r0,
                     bool times_dt) {
    for (int i = tid; i < kR * P; i += kThreads) {
      const int r = i / P, p = i % P, j = r0 + r;
      float v = 0.0f;
      if (j < q) {
        v = bf(src[((row0 + j) * H + h) * P + p]);
        if (times_dt) v *= dt_s[j];
      }
      dst[r * kPld + p] = v;
    }
  };
  // rows of B or C into a [kR][kNld] tile
  auto stage_n = [&](float* dst, const __nv_bfloat16* src, int r0) {
    for (int i = tid; i < kR * N; i += kThreads) {
      const int r = i / N, n = i % N, j = r0 + r;
      dst[r * kNld + n] = j < q ? bf(src[(row0 + j) * N + n]) : 0.0f;
    }
  };
  // the pair (i tile it in ty, j tile jt in tx): W, dG and <dy, xdt> W
  const float* cbt = cbg + (static_cast<size_t>(b) * nc + c) * q * q;
  auto pair = [&](int it, int jt) {
    constexpr int kRR = kR * kR / kThreads;
    float dws[kRR] = {};
    fma_chains<kRR, P>(
        dws, [&](int k, int p) { return ty[(tid + k * kThreads) / kR * kPld + p]; },
        [&](int k, int p) { return tx[(tid + k * kThreads) % kR * kPld + p]; });
#pragma unroll
    for (int k = 0; k < kRR; ++k) {
      const int e = tid + k * kThreads, ii = e / kR, jj = e % kR;
      const int gi = it * kR + ii, gj = jt * kR + jj;
      const float dw = dws[k];
      float w = 0.0f, dg = 0.0f;
      if (gi < q && gj <= gi) {        // exp only at and below the diagonal
        const float ev = expf(cum_s[gi] - cum_s[gj]);
        w = cbt[static_cast<size_t>(gi) * q + gj] * ev;
        dg = dw * ev;
      }
      pw[ii * kRld + jj] = w;
      pg[ii * kRld + jj] = dg;
      ps[ii * kRld + jj] = dw * w;
    }
  };

  // ---- by j tiles: dxdt (dx, ddt), dB's head partial, column sums
  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * kR;
    __syncthreads();   // g_s written; the last tiles are consumed
    stage_p(tx, x, j0, true);
    stage_n(tb, bm, j0);
    __syncthreads();
    float acc_x[C::kXP] = {}, acc_b[C::kXN] = {};
    fma_chains<C::kXP, N>(       // dS_out B_j
        acc_x, [&](int k, int n) { return tb[xp_r(k) * kNld + n]; },
        [&](int k, int n) { return d_s[xp_p(k) * kNld + n]; });
    fma_chains<C::kXN, P>(       // dS_out^T xdt_j
        acc_b, [&](int k, int p) { return tx[xn_r(k) * kPld + p]; },
        [&](int k, int p) { return d_s[p * kNld + xn_n(k)]; });
#pragma unroll
    for (int k = 0; k < C::kXP; ++k) acc_x[k] *= g_s[j0 + xp_r(k)];
#pragma unroll
    for (int k = 0; k < C::kXN; ++k) {
      tw[xn_r(k) * kNld + xn_n(k)] = acc_b[k];
      acc_b[k] *= g_s[j0 + xn_r(k)];
    }
    __syncthreads();
    if (tid < kR && j0 + tid < q) {      // g_j <B_j, dS_out^T xdt_j>
      float s = 0.0f;
      for (int n = 0; n < N; ++n)
        s = fmaf(tb[tid * kNld + n], tw[tid * kNld + n], s);
      const float v = g_s[j0 + tid] * s;
      gdg_s[j0 + tid] = v;
      dcum_s[j0 + tid] -= v;
    }
    for (int it = jt; it < nt; ++it) {
      __syncthreads();   // the last pair's tiles are consumed
      stage_p(ty, dy, it * kR, false);
      stage_n(tc, cm, it * kR);
      __syncthreads();
      pair(it, jt);
      __syncthreads();
      float sx[C::kXP] = {}, sb[C::kXN] = {};
      fma_chains<C::kXP, kR>(    // sum_i W_ij dy_i
          sx, [&](int k, int ii) { return pw[ii * kRld + xp_r(k)]; },
          [&](int k, int ii) { return ty[ii * kPld + xp_p(k)]; });
      fma_chains<C::kXN, kR>(    // sum_i dG_ij C_i
          sb, [&](int k, int ii) { return pg[ii * kRld + xn_r(k)]; },
          [&](int k, int ii) { return tc[ii * kNld + xn_n(k)]; });
#pragma unroll
      for (int k = 0; k < C::kXP; ++k) acc_x[k] += sx[k];
#pragma unroll
      for (int k = 0; k < C::kXN; ++k) acc_b[k] += sb[k];
      if (tid < kR && j0 + tid < q) {       // the column sums
        float s = 0.0f;
        for (int ii = 0; ii < kR; ++ii) s += ps[ii * kRld + tid];
        dcum_s[j0 + tid] -= s;
      }
    }
    __syncthreads();   // ty is free: it takes dxdt
    float* pbt = pb + (bch * q + j0) * N;
#pragma unroll
    for (int k = 0; k < C::kXP; ++k) {
      const int e = tid + k * kThreads, r = e / P, p = e % P;
      ty[r * kPld + p] = acc_x[k];
      if (j0 + r < q)
        dx[((row0 + j0 + r) * H + h) * P + p] =
            __float2bfloat16(acc_x[k] * dt_s[j0 + r]);
    }
#pragma unroll
    for (int k = 0; k < C::kXN; ++k) {
      const int e = tid + k * kThreads, r = e / N, n = e % N;
      if (j0 + r < q) pbt[r * N + n] = acc_b[k];
    }
    __syncthreads();
    if (tid < kR && j0 + tid < q) {        // ddt_j = <dxdt_j, x_j>
      const int j = j0 + tid;
      const __nv_bfloat16* xr = x + ((row0 + j) * H + h) * P;
      float s = 0.0f;
      for (int p = 0; p < P; ++p) s = fmaf(ty[tid * kPld + p], bf(xr[p]), s);
      ddt[(row0 + j) * H + h] = s;
    }
  }

  // ---- by i tiles: dC's head partial, the state read-in, row sums
  for (int it = 0; it < nt; ++it) {
    const int i0 = it * kR;
    __syncthreads();
    stage_p(ty, dy, i0, false);
    stage_n(tc, cm, i0);
    __syncthreads();
    float acc_c[C::kXN] = {}, sc[C::kXP] = {};
    fma_chains<C::kXN, P>(       // S^T dy_i
        acc_c, [&](int k, int p) { return ty[xn_r(k) * kPld + p]; },
        [&](int k, int p) { return s_s[p * kNld + xn_n(k)]; });
#pragma unroll
    for (int k = 0; k < C::kXN; ++k) acc_c[k] *= e_s[i0 + xn_r(k)];
    fma_chains<C::kXP, N>(       // S C_i, into tx
        sc, [&](int k, int n) { return tc[xp_r(k) * kNld + n]; },
        [&](int k, int n) { return s_s[xp_p(k) * kNld + n]; });
#pragma unroll
    for (int k = 0; k < C::kXP; ++k) tx[xp_r(k) * kPld + xp_p(k)] = sc[k];
    __syncthreads();
    if (tid < kR && i0 + tid < q) {      // e_i <dy_i, S C_i>
      float s = 0.0f;
      for (int p = 0; p < P; ++p)
        s = fmaf(ty[tid * kPld + p], tx[tid * kPld + p], s);
      dcum_s[i0 + tid] += e_s[i0 + tid] * s;
    }
    for (int jt = 0; jt <= it; ++jt) {
      __syncthreads();
      stage_p(tx, x, jt * kR, true);
      stage_n(tb, bm, jt * kR);
      __syncthreads();
      pair(it, jt);
      __syncthreads();
      float sb[C::kXN] = {};
      fma_chains<C::kXN, kR>(    // sum_j dG_ij B_j
          sb, [&](int k, int jj) { return pg[xn_r(k) * kRld + jj]; },
          [&](int k, int jj) { return tb[jj * kNld + xn_n(k)]; });
#pragma unroll
      for (int k = 0; k < C::kXN; ++k) acc_c[k] += sb[k];
      if (tid < kR && i0 + tid < q) {       // the row sums
        float s = 0.0f;
        for (int jj = 0; jj < kR; ++jj) s += ps[tid * kRld + jj];
        dcum_s[i0 + tid] += s;
      }
    }
    float* pct = pc + (bch * q + i0) * N;
#pragma unroll
    for (int k = 0; k < C::kXN; ++k) {
      const int e = tid + k * kThreads, r = e / N, n = e % N;
      if (i0 + r < q) pct[r * N + n] = acc_c[k];
    }
  }

  // ---- the last row's terms, the reverse cumsum of dcum, da
  float part = 0.0f;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i % N;
    part = fmaf(d_s[p * kNld + n], s_s[p * kNld + n], part);
  }
  red[tid] = part;
  __syncthreads();
  for (int o = kThreads / 2; o > 0; o >>= 1) {
    if (tid < o) red[tid] += red[tid + o];
    __syncthreads();
  }
  if (tid == 0) {
    float gsum = 0.0f;
    for (int j = 0; j < q; ++j) gsum += gdg_s[j];
    dcum_s[q - 1] += gsum + expf(last) * red[0];
    float acc = 0.0f;
    for (int j = q - 1; j >= 0; --j) {
      acc += dcum_s[j];
      dcum_s[j] = acc;
    }
  }
  __syncthreads();
  for (int j = tid; j < q; j += kThreads)
    da[(row0 + j) * H + h] = a_s[j] > 1e-20f ? dcum_s[j] / a_s[j] : 0.0f;
}

// ---------------------------- 5. dB and dC: the head partials, summed

template <int N>
__global__ void __launch_bounds__(kThreads)
bwd_reduce_kernel(const float* __restrict__ pb, const float* __restrict__ pc,
                  __nv_bfloat16* __restrict__ dbm,
                  __nv_bfloat16* __restrict__ dcm, int S, int H, int q) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (e >= S * N) return;
  const int s = e / N, n = e % N, c = s / q, i = s % q, nc = S / q;
  const size_t stride = static_cast<size_t>(q) * N;
  const size_t base = (static_cast<size_t>(b) * nc + c) * H * stride +
                      static_cast<size_t>(i) * N + n;
  float sb = 0.0f, sc = 0.0f;
  for (int hh = 0; hh < H; ++hh) {
    sb += pb[base + hh * stride];
    sc += pc[base + hh * stride];
  }
  const size_t o = (static_cast<size_t>(b) * S + s) * N + n;
  dbm[o] = __float2bfloat16(sb);
  dcm[o] = __float2bfloat16(sc);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int P, int N>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, const void* init, const void* dy,
           const void* dstate, void* dx, void* ddt, void* da, void* dbm,
           void* dcm, void* dinit, void* cum, void* st, void* dst, void* cb,
           void* pb, void* pc, int B, int S, int H, int q,
           cudaStream_t stream) {
  using C = Cfg<P, N>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = allow_smem(bwd_state_kernel<P, N>, C::state_smem);
    if (e == cudaSuccess)
      e = allow_smem(bwd_main_kernel<P, N>, C::main_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int nc = S / q, nt = (q + kR - 1) / kR;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* bb = static_cast<const __nv_bfloat16*>(bm);
  const auto* cc = static_cast<const __nv_bfloat16*>(cm);
  const auto* dyb = static_cast<const __nv_bfloat16*>(dy);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* af = static_cast<const float*>(a);
  auto* cumf = static_cast<float*>(cum);
  auto* stf = static_cast<float*>(st);
  auto* dsf = static_cast<float*>(dst);
  auto* cbf = static_cast<float*>(cb);
  auto* pbf = static_cast<float*>(pb);
  auto* pcf = static_cast<float*>(pc);

  bwd_state_kernel<P, N><<<dim3(nc * H, B), kThreads, C::state_smem,
                           stream>>>(xb, dtf, af, bb, cc, dyb, cumf, stf, dsf,
                                     S, H, q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_cb_kernel<N><<<dim3(nt * (nt + 1) / 2, nc, B), kThreads, 0, stream>>>(
      bb, cc, cbf, S, q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_state_pass_kernel<<<dim3((P * N + kThreads - 1) / kThreads, H, B),
                          kThreads, 0, stream>>>(
      static_cast<const float*>(init), static_cast<const float*>(dstate),
      cumf, stf, dsf, static_cast<float*>(dinit), H, P * N, nc, q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_main_kernel<P, N><<<dim3(nc * H, B), kThreads, C::main_smem, stream>>>(
      xb, dtf, af, bb, cc, dyb, cumf, stf, dsf, cbf,
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(da), pbf, pcf, S, H, q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_reduce_kernel<N><<<dim3((S * N + kThreads - 1) / kThreads, B),
                         kThreads, 0, stream>>>(
      pbf, pcf, static_cast<__nv_bfloat16*>(dbm),
      static_cast<__nv_bfloat16*>(dcm), S, H, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dy, dx: (B, S, H, P) bf16; dt, a, ddt, da: (B, S, H) f32; bm, cm, dbm,
// dcm: (B, S, N) bf16; init, dstate, dinit: (B, H, P, N) f32, each of them
// null when absent (init and dinit together).  All contiguous; S a multiple
// of the chunk q <= 256.  (P, N) one of (64, 128), (64, 64), (32, 16).
// Scratch, nc = S / q chunks: cum (B, nc, H, q), st and dst (B, nc, H, P,
// N), cb (B, nc, q, q), pb and pc (B, nc, H, q, N), all f32.  Six launches
// (five kernels) on `stream`.
REPRO_EXPORT int ssd_scan_backward(
    const void* x, const void* dt, const void* a, const void* bm,
    const void* cm, const void* init, const void* dy, const void* dstate,
    void* dx, void* ddt, void* da, void* dbm, void* dcm, void* dinit,
    void* cum, void* st, void* dst, void* cb, void* pb, void* pc, int B,
    int S, int H, int P, int N, int q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || q <= 0 || q > kMaxChunk || S % q != 0 ||
      (init == nullptr) != (dinit == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  if (P == 64 && N == 128)
    return launch<64, 128>(x, dt, a, bm, cm, init, dy, dstate, dx, ddt, da,
                           dbm, dcm, dinit, cum, st, dst, cb, pb, pc, B, S, H,
                           q, st_);
  if (P == 64 && N == 64)
    return launch<64, 64>(x, dt, a, bm, cm, init, dy, dstate, dx, ddt, da,
                          dbm, dcm, dinit, cum, st, dst, cb, pb, pc, B, S, H,
                          q, st_);
  if (P == 32 && N == 16)
    return launch<32, 16>(x, dt, a, bm, cm, init, dy, dstate, dx, ddt, da,
                          dbm, dcm, dinit, cum, st, dst, cb, pb, pc, B, S, H,
                          q, st_);
  return static_cast<int>(cudaErrorInvalidValue);
}
