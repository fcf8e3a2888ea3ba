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
//   dW_ij = <dy_i, x_j> dt_j, dG = dW E; dC_i = sum_j dG_ij B_j + e_i S^T
//   dy_i, dB_j = sum_i dG_ij C_i + g_j dS_out^T xdt_j, each summed over heads
//   dcum = row sums - column sums of dW W, + e_i <dy_i, S C_i>,
//          - g_j <dS_out, xdt_j B_j^T>, and on the last row the sum of the
//          latter and exp(cum_last) <dS_out, S>; da = (reverse cumsum of
//          dcum) / a where a > 1e-20, else 0.
// ref.py::ssd_backward_reference is the same in plain torch, and
// ref.py::ssd_backward_passes_reference the passes below step by step.
//
// What bounds it on the H100: operations at the training shapes (mamba2-
// 2.7b's B 8 x S 1024 call: 86 GFLOP of the chunked form over 0.3 GB, the
// dozen products of 2 P N flop a row a head and the pair products).  Two
// facts shape the design.  B and C are one group for all heads, so dB and
// dC take dG summed over the heads in head order, one product with C and
// one with B for all heads, instead of H products and H partials summed
// afterwards.  And dW = dy x^T needs no split: dy and x are bf16, so it is
// one exact tensor-core product; dt_j and E scale its columns after.
//
// Design: seven launches on one stream, each grid a function of (B, S, H,
// P, N, q) alone, 64-row tiles of the chunk (rows past q zero-filled),
// every product mma.sync.m16n8k16 (bf16 in, f32 accumulate) with operands
// through ldmatrix from shared bf16 rows padded by 16 bytes, tiles in
// through cp.async (zero fill past the chunk):
//   1. bwd_state_kernel, eight warps per (chunk, head, row): cum and dt into
//      a scratch (as the forward's pass 2), the chunk's own state sum_j
//      x_j^T (B_j f_j), f_j = dt_j g_j, and own state gradient sum_i dy_i^T
//      (C_i e_i);
//   2. bwd_gt_kernel: G^T = B C^T of each chunk at and above the diagonal
//      (one group, shared by the heads);
//   3. bwd_state_pass_kernel, a block per (head, row): the state from chunk
//      to chunk and the state gradient back (f32, in chunk order), each
//      chunk's S and dS_out kept as bf16 parts, d init, and exp(cum_last)
//      <dS_out, S> per chunk;
//   4. bwd_dx_kernel, four warps per (chunk, head, 64-row j tile; the
//      longest first): dxdt_j = g_j dS_out B_j + sum_{i tiles >= j} W^T dy_i
//      with dW^T = x_j dy_i^T beside it, so that dW W gives the column sums
//      (in registers) and the row sums' partials of dcum; dx, ddt;
//   5. bwd_pairs_kernel, four warps per (chunk, 64 x 64 tile pair at or
//      below the diagonal, row), looping over the heads: dG summed over the
//      heads in head order in registers, then its products with B_j (dC's
//      part) and C_i (dB's part), once;
//   6. bwd_rows_kernel, four warps per (chunk, 64-row tile, dB or dC, row),
//      looping over the heads: dB's row term sum_h g_j dt_j dS_out^T x_j and
//      dC's sum_h e_i S^T dy_i (and the row terms e_i <C_i, S^T dy_i> of
//      dcum), then dB and dC: the row term plus the pair parts in order;
//   7. bwd_da_kernel, a warp per (chunk, head, row): dcum, its reverse
//      cumsum within the chunk and da.
// Every f32 factor enters a product as two bf16 parts, each the bf16 of
// what the first leaves (split_bf16x2_parts: to ~2^-16 of its size): W^T,
// B_j f_j, C_i e_i, S, dS_out and dG; the row scales (g_j, dt_j, e_i) are
// applied to the f32 products afterwards.  x, dy, B and C enter as they
// are.  Shared memory stays under 80 KB a block at mamba2's (P, N) = (64,
// 128) but for pass 6 (110 KB): two blocks or more an SM.
//
// Determinism: no atomics; every sum runs in an order fixed by the
// chunking (tiles, k16 steps and parts in order; heads in order; pair
// parts in tile order), so two calls give the same bits.  Padded rows (x,
// B, C = 0, dt = 0, a = 1, dy = 0) get dx, ddt, dB and dC of exactly zero.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kParts = 2;           // bf16 parts of each f32 factor
constexpr int kThreads = 128;       // four warps (passes 2, 4, 5, 6)
constexpr int kStateThreads = 256;  // eight warps (pass 1)
constexpr int kPassThreads = 256;   // passes 3 and 7
constexpr int kT = 64;              // tile rows
constexpr int kMaxChunk = 256;
constexpr int kMaxTiles = kMaxChunk / kT;
constexpr int kRowOff = 3;          // scratch rows: dcol, gdg, rowterm, rs[jt]

template <int P, int N>
struct Cfg {
  static constexpr int kXld = P + 8;
  static constexpr int kBld = N + 8;
  // pass 1: warps along N (at most 8) and along P (the forward's pass 2)
  static constexpr int kWN = N / 8 < 8 ? N / 8 : 8;
  static constexpr int kWM = 8 / kWN < P / 16 ? 8 / kWN : P / 16;
  static constexpr int kMT = P / 16 / kWM;   // m16 tiles (p) a warp
  static constexpr int kNT = N / 8 / kWN;    // n8 tiles (n) a warp
  static_assert(P % 32 == 0 && P <= 64 && N % 16 == 0 && N <= 128, "shape");
  static_assert(kMT * 16 * kWM == P && kNT * 8 * kWN == N, "warp tiling");
  // pass 6: the row products' columns in chunks of at most 64
  static constexpr int kNC = N < 64 ? N : 64;

  static constexpr size_t kTileX = kT * kXld * 2;   // a bf16 tile of P
  static constexpr size_t kTileB = kT * kBld * 2;   // a bf16 tile of N
  static constexpr size_t kState = kParts * P * kBld * 2;  // a state's parts
  static constexpr size_t gt_smem = 2 * kTileB;
  // pass 1: cum, dt and the row scale, then the two-stage ring of tiles
  static constexpr size_t state_smem =
      3 * kMaxChunk * 4 + 2 * (kTileX + kTileB);
  // pass 4: cum and dt, the x_j tile, row-sum partials, then one region
  // that holds B_j and dS_out's parts for the row term and afterwards the
  // two-stage ring of (G^T tile f32, dy_i tile)
  static constexpr size_t kDxStage = kT * kT * 4 + kTileX;
  static constexpr size_t kDxRegion =
      kTileB + kState > 2 * kDxStage ? kTileB + kState : 2 * kDxStage;
  static constexpr size_t dx_smem = 2 * kMaxChunk * 4 + kTileX +
                                    kMaxTiles * 4 * kT * 4 + kDxRegion;
  // pass 5: the ring of (dy_i tile, x_j tile, cum_i, cum_j, dt_j), then
  // dG's sum [kT][kT + 4] f32 and the C_i and B_j tiles
  static constexpr size_t kPairStage = 2 * kTileX + 3 * kT * 4;
  static constexpr size_t kPairEnd = kT * (kT + 4) * 4 + 2 * kTileB;
  static constexpr size_t pairs_smem =
      2 * kPairStage > kPairEnd ? 2 * kPairStage : kPairEnd;
  // pass 6: the C_i tile, then the ring of (row tile, state parts, cum and
  // dt of the chunk)
  static constexpr size_t kRowStage = kTileX + kState + 2 * kMaxChunk * 4;
  static constexpr size_t rows_smem = kTileB + 2 * kRowStage;
};

// Column of element (r, c) of a swizzled 64-column f32 tile: 8-float
// groups XOR the row's low two bits, so rows r .. r + 3 of one group lie on
// four distinct 8-bank groups (16-byte chunks and float2 pairs stay whole).
__device__ __forceinline__ int sw_col(int r, int c) {
  return c ^ ((r & 3) << 3);
}

// Stage `rows` rows of kCols bf16 (row stride `gstride` elements in global
// memory) into shared rows of kLd; rows at or past `valid` are zero.
template <int kCols, int kLd, int kBlock = kThreads>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           size_t gstride, int rows,
                                           int valid, int tid) {
  constexpr int kVec = kCols / 8;
  for (int i = tid; i < rows * kVec; i += kBlock) {
    const int r = i / kVec, c = i % kVec;
    const int rr = r < valid ? r : 0;   // a readable address either way
    cp_async16(dst + r * kLd + c * 8, src + rr * gstride + c * 8,
               r < valid ? 16 : 0);
  }
}

// `n` floats (a multiple of 4, 16-byte aligned both sides) into shared
// memory.
__device__ __forceinline__ void stage_floats(float* dst, const float* src,
                                             int n, int tid, int block) {
  for (int i = tid; i < n / 4; i += block)
    cp_async16(dst + 4 * i, src + 4 * i, 16);
}

// A fragment (m16k16) of a row-major bf16 tile (rows m, columns k, row
// stride ld), rows r0 .. r0 + 15, columns k0 .. k0 + 15.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* base, int ld,
                                       int r0, int k0, int lane) {
  const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = k0 + (lane >> 4) * 8;
  ldmatrix_x4(a, smem_u32(base + r * ld + c));
}

// B fragments (k16n8) of two n8 tiles n0 and n0 + 8 from a bf16 tile
// stored [n][k] (row stride ld): b[0], b[1] of tile n0, b[2], b[3] of n0+8.
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

// The A fragments (m16k16, kParts bf16 parts) of k-step ks of a 16 x 64
// f32 block held in eight m16n8 accumulator tiles (the next product's
// contraction runs over its columns).
__device__ __forceinline__ void acc_to_a(const float (&x)[8][4], int ks,
                                         uint32_t (&a)[kParts][4]) {
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t p[kParts];
      split_bf16x2_parts<kParts>(x[2 * ks + u][2 * hh],
                                 x[2 * ks + u][2 * hh + 1], p);
#pragma unroll
      for (int k = 0; k < kParts; ++k) a[k][hh + 2 * u] = p[k];
    }
}

// Sum of v over the eight lanes that share lane % 4 (one column of an
// m16n8 tile over its rows g), in a fixed butterfly order.
__device__ __forceinline__ float sum_over_rows(float v) {
  v += __shfl_xor_sync(kFullMask, v, 4);
  v += __shfl_xor_sync(kFullMask, v, 8);
  return v + __shfl_xor_sync(kFullMask, v, 16);
}

// Sum of v over the four lanes of a quad (one row of an m16n8 tile).
__device__ __forceinline__ float sum_over_quad(float v) {
  v += __shfl_xor_sync(kFullMask, v, 1);
  return v + __shfl_xor_sync(kFullMask, v, 2);
}

// ----------------------- 1. cum and each chunk's own state and gradient

template <int P, int N>
__global__ void __launch_bounds__(kStateThreads)
bwd_state_kernel(const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ dt, const float* __restrict__ a,
                 const __nv_bfloat16* __restrict__ bm,
                 const __nv_bfloat16* __restrict__ cm,
                 const __nv_bfloat16* __restrict__ dy,
                 float* __restrict__ cd, float* __restrict__ own, int S,
                 int H, int q, int qp) {
  using C = Cfg<P, N>;
  const int h = blockIdx.x % H, c = blockIdx.x / H, b = blockIdx.y;
  const int nc = S / q, n_tiles = qp / kT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ __align__(16) unsigned char state_smem[];
  float* cum_s = reinterpret_cast<float*>(state_smem);   // [kMaxChunk]
  float* dt_s = cum_s + kMaxChunk;
  float* f_s = dt_s + kMaxChunk;                          // the row scale
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(f_s + kMaxChunk);
  __nv_bfloat16* v_s = x_s + 2 * kT * C::kXld;            // [2][kT][kBld]

  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * q;
  const size_t bch = (static_cast<size_t>(b) * nc + c) * H + h;
  // pass 0: x rows and B rows; pass 1: dy rows and C rows
  auto load = [&](int pass, int jt, int stage) {
    const int j0 = jt * kT;
    stage_rows<P, C::kXld, kStateThreads>(
        x_s + stage * kT * C::kXld,
        (pass == 0 ? x : dy) + ((row0 + j0) * H + h) * P,
        static_cast<size_t>(H) * P, kT, q - j0, tid);
    stage_rows<N, C::kBld, kStateThreads>(
        v_s + stage * kT * C::kBld, (pass == 0 ? bm : cm) + (row0 + j0) * N,
        N, kT, q - j0, tid);
  };
  load(0, 0, 0);   // in flight while the scan below runs
  cp_async_commit();

  for (int j = tid; j < qp; j += kStateThreads) {
    const bool in = j < q;
    cum_s[j] = in ? logf(fmaxf(a[(row0 + j) * H + h], 1e-20f)) : 0.0f;
    dt_s[j] = in ? dt[(row0 + j) * H + h] : 0.0f;
  }
  __syncthreads();
  if (warp == 0) {
    float carry = 0.0f;
    for (int base = 0; base < qp; base += 32) {
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
  __syncthreads();
  const float last = cum_s[q - 1];
  float* cd_row = cd + bch * 2 * qp;
  for (int j = tid; j < qp; j += kStateThreads) {
    f_s[j] = dt_s[j] * expf(last - cum_s[j]);   // 0 past q (dt 0)
    cd_row[j] = cum_s[j];
    cd_row[qp + j] = dt_s[j];
  }

  // P x N = rows^T (vecs scale): M = p, N = n, K = j
  const int wm = warp / C::kWN, wn = warp % C::kWN;
  const int p0 = wm * C::kMT * 16, n0 = wn * C::kNT * 8;
  const bool active = warp < C::kWN * C::kWM;
  for (int pass = 0; pass < 2; ++pass) {
    float acc[C::kMT][C::kNT][4] = {};
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int step = pass * n_tiles + jt;
      __syncthreads();   // the stage of step - 1 is free (and f_s written)
      if (jt + 1 < n_tiles)
        load(pass, jt + 1, (step + 1) & 1);
      else if (pass == 0)
        load(1, 0, (step + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      if (!active) continue;
      const __nv_bfloat16* xt = x_s + (step & 1) * kT * C::kXld;
      const __nv_bfloat16* bt = v_s + (step & 1) * kT * C::kBld;
#pragma unroll
      for (int ks = 0; ks < kT / 16; ++ks) {
        uint32_t af[C::kMT][4];
#pragma unroll
        for (int mt = 0; mt < C::kMT; ++mt) {
          // rows^T through ldmatrix.trans of the [j][p] tile
          const int r = ks * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
          const int col = p0 + mt * 16 + ((lane >> 3) & 1) * 8;
          ldmatrix_x4_trans(af[mt], smem_u32(xt + r * C::kXld + col));
        }
        const int j = jt * kT + ks * 16 + 2 * t;
        const float2 f01 = make_float2(f_s[j], f_s[j + 1]);
        const float2 f89 = make_float2(f_s[j + 8], f_s[j + 9]);
#pragma unroll
        for (int np = 0; np < (C::kNT + 1) / 2; ++np) {
          uint32_t r[4];
          if constexpr (C::kNT % 2 == 0) {
            load_b_kn(r, bt, C::kBld, n0 + np * 16, ks * 16, lane);
          } else {    // one n8 tile: the x2 form of the same load
            uint32_t r2[2];
            const int row = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
            ldmatrix_x2_trans(r2, smem_u32(bt + row * C::kBld + n0));
            r[0] = r2[0], r[1] = r2[1], r[2] = r[3] = 0u;
          }
#pragma unroll
          for (int u = 0; u < 2 && 2 * np + u < C::kNT; ++u) {
            // vecs_j scale_j in bf16 parts (rows 2t, 2t + 1 and + 8, + 9)
            const float2 v0 = bf16x2_to_float2(r[2 * u]);
            const float2 v1 = bf16x2_to_float2(r[2 * u + 1]);
            uint32_t q0[kParts], q1[kParts];
            split_bf16x2_parts<kParts>(v0.x * f01.x, v0.y * f01.y, q0);
            split_bf16x2_parts<kParts>(v1.x * f89.x, v1.y * f89.y, q1);
#pragma unroll
            for (int k = 0; k < kParts; ++k) {
              const uint32_t bk[2] = {q0[k], q1[k]};
#pragma unroll
              for (int mt = 0; mt < C::kMT; ++mt)
                mma_m16n8k16_bf16(acc[mt][2 * np + u], af[mt], bk);
            }
          }
        }
      }
    }
    if (active) {
      float* out = own + (bch * 2 + pass) * P * N;
#pragma unroll
      for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(out + (p0 + mt * 16 + g + 8 * hh) * N +
                                       n0 + nt * 8 + 2 * t) =
                make_float2(acc[mt][nt][2 * hh], acc[mt][nt][2 * hh + 1]);
    }
    if (pass == 0) {
      __syncthreads();   // every warp is past its last read of f_s
      for (int j = tid; j < qp; j += kStateThreads)
        f_s[j] = j < q ? expf(cum_s[j]) : 0.0f;   // e_i
    }
  }
  cp_async_wait<0>();
}

// --------------------------------------------- 2. G^T = B C^T per chunk

template <int N>
__global__ void __launch_bounds__(kThreads)
bwd_gt_kernel(const __nv_bfloat16* __restrict__ bm,
              const __nv_bfloat16* __restrict__ cm, float* __restrict__ gt,
              int S, int q, int qp) {
  constexpr int kBld = N + 8;
  int jt = blockIdx.x, it = 0;        // the pair (it, jt <= it)
  while (jt > it) jt -= ++it;
  const int c = blockIdx.y, b = blockIdx.z, nc = S / q;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = it * kT, j0 = jt * kT;

  extern __shared__ __align__(16) unsigned char gt_smem[];
  __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(gt_smem);
  __nv_bfloat16* c_s = b_s + kT * kBld;
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * q;
  stage_rows<N, kBld>(b_s, bm + (row0 + j0) * N, N, kT, q - j0, tid);
  stage_rows<N, kBld>(c_s, cm + (row0 + i0) * N, N, kT, q - i0, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // rows j (B), columns i (C)
  float acc[kT / 8][4] = {};
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    uint32_t af[4];
    load_a(af, b_s, kBld, warp * 16, ks * 16, lane);
#pragma unroll
    for (int np = 0; np < kT / 16; ++np) {
      uint32_t r[4];
      load_b_nk(r, c_s, kBld, np * 16, ks * 16, lane);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_m16n8k16_bf16(acc[2 * np], af, b0);
      mma_m16n8k16_bf16(acc[2 * np + 1], af, b1);
    }
  }
  float* out = gt + ((static_cast<size_t>(b) * nc + c) * qp + j0) * qp + i0;
#pragma unroll
  for (int nt = 0; nt < kT / 8; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(out + (warp * 16 + g + 8 * hh) * qp +
                                 nt * 8 + 2 * t) =
          make_float2(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
}

// ------------------- 3. the states from chunk to chunk, both directions

template <int kE>
__global__ void __launch_bounds__(kPassThreads)
bwd_state_pass_kernel(const float* __restrict__ init,
                      const float* __restrict__ dstate,
                      const float* __restrict__ cd,
                      const float* __restrict__ own,
                      __nv_bfloat16* __restrict__ parts,
                      float* __restrict__ last, float* __restrict__ dinit,
                      int H, int nc, int q, int qp) {
  constexpr int PN = kE * kPassThreads;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t bh = static_cast<size_t>(b) * H + h;
  __shared__ float red[kPassThreads / 32];
  auto chunk = [&](int c) { return (static_cast<size_t>(b) * nc + c) * H + h; };
  // parts[bch][0 = S, 1 = dS_out][part][P N]
  auto part_at = [&](size_t bch, int which, int k, int e) {
    return parts + ((bch * 2 + which) * kParts + k) * PN + e;
  };

  // forward: the state carried into each chunk, kept as its parts
  float s[kE];
#pragma unroll
  for (int k = 0; k < kE; ++k)
    s[k] = init ? init[bh * PN + tid + k * kPassThreads] : 0.0f;
  for (int c = 0; c < nc; ++c) {
    const size_t bch = chunk(c);
    const float decay = expf(cd[bch * 2 * qp + q - 1]);
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      const int e = tid + k * kPassThreads;
      float r = s[k];
#pragma unroll
      for (int pk = 0; pk < kParts; ++pk) {
        const __nv_bfloat16 v = __float2bfloat16(r);
        *part_at(bch, 0, pk, e) = v;
        r -= __bfloat162float(v);
      }
      s[k] = s[k] * decay + own[(bch * 2 + 0) * PN + e];
    }
  }
  // backward: dS_out of each chunk (kept as its parts), exp(cum_last)
  // <dS_out, S>, and what is left, d init
#pragma unroll
  for (int k = 0; k < kE; ++k)
    s[k] = dstate ? dstate[bh * PN + tid + k * kPassThreads] : 0.0f;
  for (int c = nc - 1; c >= 0; --c) {
    const size_t bch = chunk(c);
    const float decay = expf(cd[bch * 2 * qp + q - 1]);
    float dot = 0.0f;
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      const int e = tid + k * kPassThreads;
      float r = s[k], sv = 0.0f;
#pragma unroll
      for (int pk = 0; pk < kParts; ++pk) {
        const __nv_bfloat16 v = __float2bfloat16(r);
        *part_at(bch, 1, pk, e) = v;
        r -= __bfloat162float(v);
        sv += __bfloat162float(*part_at(bch, 0, pk, e));
      }
      dot = fmaf(s[k], sv, dot);
      s[k] = s[k] * decay + own[(bch * 2 + 1) * PN + e];
    }
    dot = warp_sum(dot);
    if ((tid & 31) == 0) red[tid >> 5] = dot;
    __syncthreads();
    if (tid == 0) {
      float sum = 0.0f;
      for (int w = 0; w < kPassThreads / 32; ++w) sum += red[w];
      last[bch] = decay * sum;
    }
    __syncthreads();
  }
  if (dinit) {
#pragma unroll
    for (int k = 0; k < kE; ++k) dinit[bh * PN + tid + k * kPassThreads] = s[k];
  }
}

// ------------------------------ 4. dxdt of one (chunk, head, j tile)

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
bwd_dx_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ bm,
              const __nv_bfloat16* __restrict__ dy,
              const float* __restrict__ cd, const float* __restrict__ gt,
              const __nv_bfloat16* __restrict__ parts,
              __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
              float* __restrict__ rows, int S, int H, int q, int qp,
              int n_rows) {
  using C = Cfg<P, N>;
  const int h = blockIdx.x % H, c = blockIdx.x / H, b = blockIdx.z;
  const int nc = S / q, n_tiles = qp / kT;
  const int jt = blockIdx.y;     // j tile 0 meets the most i tiles: first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = jt * kT, rl = warp * 16 + g;

  extern __shared__ __align__(16) unsigned char dx_smem[];
  float* cd_s = reinterpret_cast<float*>(dx_smem);            // cum, dt
  __nv_bfloat16* x_s =
      reinterpret_cast<__nv_bfloat16*>(cd_s + 2 * kMaxChunk);  // [kT][kXld]
  float* red = reinterpret_cast<float*>(x_s + kT * C::kXld);   // [4][4][kT]
  unsigned char* region =
      reinterpret_cast<unsigned char*>(red + kMaxTiles * 4 * kT);
  __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(region);
  __nv_bfloat16* d_s = b_s + kT * C::kBld;   // dS_out's parts [kParts][P][kBld]
  auto gt_stage = [&](int stage) {
    return reinterpret_cast<float*>(region + stage * C::kDxStage);
  };
  auto dy_stage = [&](int stage) {
    return reinterpret_cast<__nv_bfloat16*>(region + stage * C::kDxStage +
                                            kT * kT * 4);
  };

  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * q;
  const size_t bch = (static_cast<size_t>(b) * nc + c) * H + h;
  const size_t xs = static_cast<size_t>(H) * P;
  stage_rows<P, C::kXld>(x_s, x + ((row0 + j0) * H + h) * P, xs, kT, q - j0,
                         tid);
  stage_rows<N, C::kBld>(b_s, bm + (row0 + j0) * N, N, kT, q - j0, tid);
  for (int k = 0; k < kParts; ++k)
    stage_rows<N, C::kBld>(d_s + k * P * C::kBld,
                           parts + ((bch * 2 + 1) * kParts + k) * P * N, N, P,
                           P, tid);
  for (int i = tid; i < qp / 2; i += kThreads)
    cp_async16(cd_s + (i * 4 < qp ? i * 4 : kMaxChunk + i * 4 - qp),
               cd + bch * 2 * qp + i * 4, 16);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const float* cum_s = cd_s;
  const float* dt_s = cd_s + kMaxChunk;
  const float last = cum_s[q - 1];
  float cum_j[2], dt_j[2], g_j[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j = j0 + rl + 8 * hh;
    cum_j[hh] = cum_s[j];
    dt_j[hh] = dt_s[j];
    g_j[hh] = j < q ? expf(last - cum_j[hh]) : 0.0f;
  }

  // the row term dS_out B_j: M = j, N = p, K = n, part by part
  float acc[P / 8][4] = {};
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    uint32_t af[4];
    load_a(af, b_s, C::kBld, warp * 16, ks * 16, lane);
#pragma unroll
    for (int k = 0; k < kParts; ++k)
#pragma unroll
      for (int np = 0; np < P / 16; ++np) {
        uint32_t r[4];
        load_b_nk(r, d_s + k * P * C::kBld, C::kBld, np * 16, ks * 16, lane);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_m16n8k16_bf16(acc[2 * np], af, b0);
        mma_m16n8k16_bf16(acc[2 * np + 1], af, b1);
      }
  }
  // gdg_j = g_j dt_j <x_j, dS_out B_j>; then the row term times g_j
  float gdg[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float s = 0.0f;
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt) {
      const float2 xv = bf16x2_to_float2(*reinterpret_cast<const unsigned*>(
          x_s + (rl + 8 * hh) * C::kXld + nt * 8 + 2 * t));
      s = fmaf(xv.x, acc[nt][2 * hh], s);
      s = fmaf(xv.y, acc[nt][2 * hh + 1], s);
    }
    gdg[hh] = g_j[hh] * dt_j[hh] * sum_over_quad(s);
  }
#pragma unroll
  for (int nt = 0; nt < P / 8; ++nt) {
    acc[nt][0] *= g_j[0], acc[nt][1] *= g_j[0];
    acc[nt][2] *= g_j[1], acc[nt][3] *= g_j[1];
  }

  const float* gt_tile =
      gt + ((static_cast<size_t>(b) * nc + c) * qp + j0) * qp;
  auto load = [&](int it, int stage) {
    float* dst = gt_stage(stage);
    for (int i = tid; i < kT * kT / 4; i += kThreads) {
      const int r = i / (kT / 4), col = (i % (kT / 4)) * 4;
      cp_async16(dst + r * kT + sw_col(r, col),
                 gt_tile + r * qp + it * kT + col, 16);
    }
    const int i0 = it * kT;
    stage_rows<P, C::kXld>(dy_stage(stage), dy + ((row0 + i0) * H + h) * P,
                           xs, kT, q - i0, tid);
  };
  __syncthreads();   // the row term's room goes to the ring
  load(jt, 0);
  cp_async_commit();

  float colsum[2] = {0.0f, 0.0f};
  for (int it = jt; it < n_tiles; ++it) {
    const int stage = (it - jt) & 1;
    __syncthreads();   // the stage of it - 1 is free
    if (it + 1 < n_tiles) load(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* gtt = gt_stage(stage);
    const __nv_bfloat16* dyt = dy_stage(stage);
    const int i0 = it * kT;
    const bool diag = it == jt;

    // dW^T = x_j dy_i^T (before dt_j): M = j, N = i, K = p
    float dw[8][4] = {};
#pragma unroll
    for (int ks = 0; ks < P / 16; ++ks) {
      uint32_t af[4];
      load_a(af, x_s, C::kXld, warp * 16, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        load_b_nk(r, dyt, C::kXld, np * 16, ks * 16, lane);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_m16n8k16_bf16(dw[2 * np], af, b0);
        mma_m16n8k16_bf16(dw[2 * np + 1], af, b1);
      }
    }
    // W^T = G^T E^T (j <= i, else 0) in place of dW^T's partner; dW W
    // (dt_j in) summed along rows (colsum) and, over this thread's two
    // rows, along columns (rs)
    float w[8][4], rs[8][2];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      rs[nt][0] = rs[nt][1] = 0.0f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = rl + 8 * hh, jj = j0 + r;
        const int il = nt * 8 + 2 * t, i = i0 + il;
        const float2 gv =
            *reinterpret_cast<const float2*>(gtt + r * kT + sw_col(r, il));
        const float w0 = !diag || jj <= i
                             ? gv.x * expf(cum_s[i] - cum_j[hh]) : 0.0f;
        const float w1 = !diag || jj <= i + 1
                             ? gv.y * expf(cum_s[i + 1] - cum_j[hh]) : 0.0f;
        const float p0 = dw[nt][2 * hh] * dt_j[hh] * w0;
        const float p1 = dw[nt][2 * hh + 1] * dt_j[hh] * w1;
        colsum[hh] += p0 + p1;
        rs[nt][0] += p0;
        rs[nt][1] += p1;
        w[nt][2 * hh] = w0;
        w[nt][2 * hh + 1] = w1;
      }
    }
    // dxdt_j += W^T dy_i: M = j, N = p, K = i, W^T in parts
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t wp[kParts][4];
      acc_to_a(w, ks, wp);
#pragma unroll
      for (int np = 0; np < P / 16; ++np) {
        uint32_t r[4];
        load_b_kn(r, dyt, C::kXld, np * 16, ks * 16, lane);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
#pragma unroll
        for (int k = 0; k < kParts; ++k) {
          mma_m16n8k16_bf16(acc[2 * np], wp[k], b0);
          mma_m16n8k16_bf16(acc[2 * np + 1], wp[k], b1);
        }
      }
    }
    // this warp's 16 rows' sums for each column i
    float* red_it = red + ((it - jt) * 4 + warp) * kT;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = sum_over_rows(rs[nt][e]);
        if (g == 0) red_it[nt * 8 + 2 * t + e] = v;
      }
  }
  cp_async_wait<0>();

  // dx = dxdt dt_j, ddt_j = <dxdt_j, x_j>, dcum's column terms
  float* rows_bch = rows + bch * n_rows * qp;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rloc = rl + 8 * hh, j = j0 + rloc;
    float s = 0.0f;
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt) {
      const float2 xv = bf16x2_to_float2(*reinterpret_cast<const unsigned*>(
          x_s + rloc * C::kXld + nt * 8 + 2 * t));
      s = fmaf(acc[nt][2 * hh], xv.x, s);
      s = fmaf(acc[nt][2 * hh + 1], xv.y, s);
    }
    s = sum_over_quad(s);
    const float cs = sum_over_quad(colsum[hh]);
    if (j >= q) continue;
    __nv_bfloat16* dxr = dx + ((row0 + j) * H + h) * P;
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(dxr + nt * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[nt][2 * hh] * dt_j[hh],
                                acc[nt][2 * hh + 1] * dt_j[hh]);
    if (t == 0) {
      ddt[(row0 + j) * H + h] = s;
      rows_bch[j] = -cs - gdg[hh];
      rows_bch[qp + j] = gdg[hh];
    }
  }
  __syncthreads();
  // the row sums' partials of this j tile, over the warps in order
  for (int e = tid; e < (n_tiles - jt) * kT; e += kThreads) {
    const int k = e / kT, i = e % kT;
    const float* rp = red + k * 4 * kT + i;
    rows_bch[(kRowOff + jt) * qp + (jt + k) * kT + i] =
        ((rp[0] + rp[kT]) + rp[2 * kT]) + rp[3 * kT];
  }
}

// -------------------- 5. dG summed over the heads, times B_j and C_i

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
bwd_pairs_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ bm,
                 const __nv_bfloat16* __restrict__ cm,
                 const __nv_bfloat16* __restrict__ dy,
                 const float* __restrict__ cd, float* __restrict__ pairs,
                 int S, int H, int q, int qp) {
  using C = Cfg<P, N>;
  const int pair = blockIdx.x;
  int jt = pair, it = 0;              // the pair (it, jt <= it)
  while (jt > it) jt -= ++it;
  const int c = blockIdx.y, b = blockIdx.z, nc = S / q;
  const int n_pairs = (qp / kT) * (qp / kT + 1) / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = it * kT, j0 = jt * kT, rl = warp * 16 + g;
  const bool diag = it == jt;

  extern __shared__ __align__(16) unsigned char pairs_smem[];
  auto dy_stage = [&](int stage) {
    return reinterpret_cast<__nv_bfloat16*>(pairs_smem +
                                            stage * C::kPairStage);
  };
  auto x_stage = [&](int stage) { return dy_stage(stage) + kT * C::kXld; };
  auto f_stage = [&](int stage) {   // cum_i, cum_j, dt_j [3][kT]
    return reinterpret_cast<float*>(x_stage(stage) + kT * C::kXld);
  };

  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * q;
  const size_t xs = static_cast<size_t>(H) * P;
  auto load = [&](int h, int stage) {
    stage_rows<P, C::kXld>(dy_stage(stage), dy + ((row0 + i0) * H + h) * P,
                           xs, kT, q - i0, tid);
    stage_rows<P, C::kXld>(x_stage(stage), x + ((row0 + j0) * H + h) * P, xs,
                           kT, q - j0, tid);
    const float* cdh =
        cd + ((static_cast<size_t>(b) * nc + c) * H + h) * 2 * qp;
    float* f = f_stage(stage);
    stage_floats(f, cdh + i0, kT, tid, kThreads);
    stage_floats(f + kT, cdh + j0, kT, tid, kThreads);
    stage_floats(f + 2 * kT, cdh + qp + j0, kT, tid, kThreads);
  };
  load(0, 0);
  cp_async_commit();

  // dG summed over the heads: M = i, N = j
  float dg[8][4] = {};
  for (int h = 0; h < H; ++h) {
    const int stage = h & 1;
    __syncthreads();   // the stage of head h - 1 is free
    if (h + 1 < H) load(h + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* dyt = dy_stage(stage);
    const __nv_bfloat16* xt = x_stage(stage);
    const float* f = f_stage(stage);
    // dW (before dt_j) = dy_i x_j^T: M = i, N = j, K = p
    float dw[8][4] = {};
#pragma unroll
    for (int ks = 0; ks < P / 16; ++ks) {
      uint32_t af[4];
      load_a(af, dyt, C::kXld, warp * 16, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        load_b_nk(r, xt, C::kXld, np * 16, ks * 16, lane);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_m16n8k16_bf16(dw[2 * np], af, b0);
        mma_m16n8k16_bf16(dw[2 * np + 1], af, b1);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int ii = rl + 8 * hh;
      const float ci = f[ii];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jl = nt * 8 + 2 * t + e;
          if (!diag || jl <= ii)    // exp only at and below the diagonal
            dg[nt][2 * hh + e] += dw[nt][2 * hh + e] * f[2 * kT + jl] *
                                  expf(ci - f[kT + jl]);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring's room goes to dG, C_i and B_j

  float* gs = reinterpret_cast<float*>(pairs_smem);   // [kT][kT + 4]
  __nv_bfloat16* c_s = reinterpret_cast<__nv_bfloat16*>(gs + kT * (kT + 4));
  __nv_bfloat16* b_s = c_s + kT * C::kBld;
  stage_rows<N, C::kBld>(c_s, cm + (row0 + i0) * N, N, kT, q - i0, tid);
  stage_rows<N, C::kBld>(b_s, bm + (row0 + j0) * N, N, kT, q - j0, tid);
  cp_async_commit();
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(gs + (rl + 8 * hh) * (kT + 4) + nt * 8 +
                                 2 * t) =
          make_float2(dg[nt][2 * hh], dg[nt][2 * hh + 1]);
  cp_async_wait<0>();
  __syncthreads();

  float* out_b = pairs + ((static_cast<size_t>(b) * nc + c) * 2 * n_pairs +
                          pair) * kT * N;
  float* out_c = out_b + static_cast<size_t>(n_pairs) * kT * N;
  // dC's part, dG B_j: M = i, N = n, K = j, dG in parts
  {
    float acc[N / 8][4] = {};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t ap[kParts][4];
      acc_to_a(dg, ks, ap);
#pragma unroll
      for (int np = 0; np < N / 16; ++np) {
        uint32_t r[4];
        load_b_kn(r, b_s, C::kBld, np * 16, ks * 16, lane);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
#pragma unroll
        for (int k = 0; k < kParts; ++k) {
          mma_m16n8k16_bf16(acc[2 * np], ap[k], b0);
          mma_m16n8k16_bf16(acc[2 * np + 1], ap[k], b1);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(out_c + (rl + 8 * hh) * N + nt * 8 +
                                   2 * t) =
            make_float2(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
  }
  // dB's part, dG^T C_i: M = j, N = n, K = i, dG^T gathered from shared
  // memory in parts
  {
    float acc[N / 8][4] = {};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t ap[kParts][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int jj = rl + 8 * hh, ii = ks * 16 + 8 * u + 2 * t;
          uint32_t p[kParts];
          split_bf16x2_parts<kParts>(gs[ii * (kT + 4) + jj],
                                     gs[(ii + 1) * (kT + 4) + jj], p);
#pragma unroll
          for (int k = 0; k < kParts; ++k) ap[k][hh + 2 * u] = p[k];
        }
#pragma unroll
      for (int np = 0; np < N / 16; ++np) {
        uint32_t r[4];
        load_b_kn(r, c_s, C::kBld, np * 16, ks * 16, lane);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
#pragma unroll
        for (int k = 0; k < kParts; ++k) {
          mma_m16n8k16_bf16(acc[2 * np], ap[k], b0);
          mma_m16n8k16_bf16(acc[2 * np + 1], ap[k], b1);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(out_b + (rl + 8 * hh) * N + nt * 8 +
                                   2 * t) =
            make_float2(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
  }
}

// --------------- 6. the row terms summed over the heads; dB and dC

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
bwd_rows_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ cm,
                const __nv_bfloat16* __restrict__ dy,
                const float* __restrict__ cd,
                const __nv_bfloat16* __restrict__ parts,
                const float* __restrict__ pairs,
                __nv_bfloat16* __restrict__ dbm,
                __nv_bfloat16* __restrict__ dcm, float* __restrict__ rows,
                int S, int H, int q, int qp, int n_rows) {
  using C = Cfg<P, N>;
  constexpr int kNC = C::kNC;
  const int n_tiles = qp / kT, nc = S / q;
  const int tile = blockIdx.x % n_tiles;
  const int kind = (blockIdx.x / n_tiles) % 2;   // 0: dB's, 1: dC's
  const int c = blockIdx.x / (2 * n_tiles), b = blockIdx.y;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = tile * kT, rl = warp * 16 + g;

  extern __shared__ __align__(16) unsigned char rows_smem[];
  __nv_bfloat16* c_s = reinterpret_cast<__nv_bfloat16*>(rows_smem);
  auto row_stage = [&](int stage) {
    return reinterpret_cast<__nv_bfloat16*>(rows_smem + C::kTileB +
                                            stage * C::kRowStage);
  };
  auto st_stage = [&](int stage) { return row_stage(stage) + kT * C::kXld; };
  auto cd_stage = [&](int stage) {
    return reinterpret_cast<float*>(st_stage(stage) + kParts * P * C::kBld);
  };

  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * q;
  const size_t xs = static_cast<size_t>(H) * P;
  const __nv_bfloat16* src = kind == 0 ? x : dy;
  auto load = [&](int h, int stage) {
    const size_t bch = (static_cast<size_t>(b) * nc + c) * H + h;
    stage_rows<P, C::kXld>(row_stage(stage), src + ((row0 + r0) * H + h) * P,
                           xs, kT, q - r0, tid);
    for (int k = 0; k < kParts; ++k)   // dB: dS_out's parts; dC: S's
      stage_rows<N, C::kBld>(
          st_stage(stage) + k * P * C::kBld,
          parts + ((bch * 2 + (kind == 0 ? 1 : 0)) * kParts + k) * P * N, N,
          P, P, tid);
    stage_floats(cd_stage(stage), cd + bch * 2 * qp, 2 * qp, tid, kThreads);
  };
  if (kind == 1)
    stage_rows<N, C::kBld>(c_s, cm + (row0 + r0) * N, N, kT, q - r0, tid);
  load(0, 0);
  cp_async_commit();

  // sum_h scale T: M = row, N = n; T = rows^T-weighted state, K = p
  float racc[N / 8][4] = {};
  for (int h = 0; h < H; ++h) {
    const int stage = h & 1;
    __syncthreads();   // the stage of head h - 1 is free
    if (h + 1 < H) load(h + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* rt = row_stage(stage);
    const __nv_bfloat16* stt = st_stage(stage);
    const float* cum_s = cd_stage(stage);
    const float* dt_s = cum_s + qp;
    // dB: g_j dt_j; dC: e_i (0 past q)
    float scale[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + rl + 8 * hh;
      scale[hh] = r >= q ? 0.0f
                  : kind == 0 ? expf(cum_s[q - 1] - cum_s[r]) * dt_s[r]
                              : expf(cum_s[r]);
    }
    float dot[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nc0 = 0; nc0 < N; nc0 += kNC) {
      float tacc[kNC / 8][4] = {};
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        uint32_t af[4];
        load_a(af, rt, C::kXld, warp * 16, ks * 16, lane);
#pragma unroll
        for (int k = 0; k < kParts; ++k)
#pragma unroll
          for (int np = 0; np < kNC / 16; ++np) {
            uint32_t r[4];
            load_b_kn(r, stt + k * P * C::kBld, C::kBld, nc0 + np * 16,
                      ks * 16, lane);
            const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
            mma_m16n8k16_bf16(tacc[2 * np], af, b0);
            mma_m16n8k16_bf16(tacc[2 * np + 1], af, b1);
          }
      }
#pragma unroll
      for (int nt = 0; nt < kNC / 8; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (kind == 1) {   // <C_i, S^T dy_i>
            const float2 cv = bf16x2_to_float2(
                *reinterpret_cast<const unsigned*>(
                    c_s + (rl + 8 * hh) * C::kBld + nc0 + nt * 8 + 2 * t));
            dot[hh] = fmaf(cv.x, tacc[nt][2 * hh], dot[hh]);
            dot[hh] = fmaf(cv.y, tacc[nt][2 * hh + 1], dot[hh]);
          }
          racc[nc0 / 8 + nt][2 * hh] =
              fmaf(scale[hh], tacc[nt][2 * hh], racc[nc0 / 8 + nt][2 * hh]);
          racc[nc0 / 8 + nt][2 * hh + 1] = fmaf(
              scale[hh], tacc[nt][2 * hh + 1], racc[nc0 / 8 + nt][2 * hh + 1]);
        }
    }
    if (kind == 1) {   // dcum's row term e_i <dy_i, S C_i>
      const size_t bch = (static_cast<size_t>(b) * nc + c) * H + h;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float d = sum_over_quad(dot[hh]);
        const int r = r0 + rl + 8 * hh;
        if (t == 0 && r < q) rows[(bch * n_rows + 2) * qp + r] = scale[hh] * d;
      }
    }
  }
  cp_async_wait<0>();

  // dB_j = row term + sum over i tiles >= j of the pair parts; dC_i = row
  // term + sum over j tiles <= i
  const float* pc = pairs + (static_cast<size_t>(b) * nc + c) * 2 * n_pairs *
                                kT * N + (kind == 1 ? n_pairs * kT * N : 0);
  const int n_terms = kind == 0 ? n_tiles - tile : tile + 1;
  for (int k = 0; k < n_terms; ++k) {
    const int pr = kind == 0 ? (tile + k) * (tile + k + 1) / 2 + tile
                             : tile * (tile + 1) / 2 + k;
    const float* pt = pc + static_cast<size_t>(pr) * kT * N;
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 v = *reinterpret_cast<const float2*>(
            pt + (rl + 8 * hh) * N + nt * 8 + 2 * t);
        racc[nt][2 * hh] += v.x;
        racc[nt][2 * hh + 1] += v.y;
      }
  }
  __nv_bfloat16* out = kind == 0 ? dbm : dcm;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + rl + 8 * hh;
    if (r >= q) continue;
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(out + (row0 + r) * N + nt * 8 +
                                         2 * t) =
          __floats2bfloat162_rn(racc[nt][2 * hh], racc[nt][2 * hh + 1]);
  }
}

// --------------------- 7. dcum, its reverse cumsum in the chunk, and da

__global__ void __launch_bounds__(kPassThreads)
bwd_da_kernel(const float* __restrict__ a, const float* __restrict__ rows,
              const float* __restrict__ last, float* __restrict__ da, int S,
              int H, int q, int qp, int n_rows) {
  const int nc = S / q;
  const int unit = blockIdx.x * (kPassThreads / 32) + (threadIdx.x >> 5);
  const int b = blockIdx.y, lane = threadIdx.x & 31;
  if (unit >= nc * H) return;
  const int c = unit / H, h = unit % H;
  const size_t bch = (static_cast<size_t>(b) * nc + c) * H + h;
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * q;
  const float* rb = rows + bch * n_rows * qp;
  // the last row's extra: sum_j gdg_j + exp(cum_last) <dS_out, S>
  float gs = 0.0f;
  for (int j = lane; j < q; j += 32) gs += rb[qp + j];
  gs = warp_sum(gs);
  const float extra = gs + last[bch];
  auto dcum = [&](int i) {
    float v = rb[i] + rb[2 * qp + i];
    for (int jt = 0; jt <= i / kT; ++jt) v += rb[(kRowOff + jt) * qp + i];
    return i == q - 1 ? v + extra : v;
  };
  // reverse cumsum, 32 rows at a time from the end
  float carry = 0.0f;
  for (int top = q; top > 0; top -= 32) {
    const int i = top - 1 - lane;
    float v = i >= 0 ? dcum(i) : 0.0f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(kFullMask, v, o);
      if (lane >= o) v += up;
    }
    const float dla = carry + v;
    carry += __shfl_sync(kFullMask, v, 31);
    if (i >= 0) {
      const float av = a[(row0 + i) * H + h];
      da[(row0 + i) * H + h] = av > 1e-20f ? dla / av : 0.0f;
    }
  }
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
           void* dcm, void* dinit, void* cd, void* gt, void* own, void* parts,
           void* last, void* rows, void* pairs, int B, int S, int H, int q,
           cudaStream_t stream) {
  using C = Cfg<P, N>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = allow_smem(bwd_state_kernel<P, N>, C::state_smem);
    if (e == cudaSuccess) e = allow_smem(bwd_gt_kernel<N>, C::gt_smem);
    if (e == cudaSuccess) e = allow_smem(bwd_dx_kernel<P, N>, C::dx_smem);
    if (e == cudaSuccess)
      e = allow_smem(bwd_pairs_kernel<P, N>, C::pairs_smem);
    if (e == cudaSuccess) e = allow_smem(bwd_rows_kernel<P, N>, C::rows_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int nc = S / q, n_tiles = (q + kT - 1) / kT, qp = n_tiles * kT;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  const int n_rows = kRowOff + n_tiles;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* bb = static_cast<const __nv_bfloat16*>(bm);
  const auto* cc = static_cast<const __nv_bfloat16*>(cm);
  const auto* dyb = static_cast<const __nv_bfloat16*>(dy);
  auto* cdf = static_cast<float*>(cd);
  auto* gtf = static_cast<float*>(gt);
  auto* ownf = static_cast<float*>(own);
  auto* pb = static_cast<__nv_bfloat16*>(parts);
  auto* lastf = static_cast<float*>(last);
  auto* rowsf = static_cast<float*>(rows);
  auto* pairsf = static_cast<float*>(pairs);

  bwd_state_kernel<P, N><<<dim3(nc * H, B), kStateThreads, C::state_smem,
                           stream>>>(xb, static_cast<const float*>(dt),
                                     static_cast<const float*>(a), bb, cc,
                                     dyb, cdf, ownf, S, H, q, qp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_gt_kernel<N><<<dim3(n_pairs, nc, B), kThreads, C::gt_smem, stream>>>(
      bb, cc, gtf, S, q, qp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_state_pass_kernel<P * N / kPassThreads>
      <<<dim3(H, B), kPassThreads, 0, stream>>>(
          static_cast<const float*>(init), static_cast<const float*>(dstate),
          cdf, ownf, pb, lastf, static_cast<float*>(dinit), H, nc, q, qp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_dx_kernel<P, N><<<dim3(nc * H, n_tiles, B), kThreads, C::dx_smem,
                        stream>>>(xb, bb, dyb, cdf, gtf, pb,
                                  static_cast<__nv_bfloat16*>(dx),
                                  static_cast<float*>(ddt), rowsf, S, H, q,
                                  qp, n_rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_pairs_kernel<P, N><<<dim3(n_pairs, nc, B), kThreads, C::pairs_smem,
                           stream>>>(xb, bb, cc, dyb, cdf, pairsf, S, H, q,
                                     qp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_rows_kernel<P, N><<<dim3(nc * 2 * n_tiles, B), kThreads, C::rows_smem,
                          stream>>>(xb, cc, dyb, cdf, pb, pairsf,
                                    static_cast<__nv_bfloat16*>(dbm),
                                    static_cast<__nv_bfloat16*>(dcm), rowsf, S,
                                    H, q, qp, n_rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_da_kernel<<<dim3((nc * H + kPassThreads / 32 - 1) / (kPassThreads / 32),
                       B),
                  kPassThreads, 0, stream>>>(static_cast<const float*>(a),
                                             rowsf, lastf,
                                             static_cast<float*>(da), S, H, q,
                                             qp, n_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dy, dx: (B, S, H, P) bf16; dt, a, ddt, da: (B, S, H) f32; bm, cm, dbm,
// dcm: (B, S, N) bf16; init, dstate, dinit: (B, H, P, N) f32, each of them
// null when absent (init and dinit together).  All contiguous; S a multiple
// of the chunk q <= 256.  (P, N) one of (64, 128), (64, 64), (32, 16).
// Scratch, with qp = q rounded up to 64, nt = qp / 64 tiles and nc = S / q
// chunks, all f32 but parts: cd (B, nc, H, 2, qp); gt (B, nc, qp, qp); own
// (B, nc, H, 2, P, N); parts (B, nc, H, 2, 2, P, N) bf16; last (B, nc, H);
// rows (B, nc, H, 3 + nt, qp); pairs (B, nc, 2, nt (nt + 1) / 2, 64, N).
// Seven launches on `stream`.
REPRO_EXPORT int ssd_scan_backward(
    const void* x, const void* dt, const void* a, const void* bm,
    const void* cm, const void* init, const void* dy, const void* dstate,
    void* dx, void* ddt, void* da, void* dbm, void* dcm, void* dinit,
    void* cd, void* gt, void* own, void* parts, void* last, void* rows,
    void* pairs, int B, int S, int H, int P, int N, int q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || q <= 0 || q > kMaxChunk || S % q != 0 ||
      (init == nullptr) != (dinit == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P == 64 && N == 128)
    return launch<64, 128>(x, dt, a, bm, cm, init, dy, dstate, dx, ddt, da,
                           dbm, dcm, dinit, cd, gt, own, parts, last, rows,
                           pairs, B, S, H, q, st);
  if (P == 64 && N == 64)
    return launch<64, 64>(x, dt, a, bm, cm, init, dy, dstate, dx, ddt, da,
                          dbm, dcm, dinit, cd, gt, own, parts, last, rows,
                          pairs, B, S, H, q, st);
  if (P == 32 && N == 16)
    return launch<32, 16>(x, dt, a, bm, cm, init, dy, dstate, dx, ddt, da,
                          dbm, dcm, dinit, cd, gt, own, parts, last, rows,
                          pairs, B, S, H, q, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
