// A variant of the package's SSD scan kernel (src/repro_torch/csrc/
// ssd_scan.cu, whose note describes the four passes), kept so that
// tools/ssd_variants.py can time it beside the package's kernel in one
// call.  The one difference is in pass 4 (ssd_chunk_scan_kernel): W x
// runs on the warpgroup's wgmma (m64n64k16, W's three bf16 parts from
// registers as the A operand, the x tile N-major in the 128-byte swizzle,
// zero-filled past P), issued per k16 step so that one step's products
// run while the next step's W is formed; the diagonal tile runs every
// step in every warp (wgmma is collective), masked.  It computes what the
// package's kernel computes and was no faster (PERF.md): forming W
// (exp, the split) and latency bound pass 4, not the tensor cores' rate.
// The entry point and its scratch are the package's.
#include "common.cuh"
#include "hopper.cuh"

namespace {

// bf16 parts of each f32 factor (split_bf16x2_parts): W, B_j f_j, and the
// carried state
constexpr int kPW = 3, kPB = 2, kPS = 2;
constexpr int kThreads = 128;       // four warps (passes 1 and 4)
constexpr int kStateThreads = 256;  // eight warps (pass 2)
constexpr int kT = 64;              // tile rows (i and j)
constexpr int kMaxChunk = 256;
constexpr int kPassThreads = 256;

// Padded shared-memory rows: bf16 rows of x (P) and of B, C and the
// state (N).  A C.B^T tile keeps rows of kT f32 and swizzles them instead
// (cb_col): the float2 reads of a fragment's 4 x 4 lanes hit distinct
// banks.
template <int P, int N>
struct Cfg {
  static constexpr int kXld = P + 8;
  static constexpr int kBld = N + 8;
  // ssd_chunk_state_kernel: warps along N (at most 8: the fewer n tiles a
  // warp has, the fewer B_j f_j fragments it scales and splits for its
  // products) and along P; warps past kWN kWM (the smallest shape) only
  // stage tiles
  static constexpr int kWN = N / 8 < 8 ? N / 8 : 8;
  static constexpr int kWM = 8 / kWN < P / 16 ? 8 / kWN : P / 16;
  static constexpr int kMT = P / 16 / kWM;   // m16 tiles (p) a warp
  static constexpr int kNT = N / 8 / kWN;    // n8 tiles (n) a warp
  static_assert(P % 32 == 0 && P <= 64 && N % 16 == 0 && N <= 128, "shape");
  static_assert(kMT * 16 * kWM == P && kNT * 8 * kWN == N, "warp tiling");

  static constexpr size_t cb_smem = 2 * kT * kBld * 2;
  // pass 2: cum and f, then the two-stage ring of (x tile, B tile)
  static constexpr size_t state_smem =
      2 * kMaxChunk * 4 + 2 * kT * (kXld + kBld) * 2;
  // pass 4, from a 1024-byte aligned base (hence 1024 bytes of slack):
  // cum and dt, then one region that holds C and the state (its parts)
  // for the read-out and afterwards the two-stage ring of (x tile in the
  // 128-byte swizzle, 64 columns; C.B^T tile)
  static constexpr size_t kReadout = (kT * kBld + kPS * P * kBld) * 2;
  static constexpr size_t kStage = kT * 64 * 2 + kT * kT * 4;
  static constexpr size_t scan_smem =
      1024 + 2 * kMaxChunk * 4 +
      (kReadout > 2 * kStage ? kReadout : 2 * kStage);
};

// Column of element (r, c) of a swizzled C.B^T tile: 8-float groups XOR
// the row's low two bits, so rows r .. r + 3 of one group lie on four
// distinct 8-bank groups (16-byte chunks and float2 pairs stay whole).
__device__ __forceinline__ int cb_col(int r, int c) {
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

// A fragment (m16k16) of a row-major bf16 tile at `base` (rows m, columns
// k, row stride ld), rows r0 .. r0 + 15, columns k0 .. k0 + 15.
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

// ---------------------------------------------------- 1. C.B^T per chunk

template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(const __nv_bfloat16* __restrict__ bm,
              const __nv_bfloat16* __restrict__ cm, float* __restrict__ cb,
              int S, int q, int qp) {
  constexpr int kBld = N + 8;
  int jt = blockIdx.x, it = 0;        // the pair (it, jt <= it)
  while (jt > it) jt -= ++it;
  const int c = blockIdx.y, b = blockIdx.z, nc = S / q;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = it * kT, j0 = jt * kT;

  extern __shared__ __align__(16) unsigned char cb_smem[];
  __nv_bfloat16* c_s = reinterpret_cast<__nv_bfloat16*>(cb_smem);
  __nv_bfloat16* b_s = c_s + kT * kBld;
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * q;
  stage_rows<N, kBld>(c_s, cm + (row0 + i0) * N, N, kT, q - i0, tid);
  stage_rows<N, kBld>(b_s, bm + (row0 + j0) * N, N, kT, q - j0, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float acc[kT / 8][4] = {};
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    uint32_t af[4];
    load_a(af, c_s, kBld, warp * 16, ks * 16, lane);
#pragma unroll
    for (int np = 0; np < kT / 16; ++np) {
      uint32_t r[4];
      load_b_nk(r, b_s, kBld, np * 16, ks * 16, lane);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_m16n8k16_bf16(acc[2 * np], af, b0);
      mma_m16n8k16_bf16(acc[2 * np + 1], af, b1);
    }
  }
  float* out = cb + ((static_cast<size_t>(b) * nc + c) * qp + i0) * qp + j0;
#pragma unroll
  for (int nt = 0; nt < kT / 8; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(out + (warp * 16 + g + 8 * hh) * qp +
                                 nt * 8 + 2 * t) =
          make_float2(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
}

// ------------------------------------------- 2. each chunk's own state

template <int P, int N>
__global__ void __launch_bounds__(kStateThreads)
ssd_chunk_state_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ a,
                       const __nv_bfloat16* __restrict__ bm,
                       float* __restrict__ cd, float* __restrict__ ds, int S,
                       int H, int q, int qp) {
  using C = Cfg<P, N>;
  const int h = blockIdx.x % H, c = blockIdx.x / H, b = blockIdx.y;
  const int nc = S / q, n_tiles = qp / kT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ __align__(16) unsigned char state_smem[];
  float* cum_s = reinterpret_cast<float*>(state_smem);   // [kMaxChunk]
  float* f_s = cum_s + kMaxChunk;             // dt, then f [kMaxChunk]
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(f_s + kMaxChunk);
  __nv_bfloat16* b_s = x_s + 2 * kT * C::kXld;           // [2][kT][kBld]

  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * q;
  auto load = [&](int jt, int stage) {
    const int j0 = jt * kT;
    stage_rows<P, C::kXld, kStateThreads>(
        x_s + stage * kT * C::kXld, x + ((row0 + j0) * H + h) * P,
        static_cast<size_t>(H) * P, kT, q - j0, tid);
    stage_rows<N, C::kBld, kStateThreads>(b_s + stage * kT * C::kBld,
                                          bm + (row0 + j0) * N, N, kT,
                                          q - j0, tid);
  };
  load(0, 0);   // in flight while the scan below runs
  cp_async_commit();

  // log a and dt of the chunk's rows (0 past q), all loads at once; then
  // cum, one warp's scan (constant past q)
  for (int j = tid; j < qp; j += kStateThreads) {
    const bool in = j < q;
    cum_s[j] = in ? logf(fmaxf(a[(row0 + j) * H + h], 1e-20f)) : 0.0f;
    f_s[j] = in ? dt[(row0 + j) * H + h] : 0.0f;
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
  // f_j = dt_j exp(cum_last - cum_j) (0 past q); cum and dt to the scratch
  const float last = cum_s[q - 1];
  float* cd_row = cd + ((static_cast<size_t>(b) * nc + c) * H + h) * 2 * qp;
  for (int j = tid; j < qp; j += kStateThreads) {
    const float d = f_s[j];
    f_s[j] = d * expf(last - cum_s[j]);
    cd_row[j] = cum_s[j];
    cd_row[qp + j] = d;
  }

  // state (P x N) = x^T (B f): M = p, N = n, K = j
  const int wm = warp / C::kWN, wn = warp % C::kWN;
  const int p0 = wm * C::kMT * 16, n0 = wn * C::kNT * 8;
  const bool active = warp < C::kWN * C::kWM;
  float acc[C::kMT][C::kNT][4] = {};
  for (int jt = 0; jt < n_tiles; ++jt) {
    __syncthreads();   // tile jt - 1's stage is free (and f_s written)
    if (jt + 1 < n_tiles) load(jt + 1, (jt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (!active) continue;
    const __nv_bfloat16* xt = x_s + (jt & 1) * kT * C::kXld;
    const __nv_bfloat16* bt = b_s + (jt & 1) * kT * C::kBld;
#pragma unroll
    for (int ks = 0; ks < kT / 16; ++ks) {
      uint32_t af[C::kMT][4];
#pragma unroll
      for (int mt = 0; mt < C::kMT; ++mt) {
        // x^T through ldmatrix.trans of the [j][p] tile
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
          // B_j f_j in bf16 parts (rows 2t, 2t + 1 and + 8, + 9)
          const float2 v0 = bf16x2_to_float2(r[2 * u]);
          const float2 v1 = bf16x2_to_float2(r[2 * u + 1]);
          uint32_t p0[kPB], p1[kPB];
          split_bf16x2_parts<kPB>(v0.x * f01.x, v0.y * f01.y, p0);
          split_bf16x2_parts<kPB>(v1.x * f89.x, v1.y * f89.y, p1);
#pragma unroll
          for (int k = 0; k < kPB; ++k) {
            const uint32_t bk[2] = {p0[k], p1[k]};
#pragma unroll
            for (int mt = 0; mt < C::kMT; ++mt)
              mma_m16n8k16_bf16(acc[mt][2 * np + u], af[mt], bk);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;
  float* out = ds + ((static_cast<size_t>(b) * nc + c) * H + h) * P * N;
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

// ------------------------------------- 3. the state from chunk to chunk

__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(const float* __restrict__ init,
                      const float* __restrict__ cd,
                      const float* __restrict__ ds,
                      __nv_bfloat16* __restrict__ sin,
                      float* __restrict__ fin, int H, int PN, int nc, int q,
                      int qp) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const size_t bh = static_cast<size_t>(b) * H + h;
  float s = init ? init[bh * PN + e] : 0.0f;
  for (int c = 0; c < nc; ++c) {
    const size_t bch = (static_cast<size_t>(b) * nc + c) * H + h;
    if (init || c > 0) {   // pass 4 reads no zero state
      float r = s;
#pragma unroll
      for (int k = 0; k < kPS; ++k) {
        const __nv_bfloat16 part = __float2bfloat16(r);
        sin[(bch * kPS + k) * PN + e] = part;
        r -= __bfloat162float(part);
      }
    }
    s = s * expf(cd[bch * 2 * qp + q - 1]) + ds[bch * PN + e];
  }
  fin[bh * PN + e] = s;
}

// ---------------------------------------------------- 4. y of one i tile

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ cm,
                      const float* __restrict__ cd,
                      const float* __restrict__ cb,
                      const __nv_bfloat16* __restrict__ sin,
                      __nv_bfloat16* __restrict__ y, int S, int H, int q,
                      int qp, int has_init) {
  using C = Cfg<P, N>;
  const int h = blockIdx.x % H, c = blockIdx.x / H, b = blockIdx.z;
  const int nc = S / q, n_tiles = qp / kT;
  const int it = n_tiles - 1 - blockIdx.y;   // the longest tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = it * kT;
  const bool has_state = has_init || c > 0;

  // cum and dt [2][kMaxChunk] f32; then the read-out's C [kT][kBld] and
  // state parts [kPS][P][kBld] bf16, whose room the ring of (x tile
  // [kT][64] bf16 in the 128-byte swizzle, C.B^T tile [kT][kT] f32) takes
  // over after the read-out
  extern __shared__ unsigned char scan_smem[];
  unsigned char* base =
      scan_smem + ((1024 - (smem_u32(scan_smem) & 1023)) & 1023);
  float* cd_s = reinterpret_cast<float*>(base);
  unsigned char* region = base + 2 * kMaxChunk * 4;
  __nv_bfloat16* c_s = reinterpret_cast<__nv_bfloat16*>(region);
  __nv_bfloat16* st_s = c_s + kT * C::kBld;   // [kPS][P][kBld]
  auto x_stage = [&](int stage) { return region + stage * C::kStage; };
  auto cb_stage = [&](int stage) {
    return reinterpret_cast<float*>(region + stage * C::kStage + kT * 128);
  };

  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * q;
  const size_t bch = (static_cast<size_t>(b) * nc + c) * H + h;
  // C of the i tile, the carried state's parts, cum and dt
  stage_rows<N, C::kBld>(c_s, cm + (row0 + i0) * N, N, kT, q - i0, tid);
  if (has_state) {
    for (int k = 0; k < kPS; ++k)
      stage_rows<N, C::kBld>(st_s + k * P * C::kBld,
                             sin + (bch * kPS + k) * P * N, N, P, P, tid);
  }
  for (int i = tid; i < qp / 2; i += kThreads)
    cp_async16(cd_s + (i * 4 < qp ? i * 4 : kMaxChunk + i * 4 - qp),
               cd + bch * 2 * qp + i * 4, 16);
  cp_async_commit();
  const float* cb_tile =
      cb + ((static_cast<size_t>(b) * nc + c) * qp + i0) * qp;
  auto load = [&](int jt, int stage) {
    float* dst = cb_stage(stage);
    for (int i = tid; i < kT * kT / 4; i += kThreads) {
      const int r = i / (kT / 4), col = (i % (kT / 4)) * 4;
      cp_async16(dst + r * kT + cb_col(r, col),
                 cb_tile + r * qp + jt * kT + col, 16);
    }
    // x rows j0 .. j0 + 63, 64 columns (past P and past q zero)
    const int j0 = jt * kT;
    const __nv_bfloat16* src = x + ((row0 + j0) * H + h) * P;
    unsigned char* xs = x_stage(stage);
    for (int i = tid; i < kT * 8; i += kThreads) {
      const int r = i / 8, c8 = i % 8;
      const bool ok = r < q - j0 && c8 < P / 8;
      cp_async16(xs + sw128_offset(r, c8 * 8, kT),
                 src + (ok ? static_cast<size_t>(r) * H * P + c8 * 8 : 0),
                 ok ? 16 : 0);
    }
  };
  cp_async_wait<0>();
  __syncthreads();

  const float* cum_s = cd_s;
  const float* dt_s = cd_s + kMaxChunk;
  const int rl = warp * 16 + g;   // this lane's tile rows rl and rl + 8
  const float cum_r[2] = {cum_s[i0 + rl], cum_s[i0 + rl + 8]};
  // the warpgroup's m64n64 accumulator, this lane's part: n8 tile nt in
  // acc[nt] (rows rl and rl + 8), as an mma.sync m16n8 fragment holds it;
  // columns past P stay 0
  float acc[8][4] = {};
  if (has_state) {
    // exp(cum_i) C_i . state: M = i, N = p, K = n, part by part (mma.sync)
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t af[4];
      load_a(af, c_s, C::kBld, warp * 16, ks * 16, lane);
#pragma unroll
      for (int part = 0; part < kPS; ++part) {
        const __nv_bfloat16* st = st_s + part * P * C::kBld;
#pragma unroll
        for (int np = 0; np < P / 16; ++np) {
          uint32_t r[4];
          load_b_nk(r, st, C::kBld, np * 16, ks * 16, lane);
          const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          mma_m16n8k16_bf16(acc[2 * np], af, b0);
          mma_m16n8k16_bf16(acc[2 * np + 1], af, b1);
        }
      }
    }
    const float d0 = expf(cum_r[0]), d1 = expf(cum_r[1]);
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt) {
      acc[nt][0] *= d0, acc[nt][1] *= d0;
      acc[nt][2] *= d1, acc[nt][3] *= d1;
    }
  }
  __syncthreads();   // the read-out's room goes to the ring
  load(0, 0);
  cp_async_commit();

  float(&d)[32] = *reinterpret_cast<float(*)[32]>(&acc[0][0]);
  for (int jt = 0; jt <= it; ++jt) {
    __syncthreads();   // tile jt - 1's stage is free
    if (jt < it) load(jt + 1, (jt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async_shared();   // this thread's x rows, for wgmma
    __syncthreads();
    const float* cbt = cb_stage(jt & 1);
    const uint32_t x_addr = smem_u32(x_stage(jt & 1));
    const int j0 = jt * kT;
    const bool diag = jt == it;
    // per k16 step: W = C.B^T exp(cum_i - cum_j) dt_j (on the diagonal
    // tile for j <= i, else 0) in bf16 parts, a[hh + 2 half] row rl + 8 hh,
    // columns 2t (+ 8 half); the warpgroup's wgmma takes them from
    // registers against the x tile, the step's products running while the
    // next step's W is formed.  Each step keeps its own registers until
    // the wait.
    uint32_t wp[kT / 16][kPW][4];
    fence_regs(d);
#pragma unroll
    for (int ks = 0; ks < kT / 16; ++ks) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int jl = ks * 16 + 2 * t + 8 * half;
        const int j = j0 + jl;
        const float cj0 = cum_s[j], cj1 = cum_s[j + 1];
        const float dj0 = dt_s[j], dj1 = dt_s[j + 1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = i0 + rl + 8 * hh;
          const int r = rl + 8 * hh;
          const float2 v =
              *reinterpret_cast<const float2*>(cbt + r * kT + cb_col(r, jl));
          const float w0 = !diag || j <= i
                               ? v.x * expf(cum_r[hh] - cj0) * dj0 : 0.0f;
          const float w1 = !diag || j + 1 <= i
                               ? v.y * expf(cum_r[hh] - cj1) * dj1 : 0.0f;
          uint32_t pk[kPW];
          split_bf16x2_parts<kPW>(w0, w1, pk);
#pragma unroll
          for (int k = 0; k < kPW; ++k) wp[ks][k][hh + 2 * half] = pk[k];
        }
      }
      wgmma_fence();
      const uint64_t desc =
          sw128_desc(x_addr + ks * 16 * 128, kT * 128, 1024);
#pragma unroll
      for (int k = 0; k < kPW; ++k) wgmma_m64n64k16_rs_tb(d, wp[ks][k], desc);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
#pragma unroll
    for (int ks = 0; ks < kT / 16; ++ks)
#pragma unroll
      for (int k = 0; k < kPW; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(wp[ks][k][e]));
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = i0 + rl + 8 * hh;
    if (i >= q) continue;
    __nv_bfloat16* yrow = y + ((row0 + i) * H + h) * P;
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(yrow + nt * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
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
           const void* cm, const void* init_state, void* y, void* final_state,
           void* cd, void* cb, void* ds, void* sin, int B, int S, int H,
           int q, cudaStream_t stream) {
  using C = Cfg<P, N>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = allow_smem(ssd_cb_kernel<N>, C::cb_smem);
    if (e == cudaSuccess)
      e = allow_smem(ssd_chunk_state_kernel<P, N>, C::state_smem);
    if (e == cudaSuccess)
      e = allow_smem(ssd_chunk_scan_kernel<P, N>, C::scan_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int nc = S / q, n_tiles = (q + kT - 1) / kT, qp = n_tiles * kT;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* bb = static_cast<const __nv_bfloat16*>(bm);
  const auto* cc = static_cast<const __nv_bfloat16*>(cm);
  auto* cdf = static_cast<float*>(cd);
  auto* cbf = static_cast<float*>(cb);
  auto* dsf = static_cast<float*>(ds);
  auto* sinb = static_cast<__nv_bfloat16*>(sin);

  ssd_cb_kernel<N><<<dim3(n_tiles * (n_tiles + 1) / 2, nc, B), kThreads,
                     C::cb_smem, stream>>>(bb, cc, cbf, S, q, qp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_chunk_state_kernel<P, N><<<dim3(nc * H, B), kStateThreads,
                                 C::state_smem, stream>>>(
      xb, static_cast<const float*>(dt), static_cast<const float*>(a), bb,
      cdf, dsf, S, H, q, qp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_state_pass_kernel<<<dim3((P * N + kPassThreads - 1) / kPassThreads, H,
                               B),
                          kPassThreads, 0, stream>>>(
      static_cast<const float*>(init_state), cdf, dsf, sinb,
      static_cast<float*>(final_state), H, P * N, nc, q, qp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_chunk_scan_kernel<P, N><<<dim3(nc * H, n_tiles, B), kThreads,
                                C::scan_smem, stream>>>(
      xb, cc, cdf, cbf, sinb, static_cast<__nv_bfloat16*>(y), S, H, q, qp,
      init_state != nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, S, H, P) bf16; dt, a: (B, S, H) f32; bm, cm: (B, S, N) bf16;
// init_state: (B, H, P, N) f32 or null (zeros); y: (B, S, H, P) bf16;
// final_state: (B, H, P, N) f32.  All contiguous; S a multiple of the
// chunk q <= 256.  (P, N) one of (64, 128), (64, 64), (32, 16).  Scratch,
// with qp = q rounded up to 64 and nc = S / q chunks: cd (B, nc, H, 2, qp)
// f32, cb (B, nc, qp, qp) f32, ds (B, nc, H, P, N) f32, sin (B, nc, H,
// kPS, P, N) bf16.  Four launches on `stream`.
REPRO_EXPORT int ssd_scan(const void* x, const void* dt, const void* a,
                          const void* bm, const void* cm,
                          const void* init_state, void* y, void* final_state,
                          void* cd, void* cb, void* ds, void* sin, int B,
                          int S, int H, int P, int N, int q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || q <= 0 || q > kMaxChunk || S % q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P == 64 && N == 128)
    return launch<64, 128>(x, dt, a, bm, cm, init_state, y, final_state, cd,
                           cb, ds, sin, B, S, H, q, st);
  if (P == 64 && N == 64)
    return launch<64, 64>(x, dt, a, bm, cm, init_state, y, final_state, cd,
                          cb, ds, sin, B, S, H, q, st);
  if (P == 32 && N == 16)
    return launch<32, 16>(x, dt, a, bm, cm, init_state, y, final_state, cd,
                          cb, ds, sin, B, S, H, q, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
