// Shared helpers for the port's hand-written Hopper kernels.  Each kernel
// source is compiled on its own into a shared library with a plain C
// interface (see repro_torch/kernels/build.py) and includes this header once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// Masked-score sentinel of the JAX reference (models/attention.py _NEG):
// finite, so exp(_NEG - _NEG) = 1 and exp(_NEG - m) = 0 for a real m.
constexpr float kNeg = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

REPRO_EXPORT const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Max / sum over the 16 lanes of one half warp (xor offsets < 16 never
// cross the half).
__device__ __forceinline__ float half_warp_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// Sum of v over the lanes below this one (Hillis-Steele inclusive scan,
// shifted down one lane).
__device__ __forceinline__ float warp_exclusive_scan(float v, int lane) {
  float inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    float up = __shfl_up_sync(kFullMask, inc, o);
    if (lane >= o) inc += up;
  }
  float exc = __shfl_up_sync(kFullMask, inc, 1);
  return lane == 0 ? 0.0f : exc;
}

// Two packed bf16 values of one 32-bit shared-memory word, as floats.
__device__ __forceinline__ float2 bf16x2_to_float2(unsigned w) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&w);
  return __bfloat1622float2(h);
}
