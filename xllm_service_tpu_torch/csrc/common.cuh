// Shared helpers for the port's attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Masked-score sentinel, as in the JAX package (ops/attention.py NEG_INF).
#define XLLM_NEG_INF (-1e30f)

namespace xllm {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Load N consecutive elements starting at `p` (aligned to N * sizeof(T)
// bytes, at most 16) into floats with one vector load.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[N]) {
  constexpr int BYTES = N * sizeof(T);
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16 || BYTES == 32,
                "vector width");
  if constexpr (BYTES >= 16) {
    uint4 u[BYTES / 16];
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) u[i] = reinterpret_cast<const uint4*>(p)[i];
    const T* e = reinterpret_cast<const T*>(u);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  } else if constexpr (BYTES == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  } else {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace xllm
