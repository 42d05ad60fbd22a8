// Shared helpers for the port's attention kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// The TPU kernels mask with -1e30, not -inf; keep that so fully masked
// tiles behave the same (exp(-1e30 - m) == 0 once m is finite).
constexpr float NEG_INF = -1e30f;

// Per-dtype traits. PAD makes the shared-memory row stride an odd number of
// 32-bit words, so 16 (or 32) threads reading the same column of 16 (or 32)
// different rows hit 16 (or 32) different banks.
template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int PAD = 1;
  __device__ static float to_float(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
  __device__ static float2 load2(const float* p) {
    return make_float2(p[0], p[1]);
  }
};

template <> struct Elem<__nv_bfloat16> {
  static constexpr int PAD = 2;
  __device__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
  // p is 4-byte aligned: even element offset in a row of even stride
  __device__ static float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

// Copy a (rows x HD) tile whose row r starts at g + r*stride into shared
// memory with row stride LD; rows >= valid are zero-filled. 16-byte global
// loads (the wrapper checks 16-byte alignment of the base and strides), four
// 4-byte shared stores each (LD keeps every row 4-byte aligned).
template <typename T, int HD, int LD>
__device__ __forceinline__ void load_tile(T* __restrict__ s,
                                          const T* __restrict__ g,
                                          long long stride, int rows,
                                          int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = HD / VEC;
  for (int i = threadIdx.x; i < rows * VPR; i += blockDim.x) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(g + r * stride + c);
    uint32_t* dst = reinterpret_cast<uint32_t*>(s + r * LD + c);
    dst[0] = val.x;
    dst[1] = val.y;
    dst[2] = val.z;
    dst[3] = val.w;
  }
}

// Reductions over the 16 lanes of a half-warp (xor offsets < 16 stay inside).
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float max32(float x) {
  return max16(fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16)));
}

__device__ __forceinline__ float sum32(float x) {
  return sum16(x + __shfl_xor_sync(0xffffffffu, x, 16));
}

}  // namespace rt
