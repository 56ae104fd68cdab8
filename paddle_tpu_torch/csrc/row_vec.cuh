// Row-streaming helpers shared by csrc/fused_ce.cu, csrc/fused_norm.cu and
// csrc/decode_tick.cuh: 16-byte loads and stores of a row's elements (8
// bf16 or 4 fp32, widened to or narrowed from fp32 registers), the
// widening of one element of a raw 16-byte word, and the scalar
// conversions of the unaligned walk.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace row_vec {

// Elements of T in one 16-byte access.
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int n = 8; };

__device__ __forceinline__ void loadv(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    o[2 * e] = f.x;
    o[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void storev(float* p, const float* o) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ void storev(__nv_bfloat16* p, const float* o) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(o[2 * e], o[2 * e + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Element n of a raw 16-byte chunk of T (float, bf16 or int8) as fp32; n
// is a constant once the caller's loop unrolls, so no register is indexed.
template <typename T>
__device__ __forceinline__ float unpack(const uint4& u, int n) {
  const int per = 4 / (int)sizeof(T);           // elements a 32-bit word
  const uint32_t w = n / per == 0 ? u.x : n / per == 1 ? u.y
                   : n / per == 2 ? u.z : u.w;
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(w);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __uint_as_float(n % 2 ? w & 0xFFFF0000u : w << 16);  // low first
  } else {
    return (float)(int8_t)(w >> (8 * (n % 4)));
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// True when rows of `n` elements of T starting at each non-null pointer
// may be walked in 16-byte accesses.
template <typename T>
bool aligned(int n, const void* a, const void* b = nullptr,
             const void* c = nullptr) {
  return n % Vec<T>::n == 0 && (uintptr_t)a % 16 == 0 &&
         (uintptr_t)b % 16 == 0 && (uintptr_t)c % 16 == 0;
}

}  // namespace row_vec
