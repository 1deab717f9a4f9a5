// Pairs of columns for the port's streaming kernels: a unit of V = 1 or 2
// adjacent values of an fp32 or bf16 row, loaded in one instruction (8 or 4
// bytes for a pair), widened to fp32 and narrowed back.  A row of N values
// starts on a pair boundary when N is even, so the callers take V = 2 only
// for even N and pair-aligned pointers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

template <typename T, int V>
struct Vec;
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<__nv_bfloat16, 1> { using type = __nv_bfloat16; };
template <> struct Vec<__nv_bfloat16, 2> { using type = __nv_bfloat162; };

struct F2 {
  float v[2];
};

__device__ __forceinline__ F2 widen(float x) { return {{x, 0.f}}; }
__device__ __forceinline__ F2 widen(float2 x) { return {{x.x, x.y}}; }
__device__ __forceinline__ F2 widen(__nv_bfloat16 x) {
  return {{__bfloat162float(x), 0.f}};
}
__device__ __forceinline__ F2 widen(__nv_bfloat162 x) {
  const float2 f = __bfloat1622float2(x);
  return {{f.x, f.y}};
}

__device__ __forceinline__ void narrow(float* o, const float (&v)[2]) {
  *o = v[0];
}
__device__ __forceinline__ void narrow(float2* o, const float (&v)[2]) {
  *o = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void narrow(__nv_bfloat16* o,
                                       const float (&v)[2]) {
  *o = __float2bfloat16_rn(v[0]);
}
__device__ __forceinline__ void narrow(__nv_bfloat162* o,
                                       const float (&v)[2]) {
  *o = __floats2bfloat162_rn(v[0], v[1]);
}

}  // namespace repro
