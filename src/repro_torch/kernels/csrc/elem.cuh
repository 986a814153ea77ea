// Element types of the kernels' inputs and outputs: fp32, fp16 and bf16,
// each converted to fp32 in registers on load and rounded once on store.
// Shared by the attention tiles (attn_tiles.cuh) and the matrix-product
// tiles (mm_tiles.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace elem {

// Storage-type tags of the C entry points (kernels/flash_decode.py DTYPES).
enum DType { kF32 = 0, kF16 = 1, kBF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <class T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Element i of a read-only row, as fp32.
template <class T>
__device__ __forceinline__ float ld(const T* p) { return to_f32(*p); }
template <> __device__ __forceinline__ float ld<float>(const float* p) {
  return __ldg(p);
}

// Four consecutive elements as fp32: one 16-byte load for fp32, one
// 8-byte load for the 16-bit types (p aligned to four elements).
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float half_bits(uint32_t h) {
  return __half2float(__ushort_as_half((unsigned short)h));
}
__device__ __forceinline__ float4 ld4(const __half* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(half_bits(u.x & 0xffffu), half_bits(u.x >> 16),
                     half_bits(u.y & 0xffffu), half_bits(u.y >> 16));
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  // a bf16 is the upper half of the fp32 with the same value
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// The 16 / sizeof(T) values of T in a 16-byte chunk, as fp32.
template <class T>
__device__ __forceinline__ void unpack16(const uint4& u, float* out);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& u, float* out) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack16<__half>(const uint4& u, float* out) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = half_bits(w[i] & 0xffffu);
    out[2 * i + 1] = half_bits(w[i] >> 16);
  }
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& u,
                                                         float* out) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Calls f(T{}) with T the storage type of `dtype`; an unknown tag is
// cudaErrorInvalidValue.
template <class F>
int with_dtype(int dtype, F f) {
  switch (dtype) {
    case kF32: return f(float{});
    case kF16: return f(__half{});
    case kBF16: return f(__nv_bfloat16{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace elem
