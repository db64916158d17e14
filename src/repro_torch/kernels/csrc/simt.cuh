// Building blocks of the SIMT kernels, shared by flash_fwd.cu and
// flash_bwd.cu: vector reads and writes of fp32 or bf16 values as fp32,
// 16-byte cp.async copies from global to shared memory, and the row padding
// that keeps lanes reading different rows on distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {
namespace simt {

// N consecutive values at p (16-, 8- or 4-byte aligned as N * sizeof(T)
// requires), as fp32.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x, out[1] = v.y;
  } else {
    static_assert(N == 1, "vector of 1, 2 or 4");
    out[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = a.x, out[1] = a.y, out[2] = b.x, out[3] = b.y;
  } else if constexpr (N == 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x, out[1] = a.y;
  } else {
    static_assert(N == 1, "vector of 1, 2 or 4");
    out[0] = __bfloat162float(*p);
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* x) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    static_assert(N == 1, "vector of 1, 2 or 4");
    *p = x[0];
  }
}

template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* x) {
  if constexpr (N == 4) {
    uint2 raw;
    *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(x[0], x[1]);
    *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(x[2], x[3]);
    *reinterpret_cast<uint2*>(p) = raw;
  } else if constexpr (N == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x[0], x[1]);
  } else {
    static_assert(N == 1, "vector of 1, 2 or 4");
    *p = __float2bfloat16_rn(x[0]);
  }
}

// 16 bytes from global to shared memory, in flight until cp_async_wait;
// with valid false nothing is read and the 16 bytes are zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T>
constexpr int kPad = 16 / static_cast<int>(sizeof(T));  // 16 bytes of padding, in elements

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace simt
}  // namespace repro_torch
