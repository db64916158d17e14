// Standalone piecewise-linear exp2 (the paper's §3.3) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_kernel`
// (src/repro/kernels/pwl_exp2/kernel.py:23, launched by `pwl_exp2_pallas`
// at kernel.py:60). Elementwise over any number of elements, x <= 0:
//
//   out = pwl_exp2(float(x)) rounded once to the output's type
//
// with the device function of pwl_exp2.cuh, the one the forward kernel's PWL
// mode uses, so the standalone kernel, the forward's inline PWL and the plain
// version (repro_torch.core.pwl_exp2.pwl_exp2) give the same bits. Inputs and
// outputs are float32, bfloat16 or float16 of one type; the result is
// computed in fp32 and rounded to nearest even (__float2bfloat16_rn,
// __float2half_rn), as `.to(dtype)` rounds it in the plain version. An fp16
// result in the fp16 subnormal range is kept; only an fp32 result below
// 2**-126 is flushed (pwl_exp2.cuh).
//
// Design. The TPU kernel cuts the input into (256, 128) tiles and pads the
// tail; here a grid-stride loop with 64-bit indices walks the flat array and
// a bound check takes the place of the padding. Where both pointers are 16-
// byte aligned, each thread moves 16 bytes at a time (4 fp32 or 8 bf16/fp16
// values) and a scalar loop finishes the last few elements; otherwise the
// whole array takes the scalar loop. The slope and intercept tables (at most
// 64 floats each) come in by value and are staged in shared memory once per
// CTA.
//
// What bounds it on the H100: bytes. Each element is read once and written
// once (8 bytes in fp32, 4 in bf16/fp16) for ~20 fp32 instructions, far
// below the ~295 operations per byte where compute would be the limit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "pwl_exp2.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSegments = 64;
constexpr int kBlocksPerSm = 8;

struct Table {
  float v[2 * kMaxSegments];  // slope[0:K], then intercept[0:K]
};

// Element types by their bits, so a 16-byte vector is a plain array.
struct F32 {
  using Bits = float;
  static __device__ __forceinline__ float to_f32(float b) { return b; }
  static __device__ __forceinline__ float from_f32(float f) { return f; }
};
struct BF16 {
  using Bits = unsigned short;
  static __device__ __forceinline__ float to_f32(unsigned short b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
  static __device__ __forceinline__ unsigned short from_f32(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};
struct F16 {
  using Bits = unsigned short;
  static __device__ __forceinline__ float to_f32(unsigned short b) {
    return __half2float(__ushort_as_half(b));
  }
  static __device__ __forceinline__ unsigned short from_f32(float f) {
    return __half_as_ushort(__float2half_rn(f));
  }
};

template <typename Ty>
__device__ __forceinline__ typename Ty::Bits pwl_elem(typename Ty::Bits b,
                                                      const float* tab,
                                                      int num_segments) {
  return Ty::from_f32(repro_torch::pwl_exp2(Ty::to_f32(b), tab,
                                            tab + num_segments, num_segments));
}

template <typename Ty>
__global__ void __launch_bounds__(kThreads)
    pwl_exp2_kernel(const typename Ty::Bits* __restrict__ x,
                    typename Ty::Bits* __restrict__ out, long long n,
                    Table table, int num_segments, int vectorized) {
  using Bits = typename Ty::Bits;
  constexpr int kVec = 16 / sizeof(Bits);

  __shared__ float tab[2 * kMaxSegments];
  for (int i = threadIdx.x; i < 2 * num_segments; i += kThreads)
    tab[i] = table.v[i];
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long done = 0;
  if (vectorized) {
    const long long n_vec = n / kVec;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (long long i = first; i < n_vec; i += stride) {
      uint4 raw = xv[i];
      Bits e[kVec];
      memcpy(e, &raw, sizeof(raw));
#pragma unroll
      for (int j = 0; j < kVec; ++j) e[j] = pwl_elem<Ty>(e[j], tab, num_segments);
      memcpy(&raw, e, sizeof(raw));
      ov[i] = raw;
    }
    done = n_vec * kVec;
  }
  for (long long i = done + first; i < n; i += stride)
    out[i] = pwl_elem<Ty>(x[i], tab, num_segments);
}

template <typename Ty>
cudaError_t launch(const void* x, void* out, long long n, const Table& table,
                   int num_segments, cudaStream_t stream) {
  using Bits = typename Ty::Bits;
  constexpr int kVec = 16 / sizeof(Bits);
  const int vectorized = (reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                          reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const long long work = vectorized ? (n + kVec - 1) / kVec : n;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  pwl_exp2_kernel<Ty><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const Bits*>(x), static_cast<Bits*>(out), n, table,
      num_segments, vectorized);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. x and out hold n dense elements of one
// type (dtype 0 float32, 1 bfloat16, 2 float16); table is a host array of
// 2 * num_segments floats, slope then intercept, copied into the launch.
// Returns a cudaError_t.
extern "C" int pwl_exp2(const void* x, void* out, long long n,
                        const float* table, int dtype, int num_segments,
                        void* stream) {
  if (n < 1 || x == nullptr || out == nullptr || table == nullptr ||
      num_segments < 1 || num_segments > kMaxSegments)
    return cudaErrorInvalidValue;
  Table t = {};
  for (int i = 0; i < 2 * num_segments; ++i) t.v[i] = table[i];
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<F32>(x, out, n, t, num_segments, st);
    case 1: return launch<BF16>(x, out, n, t, num_segments, st);
    case 2: return launch<F16>(x, out, n, t, num_segments, st);
    default: return cudaErrorInvalidValue;
  }
}
