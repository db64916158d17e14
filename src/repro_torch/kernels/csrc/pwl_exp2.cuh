// Piecewise-linear exp2 of the paper's §3.3 as a device function.
//
// Used by the forward kernel's PWL mode (flash_fwd.cu, the port of
// `_exp2_inline`, src/repro/kernels/flash_attention/kernel.py:43) and by the
// standalone kernel (pwl_exp2.cu, the port of
// src/repro/kernels/pwl_exp2/kernel.py:23). For x <= 0:
//
//   x_i = ceil(x), x_f = x - x_i in (-1, 0]
//   k   = clip(floor((x_f + 1) * K), 0, K - 1)
//   out = ldexp(slope[k] * x_f + intercept[k], clip(x_i, -150, 127))
//
// The multiply and the add are rounded separately (no contraction into an
// FMA), and results below the smallest normal float are flushed to zero:
// that is what the jnp function repro.core.pwl_exp2.pwl_exp2 computes under
// XLA, whose CPU and TPU backends flush subnormals, and what the paper's
// hardware does (§6.2.1). With both, the result is bit-equal in float32 to
// repro.core.pwl_exp2.pwl_exp2 and to the port's plain version
// repro_torch.core.pwl_exp2.pwl_exp2.
//
// It is not bit-equal to the Pallas kernel `pwl_exp2_pallas`: in interpret
// mode that kernel rounds slope * x_f + intercept once, as a fused
// multiply-add, and so differs from this function by 1 ulp in float32 on
// about one input in eight, and is equal in bfloat16 (pinned by
// tests/test_torch_pwl_exp2_kernel.py and ROADMAP queue 3).
#pragma once

#include <cfloat>

namespace repro_torch {

// slope and intercept each hold num_segments floats (shared memory).
__device__ __forceinline__ float pwl_exp2(float x, const float* slope,
                                          const float* intercept,
                                          int num_segments) {
  const float x_i = ceilf(x);
  const float x_f = x - x_i;
  int idx = static_cast<int>(floorf((x_f + 1.0f) * static_cast<float>(num_segments)));
  idx = min(max(idx, 0), num_segments - 1);
  const float frac = __fadd_rn(__fmul_rn(slope[idx], x_f), intercept[idx]);
  const int e = static_cast<int>(fminf(fmaxf(x_i, -150.0f), 127.0f));
  const float out = ldexpf(frac, e);
  return (x_i < -148.0f || out < FLT_MIN) ? 0.0f : out;
}

}  // namespace repro_torch
