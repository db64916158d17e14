// SystolicAttention forward (the paper's Algorithm 1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (src/repro/kernels/flash_attention/kernel.py:64, launched by
// `flash_attention_fwd` at kernel.py:217). It computes what that kernel
// computes:
//
//   S   = Q K^T, unscaled, in fp32 (inputs fp32 or bf16, upcast on load);
//   mask padded keys and (causal) keys past row + q_offset with -1e30;
//   m'  = max(m, rowmax S);  b = exp2(c (m - m'));  P = exp2(c (S - m'))
//   l   = l b + rowsum P;    acc = acc b + P V        (c = scale * log2 e)
//   O   = acc / l, with l == 0 read as 1; optional LSE = c m + log2 l.
//
// exp2 is exact (exp2f) or the 8-segment PWL of §3.3 (pwl_exp2.cuh).
//
// Design. The TPU grid (B*H, q-block, k-block) runs in order and carries m,
// l and acc in VMEM across its innermost k steps. Here one CTA owns one
// (batch*head, 64-row q tile) and loops over the 64-column k tiles itself,
// carrying m and l in shared memory and acc in registers. K tiles wholly
// above the causal diagonal are skipped (the Pallas kernel runs them
// masked): row r always sees column 0, so m is finite after the first tile
// and a skipped tile would only have added exp2(-huge) = 0. GQA maps q-head
// h to kv-head h / (H / Hkv) without repeating K/V.
//
// What bounds it on the H100: at long prefill the 4 * d * S^2 / 2 causal
// operations (compute); at short prefill reading Q, K, V and writing O
// (bytes). This kernel is plain SIMT: every product is an fp32 FMA on the
// CUDA cores (67 TFLOP/s peak), with no tensor cores, no TMA and no overlap
// of loads with compute. It keeps the reference's numerics (fp32 products,
// P kept in fp32 for PV), and takes fp32 inputs, where tensor cores would
// mean TF32, and bf16 at d 16 and 32. bf16 at d 64 and 128 goes to the
// tensor-core kernel of flash_fwd_sm90.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "pwl_exp2.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 S entries each
constexpr int kSP = kBlockK + 1;   // padded S row
constexpr int kMaxSegments = 128;  // width of the packed PWL table
constexpr float kNegInf = -1e30f;  // finite: -inf - (-inf) would be NaN

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float exp2_mode(float x, bool pwl, const float* tab,
                                           int num_segments) {
  return pwl ? repro_torch::pwl_exp2(x, tab, tab + num_segments, num_segments)
             : exp2f(x);
}

template <int D>
constexpr int smem_floats() {
  // Q and K with padded rows, V, S, then m, l, b per row, then the table.
  return 2 * kBlockQ * (D + 1) + kBlockK * D + kBlockQ * kSP + 3 * kBlockQ +
         2 * kMaxSegments;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const float* __restrict__ table,
                 int heads, int kv_heads, int seq_q, int seq_k, int q_offset,
                 long long q_bstride, long long k_bstride, long long v_bstride,
                 int causal, float c, int pwl, int num_segments) {
  constexpr int DP = D + 1;  // padded: a column read hits 32 banks
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                   // [kBlockQ][DP]
  float* sK = sQ + kBlockQ * DP;      // [kBlockK][DP]
  float* sV = sK + kBlockK * DP;      // [kBlockK][D]
  float* sS = sV + kBlockK * D;       // [kBlockQ][kSP]: S, then P
  float* sM = sS + kBlockQ * kSP;     // [kBlockQ] running max (unscaled)
  float* sL = sM + kBlockQ;           // [kBlockQ] running sum
  float* sB = sL + kBlockQ;           // [kBlockQ] this tile's rescale factor
  float* sTab = sB + kBlockQ;         // [2][num_segments]: slope, intercept

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int hk = h / (heads / kv_heads);
  const int q0 = blockIdx.x * kBlockQ;
  const long long q_rs = static_cast<long long>(heads) * D;  // row strides
  const long long kv_rs = static_cast<long long>(kv_heads) * D;
  const T* qp = q + b * q_bstride + static_cast<long long>(h) * D;
  const T* kp = k + b * k_bstride + static_cast<long long>(hk) * D;
  const T* vp = v + b * v_bstride + static_cast<long long>(hk) * D;

  if (pwl) {
    for (int i = tid; i < 2 * num_segments; i += kThreads) sTab[i] = table[i];
  }
  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, col = i % D;
    sQ[r * DP + col] = q0 + r < seq_q ? load_f32(qp + (q0 + r) * q_rs + col) : 0.0f;
  }
  if (tid < kBlockQ) {
    sM[tid] = kNegInf;
    sL[tid] = 0.0f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[a][jj] = 0.0f;

  // Causal: keys at or past q0 + q_offset + kBlockQ lie above the diagonal
  // of every row of this tile.
  const int k_end = causal ? min(seq_k, q0 + q_offset + kBlockQ) : seq_k;
  const int n_k = (k_end + kBlockK - 1) / kBlockK;

  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();  // the previous tile's reads of sK, sV, sS are done
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, col = i % D;
      const bool ok = k0 + r < seq_k;
      sK[r * DP + col] = ok ? load_f32(kp + (k0 + r) * kv_rs + col) : 0.0f;
      sV[r * D + col] = ok ? load_f32(vp + (k0 + r) * kv_rs + col) : 0.0f;
    }
    __syncthreads();

    // S for rows ty + 16a and columns tx + 16bb.
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) s[a][bb] = 0.0f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = sQ[(ty + 16 * a) * DP + kk];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) kb[bb] = sK[(tx + 16 * bb) * DP + kk];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) s[a][bb] = fmaf(qa[a], kb[bb], s[a][bb]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int col = k0 + tx + 16 * bb;
        float val = s[a][bb];
        if (col >= seq_k) val = kNegInf;
        if (causal && q0 + r + q_offset < col) val = kNegInf;
        sS[r * kSP + tx + 16 * bb] = val;
      }
    }
    __syncthreads();

    // Online softmax: warp w owns rows 8w .. 8w + 7, two columns a lane.
    for (int rr = 0; rr < kBlockQ / 8; ++rr) {
      const int r = warp * (kBlockQ / 8) + rr;
      const float s0 = sS[r * kSP + lane], s1 = sS[r * kSP + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[r];
      const float m_new = fmaxf(mx, m_old);
      const float p0 = exp2_mode(c * (s0 - m_new), pwl, sTab, num_segments);
      const float p1 = exp2_mode(c * (s1 - m_new), pwl, sTab, num_segments);
      sS[r * kSP + lane] = p0;
      sS[r * kSP + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = exp2_mode(c * (m_old - m_new), pwl, sTab, num_segments);
        sB[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * b + P V for rows ty + 16a and columns tx + 16jj.
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float corr = sB[ty + 16 * a];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[a][jj] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pa[4], vb[DJ];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = sS[(ty + 16 * a) * kSP + kk];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) vb[jj] = sV[kk * D + tx + 16 * jj];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[a][jj] = fmaf(pa[a], vb[jj], acc[a][jj]);
    }
  }
  __syncthreads();

  // O = acc / l (l == 0 read as 1), written in [B, Sq, H, D] and T.
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (q0 + r >= seq_q) continue;
    const float l = sL[r];
    const float safe_l = l == 0.0f ? 1.0f : l;
    T* op = o + (static_cast<long long>(b) * seq_q + q0 + r) * q_rs +
            static_cast<long long>(h) * D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) store_f32(op + tx + 16 * jj, acc[a][jj] / safe_l);
    if (lse != nullptr && tx == 0) {
      lse[static_cast<long long>(bh) * seq_q + q0 + r] = c * sM[r] + log2f(safe_l);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const float* table, int batch, int heads,
                   int kv_heads, int seq_q, int seq_k, int q_offset,
                   long long q_bstride, long long k_bstride,
                   long long v_bstride, int causal, float c, int pwl,
                   int num_segments, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, batch * heads);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, table, heads,
      kv_heads, seq_q, seq_k, q_offset, q_bstride, k_bstride, v_bstride,
      causal, c, pwl, num_segments);
  return cudaGetLastError();
}

template <typename T, bool kWide>
cudaError_t dispatch_head_dim(int head_dim, const void* q, const void* k,
                              const void* v, void* o, float* lse,
                              const float* table, int batch, int heads,
                              int kv_heads, int seq_q, int seq_k, int q_offset,
                              long long q_bstride, long long k_bstride,
                              long long v_bstride, int causal, float c,
                              int pwl, int num_segments, cudaStream_t stream) {
#define REPRO_TORCH_LAUNCH(D)                                                 \
  return launch<T, D>(q, k, v, o, lse, table, batch, heads, kv_heads, seq_q, \
                      seq_k, q_offset, q_bstride, k_bstride, v_bstride,      \
                      causal, c, pwl, num_segments, stream)
  switch (head_dim) {
    case 16: REPRO_TORCH_LAUNCH(16);
    case 32: REPRO_TORCH_LAUNCH(32);
    case 64:
      if constexpr (kWide) REPRO_TORCH_LAUNCH(64);
      break;
    case 128:
      if constexpr (kWide) REPRO_TORCH_LAUNCH(128);
      break;
    default: break;
  }
  return cudaErrorInvalidValue;
#undef REPRO_TORCH_LAUNCH
}

}  // namespace

// C entry point, bound with ctypes. q [B, Sq, H, D], k and v [B, Sk, Hkv, D]
// with dense inner dims and any batch stride; o [B, Sq, H, D] dense; lse
// [B*H, Sq] fp32 or null; table [2, num_segments] fp32 (read when pwl).
// dtype: 0 float32 (D 16 to 128), 1 bfloat16 (D 16 or 32). Returns a
// cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, const void* table, int dtype, int batch,
                         int heads, int kv_heads, int seq_q, int seq_k,
                         int head_dim, long long q_bstride,
                         long long k_bstride, long long v_bstride,
                         int q_offset, int causal, float c, int pwl,
                         int num_segments, void* stream) {
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads != 0 ||
      seq_q < 1 || seq_k < 1 || q_offset < 0 ||
      (pwl && (num_segments < 1 || num_segments > kMaxSegments || table == nullptr)))
    return cudaErrorInvalidValue;
  auto* lse_f = static_cast<float*>(lse);
  auto* tab = static_cast<const float*>(table);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_head_dim<float, true>(head_dim, q, k, v, o, lse_f, tab, batch,
                                    heads, kv_heads, seq_q, seq_k, q_offset,
                                    q_bstride, k_bstride, v_bstride, causal, c,
                                    pwl, num_segments, st);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16, false>(  // d 64, 128: flash_fwd_sm90.cu
        head_dim, q, k, v, o, lse_f, tab, batch, heads, kv_heads, seq_q, seq_k,
        q_offset, q_bstride, k_bstride, v_bstride, causal, c, pwl,
        num_segments, st);
  return cudaErrorInvalidValue;
}
