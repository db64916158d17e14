// FlashAttention-2 backward for Hopper, sm_90a: two kernels, dQ and dK/dV.
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel`
// (src/repro/kernels/flash_attention/kernel_bwd.py:48 and :81, launched by
// `flash_attention_bwd` at kernel_bwd.py:167 and :185). They compute what
// those kernels compute, from the forward's base-2 LSE (c = scale * log2 e):
//
//   S  = Q K^T (fp32; inputs fp32 or bf16, upcast on load), masked with
//        -1e30 for padded keys and (causal) keys past row + q_offset;
//   P  = exp2(c S - LSE)          recomputed per tile, never stored, with
//                                 the exact exp2f even after a PWL forward;
//   dP = dO V^T;  dS = P (dP - delta) scale,  delta = rowsum(dO * O);
//   dQ = dS K;    dK = dS^T Q;    dV = P^T dO        (fp32 sums).
//
// Design. The TPU grids run in order and carry their accumulators in VMEM
// across the innermost grid dimension; CTAs on the card run in no order, so
// each CTA loops over that dimension itself and keeps its accumulator in
// registers:
//   * flash_bwd_dq_kernel: one CTA per (b*h, 64-row q tile). It first
//     computes delta for its rows (the reference leaves this to XLA) and
//     writes it out for the second kernel, then loops over the 64-column k
//     tiles up to the causal diagonal, dQ (4 x d/16 per thread) in
//     registers.
//   * flash_bwd_dkv_kernel: one CTA per (b, kv head, 64-row k tile). It
//     keeps its K and V tiles in shared memory and loops over the rep q
//     heads of its GQA group and, for each, over the q tiles from the
//     diagonal down; dK and dV (4 x d/16 each per thread) stay in registers,
//     so the group is summed in fp32 and rounded once. The reference writes
//     a partial per q head in k's dtype and sums them outside
//     (kernel_bwd.py:216-217); that buffer is gone.
// Neither kernel writes what another CTA writes, so there are no atomics
// and the result is deterministic. Tiles wholly above the causal diagonal
// are skipped (the Pallas kernels run them masked): P is exactly 0 there.
// c S - LSE is rounded as a product then a difference (no FMA contraction),
// as the plain PyTorch version computes it.
//
// What bounds it on the H100: the 10 d operations per causal pair and head
// of its five products (S, dP, dV, dQ, dK; S and dP are computed in both
// kernels here, so 14 d are executed). This first version is plain SIMT:
// fp32 FMAs on the CUDA cores (67 TFLOP/s peak, against 989 TFLOP/s of
// bf16 tensor cores), no tensor cores, no TMA, no overlap of loads with
// compute. Shared memory at d = 128: 146 KB (dQ) and 162 KB (dK/dV) of
// the 227 KB a CTA may use; Q, dO, K and V tiles are kept in fp32 with
// padded rows (64 x 129 floats, 33 KB each), the accumulators in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;           // rows of a q tile and of a k tile
constexpr int kThreads = 256;        // 16 x 16 threads, 4 x 4 tile entries each
constexpr int kSP = kBlock + 1;      // padded row of a P or dS tile
constexpr float kNegInf = -1e30f;    // finite, as the reference's masks

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows [r0, r0 + kBlock) of one head of a [B, S, heads, D] tensor (row
// stride rs, first row at p) into a padded fp32 tile; rows past seq are 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* p, long long rs,
                                          int r0, int seq) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, col = i % D;
    dst[r * DP + col] = r0 + r < seq ? load_f32(p + (r0 + r) * rs + col) : 0.0f;
  }
}

// s = A B^T and dp = C E^T for the 4 x 4 entries (ty + 16a, tx + 16bb) of
// two 64 x 64 products over D, all four operands padded fp32 tiles.
template <int D>
__device__ __forceinline__ void two_products(const float* sA, const float* sB,
                                             const float* sC, const float* sE,
                                             int tx, int ty, float (&s)[4][4],
                                             float (&dp)[4][4]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) s[a][bb] = dp[a][bb] = 0.0f;
#pragma unroll 4
  for (int kk = 0; kk < D; ++kk) {
    float av[4], bv[4], cv[4], ev[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      av[a] = sA[(ty + 16 * a) * DP + kk];
      cv[a] = sC[(ty + 16 * a) * DP + kk];
    }
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      bv[bb] = sB[(tx + 16 * bb) * DP + kk];
      ev[bb] = sE[(tx + 16 * bb) * DP + kk];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        s[a][bb] = fmaf(av[a], bv[bb], s[a][bb]);
        dp[a][bb] = fmaf(cv[a], ev[bb], dp[a][bb]);
      }
  }
}

// P and dS in place of s and dp, for q rows ty + 16a (tile row offset q0)
// and k columns tx + 16bb (tile column offset k0).
__device__ __forceinline__ void p_and_ds(float (&s)[4][4], float (&dp)[4][4],
                                         const float* sLse, const float* sDelta,
                                         int tx, int ty, int q0, int k0,
                                         int seq_k, int q_offset, int causal,
                                         float c, float scale) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const float lse = sLse[r], delta = sDelta[r];
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      const int col = k0 + tx + 16 * bb;
      float val = s[a][bb];
      if (col >= seq_k) val = kNegInf;
      if (causal && q0 + r + q_offset < col) val = kNegInf;
      const float p = exp2f(__fsub_rn(__fmul_rn(c, val), lse));
      s[a][bb] = p;
      dp[a][bb] = p * (dp[a][bb] - delta) * scale;
    }
  }
}

template <int D>
constexpr int dq_smem_floats() {
  // Q, dO, K, V padded tiles, dS, then LSE and delta per row.
  return 4 * kBlock * (D + 1) + kBlock * kSP + 2 * kBlock;
}

template <int D>
constexpr int dkv_smem_floats() {
  // K, V, Q, dO padded tiles, P, dS, then LSE and delta per row.
  return 4 * kBlock * (D + 1) + 2 * kBlock * kSP + 2 * kBlock;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int heads,
                    int kv_heads, int seq_q, int seq_k, int q_offset,
                    long long q_bstride, long long k_bstride,
                    long long v_bstride, long long o_bstride,
                    long long do_bstride, int causal, float c, float scale) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;  // dQ columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                  // [kBlock][DP]
  float* sDO = sQ + kBlock * DP;     // [kBlock][DP]
  float* sK = sDO + kBlock * DP;     // [kBlock][DP]
  float* sV = sK + kBlock * DP;      // [kBlock][DP]
  float* sDS = sV + kBlock * DP;     // [kBlock][kSP]
  float* sLse = sDS + kBlock * kSP;  // [kBlock]
  float* sDelta = sLse + kBlock;     // [kBlock]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int hk = h / (heads / kv_heads);
  const int q0 = blockIdx.x * kBlock;
  const long long q_rs = static_cast<long long>(heads) * D;  // row strides
  const long long kv_rs = static_cast<long long>(kv_heads) * D;
  const long long head = static_cast<long long>(h) * D;
  const T* kp = k + b * k_bstride + static_cast<long long>(hk) * D;
  const T* vp = v + b * v_bstride + static_cast<long long>(hk) * D;
  const T* op = o + b * o_bstride + head;

  load_tile<T, D>(sQ, q + b * q_bstride + head, q_rs, q0, seq_q);
  load_tile<T, D>(sDO, dout + b * do_bstride + head, q_rs, q0, seq_q);
  __syncthreads();

  // delta = rowsum(dO * O): warp w owns rows 8w .. 8w + 7.
  for (int rr = 0; rr < kBlock / 8; ++rr) {
    const int r = warp * (kBlock / 8) + rr;
    const bool ok = q0 + r < seq_q;
    float sum = 0.0f;
    if (ok) {
      for (int col = lane; col < D; col += 32)
        sum = fmaf(sDO[r * DP + col], load_f32(op + (q0 + r) * q_rs + col), sum);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      sDelta[r] = sum;
      sLse[r] = ok ? lse[static_cast<long long>(bh) * seq_q + q0 + r] : 0.0f;
      if (ok) delta[static_cast<long long>(bh) * seq_q + q0 + r] = sum;
    }
  }

  float acc[4][DJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[a][jj] = 0.0f;

  // Causal: keys at or past q0 + q_offset + kBlock lie above the diagonal
  // of every row of this tile.
  const int k_end = causal ? min(seq_k, q0 + q_offset + kBlock) : seq_k;
  const int n_k = (k_end + kBlock - 1) / kBlock;

  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * kBlock;
    __syncthreads();  // the previous tile's reads of sK, sV, sDS are done
    load_tile<T, D>(sK, kp, kv_rs, k0, seq_k);
    load_tile<T, D>(sV, vp, kv_rs, k0, seq_k);
    __syncthreads();

    float s[4][4], ds[4][4];
    two_products<D>(sQ, sK, sDO, sV, tx, ty, s, ds);
    p_and_ds(s, ds, sLse, sDelta, tx, ty, q0, k0, seq_k, q_offset, causal, c, scale);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) sDS[(ty + 16 * a) * kSP + tx + 16 * bb] = ds[a][bb];
    __syncthreads();

    // dQ += dS K for rows ty + 16a and columns tx + 16jj.
#pragma unroll 4
    for (int kk = 0; kk < kBlock; ++kk) {
      float da[4], kb[DJ];
#pragma unroll
      for (int a = 0; a < 4; ++a) da[a] = sDS[(ty + 16 * a) * kSP + kk];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) kb[jj] = sK[kk * DP + tx + 16 * jj];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[a][jj] = fmaf(da[a], kb[jj], acc[a][jj]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (q0 + r >= seq_q) continue;
    T* dqp = dq + (static_cast<long long>(b) * seq_q + q0 + r) * q_rs + head;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) store_f32(dqp + tx + 16 * jj, acc[a][jj]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int heads, int kv_heads, int seq_q,
                     int seq_k, int q_offset, long long q_bstride,
                     long long k_bstride, long long v_bstride,
                     long long do_bstride, int causal, float c, float scale) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;  // dK, dV columns per thread
  extern __shared__ float smem[];
  float* sK = smem;                  // [kBlock][DP]
  float* sV = sK + kBlock * DP;      // [kBlock][DP]
  float* sQ = sV + kBlock * DP;      // [kBlock][DP]
  float* sDO = sQ + kBlock * DP;     // [kBlock][DP]
  float* sP = sDO + kBlock * DP;     // [kBlock][kSP], q rows x k columns
  float* sDS = sP + kBlock * kSP;    // [kBlock][kSP]
  float* sLse = sDS + kBlock * kSP;  // [kBlock]
  float* sDelta = sLse + kBlock;     // [kBlock]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bhk = blockIdx.y;
  const int b = bhk / kv_heads, hk = bhk % kv_heads;
  const int rep = heads / kv_heads;
  const int k0 = blockIdx.x * kBlock;
  const long long q_rs = static_cast<long long>(heads) * D;  // row strides
  const long long kv_rs = static_cast<long long>(kv_heads) * D;
  const long long kv_head = static_cast<long long>(hk) * D;

  load_tile<T, D>(sK, k + b * k_bstride + kv_head, kv_rs, k0, seq_k);
  load_tile<T, D>(sV, v + b * v_bstride + kv_head, kv_rs, k0, seq_k);

  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dk_acc[a][jj] = dv_acc[a][jj] = 0.0f;

  // Causal: q rows before k0 - q_offset see none of this tile's keys.
  const int n_q = (seq_q + kBlock - 1) / kBlock;
  const int i_start = causal ? max(0, k0 - q_offset) / kBlock : 0;

  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const long long head = static_cast<long long>(h) * D;
    const long long row0 = (static_cast<long long>(b) * heads + h) * seq_q;
    for (int i = i_start; i < n_q; ++i) {
      const int q0 = i * kBlock;
      __syncthreads();  // the previous tile's reads of sQ, sDO, sP, sDS are done
      load_tile<T, D>(sQ, q + b * q_bstride + head, q_rs, q0, seq_q);
      load_tile<T, D>(sDO, dout + b * do_bstride + head, q_rs, q0, seq_q);
      if (tid < kBlock) {
        const bool ok = q0 + tid < seq_q;
        sLse[tid] = ok ? lse[row0 + q0 + tid] : 0.0f;
        sDelta[tid] = ok ? delta[row0 + q0 + tid] : 0.0f;
      }
      __syncthreads();

      float p[4][4], ds[4][4];
      two_products<D>(sQ, sK, sDO, sV, tx, ty, p, ds);
      p_and_ds(p, ds, sLse, sDelta, tx, ty, q0, k0, seq_k, q_offset, causal, c, scale);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          sP[(ty + 16 * a) * kSP + tx + 16 * bb] = p[a][bb];
          sDS[(ty + 16 * a) * kSP + tx + 16 * bb] = ds[a][bb];
        }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q for k rows ty + 16a, columns tx + 16jj.
#pragma unroll 2
      for (int r = 0; r < kBlock; ++r) {
        float pa[4], da[4], dob[DJ], qb[DJ];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pa[a] = sP[r * kSP + ty + 16 * a];
          da[a] = sDS[r * kSP + ty + 16 * a];
        }
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          dob[jj] = sDO[r * DP + tx + 16 * jj];
          qb[jj] = sQ[r * DP + tx + 16 * jj];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int jj = 0; jj < DJ; ++jj) {
            dv_acc[a][jj] = fmaf(pa[a], dob[jj], dv_acc[a][jj]);
            dk_acc[a][jj] = fmaf(da[a], qb[jj], dk_acc[a][jj]);
          }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (k0 + r >= seq_k) continue;
    const long long off = (static_cast<long long>(b) * seq_k + k0 + r) * kv_rs + kv_head;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      store_f32(dk + off + tx + 16 * jj, dk_acc[a][jj]);
      store_f32(dv + off + tx + 16 * jj, dv_acc[a][jj]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *delta, *dq, *dk, *dv;
  int batch, heads, kv_heads, seq_q, seq_k, q_offset, causal;
  long long q_bstride, k_bstride, v_bstride, o_bstride, do_bstride;
  float c, scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq_q + kBlock - 1) / kBlock, a.batch * a.heads);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<float*>(a.delta), static_cast<T*>(a.dq), a.heads,
      a.kv_heads, a.seq_q, a.seq_k, a.q_offset, a.q_bstride, a.k_bstride,
      a.v_bstride, a.o_bstride, a.do_bstride, a.causal, a.c, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq_k + kBlock - 1) / kBlock, a.batch * a.kv_heads);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.heads, a.kv_heads,
      a.seq_q, a.seq_k, a.q_offset, a.q_bstride, a.k_bstride, a.v_bstride,
      a.do_bstride, a.causal, a.c, a.scale);
  return cudaGetLastError();
}

template <bool kDq, typename T>
cudaError_t dispatch_head_dim(int head_dim, const Args& a) {
  switch (head_dim) {
    case 16: return kDq ? launch_dq<T, 16>(a) : launch_dkv<T, 16>(a);
    case 32: return kDq ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return kDq ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128: return kDq ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kDq>
cudaError_t dispatch(int dtype, int head_dim, const Args& a) {
  if (a.batch < 1 || a.heads < 1 || a.kv_heads < 1 ||
      a.heads % a.kv_heads != 0 || a.seq_q < 1 || a.seq_k < 1 ||
      a.q_offset < 0)
    return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_head_dim<kDq, float>(head_dim, a);
  if (dtype == 1) return dispatch_head_dim<kDq, __nv_bfloat16>(head_dim, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry points, bound with ctypes. q, o, dout [B, Sq, H, D] and k, v
// [B, Sk, Hkv, D] with dense inner dims and any batch stride; lse and delta
// [B*H, Sq] fp32; dq [B, Sq, H, D], dk and dv [B, Sk, Hkv, D] dense.
// dtype: 0 float32, 1 bfloat16. c = scale * log2(e). Each returns a
// cudaError_t. flash_bwd_dq writes delta, which flash_bwd_dkv reads: launch
// them in that order on one stream.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* delta, void* dq, int dtype, int batch,
                            int heads, int kv_heads, int seq_q, int seq_k,
                            int head_dim, long long q_bstride,
                            long long k_bstride, long long v_bstride,
                            long long o_bstride, long long do_bstride,
                            int q_offset, int causal, float c, float scale,
                            void* stream) {
  Args a{q, k, v, o, dout, lse, delta, dq, nullptr, nullptr,
         batch, heads, kv_heads, seq_q, seq_k, q_offset, causal,
         q_bstride, k_bstride, v_bstride, o_bstride, do_bstride,
         c, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, head_dim, a);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int dtype,
                             int batch, int heads, int kv_heads, int seq_q,
                             int seq_k, int head_dim, long long q_bstride,
                             long long k_bstride, long long v_bstride,
                             long long do_bstride, int q_offset, int causal,
                             float c, float scale, void* stream) {
  Args a{q, k, v, nullptr, dout, lse, const_cast<void*>(delta), nullptr, dk, dv,
         batch, heads, kv_heads, seq_q, seq_k, q_offset, causal,
         q_bstride, k_bstride, v_bstride, 0, do_bstride,
         c, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, head_dim, a);
}
