// SystolicAttention forward (the paper's Algorithm 1) on the CUDA cores of
// Hopper, sm_90a: the SIMT kernel, for fp32 at d 16 to 128 and bf16 at d 16
// and 32 (bf16 at d 64 and 128 goes to the tensor-core kernel of
// flash_fwd_sm90.cu).
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (src/repro/kernels/flash_attention/kernel.py:64, launched by
// `flash_attention_fwd` at kernel.py:217). It computes what that kernel
// computes:
//
//   S   = Q K^T, unscaled, in fp32 (inputs fp32 or bf16, upcast on read);
//   mask padded keys and (causal) keys past row + q_offset with -1e30;
//   m'  = max(m, rowmax S);  b = exp2(c (m - m'));  P = exp2(c (S - m'))
//   l   = l b + rowsum P;    acc = acc b + P V        (c = scale * log2 e)
//   O   = acc / l, with l == 0 read as 1; optional LSE = c m + log2 l.
//
// exp2 is exact (exp2f) or the K-segment PWL of §3.3 (pwl_exp2.cuh). Every
// product is an fp32 FMA on the CUDA cores: fp32 inputs stay fp32 (no TF32,
// no tensor cores) and P stays fp32 for PV, the reference's numerics.
//
// Tiles. The k tile is 64 keys, as the plain version's: with the PWL exp2
// the rescale factor b is not multiplicative, so where the k tiles break
// decides l and the LSE. The q tile is 32 or 16 rows (BQ), chosen by the
// wrapper (kernel.simt_q_tile): 16 where 32-row tiles would leave SMs of
// the card idle. Rows are independent, so the q tile never changes a
// result. K tiles wholly above the causal diagonal are skipped (the Pallas
// kernel runs them masked): every row has seen key 0 by then, and a tile
// masked for a whole row leaves it as it was (P = 0, b = exp2(0) = 1, also
// for the PWL). Only tiles on the diagonal or the ragged end are masked.
//
// What bounds it on the H100. At serving lengths (S up to a few hundred
// tokens, B*H = 16) the work is small (0.27 GFLOP at S = 256, 4 us at the
// CUDA cores' 67 TFLOP/s): the time is that of the slowest CTA, the causal
// q tile with the most k tiles, and of how many SMs hold a CTA at all. At
// long prefill it is the 4 d S^2 / 2 causal operations at the fp32 FMA
// rate, and feeding them: shared memory hands the lanes of an SM 32 words a
// cycle (a broadcast word counts for each lane), its FMA units take 128 a
// cycle. What the design does:
//   * fill the card: one CTA per (b*h, q tile) with small q tiles, launched
//     heaviest first (the grid's linear order walks the q tiles from the
//     last down, all heads of one q tile together), so the longest chains
//     start first and the short ones fill in behind.
//   * register blocking: 128 threads, 8 row groups of BQ/8 rows by 16
//     column groups. In S a thread holds BQ/8 rows x 4 keys (keys cg + 16 i)
//     and reads Q and K along d as 16-byte vectors; in PV it holds BQ/8 rows
//     x d/16 columns, reads P^T as one vector and V in 16-byte vectors: at
//     BQ = 32 and d = 128, 2 FMAs a word in S and 2.7 in PV. K's rows are
//     padded by 16 bytes, so the lanes reading keys cg + 16 i hit distinct
//     banks. 8 x 8 tiles (4 FMAs a word: S split along d over the warps and
//     summed in shared memory, PV split along the keys) were tried on the
//     H100 and did not pay: with S and O both 8 x 8 a thread needs nearly
//     all of its registers, and the CTA an SM to itself.
//   * two CTAs an SM, overlapped loads: one shared buffer each for K and V
//     (92 KB at fp32, d = 128, BQ = 32), so two CTAs share an SM, two warps
//     a scheduler, and cover each other's latencies; the 16-byte cp.async
//     loads are staggered, V tile j in flight during S of tile j and K tile
//     j + 1 during PV of tile j (bf16 copied raw, converted on the shared
//     read). Two stages of K and V at one CTA an SM were slower at long
//     prefill.
//   * the row softmax inside a warp: the 16 lanes of a row group hold one
//     row's 64 scores; max and sum are reduced with __shfl_xor_sync, and m
//     and l stay in registers. P goes to shared memory as P^T. A k tile
//     takes two __syncthreads: one when K tile j has landed, one when V
//     tile j and P have.
// GQA maps q-head h to kv-head h / (H / Hkv) without repeating K/V.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "pwl_exp2.cuh"
#include "simt.cuh"  // vector reads and writes, cp.async, row padding

namespace {

using namespace repro_torch::simt;

constexpr int kBlockK = 64;          // keys of a k tile (kernel.SIMT.tile)
constexpr int kThreads = 128;        // 8 row groups x 16 column groups
constexpr int kRowGroups = 8;
constexpr int kColGroups = 16;
constexpr int kKeys = kBlockK / kColGroups;  // keys of S a thread holds: cg + 16 i
constexpr int kMaxSegments = 128;    // width of the packed PWL table
constexpr float kNegInf = -1e30f;    // finite: -inf - (-inf) would be NaN

__device__ __forceinline__ float exp2_mode(float x, bool pwl, const float* tab,
                                           int num_segments) {
  return pwl ? repro_torch::pwl_exp2(x, tab, tab + num_segments, num_segments)
             : exp2f(x);
}

template <typename T, int D, int BQ>
constexpr size_t smem_bytes() {
  // Q [BQ][D + pad], K [64][D + pad] and V [64][D] in T, P^T [64][BQ + 4]
  // and the PWL table [2][128] in fp32.
  return sizeof(T) * ((BQ + kBlockK) * (D + kPad<T>) + kBlockK * D) +
         sizeof(float) * (kBlockK * (BQ + 4) + 2 * kMaxSegments);
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const float* __restrict__ table,
                 int heads, int kv_heads, int seq_q, int seq_k, int q_offset,
                 long long q_bstride, long long k_bstride, long long v_bstride,
                 int causal, float c, int pwl, int num_segments) {
  constexpr int RM = BQ / kRowGroups;         // rows a thread holds: 4 or 2
  constexpr int TN = D / kColGroups;          // output columns a thread holds
  constexpr int VW = TN < 4 ? TN : 4;         // ... read and written VW at a time
  constexpr int DP = D + kPad<T>;             // padded row of Q and K
  constexpr int BQP = BQ + 4;                 // padded row of P^T
  constexpr int kVec = 16 / sizeof(T);        // elements of one cp.async
  constexpr int kChunks = D / kVec;           // cp.asyncs a row
  static_assert(BQ % kRowGroups == 0 && (RM == 2 || RM == 4), "q tile of 16 or 32");
  static_assert(D % kColGroups == 0 && D % kVec == 0 && TN % VW == 0, "head_dim");

  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);                        // [BQ][DP]
  T* sK = sQ + BQ * DP;                                      // [kBlockK][DP]
  T* sV = sK + kBlockK * DP;                                 // [kBlockK][D]
  float* sP = reinterpret_cast<float*>(sV + kBlockK * D);    // [kBlockK][BQP]: P^T
  float* sTab = sP + kBlockK * BQP;                          // [2][num_segments]

  const int tid = threadIdx.x;
  const int g = tid / kColGroups;   // row group: rows g * RM + r (warp w: 2w, 2w + 1)
  const int cg = tid % kColGroups;  // column group: keys cg + 16 i of S
  // Heaviest first: block i takes q tile n_q - 1 - i / (B*H) of head i % (B*H).
  const int n_q = (seq_q + BQ - 1) / BQ;
  const int n_bh = gridDim.x / n_q;
  const int bh = blockIdx.x % n_bh;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x) / n_bh) * BQ;
  const int b = bh / heads, h = bh % heads;
  const int hk = h / (heads / kv_heads);
  const long long q_rs = static_cast<long long>(heads) * D;  // row strides
  const long long kv_rs = static_cast<long long>(kv_heads) * D;
  const T* qp = q + b * q_bstride + static_cast<long long>(h) * D;
  const T* kp = k + b * k_bstride + static_cast<long long>(hk) * D;
  const T* vp = v + b * v_bstride + static_cast<long long>(hk) * D;

  // Tile j of K or V (row stride ld in shared memory); keys past seq_k read
  // as zeros.
  auto load_tile = [&](const T* src, T* dst, int ld, int j) {
    const int k0 = j * kBlockK;
    for (int i = tid; i < kBlockK * kChunks; i += kThreads) {
      const int r = i / kChunks, col = (i % kChunks) * kVec;
      const bool ok = k0 + r < seq_k;
      cp_async16(dst + r * ld + col, src + (ok ? k0 + r : 0) * kv_rs + col, ok);
    }
  };

  if (pwl) {
    for (int i = tid; i < 2 * num_segments; i += kThreads) sTab[i] = table[i];
  }
  for (int i = tid; i < BQ * kChunks; i += kThreads) {
    const int r = i / kChunks, col = (i % kChunks) * kVec;
    const bool ok = q0 + r < seq_q;
    cp_async16(sQ + r * DP + col, qp + (ok ? q0 + r : 0) * q_rs + col, ok);
  }
  load_tile(kp, sK, DP, 0);
  cp_async_commit();

  float m[RM], l[RM], acc[RM][TN];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[r][n] = 0.0f;
  }

  // Causal: keys at or past q0 + q_offset + BQ lie above the diagonal of
  // every row of this tile.
  const int k_end = causal ? min(seq_k, q0 + q_offset + BQ) : seq_k;
  const int n_k = (k_end + kBlockK - 1) / kBlockK;

  // One buffer each for K and V, two CTAs an SM; the loads are staggered so
  // that each is in flight while the other product runs: V tile j during S
  // of tile j, K tile j + 1 during PV of tile j.
  for (int j = 0; j < n_k; ++j) {
    cp_async_wait();  // K tile j
    __syncthreads();  // K tile j in every view; every warp is done with V tile j - 1 and P
    load_tile(vp, sV, D, j);
    cp_async_commit();
    const int k0 = j * kBlockK;

    // S for rows g * RM + r and keys cg + 16 i, 4 depths a step.
    float s[RM][kKeys];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int i = 0; i < kKeys; ++i) s[r][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 4) {
      float qa[RM][4], kb[kKeys][4];
#pragma unroll
      for (int r = 0; r < RM; ++r) load_vec<4>(sQ + (g * RM + r) * DP + kk, qa[r]);
#pragma unroll
      for (int i = 0; i < kKeys; ++i) load_vec<4>(sK + (cg + kColGroups * i) * DP + kk, kb[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int i = 0; i < kKeys; ++i) s[r][i] = fmaf(qa[r][e], kb[i][e], s[r][i]);
    }
    // Only the diagonal and the ragged end need the mask.
    if (k0 + kBlockK > seq_k || (causal && k0 + kBlockK - 1 > q0 + q_offset)) {
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int row = q0 + g * RM + r;
#pragma unroll
        for (int i = 0; i < kKeys; ++i) {
          const int col = k0 + cg + kColGroups * i;
          if (col >= seq_k || (causal && row + q_offset < col)) s[r][i] = kNegInf;
        }
      }
    }

    // Online softmax: a row's 64 scores lie in the 16 lanes of its row
    // group, within one warp.
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      float mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
#pragma unroll
      for (int off = 1; off < kColGroups; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = exp2_mode(c * (m[r] - m_new), pwl, sTab, num_segments);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        s[r][i] = exp2_mode(c * (s[r][i] - m_new), pwl, sTab, num_segments);
        sum += s[r][i];
      }
#pragma unroll
      for (int off = 1; off < kColGroups; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[r][n] *= corr;
    }

    // P^T for this warp's rows (the warp alone reads them back).
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      float col[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) col[r] = s[r][i];
      store_vec<RM>(sP + (cg + kColGroups * i) * BQP + g * RM, col);
    }
    cp_async_wait();  // V tile j
    __syncthreads();  // V tile j and P^T in every view; every warp is done with K tile j
    if (j + 1 < n_k) load_tile(kp, sK, DP, j + 1);
    cp_async_commit();

    // acc += P V for rows g * RM + r and columns VW cg + 16 VW jj + e.
#pragma unroll 16
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pa[RM], vb[TN];
      load_vec<RM>(sP + kk * BQP + g * RM, pa);
#pragma unroll
      for (int jj = 0; jj < TN / VW; ++jj)
        load_vec<VW>(sV + kk * D + VW * cg + kColGroups * VW * jj, vb + VW * jj);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[r][n] = fmaf(pa[r], vb[n], acc[r][n]);
    }
  }

  // O = acc / l (l == 0 read as 1), written in [B, Sq, H, D] and T.
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = q0 + g * RM + r;
    if (row >= seq_q) continue;
    const float safe_l = l[r] == 0.0f ? 1.0f : l[r];
    T* op = o + (static_cast<long long>(b) * seq_q + row) * q_rs +
            static_cast<long long>(h) * D;
#pragma unroll
    for (int jj = 0; jj < TN / VW; ++jj) {
      float out[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) out[e] = acc[r][VW * jj + e] / safe_l;
      store_vec<VW>(op + VW * cg + kColGroups * VW * jj, out);
    }
    if (lse != nullptr && cg == 0) {
      lse[static_cast<long long>(bh) * seq_q + row] =
          __fadd_rn(__fmul_rn(c, m[r]), log2f(safe_l));
    }
  }
}

template <typename T, int D, int BQ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const float* table, int batch, int heads,
                   int kv_heads, int seq_q, int seq_k, int q_offset,
                   long long q_bstride, long long k_bstride,
                   long long v_bstride, int causal, float c, int pwl,
                   int num_segments, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D, BQ>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>((seq_q + BQ - 1) / BQ) * batch * heads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_kernel<T, D, BQ><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, table, heads,
      kv_heads, seq_q, seq_k, q_offset, q_bstride, k_bstride, v_bstride,
      causal, c, pwl, num_segments);
  return cudaGetLastError();
}

template <typename T, bool kWide>
cudaError_t dispatch(int head_dim, int block_q, const void* q, const void* k,
                     const void* v, void* o, float* lse, const float* table,
                     int batch, int heads, int kv_heads, int seq_q, int seq_k,
                     int q_offset, long long q_bstride, long long k_bstride,
                     long long v_bstride, int causal, float c, int pwl,
                     int num_segments, cudaStream_t stream) {
#define REPRO_TORCH_LAUNCH(D)                                                   \
  return block_q == 32                                                         \
      ? launch<T, D, 32>(q, k, v, o, lse, table, batch, heads, kv_heads,       \
                         seq_q, seq_k, q_offset, q_bstride, k_bstride,         \
                         v_bstride, causal, c, pwl, num_segments, stream)      \
      : launch<T, D, 16>(q, k, v, o, lse, table, batch, heads, kv_heads,       \
                         seq_q, seq_k, q_offset, q_bstride, k_bstride,         \
                         v_bstride, causal, c, pwl, num_segments, stream)
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
// with dense inner dims, 16-byte aligned bases and batch strides of whole
// 16-byte units; o [B, Sq, H, D] dense and 16-byte aligned; lse [B*H, Sq]
// fp32 or null; table [2, num_segments] fp32 (read when pwl). dtype: 0
// float32 (D 16 to 128), 1 bfloat16 (D 16 or 32). block_q: the q tile, 16
// or 32 (kernel.simt_q_tile). Returns a cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, const void* table, int dtype, int batch,
                         int heads, int kv_heads, int seq_q, int seq_k,
                         int head_dim, long long q_bstride,
                         long long k_bstride, long long v_bstride,
                         int q_offset, int causal, float c, int pwl,
                         int num_segments, void* stream, int block_q) {
  const long long size = dtype == 0 ? 4 : 2;
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads != 0 ||
      seq_q < 1 || seq_k < 1 || q_offset < 0 || (block_q != 16 && block_q != 32) ||
      (pwl && (num_segments < 1 || num_segments > kMaxSegments || table == nullptr)))
    return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o) ||
      (q_bstride * size) % 16 || (k_bstride * size) % 16 || (v_bstride * size) % 16)
    return cudaErrorMisalignedAddress;
  auto* lse_f = static_cast<float*>(lse);
  auto* tab = static_cast<const float*>(table);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float, true>(head_dim, block_q, q, k, v, o, lse_f, tab, batch,
                                 heads, kv_heads, seq_q, seq_k, q_offset, q_bstride,
                                 k_bstride, v_bstride, causal, c, pwl,
                                 num_segments, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, false>(  // d 64, 128: flash_fwd_sm90.cu
        head_dim, block_q, q, k, v, o, lse_f, tab, batch, heads, kv_heads, seq_q,
        seq_k, q_offset, q_bstride, k_bstride, v_bstride, causal, c, pwl,
        num_segments, st);
  return cudaErrorInvalidValue;
}
