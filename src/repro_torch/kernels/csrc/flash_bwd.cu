// FlashAttention-2 backward on the CUDA cores of Hopper, sm_90a: the SIMT
// pair, dQ and dK/dV, for fp32 at d 16 to 128 and bf16 at d 16 and 32 (bf16
// at d 64 and 128 goes to the tensor-core pair of flash_bwd_sm90.cu).
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel`
// (src/repro/kernels/flash_attention/kernel_bwd.py:48 and :81, launched by
// `flash_attention_bwd` at kernel_bwd.py:167 and :185). They compute what
// those kernels compute, from the forward's base-2 LSE (c = scale * log2 e):
//
//   S  = Q K^T (fp32; inputs fp32 or bf16, upcast on the shared read),
//        masked with -1e30 for padded keys and (causal) keys past
//        row + q_offset;
//   P  = exp2(c S - LSE)          recomputed per tile, never stored, with
//                                 the exact exp2f even after a PWL forward;
//   dP = dO V^T;  dS = P (dP - delta) scale,  delta = rowsum(dO * O);
//   dQ = dS K;    dK = dS^T Q;    dV = P^T dO        (fp32 sums).
//
// Every product is an fp32 FMA on the CUDA cores (no TF32, no tensor
// cores), P and dS stay fp32, and c S - LSE is rounded as a product then a
// difference (no FMA contraction), as the plain PyTorch version computes it.
//
// Design. The TPU grids run in order and carry their accumulators in VMEM
// across the innermost grid dimension; CTAs on the card run in no order, so
// each CTA loops over that dimension itself and keeps its accumulator in
// registers. Each kernel holds a small resident tile and streams 64-row
// tiles of the other side (kStream, kernel_bwd.SIMT.tile):
//   * flash_bwd_dq_kernel: one CTA per (b*h, q tile of R = 32 or 16 rows).
//     It computes delta for its rows (the reference leaves this to XLA) and
//     writes it out for the second kernel, then streams the 64-key K and V
//     tiles up to the causal diagonal: dP = dO V^T, S = Q K^T, P and dS,
//     dQ += dS K, dQ in registers.
//   * flash_bwd_dkv_kernel: one CTA per (b, kv head, k tile of R = 32 or
//     16 keys). It keeps K and V resident and streams the 64-row Q and dO
//     tiles of the rep q heads of its GQA group, from the diagonal down:
//     dP^T = V dO^T, S^T = K Q^T, P^T and dS^T, dV += P^T dO, dK += dS^T Q,
//     dK and dV in registers, so the group is summed in fp32 and rounded
//     once. The reference writes a partial per q head in k's dtype and sums
//     them outside (kernel_bwd.py:216-217); that buffer is gone.
// Neither kernel writes what another CTA writes, so there are no atomics
// and the result is deterministic. Tiles wholly above the causal diagonal
// are skipped (the Pallas kernels run them masked): P is exactly 0 there;
// only tiles on the diagonal or the ragged end are masked.
//
// What bounds it on the H100: the fp32 FMAs of its products (10 d
// operations per causal pair and head for S, dP, dV, dQ, dK; S and dP are
// computed in both kernels, so 14 d are executed) at the CUDA cores' 67
// TFLOP/s, and feeding them: shared memory hands the lanes of an SM 32
// words a cycle (a broadcast word counts for each lane), its FMA units take
// 128 a cycle. What the design does (the SIMT forward's, flash_fwd.cu):
//   * fill the card, heaviest first: the wrapper chooses R
//     (kernel_bwd.simt_bwd_tiles: 16 where 32 would leave SMs idle); the
//     dQ grid walks the q tiles from the last one down, the dK/dV grid the
//     k tiles from the first one up (under a causal mask, the last q tile
//     sees the most k tiles and the first k tile the most q tiles).
//   * register blocking: 128 threads, 8 row groups of R/8 resident rows by
//     16 column groups. In S and dP a thread owns R/8 rows x 4 streamed
//     rows (cg + 16 i); two neighbouring lanes split d and each sums both
//     their row sets (R/8 x 8) over its half, reading both operands along d
//     as 16-byte vectors, then they swap halves by one shuffle a sum. In
//     the accumulating products a thread holds R/8 rows x d/16 columns and
//     reads the 64-row operands (dS^T, P^T) as one vector and Q, dO or K in
//     16-byte vectors: at R = 32 and d = 128, 2.7 FMAs a shared word in
//     every product (2 without the split of d, which measured about 3%
//     slower on the H100). The streamed tiles' rows are padded by 16 bytes,
//     so the lanes reading different streamed rows hit distinct banks; the
//     resident tiles are read by the lanes of one row group at once (a
//     broadcast) and need no padding.
//   * two CTAs an SM, overlapped loads: one shared buffer for each streamed
//     tile (107 KB a CTA at fp32, d = 128, R = 32), so two CTAs share an SM
//     and cover each other's latencies; the 16-byte cp.async loads are
//     staggered so that each is in flight during a product that does not
//     read it: in dQ, K tile j during dP of tile j and V tile j + 1 during S
//     and dQ of tile j; in dK/dV, Q tile t during dP^T of tile t and dO tile
//     t + 1 during dK of tile t (bf16 copied raw, converted on the shared
//     read). dS^T (dQ) and P^T then dS^T (dK/dV) pass through shared memory
//     within a warp: the 16 lanes of a row group compute the entries its
//     rows read back. dQ takes two __syncthreads a tile, dK/dV three.
// GQA maps q-head h to kv-head h / (H / Hkv) without repeating K/V.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <initializer_list>

#include "simt.cuh"  // vector reads and writes, cp.async, row padding

namespace {

using namespace repro_torch::simt;

constexpr int kStream = 64;          // rows of a streamed tile (kernel_bwd.SIMT.tile)
constexpr int kThreads = 128;        // 8 row groups x 16 column groups
constexpr int kRowGroups = 8;
constexpr int kColGroups = 16;
constexpr int kCols = kStream / kColGroups;  // streamed rows of S a thread holds: cg + 16 i
constexpr float kNegInf = -1e30f;    // finite, as the reference's masks

template <typename T, int D, int R>
constexpr size_t smem_bytes() {
  // The resident tiles [R][D] (dQ: Q, dO; dK/dV: K, V) and the streamed
  // tiles [64][D + pad] (dQ: K, V; dK/dV: Q, dO) in T; dS^T or P^T
  // [64][R + 4] in fp32.
  return sizeof(T) * (2 * R * D + 2 * kStream * (D + kPad<T>)) +
         sizeof(float) * kStream * (R + 4);
}

// Rows [r0, r0 + rows) of one head of a [B, S, heads, D] tensor (first row
// at p, row stride rs) into shared memory (row stride ld) by 16-byte
// cp.async; rows past seq read as zeros.
template <typename T, int D, int rows>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* p, long long rs, int r0,
                                          int seq) {
  constexpr int kVec = 16 / sizeof(T);  // elements of one cp.async
  constexpr int kChunks = D / kVec;
  static_assert(D % kVec == 0, "head_dim");
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, col = (i % kChunks) * kVec;
    const bool ok = r0 + r < seq;
    cp_async16(dst + r * ld + col, p + (ok ? r0 + r : 0) * rs + col, ok);
  }
}

// s[r][i] = sum over d of A[r][d] B[cg + 16 i][d] for this thread's RM
// resident rows (a: the first, row stride lda) and its 4 streamed rows
// (b: the streamed tile, row stride ldb). The lanes cg and cg ^ 1 split d
// between them (4-value steps, alternating) and each computes both of the
// pair's row sets, (cg & ~1) + e + 16 i for e = 0, 1: RM x 8 partial sums
// from RM + 8 vectors a step (2.7 FMAs a shared word at RM = 4). Then each lane keeps
// e = cg & 1 and adds its partner's half of it (one shuffle a sum).
template <typename T, int D, int RM>
__device__ __forceinline__ void row_products(const T* a, int lda, const T* b, int ldb, int cg,
                                             float (&s)[RM][kCols]) {
  const int h = cg & 1;  // this lane's half of d: values 8 p + 4 h + [0, 4)
  a += 4 * h;
  b += (cg - h) * ldb + 4 * h;
  float part[RM][2][kCols];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < kCols; ++i) part[r][e][i] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 8) {
    float av[RM][4], bv[2][kCols][4];
#pragma unroll
    for (int r = 0; r < RM; ++r) load_vec<4>(a + r * lda + kk, av[r]);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < kCols; ++i) load_vec<4>(b + (e + kColGroups * i) * ldb + kk, bv[e][i]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int i = 0; i < kCols; ++i) part[r][e][i] = fmaf(av[r][q], bv[e][i][q], part[r][e][i]);
  }
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const float keep = h ? part[r][1][i] : part[r][0][i];
      const float give = h ? part[r][0][i] : part[r][1][i];
      s[r][i] = keep + __shfl_xor_sync(0xffffffffu, give, 1);
    }
}

// acc[r][n] += sum over the 64 streamed rows kk of X^T[kk][r] Y[kk][n]: xt
// points at this thread's resident rows in an fp32 [64][ldx] tile (dS^T or
// P^T, RM values a row read as one vector), y at its first column VW cg of
// a [64][ldy] tile whose columns it holds at VW cg + 16 VW jj + e.
template <typename T, int D, int RM>
__device__ __forceinline__ void accumulate(const float* xt, int ldx, const T* y, int ldy,
                                           float (&acc)[RM][D / kColGroups]) {
  constexpr int TN = D / kColGroups;
  constexpr int VW = TN < 4 ? TN : 4;
#pragma unroll 16
  for (int kk = 0; kk < kStream; ++kk) {
    float xa[RM], yb[TN];
    load_vec<RM>(xt + kk * ldx, xa);
#pragma unroll
    for (int jj = 0; jj < TN / VW; ++jj)
      load_vec<VW>(y + kk * ldy + kColGroups * VW * jj, yb + VW * jj);
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[r][n] = fmaf(xa[r], yb[n], acc[r][n]);
  }
}

// P = exp2(c S - LSE), S masked with -1e30, and dS = P (dP - delta) scale,
// in place of s and dp.
__device__ __forceinline__ void p_and_ds(float& s, float& dp, bool masked, float lse,
                                         float delta, float c, float scale) {
  const float p = exp2f(__fsub_rn(__fmul_rn(c, masked ? kNegInf : s), lse));
  dp = p * (dp - delta) * scale;
  s = p;
}

// One row of a register tile, x[n] for n = VW jj + e, written to a row of a
// [B, S, heads, D] tensor at p + 16 VW jj + e (p: the row's column VW cg).
template <typename T, int D>
__device__ __forceinline__ void store_row(T* p, const float (&x)[D / kColGroups]) {
  constexpr int TN = D / kColGroups;
  constexpr int VW = TN < 4 ? TN : 4;
#pragma unroll
  for (int jj = 0; jj < TN / VW; ++jj) {
    float out[VW];
#pragma unroll
    for (int e = 0; e < VW; ++e) out[e] = x[VW * jj + e];
    store_vec<VW>(p + kColGroups * VW * jj, out);
  }
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int heads,
                    int kv_heads, int seq_q, int seq_k, int q_offset,
                    long long q_bstride, long long k_bstride,
                    long long v_bstride, long long o_bstride,
                    long long do_bstride, int causal, float c, float scale) {
  constexpr int RM = BQ / kRowGroups;  // q rows a thread holds: 4 or 2
  constexpr int TN = D / kColGroups;   // dQ columns a thread holds
  constexpr int VW = TN < 4 ? TN : 4;  // ... read and written VW at a time
  constexpr int DP = D + kPad<T>;      // padded row of K and V
  constexpr int BQP = BQ + 4;          // padded row of dS^T
  static_assert(RM == 2 || RM == 4, "q tile of 16 or 32");
  static_assert(D % kColGroups == 0 && TN % VW == 0, "head_dim");

  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);                       // [BQ][D]
  T* sDO = sQ + BQ * D;                                     // [BQ][D]
  T* sK = sDO + BQ * D;                                     // [64][DP]
  T* sV = sK + kStream * DP;                                // [64][DP]
  float* sDS = reinterpret_cast<float*>(sV + kStream * DP);  // [64][BQP]: dS^T

  const int tid = threadIdx.x;
  const int g = tid / kColGroups;   // row group: q rows g * RM + r (warp w: 2w, 2w + 1)
  const int cg = tid % kColGroups;  // column group: keys cg + 16 i of S and dP
  // Heaviest first: block i takes q tile n_q - 1 - i / (B*H) of head i % (B*H).
  const int n_q = (seq_q + BQ - 1) / BQ;
  const int n_bh = gridDim.x / n_q;
  const int bh = blockIdx.x % n_bh;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x) / n_bh) * BQ;
  const int b = bh / heads, h = bh % heads;
  const int hk = h / (heads / kv_heads);
  const long long q_rs = static_cast<long long>(heads) * D;  // row strides
  const long long kv_rs = static_cast<long long>(kv_heads) * D;
  const long long head = static_cast<long long>(h) * D;
  const long long stats = static_cast<long long>(bh) * seq_q;  // row 0 of lse, delta
  const T* kp = k + b * k_bstride + static_cast<long long>(hk) * D;
  const T* vp = v + b * v_bstride + static_cast<long long>(hk) * D;

  load_rows<T, D, BQ>(sQ, D, q + b * q_bstride + head, q_rs, q0, seq_q);
  load_rows<T, D, BQ>(sDO, D, dout + b * do_bstride + head, q_rs, q0, seq_q);
  load_rows<T, D, kStream>(sV, DP, vp, kv_rs, 0, seq_k);
  cp_async_commit();

  // delta = rowsum(dO * O) and the LSE of this thread's rows, in registers:
  // the 16 lanes of a row group read one row's d columns from global
  // memory and sum them by shuffles within the warp.
  float lse_r[RM], delta_r[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = q0 + g * RM + r;
    float sum = 0.0f;
    if (row < seq_q) {
      const long long off = row * q_rs + head + VW * cg;
#pragma unroll
      for (int jj = 0; jj < TN / VW; ++jj) {
        float ov[VW], dov[VW];
        load_vec<VW>(o + b * o_bstride + off + kColGroups * VW * jj, ov);
        load_vec<VW>(dout + b * do_bstride + off + kColGroups * VW * jj, dov);
#pragma unroll
        for (int e = 0; e < VW; ++e) sum = fmaf(dov[e], ov[e], sum);
      }
    }
#pragma unroll
    for (int off = 1; off < kColGroups; off <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    delta_r[r] = sum;
    lse_r[r] = row < seq_q ? lse[stats + row] : 0.0f;
    if (cg == 0 && row < seq_q) delta[stats + row] = sum;
  }

  float acc[RM][TN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[r][n] = 0.0f;

  // Causal: keys at or past q0 + q_offset + BQ lie above the diagonal of
  // every row of this tile.
  const int k_end = causal ? min(seq_k, q0 + q_offset + BQ) : seq_k;
  const int n_k = (k_end + kStream - 1) / kStream;

  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * kStream;
    cp_async_wait();  // V tile j (with Q and dO at j = 0)
    __syncthreads();  // ... in every view; every warp is done with K tile j - 1 and dS^T
    load_rows<T, D, kStream>(sK, DP, kp, kv_rs, k0, seq_k);
    cp_async_commit();

    float dp[RM][kCols];
    row_products<T, D, RM>(sDO + g * RM * D, D, sV, DP, cg, dp);
    cp_async_wait();  // K tile j
    __syncthreads();  // K tile j in every view; every warp is done with V tile j
    if (j + 1 < n_k) load_rows<T, D, kStream>(sV, DP, vp, kv_rs, k0 + kStream, seq_k);
    cp_async_commit();

    float s[RM][kCols];
    row_products<T, D, RM>(sQ + g * RM * D, D, sK, DP, cg, s);
    // Only the diagonal and the ragged end need the mask.
    const bool edge = k0 + kStream > seq_k || (causal && k0 + kStream - 1 > q0 + q_offset);
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int col = k0 + cg + kColGroups * i;
      float ds[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int row = q0 + g * RM + r;
        const bool masked = edge && (col >= seq_k || (causal && row + q_offset < col));
        p_and_ds(s[r][i], dp[r][i], masked, lse_r[r], delta_r[r], c, scale);
        ds[r] = dp[r][i];
      }
      store_vec<RM>(sDS + (cg + kColGroups * i) * BQP + g * RM, ds);
    }
    __syncwarp();  // dS^T of this warp's rows: the warp alone reads them back

    // dQ += dS K for rows g * RM + r and columns VW cg + 16 VW jj + e.
    accumulate<T, D, RM>(sDS + g * RM, BQP, sK + VW * cg, DP, acc);
  }

  // dQ, written in [B, Sq, H, D] and T.
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = q0 + g * RM + r;
    if (row >= seq_q) continue;
    store_row<T, D>(dq + (static_cast<long long>(b) * seq_q + row) * q_rs + head + VW * cg, acc[r]);
  }
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int heads, int kv_heads, int seq_q,
                     int seq_k, int q_offset, long long q_bstride,
                     long long k_bstride, long long v_bstride,
                     long long do_bstride, int causal, float c, float scale) {
  constexpr int RK = BK / kRowGroups;  // keys a thread holds: 4 or 2
  constexpr int TN = D / kColGroups;   // dK, dV columns a thread holds
  constexpr int VW = TN < 4 ? TN : 4;  // ... read and written VW at a time
  constexpr int DP = D + kPad<T>;      // padded row of Q and dO
  constexpr int BKP = BK + 4;          // padded row of P^T and dS^T
  static_assert(RK == 2 || RK == 4, "k tile of 16 or 32");
  static_assert(D % kColGroups == 0 && TN % VW == 0, "head_dim");

  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);                        // [BK][D]
  T* sV = sK + BK * D;                                       // [BK][D]
  T* sQ = sV + BK * D;                                       // [64][DP]
  T* sDO = sQ + kStream * DP;                                // [64][DP]
  float* sPS = reinterpret_cast<float*>(sDO + kStream * DP);  // [64][BKP]: P^T, then dS^T

  const int tid = threadIdx.x;
  const int g = tid / kColGroups;   // row group: keys g * RK + r (warp w: 2w, 2w + 1)
  const int cg = tid % kColGroups;  // column group: q rows cg + 16 i of S^T and dP^T
  // Heaviest first: block i takes k tile i / (B*Hkv) of kv head i % (B*Hkv).
  const int n_k = (seq_k + BK - 1) / BK;
  const int n_bhk = gridDim.x / n_k;
  const int bhk = blockIdx.x % n_bhk;
  const int k0 = static_cast<int>(blockIdx.x) / n_bhk * BK;
  const int b = bhk / kv_heads, hk = bhk % kv_heads;
  const int rep = heads / kv_heads;
  const long long q_rs = static_cast<long long>(heads) * D;  // row strides
  const long long kv_rs = static_cast<long long>(kv_heads) * D;
  const long long kv_head = static_cast<long long>(hk) * D;

  // Causal: q rows before k0 - q_offset see none of this tile's keys. Tile
  // t is q tile i_start + t % per_head of q head hk * rep + t / per_head.
  const int n_q = (seq_q + kStream - 1) / kStream;
  const int i_start = causal ? min(n_q, max(0, k0 - q_offset) / kStream) : 0;
  const int per_head = n_q - i_start;
  const int n_tiles = rep * per_head;
  auto load_q_rows = [&](T* dst, const T* src, long long bstride, int t) {
    const long long h = hk * rep + t / per_head;
    load_rows<T, D, kStream>(dst, DP, src + b * bstride + h * D, q_rs,
                             (i_start + t % per_head) * kStream, seq_q);
  };

  float dk_acc[RK][TN], dv_acc[RK][TN];
#pragma unroll
  for (int r = 0; r < RK; ++r)
#pragma unroll
    for (int n = 0; n < TN; ++n) dk_acc[r][n] = dv_acc[r][n] = 0.0f;

  if (n_tiles > 0) {
    load_rows<T, D, BK>(sK, D, k + b * k_bstride + kv_head, kv_rs, k0, seq_k);
    load_rows<T, D, BK>(sV, D, v + b * v_bstride + kv_head, kv_rs, k0, seq_k);
    load_q_rows(sDO, dout, do_bstride, 0);
    cp_async_commit();
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int h = hk * rep + t / per_head;
    const int q0 = (i_start + t % per_head) * kStream;
    const long long stats = (static_cast<long long>(b) * heads + h) * seq_q;
    cp_async_wait();  // dO tile t (with K and V at t = 0)
    __syncthreads();  // ... in every view; every warp is done with Q tile t - 1
    load_q_rows(sQ, q, q_bstride, t);
    cp_async_commit();

    float lse_c[kCols], delta_c[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int row = q0 + cg + kColGroups * i;
      lse_c[i] = row < seq_q ? lse[stats + row] : 0.0f;
      delta_c[i] = row < seq_q ? delta[stats + row] : 0.0f;
    }

    float dp[RK][kCols];
    row_products<T, D, RK>(sV + g * RK * D, D, sDO, DP, cg, dp);
    cp_async_wait();  // Q tile t
    __syncthreads();  // Q tile t in every view
    float s[RK][kCols];
    row_products<T, D, RK>(sK + g * RK * D, D, sQ, DP, cg, s);

    // P^T and dS^T for keys g * RK + r and q rows cg + 16 i; only the
    // diagonal and the ragged end need the mask.
    const bool edge = k0 + BK > seq_k || (causal && k0 + BK - 1 > q0 + q_offset);
#pragma unroll
    for (int r = 0; r < RK; ++r) {
      const int key = k0 + g * RK + r;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int row = q0 + cg + kColGroups * i;
        const bool masked = edge && (key >= seq_k || (causal && row + q_offset < key));
        p_and_ds(s[r][i], dp[r][i], masked, lse_c[i], delta_c[i], c, scale);
      }
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      float col[RK];
#pragma unroll
      for (int r = 0; r < RK; ++r) col[r] = s[r][i];
      store_vec<RK>(sPS + (cg + kColGroups * i) * BKP + g * RK, col);
    }
    __syncwarp();  // P^T of this warp's keys: the warp alone reads them back
    // dV += P^T dO for keys g * RK + r and columns VW cg + 16 VW jj + e.
    accumulate<T, D, RK>(sPS + g * RK, BKP, sDO + VW * cg, DP, dv_acc);
    __syncwarp();  // every lane of the warp is done with P^T
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      float col[RK];
#pragma unroll
      for (int r = 0; r < RK; ++r) col[r] = dp[r][i];
      store_vec<RK>(sPS + (cg + kColGroups * i) * BKP + g * RK, col);
    }
    __syncthreads();  // dS^T in view; every warp is done with dO tile t
    if (t + 1 < n_tiles) load_q_rows(sDO, dout, do_bstride, t + 1);
    cp_async_commit();
    // dK += dS^T Q.
    accumulate<T, D, RK>(sPS + g * RK, BKP, sQ + VW * cg, DP, dk_acc);
  }

  // dK and dV, written in [B, Sk, Hkv, D] and T (zeros where no q row sees
  // the tile).
#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int key = k0 + g * RK + r;
    if (key >= seq_k) continue;
    const long long off = (static_cast<long long>(b) * seq_k + key) * kv_rs + kv_head + VW * cg;
    store_row<T, D>(dk + off, dk_acc[r]);
    store_row<T, D>(dv + off, dv_acc[r]);
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

template <bool kDq, typename T, int D, int R>
auto kernel_of() {
  if constexpr (kDq)
    return flash_bwd_dq_kernel<T, D, R>;
  else
    return flash_bwd_dkv_kernel<T, D, R>;
}

// Shared memory above 48 KB, and the largest shared-memory carveout, so
// that two CTAs share an SM.
template <bool kDq, typename T, int D, int R>
cudaError_t configure() {
  const auto fn = kernel_of<kDq, T, D, R>();
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes<T, D, R>()));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

struct Launch {
  const Args& a;

  template <bool kDq, typename T, int D, int R>
  cudaError_t run() const {
    cudaError_t err = configure<kDq, T, D, R>();
    if (err != cudaSuccess) return err;
    const int tiles = ((kDq ? a.seq_q : a.seq_k) + R - 1) / R;
    const long long blocks =
        static_cast<long long>(tiles) * a.batch * (kDq ? a.heads : a.kv_heads);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    const auto grid = static_cast<unsigned>(blocks);
    constexpr size_t smem = smem_bytes<T, D, R>();
    const auto* q = static_cast<const T*>(a.q);
    const auto* k = static_cast<const T*>(a.k);
    const auto* v = static_cast<const T*>(a.v);
    const auto* dout = static_cast<const T*>(a.dout);
    const auto* lse = static_cast<const float*>(a.lse);
    if constexpr (kDq) {
      flash_bwd_dq_kernel<T, D, R><<<grid, kThreads, smem, a.stream>>>(
          q, k, v, static_cast<const T*>(a.o), dout, lse, static_cast<float*>(a.delta),
          static_cast<T*>(a.dq), a.heads, a.kv_heads, a.seq_q, a.seq_k, a.q_offset,
          a.q_bstride, a.k_bstride, a.v_bstride, a.o_bstride, a.do_bstride, a.causal,
          a.c, a.scale);
    } else {
      flash_bwd_dkv_kernel<T, D, R><<<grid, kThreads, smem, a.stream>>>(
          q, k, v, dout, lse, static_cast<const float*>(a.delta), static_cast<T*>(a.dk),
          static_cast<T*>(a.dv), a.heads, a.kv_heads, a.seq_q, a.seq_k, a.q_offset,
          a.q_bstride, a.k_bstride, a.v_bstride, a.do_bstride, a.causal, a.c, a.scale);
    }
    return cudaGetLastError();
  }
};

struct Occupancy {
  int* ctas;

  template <bool kDq, typename T, int D, int R>
  cudaError_t run() const {
    cudaError_t err = configure<kDq, T, D, R>();
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, kernel_of<kDq, T, D, R>(), kThreads, smem_bytes<T, D, R>());
  }
};

template <bool kDq, typename T, int D, typename Op>
cudaError_t dispatch_tile(int tile, const Op& op) {
  if (tile == 32) return op.template run<kDq, T, D, 32>();
  if (tile == 16) return op.template run<kDq, T, D, 16>();
  return cudaErrorInvalidValue;
}

template <bool kDq, typename Op>
cudaError_t dispatch(int dtype, int head_dim, int tile, const Op& op) {
  using bf16 = __nv_bfloat16;
  // fp32 at d 16 to 128; bf16 at d 16 and 32 (d 64 and 128: flash_bwd_sm90.cu).
  switch (dtype * 1000 + head_dim) {
    case 16: return dispatch_tile<kDq, float, 16>(tile, op);
    case 32: return dispatch_tile<kDq, float, 32>(tile, op);
    case 64: return dispatch_tile<kDq, float, 64>(tile, op);
    case 128: return dispatch_tile<kDq, float, 128>(tile, op);
    case 1016: return dispatch_tile<kDq, bf16, 16>(tile, op);
    case 1032: return dispatch_tile<kDq, bf16, 32>(tile, op);
    default: return cudaErrorInvalidValue;
  }
}

// cudaErrorInvalidValue for shapes the kernels do not take,
// cudaErrorMisalignedAddress where a 16-byte cp.async or vector access could
// not read or write a tensor; cudaSuccess otherwise.
cudaError_t check(const Args& a, int dtype) {
  if (a.batch < 1 || a.heads < 1 || a.kv_heads < 1 || a.heads % a.kv_heads != 0 ||
      a.seq_q < 1 || a.seq_k < 1 || a.q_offset < 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const long long size = dtype == 0 ? 4 : 2;
  for (const void* p : {a.q, a.k, a.v, a.dout, a.o, static_cast<const void*>(a.dq),
                        static_cast<const void*>(a.dk), static_cast<const void*>(a.dv)})
    if (!aligned16(p)) return cudaErrorMisalignedAddress;  // null is aligned
  for (long long stride : {a.q_bstride, a.k_bstride, a.v_bstride, a.o_bstride, a.do_bstride})
    if ((stride * size) % 16) return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

}  // namespace

// C entry points, bound with ctypes. q, o, dout [B, Sq, H, D] and k, v
// [B, Sk, Hkv, D] with dense inner dims, 16-byte aligned bases and batch
// strides of whole 16-byte units; lse and delta [B*H, Sq] fp32; dq
// [B, Sq, H, D], dk and dv [B, Sk, Hkv, D] dense and 16-byte aligned.
// dtype: 0 float32 (D 16 to 128), 1 bfloat16 (D 16 or 32). c = scale *
// log2(e). block_q: the q tile of dQ, block_k: the k tile of dK/dV, each 16
// or 32 (kernel_bwd.simt_bwd_tiles). Each returns a cudaError_t.
// flash_bwd_dq writes delta, which flash_bwd_dkv reads: launch them in that
// order on one stream.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* delta, void* dq, int dtype, int batch,
                            int heads, int kv_heads, int seq_q, int seq_k,
                            int head_dim, long long q_bstride,
                            long long k_bstride, long long v_bstride,
                            long long o_bstride, long long do_bstride,
                            int q_offset, int causal, float c, float scale,
                            void* stream, int block_q) {
  const Args a{q, k, v, o, dout, lse, delta, dq, nullptr, nullptr,
               batch, heads, kv_heads, seq_q, seq_k, q_offset, causal,
               q_bstride, k_bstride, v_bstride, o_bstride, do_bstride,
               c, scale, static_cast<cudaStream_t>(stream)};
  const cudaError_t err = check(a, dtype);
  return err != cudaSuccess ? err : dispatch<true>(dtype, head_dim, block_q, Launch{a});
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int dtype,
                             int batch, int heads, int kv_heads, int seq_q,
                             int seq_k, int head_dim, long long q_bstride,
                             long long k_bstride, long long v_bstride,
                             long long do_bstride, int q_offset, int causal,
                             float c, float scale, void* stream, int block_k) {
  const Args a{q, k, v, nullptr, dout, lse, const_cast<void*>(delta), nullptr, dk, dv,
               batch, heads, kv_heads, seq_q, seq_k, q_offset, causal,
               q_bstride, k_bstride, v_bstride, 0, do_bstride,
               c, scale, static_cast<cudaStream_t>(stream)};
  const cudaError_t err = check(a, dtype);
  return err != cudaSuccess ? err : dispatch<false>(dtype, head_dim, block_k, Launch{a});
}

// CTAs of one kernel instantiation that an SM holds at once (written to
// *ctas): dq 1 for flash_bwd_dq_kernel, 0 for flash_bwd_dkv_kernel; tile 16
// or 32. Returns a cudaError_t.
extern "C" int flash_bwd_ctas_per_sm(int dq, int dtype, int head_dim, int tile, int* ctas) {
  const Occupancy op{ctas};
  return dq ? dispatch<true>(dtype, head_dim, tile, op) : dispatch<false>(dtype, head_dim, tile, op);
}
