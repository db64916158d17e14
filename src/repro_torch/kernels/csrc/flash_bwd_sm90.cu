// FlashAttention-2 backward for Hopper, sm_90a: bf16 inputs, head width 64
// or 128, on the tensor cores. Two kernels, dQ and dK/dV.
//
// Replaces the Pallas TPU kernels `_dq_kernel` (with `_mask_bias`) and
// `_dkv_kernel` (src/repro/kernels/flash_attention/kernel_bwd.py:48, :34
// and :81, launched by `flash_attention_bwd` at kernel_bwd.py:167 and :185)
// for bf16 inputs at d 64 and 128; fp32 inputs and bf16 at d 16 or 32 stay
// on the SIMT kernels of flash_bwd.cu. From the forward's base-2 LSE
// (c = scale log2 e) they compute
//
//   S  = Q K^T,  dP = dO V^T      fp32 accumulation of exact bf16 products;
//   mask padded keys and (causal) keys past row + q_offset with -1e30;
//   P  = exp2(c S - LSE)          the exact exp2f, also after a PWL forward;
//                                 c S - LSE rounded as a product then a
//                                 difference, as the plain version does;
//   dS = P (dP - delta) scale,    delta = rowsum(dO * O);
//   dQ = bf16(dS) K;  dK = bf16(dS)^T Q;  dV = bf16(P)^T dO   (fp32 sums,
//                                 each gradient rounded to bf16 once).
//
// P and dS are computed in fp32 from the fp32 S and dP and rounded to bf16
// only as operands of the products, as wgmma takes them (FlashAttention-2
// and -3 do the same); the plain twin in kernel_bwd.py rounds them at the
// same places. The reference keeps them in fp32 (ROADMAP queue 3,
// departure (e)).
//
// What bounds it on the H100. The five products (S, dP, dV, dQ, dK) do
// 10 d operations per causal pair and head against 8 [B, S, H, d] bf16
// tensors read or written once: at S = 2048, d = 128 about 640 operations a
// byte, above the card's ~295, so the tensor cores bound it (989 TFLOP/s
// bf16). The SIMT kernels of flash_bwd.cu reached ~18 TFLOP/s: fp32 FMAs on
// the CUDA cores, scalar loads of padded fp32 tiles between block-wide
// barriers, no overlap of loads with compute.
//
// Design. Two deterministic kernels, as the SIMT pair: dQ first (it also
// writes delta and a padded copy of the LSE), then dK/dV; neither writes
// what another CTA writes, so there are no atomics and no partial buffers,
// and a GQA group's dK/dV are summed in fp32 and rounded once (departure
// (b)). The price is S and dP computed in both: 7 products executed
// against the 5 that count. Each kernel has the forward's shape
// (flash_fwd_sm90.cu): a persistent grid of one CTA an SM walking its work
// tiles heaviest first, in an order that snakes across the CTAs; a
// producer warpgroup whose one thread issues TMA loads (4-D tensor maps
// over [B, S, H, d], 128-byte swizzle) through a ring of kStages stages
// with full and empty mbarriers and gives its registers away (setmaxnreg);
// two consumer warpgroups of 64 rows each, which run independently:
//   * flash_bwd_sm90_dq_kernel: a work tile is one (b*h, 128-row q tile):
//     its Q, dO and O, then 64-key K and V tiles streamed by the producer.
//     S = Q K^T and dP = dO V^T are m64n64 wgmma with both operands K-major
//     in shared memory; dS is formed in registers and is the A operand of
//     dQ += dS K (m64nD, K read MN-major), as the forward's P is of P V.
//     While a work tile's first S and dP run, each consumer sums delta for
//     its 64 rows from dO and O in shared memory (a warp's 16 rows are its
//     own accumulator rows, so the sums stay in registers) and writes
//     delta and the LSE, padded with +inf, for the dK/dV kernel. (Summed
//     from global memory before the first products, delta held up every
//     work tile; PERF.md.)
//   * flash_bwd_sm90_dkv_kernel: a work tile is one (b, kv head, 128-key
//     tile), keys of the lowest tiles (most q tiles under the causal mask)
//     first. Its K and V stay in shared memory; the producer streams 64-row
//     Q and dO tiles with their LSE and delta rows (bulk copies) over the
//     rep q heads of the GQA group, from the diagonal down. Each consumer
//     owns 64 keys: S^T = K Q^T and dP^T = V dO^T (m64n64, K-major), P^T
//     and dS^T in registers as the A operands of dV += P^T dO and
//     dK += dS^T Q (dO and Q read MN-major). Per consumer thread dK and dV
//     take 2 x D / 2 registers and S^T and dP^T 2 x 32: the 64-row q tile
//     keeps that within the 240 of setmaxnreg.
// Rows past Sq and keys past Sk arrive as TMA zeros. Padded keys are masked
// in dQ; in dK/dV only their own (unwritten) rows would see them. Padded q
// rows carry the LSE +inf, so their P is exp2(-inf) = 0 and their dS 0.
// Only tiles that cross the causal diagonal or the ragged end are masked;
// a consumer skips the products of a tile it cannot see (all masked), but
// still waits on and releases its stage, so the rings' phases stay paired.

#include <cuda.h>  // CUtensorMap and its enums; libcuda is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"  // mbarriers, TMA, wgmma, tensor maps

namespace {

using namespace repro_torch::sm90;

constexpr int kConsumers = 2;            // warpgroups of 64 rows
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kStages = 2;               // the ring of streamed tiles
constexpr int kTile = 64;                // q rows of a Q or dO tile streamed to dK/dV
constexpr int kBlock = 64 * kConsumers;  // rows of a work tile: q rows (dQ), keys (dK/dV)
constexpr int kDqKeys = 64;              // keys of a K or V tile streamed to dQ
static_assert(kDqKeys == 64, "dQ's S and dP are m64n64 products");
constexpr float kNegInf = -1e30f;        // finite, as the reference's masks

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// CTA blockIdx.x of gridDim.x takes work tiles x, then 2G - 1 - x, then
// 2G + x, ... (G CTAs): tile i of this CTA is work tile work_id(i).
__device__ __forceinline__ int work_id(int i) {
  const int x = static_cast<int>(blockIdx.x), n = static_cast<int>(gridDim.x);
  return i * n + ((i & 1) ? n - 1 - x : x);
}

// P and dS of one element from its S and dP, as the plain version rounds
// them: exp2(c S - lse) with the product and the difference rounded apart.
__device__ __forceinline__ float2 p_ds(float s, float dp, float lse, float delta, float c, float scale) {
  const float p = exp2f(__fsub_rn(__fmul_rn(c, s), lse));
  return make_float2(p, p * (dp - delta) * scale);
}

// The 64 x D product of a consumer's bf16 accumulator rows, rows r_a and
// r_b (= r_a + 8) of [B, S, H, d] rows at `out` (row stride `rs`), written
// where the row is below `seq`.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long rs, int r_a, int seq, int col0,
                                           const float (&acc)[D / 2]) {
  __nv_bfloat16* a = out + static_cast<long long>(r_a) * rs;
  __nv_bfloat16* b = a + 8 * rs;
#pragma unroll
  for (int g = 0; g < D / 8; ++g) {
    const int col = 8 * g + col0;
    if (r_a < seq)
      *reinterpret_cast<__nv_bfloat162*>(a + col) = __floats2bfloat162_rn(acc[4 * g], acc[4 * g + 1]);
    if (r_a + 8 < seq)
      *reinterpret_cast<__nv_bfloat162*>(b + col) = __floats2bfloat162_rn(acc[4 * g + 2], acc[4 * g + 3]);
  }
}

// -- dQ ---------------------------------------------------------------------------

// Shared memory of the dQ kernel, from a 1024-byte aligned base.
template <int D>
struct DqSmem {
  static constexpr int kQBytes = kBlock * D * 2;  // Q, dO or O of the work tile
  static constexpr int kKBytes = kDqKeys * D * 2;  // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kQBytes;
  static constexpr int kO = kDO + kQBytes;
  static constexpr int kK = kO + kQBytes;
  static constexpr int kV = kK + kStages * kKBytes;
  static constexpr int kBars = kV + kStages * kKBytes;
  static constexpr int kNumBars = 2 + 3 * kStages;  // qd_full, qd_empty, k_full, v_full, kv_empty
  static constexpr int kBytes = kBars + 8 * kNumBars;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

// One row's delta = rowsum(dO * O) over a swizzled [rows][64]-column-block
// tile pair in shared memory (row `r` of the tile): lane l sums columns
// 2l, 2l + 1 of each column block (16-byte chunk l / 4 of the row, moved by
// the 128-byte swizzle to chunk (l / 4) ^ (r % 8)), then a butterfly leaves
// the sum in every lane. Rows past Sq are TMA zeros, so their sum is 0.
template <int D>
__device__ __forceinline__ float row_delta(const uint8_t* s_do, const uint8_t* s_o, int r, int lane) {
  const int off = r * kRowBytes + (((lane / 4) ^ (r % 8)) * 16) + (lane % 4) * 4;
  float sum = 0.0f;
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) {
    const float2 dv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s_do + cb * kBlock * kRowBytes + off));
    const float2 ov = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s_o + cb * kBlock * kRowBytes + off));
    sum = fmaf(dv.x, ov.x, sum);
    sum = fmaf(dv.y, ov.y, sum);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  return sum;
}

struct DqWork {
  int b, h, hk, bh, q0, n_k;
};

// Work tile w, the last q tiles (most keys under the causal mask) of every
// head first; n_k k tiles, those wholly above the causal diagonal skipped.
__device__ __forceinline__ DqWork dq_work(int w, int n_q, int n_bh, int heads, int kv_heads, int seq_k,
                                          int q_offset, int causal) {
  DqWork t;
  t.bh = w % n_bh;
  t.b = t.bh / heads;
  t.h = t.bh % heads;
  t.hk = t.h / (heads / kv_heads);
  t.q0 = (n_q - 1 - w / n_bh) * kBlock;
  const int k_end = causal ? min(seq_k, t.q0 + q_offset + kBlock) : seq_k;
  t.n_k = (k_end + kDqKeys - 1) / kDqKeys;
  return t;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_sm90_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_o, const float* __restrict__ lse,
                         float* __restrict__ delta, float* __restrict__ lse_pad, __nv_bfloat16* __restrict__ dq,
                         int batch, int heads, int kv_heads, int seq_q, int seq_k, int q_offset, int causal,
                         float c, float scale) {
  using L = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t s_q = base + L::kQ, s_do = base + L::kDO, s_o = base + L::kO;
  const uint32_t s_k = base + L::kK, s_v = base + L::kV;
  const uint32_t qd_full = base + L::kBars, qd_empty = qd_full + 8;
  auto k_full = [&](int s) { return qd_full + 8 * (2 + s); };
  auto v_full = [&](int s) { return qd_full + 8 * (2 + kStages + s); };
  auto kv_empty = [&](int s) { return qd_full + 8 * (2 + 2 * kStages + s); };

  const int n_q = (seq_q + kBlock - 1) / kBlock, n_bh = batch * heads;
  const int n_work = n_q * n_bh, seq_q_pad = n_q * kBlock;
  auto work = [&](int w) { return dq_work(w, n_q, n_bh, heads, kv_heads, seq_k, q_offset, causal); };

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(qd_full, 1);
    mbar_init(qd_empty, 4 * kConsumers);  // one arrive per consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(kv_empty(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // Producer warpgroup. Each barrier's round r waits for the consumers'
    // release of round r - 1 (round 0 passes at once); `it` counts the k
    // tiles of all this CTA's work tiles, so the ring runs on across them.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 0) {
      int it = 0;
      for (int i = 0; work_id(i) < n_work; ++i) {
        const DqWork t = work(work_id(i));
        mbar_wait(qd_empty, (i & 1) ^ 1);
        mbar_expect_tx(qd_full, 3 * L::kQBytes);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb) {
          tma_load(s_q + cb * kBlock * kRowBytes, &tm_q, qd_full, 64 * cb, t.h, t.q0, t.b);
          tma_load(s_do + cb * kBlock * kRowBytes, &tm_do, qd_full, 64 * cb, t.h, t.q0, t.b);
          tma_load(s_o + cb * kBlock * kRowBytes, &tm_o, qd_full, 64 * cb, t.h, t.q0, t.b);
        }
        for (int j = 0; j < t.n_k; ++j, ++it) {
          const int s = it % kStages;
          mbar_wait(kv_empty(s), ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(k_full(s), L::kKBytes);
#pragma unroll
          for (int cb = 0; cb < D / 64; ++cb)
            tma_load(s_k + s * L::kKBytes + cb * kDqKeys * kRowBytes, &tm_k, k_full(s), 64 * cb, t.hk,
                     j * kDqKeys, t.b);
          mbar_expect_tx(v_full(s), L::kKBytes);
#pragma unroll
          for (int cb = 0; cb < D / 64; ++cb)
            tma_load(s_v + s * L::kKBytes + cb * kDqKeys * kRowBytes, &tm_v, v_full(s), 64 * cb, t.hk,
                     j * kDqKeys, t.b);
        }
      }
    }
  } else {
    // Consumer warpgroups: rows wq * 64 .. wq * 64 + 63 of each q tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int wq = tid / 128 - 1;
    const int t_id = tid % 128, warp = t_id / 32, lane = t_id % 32;
    // This thread's rows (local to the q tile) and first column of each
    // 8-column group of a wgmma accumulator.
    const int row_a = wq * 64 + warp * 16 + lane / 4, row_b = row_a + 8;
    const int col0 = 2 * (lane % 4);
    const long long q_rs = static_cast<long long>(heads) * D;  // row stride of dq
    int it = 0;
    for (int i = 0; work_id(i) < n_work; ++i) {
      const DqWork t = work(work_id(i));
      const int qa = t.q0 + row_a, qb = t.q0 + row_b;

      // The LSE of this thread's rows (+inf past Sq, where P is then 0),
      // loaded early; delta follows from the tile in shared memory.
      const long long row0 = static_cast<long long>(t.bh) * seq_q;
      const float lse_a = qa < seq_q ? lse[row0 + qa] : pos_inf();
      const float lse_b = qb < seq_q ? lse[row0 + qb] : pos_inf();
      float delta_a = 0.0f, delta_b = 0.0f;

      float acc[D / 2];
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc[e] = 0.0f;

      mbar_wait(qd_full, i & 1);
      for (int j = 0; j < t.n_k; ++j, ++it) {
        const int s = it % kStages;
        const uint32_t parity = (it / kStages) & 1;
        const int k0 = j * kDqKeys;
        if (causal && k0 > t.q0 + wq * 64 + 63 + q_offset) {
          // This consumer's rows see none of this tile's keys (causal):
          // take the stage and release it.
          mbar_wait(k_full(s), parity);
          mbar_wait(v_full(s), parity);
          __syncwarp();
          if (lane == 0) {
            if (j == t.n_k - 1) mbar_arrive(qd_empty);
            mbar_arrive(kv_empty(s));
          }
          continue;
        }

        // S = Q K^T and dP = dO V^T: 64 x kDqKeys each, D / 16 steps of 16.
        float sc[kDqKeys / 2], dp[kDqKeys / 2];
        mbar_wait(k_full(s), parity);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * kBlock * kRowBytes + wq * 64 * kRowBytes + (kk % 4) * 32;
          const uint32_t koff = s * L::kKBytes + (kk / 4) * kDqKeys * kRowBytes + (kk % 4) * 32;
          wgmma_ss_n64(sc, desc_sw128(s_q + off, 16, 1024), desc_sw128(s_k + koff, 16, 1024), kk > 0);
        }
        wgmma_commit();
        mbar_wait(v_full(s), parity);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * kBlock * kRowBytes + wq * 64 * kRowBytes + (kk % 4) * 32;
          const uint32_t voff = s * L::kKBytes + (kk / 4) * kDqKeys * kRowBytes + (kk % 4) * 32;
          wgmma_ss_n64(dp, desc_sw128(s_do + off, 16, 1024), desc_sw128(s_v + voff, 16, 1024), kk > 0);
        }
        wgmma_commit();
        if (j == 0) {
          // While the tile's first products run: delta = rowsum(dO * O) over
          // the warp's 16 rows (its own accumulator rows), and delta and the
          // LSE, padded to whole q tiles, for the dK/dV kernel.
          const uint8_t* s_do_p = smem + L::kDO;
          const uint8_t* s_o_p = smem + L::kO;
#pragma unroll
          for (int rr = 0; rr < 16; ++rr) {
            const float sum = row_delta<D>(s_do_p, s_o_p, wq * 64 + warp * 16 + rr, lane);
            if (rr == lane / 4) delta_a = sum;
            if (rr == lane / 4 + 8) delta_b = sum;
          }
          if (lane % 4 == 0) {
            const long long pad0 = static_cast<long long>(t.bh) * seq_q_pad;
            delta[pad0 + qa] = delta_a;
            delta[pad0 + qb] = delta_b;
            lse_pad[pad0 + qa] = lse_a;
            lse_pad[pad0 + qb] = lse_b;
          }
        }
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(dp);
        if (j == t.n_k - 1) {  // the producer may load the next work tile's Q, dO and O
          __syncwarp();
          if (lane == 0) mbar_arrive(qd_empty);
        }

        // Accumulator element e sits at row qa (+8 if bit 1 of e: qb) and
        // key k0 + 8 (e / 4) + col0 + (e & 1).
        const bool ragged = k0 + kDqKeys > seq_k;
        const bool diagonal = causal && k0 + kDqKeys - 1 > t.q0 + wq * 64 + q_offset;
        if (ragged || diagonal) {
#pragma unroll
          for (int e = 0; e < kDqKeys / 2; ++e) {
            const int key = k0 + 8 * (e / 4) + col0 + (e & 1);
            const int row = (e & 2) ? qb : qa;
            if (key >= seq_k || (causal && row + q_offset < key)) sc[e] = kNegInf;
          }
        }

        // dS in bf16 as wgmma A fragments: keys 16 kk .. 16 kk + 15 are
        // accumulator elements 8 kk .. 8 kk + 7, already in fragment order.
        uint32_t da[kDqKeys / 16][4];
#pragma unroll
        for (int kk = 0; kk < kDqKeys / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int e = 8 * kk + 2 * r;
            const float l = (e & 2) ? lse_b : lse_a, dl = (e & 2) ? delta_b : delta_a;
            const float2 x = p_ds(sc[e], dp[e], l, dl, c, scale);
            const float2 y = p_ds(sc[e + 1], dp[e + 1], l, dl, c, scale);
            da[kk][r] = pack_bf16(x.y, y.y);
          }

        // dQ += dS K: K [keys][d] is MN-major; kDqKeys / 16 steps of 16 keys.
        fence_regs(acc);
        fence_regs(da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDqKeys / 16; ++kk)
          wgmma_rs<D>(acc, da[kk],
                      desc_sw128(s_k + s * L::kKBytes + kk * 16 * kRowBytes, kDqKeys * kRowBytes, 1024));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(kv_empty(s));
      }

      store_rows<D>(dq + static_cast<long long>(t.b) * seq_q * q_rs + static_cast<long long>(t.h) * D, q_rs,
                    qa, seq_q, col0, acc);
    }
  }
}

// -- dK/dV --------------------------------------------------------------------------

// Shared memory of the dK/dV kernel, from a 1024-byte aligned base.
template <int D>
struct DkvSmem {
  static constexpr int kKBytes = kBlock * D * 2;  // K or V of the work tile
  static constexpr int kQBytes = kTile * D * 2;   // one Q or dO tile
  static constexpr int kRowBytes32 = kTile * 4;   // one tile's LSE or delta (fp32)
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKBytes;
  static constexpr int kQ = kV + kKBytes;
  static constexpr int kDO = kQ + kStages * kQBytes;
  static constexpr int kLse = kDO + kStages * kQBytes;
  static constexpr int kDelta = kLse + kStages * kRowBytes32;
  static constexpr int kBars = kDelta + kStages * kRowBytes32;
  static constexpr int kNumBars = 2 + 3 * kStages;  // kv_full, kv_empty, q_full, do_full, q_empty
  static constexpr int kBytes = kBars + 8 * kNumBars;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

struct DkvWork {
  int b, hk, k0, i0;  // i0: the first q tile that sees a key of the tile
};

// Work tile w, the lowest key tiles (the most q tiles under the causal
// mask) of every (b, kv head) first.
__device__ __forceinline__ DkvWork dkv_work(int w, int n_bhk, int kv_heads, int q_offset, int causal) {
  DkvWork t;
  const int bhk = w % n_bhk;
  t.b = bhk / kv_heads;
  t.hk = bhk % kv_heads;
  t.k0 = (w / n_bhk) * kBlock;
  t.i0 = causal ? max(0, t.k0 - q_offset) / kTile : 0;  // q rows before k0 - q_offset see none
  return t;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_sm90_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse_pad, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int batch,
                          int heads, int kv_heads, int seq_q, int seq_k, int q_offset, int causal, float c,
                          float scale) {
  using L = DkvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t s_k = base + L::kK, s_v = base + L::kV, s_q = base + L::kQ, s_do = base + L::kDO;
  const uint32_t s_lse = base + L::kLse, s_delta = base + L::kDelta;
  const uint32_t kv_full = base + L::kBars, kv_empty = kv_full + 8;
  auto q_full = [&](int s) { return kv_full + 8 * (2 + s); };
  auto do_full = [&](int s) { return kv_full + 8 * (2 + kStages + s); };
  auto q_empty = [&](int s) { return kv_full + 8 * (2 + 2 * kStages + s); };

  const int rep = heads / kv_heads;
  const int n_qt = (seq_q + kTile - 1) / kTile;
  const int seq_q_pad = (seq_q + kBlock - 1) / kBlock * kBlock;  // rows of lse_pad and delta
  const int n_bhk = batch * kv_heads;
  const int n_work = (seq_k + kBlock - 1) / kBlock * n_bhk;
  auto work = [&](int w) { return dkv_work(w, n_bhk, kv_heads, q_offset, causal); };

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 4 * kConsumers);  // one arrive per consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(q_full(s), 1);
      mbar_init(do_full(s), 1);
      mbar_init(q_empty(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // Producer warpgroup: each work tile's K and V, then its q tiles' Q
    // with the LSE and dO with delta through the ring (`it` runs on across
    // work tiles).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 0) {
      int it = 0;
      for (int i = 0; work_id(i) < n_work; ++i) {
        const DkvWork t = work(work_id(i));
        mbar_wait(kv_empty, (i & 1) ^ 1);
        mbar_expect_tx(kv_full, 2 * L::kKBytes);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb) {
          tma_load(s_k + cb * kBlock * kRowBytes, &tm_k, kv_full, 64 * cb, t.hk, t.k0, t.b);
          tma_load(s_v + cb * kBlock * kRowBytes, &tm_v, kv_full, 64 * cb, t.hk, t.k0, t.b);
        }
        for (int hh = 0; hh < rep; ++hh) {
          const int h = t.hk * rep + hh;
          const long long row0 = (static_cast<long long>(t.b) * heads + h) * seq_q_pad;
          for (int qi = t.i0; qi < n_qt; ++qi, ++it) {
            const int s = it % kStages;
            mbar_wait(q_empty(s), ((it / kStages) & 1) ^ 1);
            mbar_expect_tx(q_full(s), L::kQBytes + L::kRowBytes32);
#pragma unroll
            for (int cb = 0; cb < D / 64; ++cb)
              tma_load(s_q + s * L::kQBytes + cb * kTile * kRowBytes, &tm_q, q_full(s), 64 * cb, h,
                       qi * kTile, t.b);
            bulk_load(s_lse + s * L::kRowBytes32, lse_pad + row0 + qi * kTile, L::kRowBytes32, q_full(s));
            mbar_expect_tx(do_full(s), L::kQBytes + L::kRowBytes32);
#pragma unroll
            for (int cb = 0; cb < D / 64; ++cb)
              tma_load(s_do + s * L::kQBytes + cb * kTile * kRowBytes, &tm_do, do_full(s), 64 * cb, h,
                       qi * kTile, t.b);
            bulk_load(s_delta + s * L::kRowBytes32, delta + row0 + qi * kTile, L::kRowBytes32, do_full(s));
          }
        }
      }
    }
  } else {
    // Consumer warpgroups: keys wq * 64 .. wq * 64 + 63 of each key tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int wq = tid / 128 - 1;
    const int t_id = tid % 128, warp = t_id / 32, lane = t_id % 32;
    // This thread's keys (local to the consumer's 64) and first q column of
    // each 8-column group of a wgmma accumulator.
    const int row_a = warp * 16 + lane / 4, row_b = row_a + 8;
    const int col0 = 2 * (lane % 4);
    const float* lse_s = reinterpret_cast<const float*>(smem + L::kLse);
    const float* delta_s = reinterpret_cast<const float*>(smem + L::kDelta);
    int it = 0;
    for (int i = 0; work_id(i) < n_work; ++i) {
      const DkvWork t = work(work_id(i));
      const int kc0 = t.k0 + wq * 64;  // this consumer's first key
      const int ka = kc0 + row_a, kb = kc0 + row_b;
      float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
      for (int e = 0; e < D / 2; ++e) dk_acc[e] = dv_acc[e] = 0.0f;

      mbar_wait(kv_full, i & 1);
      if (t.i0 >= n_qt) {  // no q row sees these keys: dK = dV = 0
        __syncwarp();
        if (lane == 0) mbar_arrive(kv_empty);
      }
      for (int hh = 0; hh < rep; ++hh) {
        for (int qi = t.i0; qi < n_qt; ++qi, ++it) {
          const int s = it % kStages;
          const uint32_t parity = (it / kStages) & 1;
          const int q0 = qi * kTile;
          const bool last = hh == rep - 1 && qi == n_qt - 1;  // K and V are read no more after it
          if ((causal && q0 + kTile - 1 + q_offset < kc0) || kc0 >= seq_k) {
            // No row of this q tile sees a key of this consumer (causal),
            // or all its keys are padding: take the stage and release it.
            mbar_wait(q_full(s), parity);
            mbar_wait(do_full(s), parity);
            __syncwarp();
            if (lane == 0) {
              if (last) mbar_arrive(kv_empty);
              mbar_arrive(q_empty(s));
            }
            continue;
          }

          // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 q rows each.
          float st[32], dpt[32];
          mbar_wait(q_full(s), parity);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t koff = (kk / 4) * kBlock * kRowBytes + wq * 64 * kRowBytes + (kk % 4) * 32;
            const uint32_t qoff = s * L::kQBytes + (kk / 4) * kTile * kRowBytes + (kk % 4) * 32;
            wgmma_ss_n64(st, desc_sw128(s_k + koff, 16, 1024), desc_sw128(s_q + qoff, 16, 1024), kk > 0);
          }
          wgmma_commit();
          mbar_wait(do_full(s), parity);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t koff = (kk / 4) * kBlock * kRowBytes + wq * 64 * kRowBytes + (kk % 4) * 32;
            const uint32_t qoff = s * L::kQBytes + (kk / 4) * kTile * kRowBytes + (kk % 4) * 32;
            wgmma_ss_n64(dpt, desc_sw128(s_v + koff, 16, 1024), desc_sw128(s_do + qoff, 16, 1024), kk > 0);
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(st);
          fence_regs(dpt);
          if (last) {  // the next work tile's K and V may load
            __syncwarp();
            if (lane == 0) mbar_arrive(kv_empty);
          }

          // Element e sits at key ka (+8 if bit 1 of e: kb) and q row
          // q0 + 8 (e / 4) + col0 + (e & 1); the LSE and delta vary along
          // the columns, read from the stage for this thread's 16.
          const bool diagonal = causal && q0 + q_offset < kc0 + 63;
          uint32_t pa[4][4], da[4][4];
#pragma unroll
          for (int g = 0; g < 8; ++g) {
            const int col = 8 * g + col0;
            const float2 l = *reinterpret_cast<const float2*>(lse_s + s * kTile + col);
            const float2 dl = *reinterpret_cast<const float2*>(delta_s + s * kTile + col);
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {  // keys ka, kb: elements 4 g + 2 h2 + {0, 1}
              const int e = 4 * g + 2 * h2;
              const int key = h2 ? kb : ka;
              float s0 = st[e], s1 = st[e + 1];
              if (diagonal) {
                if (q0 + col + q_offset < key) s0 = kNegInf;
                if (q0 + col + 1 + q_offset < key) s1 = kNegInf;
              }
              const float2 x = p_ds(s0, dpt[e], l.x, dl.x, c, scale);
              const float2 y = p_ds(s1, dpt[e + 1], l.y, dl.y, c, scale);
              // A fragments: q rows 16 kk .. 16 kk + 15 are elements
              // 8 kk .. 8 kk + 7, register r = (e % 8) / 2.
              pa[g / 2][(e % 8) / 2] = pack_bf16(x.x, y.x);
              da[g / 2][(e % 8) / 2] = pack_bf16(x.y, y.y);
            }
          }

          // dV += P^T dO and dK += dS^T Q: dO and Q [q rows][d] are
          // MN-major; 4 steps of 16 q rows each.
          fence_regs(dv_acc);
          fence_regs(dk_acc);
          fence_regs(pa);
          fence_regs(da);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs<D>(dv_acc, pa[kk],
                        desc_sw128(s_do + s * L::kQBytes + kk * 16 * kRowBytes, kTile * kRowBytes, 1024));
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs<D>(dk_acc, da[kk],
                        desc_sw128(s_q + s * L::kQBytes + kk * 16 * kRowBytes, kTile * kRowBytes, 1024));
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(dv_acc);
          fence_regs(dk_acc);
          __syncwarp();
          if (lane == 0) mbar_arrive(q_empty(s));
        }
      }

      const long long kv_rs = static_cast<long long>(kv_heads) * D;
      const long long out0 = static_cast<long long>(t.b) * seq_k * kv_rs + static_cast<long long>(t.hk) * D;
      store_rows<D>(dk + out0, kv_rs, ka, seq_k, col0, dk_acc);
      store_rows<D>(dv + out0, kv_rs, ka, seq_k, col0, dv_acc);
    }
  }
}

// -- host side ----------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *delta, *dq, *dk, *dv;
  int batch, heads, kv_heads, seq_q, seq_k, head_dim, q_offset, causal;
  long long q_bstride, k_bstride, v_bstride, o_bstride, do_bstride;
  float c, scale;
  cudaStream_t stream;
};

// The tensor maps, Q, dO (and O, where `to` is given) in boxes of `q_rows`
// rows, K and V of `k_rows`.
int make_maps(const Args& a, int q_rows, int k_rows, CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv,
              CUtensorMap* tdo, CUtensorMap* to = nullptr) {
  int err = make_map(tq, a.q, a.head_dim, a.heads, a.seq_q, a.batch, a.q_bstride, q_rows);
  if (err == 0) err = make_map(tdo, a.dout, a.head_dim, a.heads, a.seq_q, a.batch, a.do_bstride, q_rows);
  if (err == 0 && to != nullptr)
    err = make_map(to, a.o, a.head_dim, a.heads, a.seq_q, a.batch, a.o_bstride, q_rows);
  if (err == 0) err = make_map(tk, a.k, a.head_dim, a.kv_heads, a.seq_k, a.batch, a.k_bstride, k_rows);
  if (err == 0) err = make_map(tv, a.v, a.head_dim, a.kv_heads, a.seq_k, a.batch, a.v_bstride, k_rows);
  return err;
}

int grid_for(long long n_work, int sms) { return static_cast<int>(n_work < sms ? n_work : sms); }

template <int D>
int launch_dq(const Args& a) {
  CUtensorMap tq, tk, tv, tdo, to;
  int err = make_maps(a, kBlock, kDqKeys, &tq, &tk, &tv, &tdo, &to);
  if (err != 0) return err;
  constexpr int smem = DqSmem<D>::kAlloc;
  auto kernel = flash_bwd_sm90_dq_kernel<D>;
  static GridCache cache;
  int sms = 0;
  err = sm_count(kernel, smem, cache, &sms);
  if (err != cudaSuccess) return err;
  const int n_q = (a.seq_q + kBlock - 1) / kBlock;
  auto* delta = static_cast<float*>(a.delta);
  float* lse_pad = delta + static_cast<long long>(a.batch) * a.heads * n_q * kBlock;
  kernel<<<grid_for(static_cast<long long>(n_q) * a.batch * a.heads, sms), kThreads, smem, a.stream>>>(
      tq, tk, tv, tdo, to, static_cast<const float*>(a.lse), delta, lse_pad, static_cast<__nv_bfloat16*>(a.dq),
      a.batch, a.heads, a.kv_heads, a.seq_q, a.seq_k, a.q_offset, a.causal, a.c, a.scale);
  return cudaGetLastError();
}

template <int D>
int launch_dkv(const Args& a) {
  CUtensorMap tq, tk, tv, tdo;
  int err = make_maps(a, kTile, kBlock, &tq, &tk, &tv, &tdo);
  if (err != 0) return err;
  constexpr int smem = DkvSmem<D>::kAlloc;
  auto kernel = flash_bwd_sm90_dkv_kernel<D>;
  static GridCache cache;
  int sms = 0;
  err = sm_count(kernel, smem, cache, &sms);
  if (err != cudaSuccess) return err;
  const long long n_work = static_cast<long long>((a.seq_k + kBlock - 1) / kBlock) * a.batch * a.kv_heads;
  kernel<<<grid_for(n_work, sms), kThreads, smem, a.stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv), a.batch, a.heads, a.kv_heads,
      a.seq_q, a.seq_k, a.q_offset, a.causal, a.c, a.scale);
  return cudaGetLastError();
}

bool valid(int dtype, const Args& a) {
  const long long n_q = (a.seq_q + kBlock - 1) / kBlock, n_k = (a.seq_k + kBlock - 1) / kBlock;
  return dtype == 1 && a.batch >= 1 && a.heads >= 1 && a.kv_heads >= 1 && a.heads % a.kv_heads == 0 &&
         a.seq_q >= 1 && a.seq_k >= 1 && a.q_offset >= 0 && (a.head_dim == 64 || a.head_dim == 128) &&
         n_q * a.batch * a.heads <= 0x7fffffff && n_k * a.batch * a.kv_heads <= 0x7fffffff;
}

}  // namespace

// C entry points, bound with ctypes, with the arguments of flash_bwd.cu's
// flash_bwd_dq and flash_bwd_dkv; dtype must be 1 (bfloat16), head_dim 64
// or 128. q, o, dout [B, Sq, H, d] and k, v [B, Sk, Hkv, d] with dense
// [S, H, d] inner dims, 16-byte aligned bases and batch strides (elements)
// whose bytes are multiples of 16 (kernel_bwd.py checks this before the
// call); lse [B*H, Sq] fp32 from the forward; dq [B, Sq, H, d], dk and dv
// [B, Sk, Hkv, d] bf16 dense. Unlike flash_bwd.cu's, `delta` is
// [2, B*H, Sq'] fp32 with Sq' = Sq rounded up to 128: flash_bwd_sm90_dq
// writes delta into its first half and the LSE, +inf past Sq, into its
// second; flash_bwd_sm90_dkv takes the two halves as `delta` and `lse`.
// Launch them in that order on one stream. c = scale * log2(e). Each
// returns a cudaError_t, or kErrNoEncode / kErrTensorMap + CUresult.
extern "C" int flash_bwd_sm90_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq, int dtype, int batch, int heads,
                                 int kv_heads, int seq_q, int seq_k, int head_dim, long long q_bstride,
                                 long long k_bstride, long long v_bstride, long long o_bstride,
                                 long long do_bstride, int q_offset, int causal, float c, float scale,
                                 void* stream) {
  const Args a{q, k, v, o, dout, lse, delta, dq, nullptr, nullptr,
               batch, heads, kv_heads, seq_q, seq_k, head_dim, q_offset, causal,
               q_bstride, k_bstride, v_bstride, o_bstride, do_bstride,
               c, scale, static_cast<cudaStream_t>(stream)};
  if (!valid(dtype, a)) return cudaErrorInvalidValue;
  return head_dim == 128 ? launch_dq<128>(a) : launch_dq<64>(a);
}

extern "C" int flash_bwd_sm90_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv, int dtype, int batch,
                                  int heads, int kv_heads, int seq_q, int seq_k, int head_dim,
                                  long long q_bstride, long long k_bstride, long long v_bstride,
                                  long long do_bstride, int q_offset, int causal, float c, float scale,
                                  void* stream) {
  const Args a{q, k, v, nullptr, dout, lse, const_cast<void*>(delta), nullptr, dk, dv,
               batch, heads, kv_heads, seq_q, seq_k, head_dim, q_offset, causal,
               q_bstride, k_bstride, v_bstride, 0, do_bstride,
               c, scale, static_cast<cudaStream_t>(stream)};
  if (!valid(dtype, a)) return cudaErrorInvalidValue;
  return head_dim == 128 ? launch_dkv<128>(a) : launch_dkv<64>(a);
}
