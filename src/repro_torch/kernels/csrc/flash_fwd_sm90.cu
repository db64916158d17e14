// SystolicAttention forward (the paper's Algorithm 1) for Hopper, sm_90a:
// bf16 inputs, head width 64 or 128, on the tensor cores.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (with `_exp2_inline`)
// (src/repro/kernels/flash_attention/kernel.py:64 and :43, launched by
// `flash_attention_fwd` at kernel.py:217) for bf16 inputs; fp32 inputs and
// bf16 at d 16 or 32 stay on the SIMT kernel of flash_fwd.cu. It computes
//
//   S   = Q K^T, unscaled, fp32 accumulation of exact bf16 products;
//   mask padded keys and (causal) keys past row + q_offset with -1e30;
//   m'  = max(m, rowmax S);  b = exp2(c (m - m'));  P = exp2(c (S - m'))
//   l   = l b + rowsum P (from the fp32 P);  acc = acc b + bf16(P) V
//   O   = acc / l, with l == 0 read as 1, rounded once to bf16;
//   LSE = c m + log2 l (fp32, [B*H, Sq]), when asked for;   c = scale log2 e.
//
// exp2 is exact (exp2f) or the §3.3 PWL (pwl_exp2.cuh, table in shared
// memory, multiply and add rounded separately). P is rounded to bf16 for the
// PV product, as wgmma takes it; l is summed before that rounding, so the
// LSE is the fp32-P one. The plain twin in kernel.py rounds P the same way.
//
// What bounds it on the H100. Causal attention does 4 d S^2 / 2 operations
// per head against 4 S d bf16 bytes read and written: S / 4 operations a
// byte, 512 at S = 2048, above the card's ~295, so it is bound by the
// tensor cores (989 TFLOP/s bf16) from S ~ 1200 up and by bytes below. The
// SIMT kernel reached ~12 TFLOP/s (PERF.md): fp32 FMAs on the CUDA cores,
// scalar loads with a block-wide barrier on each side, and S through shared
// memory.
//
// Design. A work tile is one (b*h, 128-row q tile), looping over 128-key
// tiles. The grid is persistent: one CTA per SM (its 160 KB of shared
// memory and 384 threads allow no second), each walking its share of the
// work tiles, the last q tiles (most keys under the causal mask) first, in
// an order that snakes across the CTAs so their loads even out. A CTA has
// three warpgroups:
//   * warpgroup 0, the producer: one thread issues TMA loads (4-D tensor
//     maps over [B, S, H, d] with the caller's batch stride, 128-byte
//     swizzle): each work tile's Q, then its K and V through a ring of
//     kStages stages with full and empty mbarriers; it gives its registers
//     away (setmaxnreg).
//   * warpgroups 1 and 2, the consumers, 64 q rows each: S with
//     wgmma.mma_async (both operands from shared memory, fp32 accumulators
//     in registers), the online softmax in registers (a row lives on four
//     threads, reduced by two shuffles), then O += P V with wgmma, P from
//     registers (the S accumulator layout is the A-operand layout, so P
//     needs no shuffle) and V from shared memory read transposed.
// The loads run ahead of the products and softmax: within a work tile the
// next k tile's, and across work tiles the next Q (released after the last
// S of a work tile) and first K and V, while the consumers finish the PV
// and write O. The two consumers run independently. Keys past Sk arrive as
// zeros (the maps' sequence extent is the logical Sk) and are masked; only
// tiles that cross the causal diagonal or the ragged end are masked; tiles
// wholly above the diagonal are skipped (row r always sees key 0, so m is
// finite after the first tile and a skipped tile would only multiply l and
// acc by exp2(0) = 1, which the PWL also returns exactly). The k tiles run
// in increasing order, as in the plain version: with the PWL, l and the LSE
// depend on where the k tiles break and in which order (the rescale factor
// is not multiplicative).
//
// Not kept: FlashAttention-3's intra-warpgroup overlap (S of tile j issued
// with PV of tile j - 1, the softmax of j between) and ping-pong between
// the two consumers (named barriers); both gave the same bits and no gain
// at the main path's shapes (PERF.md).

#include <cuda.h>  // CUtensorMap and its enums; libcuda is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "pwl_exp2.cuh"
#include "sm90.cuh"  // mbarriers, TMA, wgmma, tensor maps

namespace {

using namespace repro_torch::sm90;

constexpr int kBlockM = 128;  // q rows per CTA
constexpr int kBlockN = 128;  // keys per k tile
constexpr int kStages = 2;    // K/V ring
constexpr int kConsumers = 2;  // warpgroups of 64 q rows
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kMaxSegments = 128;  // width of the packed PWL table
constexpr float kNegInf = -1e30f;  // finite: -inf - (-inf) would be NaN

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle's
// atom is 8 rows x 128 bytes). A tile of D columns is D / 64 column blocks
// of [rows][64] bf16, one TMA box each.
template <int D>
struct Smem {
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kKVBytes = kBlockN * D * 2;  // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;
  static constexpr int kNumBars = 2 + 3 * kStages;  // q_full, q_empty, k_full, v_full, kv_empty
  static constexpr int kTable = kBars + 8 * kNumBars;
  static constexpr int kBytes = kTable + 2 * kMaxSegments * 4;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

template <bool kPwl>
__device__ __forceinline__ float exp2_mode(float x, const float* tab, int num_segments) {
  if constexpr (kPwl) return repro_torch::pwl_exp2(x, tab, tab + num_segments, num_segments);
  return exp2f(x);
}

// -- the kernel ---------------------------------------------------------------------

// The work of one (b*h, q tile): where it starts and how many k tiles it
// takes (tiles wholly above the causal diagonal are skipped).
struct Work {
  int b, h, hk, bh, q0, n_k;
};

// Work tile w, in the order that runs the last q tiles (most keys under the
// causal mask) of every head first.
__device__ __forceinline__ Work work_tile(int w, int n_q, int n_bh, int heads, int kv_heads,
                                          int seq_k, int q_offset, int causal) {
  Work t;
  t.bh = w % n_bh;
  t.b = t.bh / heads;
  t.h = t.bh % heads;
  t.hk = t.h / (heads / kv_heads);
  t.q0 = (n_q - 1 - w / n_bh) * kBlockM;
  const int k_end = causal ? min(seq_k, t.q0 + q_offset + kBlockM) : seq_k;
  t.n_k = (k_end + kBlockN - 1) / kBlockN;
  return t;
}

template <int D, bool kPwl>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      const float* __restrict__ table, int batch, int heads, int kv_heads,
                      int seq_q, int seq_k, int q_offset, int causal, float c, int num_segments) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t s_q = base + L::kQ, s_k = base + L::kK, s_v = base + L::kV;
  const uint32_t q_full = base + L::kBars, q_empty = q_full + 8;
  auto k_full = [&](int s) { return q_full + 8 * (2 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (2 + kStages + s); };
  auto kv_empty = [&](int s) { return q_full + 8 * (2 + 2 * kStages + s); };
  float* s_tab = reinterpret_cast<float*>(smem + L::kTable);

  // Persistent: CTA x takes work tiles x, then 2G - 1 - x, then 2G + x, ...
  // (G CTAs; the order snakes so that no CTA takes the heaviest of every
  // round) until they run out. Tile i of this CTA is work tile work_id(i).
  const int n_q = (seq_q + kBlockM - 1) / kBlockM, n_bh = batch * heads;
  const int n_work = n_q * n_bh, n_ctas = gridDim.x;
  auto work_id = [&](int i) {
    const int x = static_cast<int>(blockIdx.x);
    return i * n_ctas + ((i & 1) ? n_ctas - 1 - x : x);
  };
  auto work = [&](int w) {
    return work_tile(w, n_q, n_bh, heads, kv_heads, seq_k, q_offset, causal);
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * kConsumers);  // one arrive per consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(kv_empty(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (kPwl) {
    for (int i = tid; i < 2 * num_segments; i += kThreads) s_tab[i] = table[i];
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
        const Work t = work(work_id(i));
        mbar_wait(q_empty, (i & 1) ^ 1);
        mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb)
          tma_load(s_q + cb * kBlockM * kRowBytes, &tm_q, q_full, 64 * cb, t.h, t.q0, t.b);
        for (int j = 0; j < t.n_k; ++j, ++it) {
          const int s = it % kStages;
          mbar_wait(kv_empty(s), ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(k_full(s), L::kKVBytes);
#pragma unroll
          for (int cb = 0; cb < D / 64; ++cb)
            tma_load(s_k + s * L::kKVBytes + cb * kBlockN * kRowBytes, &tm_k, k_full(s), 64 * cb,
                     t.hk, j * kBlockN, t.b);
          mbar_expect_tx(v_full(s), L::kKVBytes);
#pragma unroll
          for (int cb = 0; cb < D / 64; ++cb)
            tma_load(s_v + s * L::kKVBytes + cb * kBlockN * kRowBytes, &tm_v, v_full(s), 64 * cb,
                     t.hk, j * kBlockN, t.b);
        }
      }
    }
  } else {
    // Consumer warpgroups: rows wq * 64 .. wq * 64 + 63 of each q tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int wq = tid / 128 - 1;
    const int t_id = tid % 128, lane = t_id % 32;
    // This thread's rows (local to the q tile) and first column of each
    // 8-column group of a wgmma accumulator.
    const int row_a = wq * 64 + (t_id / 32) * 16 + lane / 4, row_b = row_a + 8;
    const int col0 = 2 * (lane % 4);
    int it = 0;
    for (int i = 0; work_id(i) < n_work; ++i) {
      const Work t = work(work_id(i));
      float acc[D / 2];
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc[e] = 0.0f;
      float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;  // l: this thread's part

      mbar_wait(q_full, i & 1);
      for (int j = 0; j < t.n_k; ++j, ++it) {
        const int s = it % kStages;
        const uint32_t parity = (it / kStages) & 1;
        const int k0 = j * kBlockN;

        // S = Q K^T: 64 x 128 per warpgroup, D / 16 steps of 16.
        float sc[64];
        mbar_wait(k_full(s), parity);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t cb = (kk / 4) * kBlockM * kRowBytes, off = (kk % 4) * 32;
          const uint64_t da = desc_sw128(s_q + cb + wq * 64 * kRowBytes + off, 16, 1024);
          const uint64_t db =
              desc_sw128(s_k + s * L::kKVBytes + (kk / 4) * kBlockN * kRowBytes + off, 16, 1024);
          wgmma_ss_n128(sc, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        if (j == t.n_k - 1) {  // the producer may load the next work tile's Q
          __syncwarp();
          if (lane == 0) mbar_arrive(q_empty);
        }

        // Accumulator element e sits at row row_a (+8 if bit 1 of e) and
        // column 8 (e / 4) + col0 + (e & 1).
        const bool ragged = k0 + kBlockN > seq_k;
        const bool diagonal = causal && k0 + kBlockN - 1 > t.q0 + wq * 64 + q_offset;
        if (ragged || diagonal) {
#pragma unroll
          for (int e = 0; e < 64; ++e) {
            const int key = k0 + 8 * (e / 4) + col0 + (e & 1);
            const int row = t.q0 + ((e & 2) ? row_b : row_a);
            if (key >= seq_k || (causal && row + q_offset < key)) sc[e] = kNegInf;
          }
        }

        // Online softmax: the four threads lane / 4 share a row.
        float mx_a = m_a, mx_b = m_b;
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          if (e & 2) mx_b = fmaxf(mx_b, sc[e]);
          else mx_a = fmaxf(mx_a, sc[e]);
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
        }
        const float b_a = exp2_mode<kPwl>(c * (m_a - mx_a), s_tab, num_segments);
        const float b_b = exp2_mode<kPwl>(c * (m_b - mx_b), s_tab, num_segments);
        m_a = mx_a;
        m_b = mx_b;
        float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          const float p = exp2_mode<kPwl>(c * (sc[e] - ((e & 2) ? mx_b : mx_a)), s_tab, num_segments);
          sc[e] = p;
          if (e & 2) sum_b += p;
          else sum_a += p;
        }
        l_a = l_a * b_a + sum_a;
        l_b = l_b * b_b + sum_b;
#pragma unroll
        for (int e = 0; e < D / 2; ++e) acc[e] *= (e & 2) ? b_b : b_a;

        // P in bf16 as wgmma A fragments: keys 16 kk .. 16 kk + 15 are
        // accumulator elements 8 kk .. 8 kk + 7, already in fragment order.
        uint32_t pa[8][4];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

        // acc += P V: V [keys][d] is MN-major; 8 steps of 16 keys.
        mbar_wait(v_full(s), parity);
        fence_regs(acc);
        fence_regs(pa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint64_t db = desc_sw128(s_v + s * L::kKVBytes + kk * 16 * kRowBytes,
                                         kBlockN * kRowBytes, 1024);
          wgmma_rs<D>(acc, pa[kk], db);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(kv_empty(s));
      }

      // Epilogue: whole-row l, O = acc / l, LSE = c m + log2 l.
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
      }
      const float safe_a = l_a == 0.0f ? 1.0f : l_a, safe_b = l_b == 0.0f ? 1.0f : l_b;
      const int qa = t.q0 + row_a, qb = t.q0 + row_b;
      const long long q_rs = static_cast<long long>(heads) * D;
      __nv_bfloat16* o_a =
          o + (static_cast<long long>(t.b) * seq_q + qa) * q_rs + static_cast<long long>(t.h) * D;
      __nv_bfloat16* o_b = o_a + 8 * q_rs;
#pragma unroll
      for (int g = 0; g < D / 8; ++g) {
        const int col = 8 * g + col0;
        if (qa < seq_q)
          *reinterpret_cast<__nv_bfloat162*>(o_a + col) =
              __floats2bfloat162_rn(acc[4 * g] / safe_a, acc[4 * g + 1] / safe_a);
        if (qb < seq_q)
          *reinterpret_cast<__nv_bfloat162*>(o_b + col) =
              __floats2bfloat162_rn(acc[4 * g + 2] / safe_b, acc[4 * g + 3] / safe_b);
      }
      if (lse != nullptr && lane % 4 == 0) {
        const long long row0 = static_cast<long long>(t.bh) * seq_q;
        if (qa < seq_q) lse[row0 + qa] = c * m_a + log2f(safe_a);
        if (qb < seq_q) lse[row0 + qb] = c * m_b + log2f(safe_b);
      }
    }
  }
}

// -- host side ----------------------------------------------------------------------

template <int D, bool kPwl>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* o, float* lse,
           const float* table, int batch, int heads, int kv_heads, int seq_q, int seq_k,
           int q_offset, int causal, float c, int num_segments, cudaStream_t stream) {
  constexpr int smem = Smem<D>::kAlloc;
  auto kernel = flash_fwd_sm90_kernel<D, kPwl>;
  static GridCache cache;
  int sms = 0;
  const cudaError_t err = sm_count(kernel, smem, cache, &sms);
  if (err != cudaSuccess) return err;
  // One CTA an SM (shared memory and registers allow no second), each
  // walking its share of the work tiles.
  const long long n_work = static_cast<long long>((seq_q + kBlockM - 1) / kBlockM) * batch * heads;
  const int grid = static_cast<int>(n_work < sms ? n_work : sms);
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, table,
                                           batch, heads, kv_heads, seq_q, seq_k, q_offset, causal,
                                           c, num_segments);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes, with the arguments of flash_fwd.cu's
// flash_fwd; dtype must be 1 (bfloat16). q [B, Sq, H, d], k and v
// [B, Sk, Hkv, d], dense [S, H, d] inner dims, 16-byte aligned bases and batch strides
// (elements) whose bytes are multiples of 16 (kernel.py checks this before
// the call); o [B, Sq, H, d] bf16 dense; lse [B*H, Sq] fp32 or null; table
// [2, num_segments] fp32 (read when pwl). head_dim 64 or 128. Returns a
// cudaError_t, or kErrNoEncode / kErrTensorMap + CUresult.
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse,
                              const void* table, int dtype, int batch, int heads, int kv_heads, int seq_q,
                              int seq_k, int head_dim, long long q_bstride, long long k_bstride,
                              long long v_bstride, int q_offset, int causal, float c, int pwl,
                              int num_segments, void* stream) {
  if (dtype != 1 || batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads != 0 || seq_q < 1 || seq_k < 1 ||
      q_offset < 0 ||
      static_cast<long long>((seq_q + kBlockM - 1) / kBlockM) * batch * heads > 0x7fffffff ||
      (head_dim != 64 && head_dim != 128) ||
      (pwl && (num_segments < 1 || num_segments > kMaxSegments || table == nullptr)))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, head_dim, heads, seq_q, batch, q_bstride, kBlockM);
  if (err == 0) err = make_map(&tk, k, head_dim, kv_heads, seq_k, batch, k_bstride, kBlockN);
  if (err == 0) err = make_map(&tv, v, head_dim, kv_heads, seq_k, batch, v_bstride, kBlockN);
  if (err != 0) return err;
  auto* lse_f = static_cast<float*>(lse);
  auto* tab = static_cast<const float*>(table);
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_TORCH_LAUNCH(D, P)                                                                  \
  return launch<D, P>(tq, tk, tv, o, lse_f, tab, batch, heads, kv_heads, seq_q, seq_k, q_offset, \
                      causal, c, num_segments, st)
  if (head_dim == 128) {
    if (pwl) REPRO_TORCH_LAUNCH(128, true);
    REPRO_TORCH_LAUNCH(128, false);
  }
  if (pwl) REPRO_TORCH_LAUNCH(64, true);
  REPRO_TORCH_LAUNCH(64, false);
#undef REPRO_TORCH_LAUNCH
}
