// Decode attention over a KV cache on the CUDA cores of Hopper, sm_90a:
// S query rows a slot (S = 1 for a decode step, S = K + 1 for a speculative
// verify) against the slot's cached rows, split along the rows
// ("flash-decoding") and merged by a second, small kernel.
//
// Replaces no TPU kernel: the reference's decode is a jnp.einsum pair that
// XLA compiles (src/repro/models/attention.py:319-329, and verify_attention
// above it), which the port's plain version copies
// (kernels/decode_attention/kernel.py::decode_attention_plain). It was
// added because that formulation, run eagerly on the card, widens the whole
// cache to fp32 and copies it again into each einsum's layout in every
// layer of every step. It computes what the reference computes, in fp32:
//
//   limit = min(write_pos[b] + j, max_len - 1)      query row j of slot b
//   s_t   = (q . k_t) * scale,  t = 0 .. limit      K widened in registers
//   o     = sum_t exp(s_t - max s) v_t / sum_t exp(s_t - max s)
//
// The reference scores every row and masks those past write_pos + j with
// -1e30, which adds exactly 0 after the max subtraction; a slot whose length
// ran past the cache (a retired or never used slot) sees every row, hence
// the clamp to max_len - 1. Rows past the limit are never read. Widening
// bf16 to fp32 is exact; the online softmax (a running max, sum and
// rescaled accumulator per split, merged across splits in fp32) changes
// only the order of the sums. expf, never exp2f of a rescaled argument.
//
// What bounds it on the H100: bytes. A (slot, KV head) reads 2 x rows x d x
// element size once for all rep x S queries that share it, against
// 4 x rep x S x rows x d operations: at S = 1 and rep <= 16, under 8 fp32
// FMAs a byte of bf16. What the design does:
//   * one read, where the cache lies ([B, max_len, Hkv, d], any strides
//     with d dense): 16-byte read-only loads straight into registers, four
//     rows of K and V a thread in flight; no shared-memory staging, no copy
//     of K or V anywhere.
//   * lanes along d: L lanes (a power of 2) hold a row's 16-byte vectors,
//     32 / L rows a warp side by side; a row's partial dots are summed by
//     butterfly shuffles inside its L lanes.
//   * queries sharing a KV head share its loads: a thread keeps QW (1 or 4)
//     query rows' q and accumulators in registers; up to 4 warps take
//     different query rows of one (slot, KV head) and read the same rows
//     of the cache (the first warp from device memory, the others from L1
//     and L2), the remaining warps take other rows. Query rows beyond 16 a
//     (slot, KV head) take further CTAs.
//   * split along the rows so that small batches fill the card: the
//     wrapper chooses the split on the host from the CTAs the grid has
//     without it (B x Hkv x chunks of 16 query rows) and max_len
//     (kernel.split_plan); a CTA whose split lies wholly past its queries'
//     limits exits at once, so masked rows cost nothing.
//   * each split writes its unnormalised accumulator, max and sum (fp32);
//     decode_attention_combine weighs the splits that hold rows of each
//     query by exp(m_s - max m) and divides once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "simt.cuh"  // aligned16

namespace {

using namespace repro_torch::simt;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // rows of K and V a thread has in flight
constexpr int kMaxHeadDim = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* write_pos;
  float* o_part;  // [B, Hkv, Q, splits, d]: unnormalised
  float* m_part;  // [B, Hkv, Q, splits]
  float* l_part;  // [B, Hkv, Q, splits]
  float* out;     // [B, S, H, d]
  long long q_sb, q_ss, q_sh, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh;  // in elements
  int seq_q, kv_heads, rep, max_len, head_dim;
  int splits, rows_per_split;
  int lanes;     // lanes a row: a power of 2, at most 32
  int q_warps;   // warps along the query rows: 1, 2 or 4
  int q_chunks;  // CTAs along the query rows
  float scale;
};

__device__ __forceinline__ int row_limit(int write_pos, int j, int max_len) {
  return static_cast<int>(min(static_cast<long long>(write_pos) + j,
                              static_cast<long long>(max_len) - 1));
}

// 16 bytes of T as fp32: 4 floats or 8 widened bf16.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void widen(const uint4& r, float* out) {
    out[0] = __uint_as_float(r.x), out[1] = __uint_as_float(r.y);
    out[2] = __uint_as_float(r.z), out[3] = __uint_as_float(r.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void widen(const uint4& r, float* out) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // bf16 is the top half of an fp32: exact.
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Merge (mo, lo, acc_o) into (m, l, acc): both scaled to the larger max.
// An empty state has m = -inf and l = acc = 0.
__device__ __forceinline__ void merge_weights(float m, float mo, float* a, float* c, float* mx) {
  *mx = fmaxf(m, mo);
  *a = m == -INFINITY ? 0.f : expf(m - *mx);
  *c = mo == -INFINITY ? 0.f : expf(mo - *mx);
}

// One CTA: slot b, KV head h, a chunk of up to q_warps x QW query rows, and
// the rows [split * rows_per_split, +rows_per_split) up to the chunk's
// largest limit. NV: 16-byte vectors a lane (2 for fp32 at d > 128).
template <typename T, int NV, int QW>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(const Params p) {
  constexpr int VW = Vec<T>::n;
  constexpr int W = NV * VW;  // values of d a lane holds
  int idx = blockIdx.x;
  const int split = idx % p.splits;
  idx /= p.splits;
  const int qc = idx % p.q_chunks;
  idx /= p.q_chunks;
  const int h = idx % p.kv_heads;
  const int b = idx / p.kv_heads;
  const int q_rows = p.seq_q * p.rep;
  const int q0 = qc * p.q_warps * QW;
  const int q1 = min(q0 + p.q_warps * QW, q_rows);
  const int wp = p.write_pos[b];
  const int r_begin = split * p.rows_per_split;
  const int lim_max = row_limit(wp, (q1 - 1) / p.rep, p.max_len);
  if (r_begin > lim_max) return;  // the whole CTA: no barrier passed yet
  const int r_end = min(r_begin + p.rows_per_split, lim_max + 1);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wq = warp % p.q_warps, wr = warp / p.q_warps;
  const int row_warps = kWarps / p.q_warps;
  const int L = p.lanes, G = 32 / L, g = lane / L, l = lane % L;
  const int nvec = p.head_dim / VW;
  bool has[NV];  // this lane's vectors l + i * L lie inside d
#pragma unroll
  for (int i = 0; i < NV; ++i) has[i] = l + i * L < nvec;

  const T* qbase = static_cast<const T*>(p.q) + b * p.q_sb;
  int lim[QW];
  float qv[QW][W];
#pragma unroll
  for (int qi = 0; qi < QW; ++qi) {
    const int qr = q0 + wq * QW + qi;
    lim[qi] = -1;  // a padding query: no row is valid
#pragma unroll
    for (int e = 0; e < W; ++e) qv[qi][e] = 0.f;
    if (qr < q1) {
      const int j = qr / p.rep, r = qr % p.rep;
      lim[qi] = row_limit(wp, j, p.max_len);
      const T* qp = qbase + j * p.q_ss + (h * p.rep + r) * p.q_sh;
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (has[i]) Vec<T>::widen(load16(qp + (l + i * L) * VW), &qv[qi][i * VW]);
    }
  }

  float m[QW], lsum[QW], acc[QW][W];
#pragma unroll
  for (int qi = 0; qi < QW; ++qi) {
    m[qi] = -INFINITY, lsum[qi] = 0.f;
#pragma unroll
    for (int e = 0; e < W; ++e) acc[qi][e] = 0.f;
  }

  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int step = row_warps * G * kRows;
  // The loop bound depends on the warp alone, so every lane of a warp takes
  // the same trips and the shuffles below see all 32.
  for (int wbase = r_begin + wr * G * kRows; wbase < r_end; wbase += step) {
    const int row0 = wbase + g * kRows;
    uint4 kr[kRows][NV], vr[kRows][NV];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const long long row = row0 + u;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const bool in = row < r_end && has[i];
        const int col = (l + i * L) * VW;
        kr[u][i] = in ? load16(kb + row * p.k_sr + col) : make_uint4(0, 0, 0, 0);
        vr[u][i] = in ? load16(vb + row * p.v_sr + col) : make_uint4(0, 0, 0, 0);
      }
    }
    float s[QW][kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
#pragma unroll
      for (int qi = 0; qi < QW; ++qi) s[qi][u] = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float kf[VW];
        Vec<T>::widen(kr[u][i], kf);
#pragma unroll
        for (int qi = 0; qi < QW; ++qi)
#pragma unroll
          for (int e = 0; e < VW; ++e) s[qi][u] = fmaf(qv[qi][i * VW + e], kf[e], s[qi][u]);
      }
    }
    for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
      for (int qi = 0; qi < QW; ++qi)
#pragma unroll
        for (int u = 0; u < kRows; ++u) s[qi][u] += __shfl_xor_sync(kFull, s[qi][u], off);

    float vf[kRows][W];
#pragma unroll
    for (int u = 0; u < kRows; ++u)
#pragma unroll
      for (int i = 0; i < NV; ++i) Vec<T>::widen(vr[u][i], &vf[u][i * VW]);
#pragma unroll
    for (int qi = 0; qi < QW; ++qi) {
      float sc[kRows];
      bool ok[kRows];
      float mx = m[qi];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int row = row0 + u;
        ok[u] = row < r_end && row <= lim[qi];
        sc[u] = s[qi][u] * p.scale;
        if (ok[u]) mx = fmaxf(mx, sc[u]);
      }
      const float alpha = m[qi] == -INFINITY ? 0.f : expf(m[qi] - mx);
      float pu[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) pu[u] = ok[u] ? expf(sc[u] - mx) : 0.f;
      float ls = lsum[qi] * alpha;
#pragma unroll
      for (int u = 0; u < kRows; ++u) ls += pu[u];
      lsum[qi] = ls;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        float a = acc[qi][e] * alpha;
#pragma unroll
        for (int u = 0; u < kRows; ++u) a = fmaf(pu[u], vf[u][e], a);
        acc[qi][e] = a;
      }
      m[qi] = mx;
    }
  }

  // Merge the warp's row groups (lanes l, l + L, ...); every lane ends with
  // the merged state (x + y == y + x, so both sides of a pair agree).
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int qi = 0; qi < QW; ++qi) {
      const float mo = __shfl_xor_sync(kFull, m[qi], off);
      const float lo = __shfl_xor_sync(kFull, lsum[qi], off);
      float a, c, mx;
      merge_weights(m[qi], mo, &a, &c, &mx);
      lsum[qi] = lsum[qi] * a + lo * c;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const float ao = __shfl_xor_sync(kFull, acc[qi][e], off);
        acc[qi][e] = acc[qi][e] * a + ao * c;
      }
      m[qi] = mx;
    }
  }

  // Merge the warps that took other rows for the same query rows.
  __shared__ float red_acc[kWarps][QW][kMaxHeadDim];
  __shared__ float red_m[kWarps][QW], red_l[kWarps][QW];
  if (row_warps > 1) {
    if (g == 0) {
#pragma unroll
      for (int qi = 0; qi < QW; ++qi) {
#pragma unroll
        for (int i = 0; i < NV; ++i)
          if (has[i])
#pragma unroll
            for (int e = 0; e < VW; ++e) red_acc[warp][qi][(l + i * L) * VW + e] = acc[qi][i * VW + e];
        if (l == 0) red_m[warp][qi] = m[qi], red_l[warp][qi] = lsum[qi];
      }
    }
    __syncthreads();
    if (wr == 0) {
      for (int w2 = 1; w2 < row_warps; ++w2) {
        const int other = w2 * p.q_warps + wq;
#pragma unroll
        for (int qi = 0; qi < QW; ++qi) {
          float a, c, mx;
          merge_weights(m[qi], red_m[other][qi], &a, &c, &mx);
          lsum[qi] = lsum[qi] * a + red_l[other][qi] * c;
#pragma unroll
          for (int i = 0; i < NV; ++i)
#pragma unroll
            for (int e = 0; e < VW; ++e) {
              const float ao = has[i] ? red_acc[other][qi][(l + i * L) * VW + e] : 0.f;
              acc[qi][i * VW + e] = acc[qi][i * VW + e] * a + ao * c;
            }
          m[qi] = mx;
        }
      }
    }
  }
  if (wr != 0 || g != 0) return;
#pragma unroll
  for (int qi = 0; qi < QW; ++qi) {
    const int qr = q0 + wq * QW + qi;
    if (qr >= q1) continue;
    const long long slot =
        ((static_cast<long long>(b) * p.kv_heads + h) * q_rows + qr) * p.splits + split;
    float* op = p.o_part + slot * p.head_dim;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (has[i])
#pragma unroll
        for (int e = 0; e < VW; ++e) op[(l + i * L) * VW + e] = acc[qi][i * VW + e];
    if (l == 0) p.m_part[slot] = m[qi], p.l_part[slot] = lsum[qi];
  }
}

// One CTA a (slot, KV head): each output value weighs the splits that hold
// rows of its query row (split s holds row s * rows_per_split <= limit) by
// exp(m_s - max m) and divides by the weighed sums once.
__global__ void __launch_bounds__(kThreads) decode_attention_combine(const Params p) {
  const int bh = blockIdx.x;
  const int b = bh / p.kv_heads, h = bh % p.kv_heads;
  const int q_rows = p.seq_q * p.rep;
  const int heads = p.kv_heads * p.rep;
  const int wp = p.write_pos[b];
  for (int i = threadIdx.x; i < q_rows * p.head_dim; i += kThreads) {
    const int qr = i / p.head_dim, d = i % p.head_dim;
    const int j = qr / p.rep, r = qr % p.rep;
    const int n = min(p.splits, row_limit(wp, j, p.max_len) / p.rows_per_split + 1);
    const long long base = (static_cast<long long>(bh) * q_rows + qr) * p.splits;
    float mx = p.m_part[base];
    for (int s = 1; s < n; ++s) mx = fmaxf(mx, p.m_part[base + s]);
    float lsum = 0.f, o = 0.f;
    for (int s = 0; s < n; ++s) {
      const float w = expf(p.m_part[base + s] - mx);
      lsum += p.l_part[base + s] * w;
      o += p.o_part[(base + s) * p.head_dim + d] * w;
    }
    p.out[((static_cast<long long>(b) * p.seq_q + j) * heads + h * p.rep + r) * p.head_dim + d] = o / lsum;
  }
}

template <typename T, int NV, int QW>
cudaError_t launch(const Params& p, long long blocks, cudaStream_t stream) {
  decode_attention_kernel<T, NV, QW><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int NV>
cudaError_t launch_q(const Params& p, int qw, long long blocks, cudaStream_t stream) {
  return qw == 1 ? launch<T, NV, 1>(p, blocks, stream) : launch<T, NV, 4>(p, blocks, stream);
}

}  // namespace

// C entry point, bound with ctypes. q [B, S, H, d], k and v [B, max_len,
// Hkv, d], each with d dense, a 16-byte aligned base and strides (in
// elements) of whole 16-byte units; dtype 0 float32, 1 bfloat16 (q, k, v
// alike). write_pos [B] int32 on the device. out [B, S, H, d] fp32 dense;
// o_part [B * Hkv * S * H/Hkv * splits * d], m_part and l_part [B * Hkv *
// S * H/Hkv * splits] fp32 scratch. d a multiple of 8, at most 256;
// splits * rows_per_split >= max_len. Launches the split kernel and its
// combine on `stream`; returns a cudaError_t.
extern "C" int decode_attention(const void* q, const void* k, const void* v, const void* write_pos,
                                void* out, void* o_part, void* m_part, void* l_part, int dtype,
                                int batch, int seq_q, int heads, int kv_heads, int max_len,
                                int head_dim, long long q_sb, long long q_ss, long long q_sh,
                                long long k_sb, long long k_sr, long long k_sh, long long v_sb,
                                long long v_sr, long long v_sh, int splits, int rows_per_split,
                                float scale, void* stream) {
  if (batch < 1 || seq_q < 1 || kv_heads < 1 || heads < kv_heads || heads % kv_heads != 0 ||
      max_len < 1 || head_dim < 8 || head_dim > kMaxHeadDim || head_dim % 8 != 0 || splits < 1 ||
      rows_per_split < 1 || static_cast<long long>(splits) * rows_per_split < max_len ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const long long size = dtype == 0 ? 4 : 2;
  const long long strides[] = {q_sb, q_ss, q_sh, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh};
  for (long long s : strides)
    if ((s * size) % 16) return cudaErrorMisalignedAddress;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v))
    return cudaErrorMisalignedAddress;

  Params p;
  p.q = q, p.k = k, p.v = v, p.write_pos = static_cast<const int*>(write_pos);
  p.o_part = static_cast<float*>(o_part), p.m_part = static_cast<float*>(m_part);
  p.l_part = static_cast<float*>(l_part), p.out = static_cast<float*>(out);
  p.q_sb = q_sb, p.q_ss = q_ss, p.q_sh = q_sh;
  p.k_sb = k_sb, p.k_sr = k_sr, p.k_sh = k_sh;
  p.v_sb = v_sb, p.v_sr = v_sr, p.v_sh = v_sh;
  p.seq_q = seq_q, p.kv_heads = kv_heads, p.rep = heads / kv_heads;
  p.max_len = max_len, p.head_dim = head_dim;
  p.splits = splits, p.rows_per_split = rows_per_split, p.scale = scale;

  // Query rows of a (slot, KV head): one takes the lone-query kernel with
  // all four warps along the rows; more take 4 a warp, up to 4 warps.
  const int q_rows = seq_q * p.rep;
  const int qw = q_rows == 1 ? 1 : 4;
  p.q_warps = q_rows <= 4 ? 1 : q_rows <= 8 ? 2 : 4;
  p.q_chunks = (q_rows + p.q_warps * qw - 1) / (p.q_warps * qw);
  const int nvec = head_dim / (dtype == 0 ? 4 : 8);
  const int nv = nvec > 32 ? 2 : 1;
  const int per_lane = (nvec + nv - 1) / nv;
  p.lanes = 1;
  while (p.lanes < per_lane) p.lanes *= 2;

  const long long blocks = static_cast<long long>(splits) * p.q_chunks * kv_heads * batch;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = launch_q<__nv_bfloat16, 1>(p, qw, blocks, st);
  else
    err = nv == 1 ? launch_q<float, 1>(p, qw, blocks, st) : launch_q<float, 2>(p, qw, blocks, st);
  if (err != cudaSuccess) return err;
  decode_attention_combine<<<static_cast<unsigned>(batch) * kv_heads, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}
