// Decode attention for sm_90a: one query token per row against a KV cache.
//
// Replaces src/repro/kernels/decode_attention.py `_kernel` / `decode_attention`
// (the pallas_call at :116): q (B, 1, H, D), cache k (B, L, KV, D) and
// v (B, L, KV, Dv), bf16 or fp32, contiguous; kv_len (B,) int32 valid entries
// per row; optional window (keys kv_len - window .. kv_len - 1)
// -> o (B, 1, H, Dv) in q's type. The G = H / KV query heads of a kv head are
// handled together. Pallas contract: a row with kv_len = 0 gives exact zeros
// (l = 0, acc / max(l, 1e-30) = 0).
//
// Bound: bytes. Each valid cache entry is read once (2 * (D + Dv) bytes a key
// and kv head in bf16) for 2 * G * (D + Dv) FLOP: ~4 FLOP a byte at G = 4.
// At 8 rows x 2048 x 8 kv heads x 128 that is 67 MB a layer at full length,
// 20 us at 3.35 TB/s.
// Design: L is split across blocks so that B * KV * n_split blocks fill the
// card (the TPU walked L sequentially in one grid row; 8 rows x 8 kv heads
// alone give 64 blocks for 132 SMs). A block of 4 warps owns one (kv head,
// row, split); each warp takes groups of 4 keys in turn and keeps its own
// online softmax (m, l, acc) for the G heads in registers. Each lane holds
// DPL = D / 32 consecutive elements of a key, so a warp reads whole cache
// rows in coalesced 32 * DPL-element runs, and a score is the lane partial
// dot reduced by shuffles. Only keys in [max(0, kv_len - window), kv_len)
// are read: blocks past kv_len read nothing. The 4 warps combine in shared
// memory; with one split the block writes o, else it writes (m, l, acc) and
// decode_combine merges the splits.
#include <cuda_bf16.h>
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int UNR = 4;                 // keys a warp takes at a time
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// part: (B, KV, n_split, G, 2 + Dv) fp32 rows [m, l, acc...], used when n_split > 1
template <typename T, int G, int DPL>
__global__ void __launch_bounds__(WARPS * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ kv_len,
              T* __restrict__ o, float* __restrict__ part, int L, int KV, int D,
              int Dv, float scale, int window, int chunk, int n_split) {
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int H = KV * G;
  const int len = min(max(kv_len[b], 0), L);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int s0 = max(lo, split * chunk), s1 = min(len, (split + 1) * chunk);

  float qf[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane * DPL + i;
      qf[g][i] = d < D ? to_f(q[((long long)b * H + kvh * G + g) * D + d]) * scale : 0.f;
    }
  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  const long long row_stride = (long long)KV * D, vrow_stride = (long long)KV * Dv;
  const T* kb = k + (long long)b * L * row_stride + (long long)kvh * D;
  const T* vb = v + (long long)b * L * vrow_stride + (long long)kvh * Dv;
  for (int base = s0 + warp * UNR; base < s1; base += WARPS * UNR) {
    float kf[UNR][DPL], vf[UNR][DPL];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const bool valid = base + u < s1;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane * DPL + i;
        kf[u][i] = valid && d < D ? to_f(kb[(base + u) * row_stride + d]) : 0.f;
        vf[u][i] = valid && d < Dv ? to_f(vb[(base + u) * vrow_stride + d]) : 0.f;
      }
    }
    float s[UNR][G];
#pragma unroll
    for (int u = 0; u < UNR; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) dot = fmaf(qf[g][i], kf[u][i], dot);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u][g] = dot;
      }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = s[0][g];                     // key base is always valid
#pragma unroll
      for (int u = 1; u < UNR; ++u)
        if (base + u < s1) mx = fmaxf(mx, s[u][g]);
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        if (base + u >= s1) continue;
        const float p = expf(s[u][g] - m_new);
        l[g] += p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] = fmaf(p, vf[u][i], acc[g][i]);
      }
      m[g] = m_new;
    }
  }

  // combine the warps
  __shared__ float sm_m[WARPS][G], sm_l[WARPS][G];
  __shared__ float sm_acc[WARPS][G][32 * DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) sm_acc[warp][g][lane * DPL + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * Dv; idx += WARPS * 32) {
    const int g = idx / Dv, e = idx % Dv;
    float mm = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, sm_m[w][g]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(sm_m[w][g] - mm);
      ll = fmaf(sm_l[w][g], f, ll);
      aa = fmaf(sm_acc[w][g][e], f, aa);
    }
    if (n_split == 1) {
      store(o + ((long long)b * H + kvh * G + g) * Dv + e, aa / fmaxf(ll, 1e-30f));
    } else {
      float* row = part + ((((long long)b * KV + kvh) * n_split + split) * G + g) * (2 + Dv);
      row[2 + e] = aa;
      if (e == 0) {
        row[0] = mm;
        row[1] = ll;
      }
    }
  }
}

// one block of Dv threads per (row, head): merge the n_split partials
template <typename T>
__global__ void decode_combine(const float* __restrict__ part, T* __restrict__ o,
                               int KV, int G, int Dv, int n_split) {
  const int bh = blockIdx.x;                 // b * H + kvh * G + g
  const int e = threadIdx.x;
  const int H = KV * G;
  const int b = bh / H, h = bh % H, kvh = h / G, g = h % G;
  const float* rows = part + (((long long)b * KV + kvh) * n_split * G + g) * (2 + Dv);
  const long long stride = (long long)G * (2 + Dv);   // from one split to the next
  float mm = NEG_INF;
  for (int s = 0; s < n_split; ++s) mm = fmaxf(mm, rows[s * stride]);
  float ll = 0.f, aa = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float* r = rows + s * stride;
    const float f = expf(r[0] - mm);
    ll = fmaf(r[1], f, ll);
    aa = fmaf(r[2 + e], f, aa);
  }
  store(o + (long long)bh * Dv + e, aa / fmaxf(ll, 1e-30f));
}

template <typename T, int G, int DPL>
int launch(const void* q, const void* k, const void* v, const int* kv_len, void* o,
           float* part, int B, int L, int KV, int D, int Dv, float scale, int window,
           int n_split, cudaStream_t stream) {
  const int chunk = (L + n_split - 1) / n_split;
  decode_kernel<T, G, DPL><<<dim3(KV, B, n_split), WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      kv_len, static_cast<T*>(o), part, L, KV, D, Dv, scale, window, chunk, n_split);
  if (n_split > 1) {
    int rc = launch_status();
    if (rc != 0) return rc;
    decode_combine<T><<<B * KV * G, Dv, 0, stream>>>(part, static_cast<T*>(o), KV, G,
                                                     Dv, n_split);
  }
  return launch_status();
}

// The (G, DPL) pairs of the ported configs: llama3-8b (G = 4, D = 128) and its
// smoke config (G = 2, D = 16). Another config adds its pair here.
template <typename T>
int by_shape(int G, const void* q, const void* k, const void* v, const int* kv_len,
             void* o, float* part, int B, int L, int KV, int D, int Dv, float scale,
             int window, int n_split, cudaStream_t s) {
  const int w = D > Dv ? D : Dv;
  if (G == 2 && w <= 32)
    return launch<T, 2, 1>(q, k, v, kv_len, o, part, B, L, KV, D, Dv, scale, window, n_split, s);
  if (G == 4 && w <= 128)
    return launch<T, 4, 4>(q, k, v, kv_len, o, part, B, L, KV, D, Dv, scale, window, n_split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype 0: fp32, 1: bf16. G = H / KV = 2 with D, Dv <= 32, or G = 4 with
// D, Dv <= 128; B, L > 0; part holds B * KV * n_split * G * (2 + Dv) floats when n_split > 1
// (else may be null). window <= 0 means no window. Returns a cudaError_t.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* kv_len, void* o, void* part, int dtype,
                                int B, int L, int H, int KV, int D, int Dv,
                                float scale, int window, int n_split, void* stream) {
  if (KV <= 0 || H % KV != 0 || D <= 0 || Dv <= 0 || n_split < 1 || (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / KV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(kv_len);
  float* p = static_cast<float*>(part);
  if (dtype == 1)
    return by_shape<__nv_bfloat16>(G, q, k, v, len, o, p, B, L, KV, D, Dv, scale, window,
                                   n_split, s);
  return by_shape<float>(G, q, k, v, len, o, p, B, L, KV, D, Dv, scale, window, n_split, s);
}
