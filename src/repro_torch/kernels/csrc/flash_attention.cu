// Flash attention (prefill) for sm_90a: online softmax over K/V tiles.
//
// Replaces src/repro/kernels/flash_attention.py `_kernel` / `flash_attention`
// (the pallas_call at :115): q (B, Sq, H, D), k (B, Skv, KV, D),
// v (B, Skv, KV, Dv), bf16 or fp32, contiguous, in the reference's layout
// -> o (B, Sq, H, Dv) in q's type. Causal and sliding-window masks,
// q_offset, and GQA by kv head = h / (H / KV) with no KV expansion.
// Arithmetic as the reference: q * scale in fp32, fp32 scores, masked
// scores set to NEG_INF = -1e30, fp32 running (m, l, acc), acc / max(l, 1e-30).
//
// Bound: operations. A causal prefill of S tokens does 2 * S^2 * H * (D + Dv)
// / 2 FLOP against 2 * S * (H * (D + Dv) + 2 * KV * D) bytes (bf16): at
// S = 1024, H = 32 that is 8.6 GFLOP against 10.5 MB, ~500 FLOP a byte.
// Design (simple, no tensor cores; wgmma/TMA is later work): one block of
// 256 threads per (q tile of 64 rows, head, batch), heaviest causal tiles
// launched first. The q tile is loaded once, scaled, transposed into shared
// memory as fp32; for each K/V tile of 64 keys the block stages K
// (transposed) and V in shared memory, each thread computes a 4x4 block of
// scores (rows ty + 16 i, columns tx + 16 j: strided so that shared-memory
// reads hit distinct banks or broadcast), the 16 threads of a row reduce max
// and sum by warp shuffles, P goes to shared memory over the spent K tile,
// and each thread accumulates 4 rows x 8 output columns of P @ V in
// registers. Tiles wholly masked by causality or the window are never
// loaded. Ragged tiles (Sq or Skv not a multiple of 64) are masked here:
// rows past Sq are not stored, keys past Skv load as zeros and score NEG_INF.
#include <cuda_bf16.h>
#include "common.cuh"

namespace {

constexpr int BQ = 64, BK = 64;           // q rows and keys per tile
constexpr int TX = 16, TY = 16;           // 256 threads as 16 x 16
constexpr int RPT = BQ / TY;              // 4 rows a thread
constexpr int CPT = BK / TX;              // 4 score columns a thread
constexpr int MAX_DV = 128;
constexpr int VPT = MAX_DV / TX;          // 8 output columns a thread
constexpr int MAX_D = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(TX * TY, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
             int H, int KV, int D, int Dv, float scale, int causal,
             int window, int q_offset) {
  extern __shared__ float smem[];
  float* Qt = smem;                            // [D][BQ + 1]
  float* Kt = Qt + D * (BQ + 1);               // [D][BK + 1], then P [BQ][BK + 1]
  float* Vs = Kt + (D > BQ ? D : BQ) * (BK + 1);   // [BK][Dv]
  float* Ps = Kt;

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;

  for (int i = tid; i < BQ * D; i += TX * TY) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (q0 + r < Sq) x = to_f(q[((long long)(b * Sq + q0 + r) * H + h) * D + d]) * scale;
    Qt[d * (BQ + 1) + r] = x;
  }

  // the K/V tiles this q tile can see
  const int n_k = (Skv + BK - 1) / BK;
  int kt_end = n_k;
  if (causal) {
    const int last_q = min(q0 + BQ, Sq) - 1 + q_offset;
    kt_end = last_q < 0 ? 0 : min(n_k, last_q / BK + 1);
  }
  int kt_begin = 0;
  if (window > 0) {
    const int first_k = q0 + q_offset - window + 1;   // first key any row sees
    if (first_k > 0) kt_begin = first_k / BK;
  }

  float m[RPT], l[RPT], acc[RPT][VPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < VPT; ++e) acc[i][e] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                           // the last tile's P and V are spent
    for (int i = tid; i < BK * D; i += TX * TY) {
      const int c = i / D, d = i % D;
      float x = 0.f;
      if (k0 + c < Skv) x = to_f(k[((long long)(b * Skv + k0 + c) * KV + kvh) * D + d]);
      Kt[d * (BK + 1) + c] = x;
    }
    for (int i = tid; i < BK * Dv; i += TX * TY) {
      const int c = i / Dv, e = i % Dv;
      float x = 0.f;
      if (k0 + c < Skv) x = to_f(v[((long long)(b * Skv + k0 + c) * KV + kvh) * Dv + e]);
      Vs[c * Dv + e] = x;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[RPT], bk[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = Qt[d * (BQ + 1) + ty + TY * i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) bk[j] = Kt[d * (BK + 1) + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
    __syncthreads();                           // every thread is done with Kt

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + ty + TY * i + q_offset;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + TX * j;
        bool ok = kpos < Skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (!ok) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, TX));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty + TY * i) * (BK + 1) + tx + TX * j] = p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off, TX);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < VPT; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float vv[VPT];
#pragma unroll
      for (int e = 0; e < VPT; ++e) {
        const int col = tx + TX * e;
        vv[e] = col < Dv ? Vs[c * Dv + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = Ps[(ty + TY * i) * (BK + 1) + c];
#pragma unroll
        for (int e = 0; e < VPT; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty + TY * i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((long long)(b * Sq + r) * H + h) * Dv;
#pragma unroll
    for (int e = 0; e < VPT; ++e) {
      const int col = tx + TX * e;
      if (col < Dv) store(orow + col, acc[i][e] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Skv, int H, int KV, int D, int Dv, float scale, int causal,
           int window, int q_offset, cudaStream_t stream) {
  const size_t rows_kp = D > BQ ? D : BQ;     // K tile rows, reused for P
  const size_t smem =
      sizeof(float) * ((size_t)D * (BQ + 1) + rows_kp * (BK + 1) + (size_t)BK * Dv);
  static size_t opted_in = 0;                 // shared-memory opt-in, once per size
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<T><<<grid, TX * TY, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, H, KV, D, Dv, scale, causal, window, q_offset);
  return launch_status();
}

}  // namespace

// dtype 0: fp32, 1: bf16. H % KV == 0, 0 < D <= 256, 0 < Dv <= 128,
// B * Sq > 0, Skv > 0; window <= 0 means no window. Returns a cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               int dtype, int B, int Sq, int Skv, int H, int KV,
                               int D, int Dv, float scale, int causal, int window,
                               int q_offset, void* stream) {
  if (D <= 0 || D > MAX_D || Dv <= 0 || Dv > MAX_DV || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, KV, D, Dv, scale, causal,
                                 window, q_offset, s);
  return launch<float>(q, k, v, o, B, Sq, Skv, H, KV, D, Dv, scale, causal, window,
                       q_offset, s);
}
