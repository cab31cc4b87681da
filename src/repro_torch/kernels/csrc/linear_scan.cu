// RWKV6 scan for sm_90a: matrix-state linear attention with a data-dependent
// decay and a bonus for the current token.
//
// Replaces src/repro/kernels/linear_scan.py `_rwkv_kernel` / `rwkv_scan` (the
// pallas_call at :147); the contract is src/repro/kernels/ref.py `rwkv_scan`.
// For each (b, h), with the (K, V) state starting at h0 (zeros when null):
//   kv = k_t v_t^T;  o_t = r_t . (state + diag(u) kv);  state = diag(w_t) state + kv
// Inputs: r, k (B, S, H, K) and v (B, S, H, V) in bf16 or fp32; w (B, S, H, K)
// fp32; u (H, K) fp32; h0 (B, H, K, V) fp32 or null; all contiguous. Outputs:
// o (B, S, H, V) in v's type and the final state hout (B, H, K, V) fp32. hout
// may alias h0 (the decode step updates a cache slice in place): each thread
// reads and writes only its own column of the state.
//
// Bound: at the prefill shape (1, 1024, 40, 64) in bf16, bytes and FLOP are
// about equal: 32.8 MB (r, k, v, o in bf16, w in fp32, the state) over
// 3.35 TB/s and ~4 K V FLOP a head-step over the fp32 peak, ~10 us each. At
// the decode shape (8, 1, 40, 64) the state read and written, 10.5 MB, ~3 us.
//
// Design. Column v of the state depends only on r_t, w_t, k_t (shared by all
// columns) and on v_t[v]. So one thread owns one column, with its K fp32
// values in registers, and o_t[v] is that thread's own dot product: nothing is
// reduced across threads. A block of COLS threads owns COLS columns of one
// (b, h); the grid is (ceil(V / COLS), H, B). The TPU walked time as the
// innermost sequential grid axis with the state in VMEM; here the time loop
// runs inside the block. A tile of TILE steps of r, w, k (and v for the
// block's columns) is staged in shared memory as fp32 with coalesced loads
// (each (t, h) row of K values is contiguous), u stays in shared memory, and
// each thread walks the tile reading r, w, k and u as broadcast float4s. The
// (B, S, H, .) layout of the projections is read in place (no transposes) and
// any S >= 1 is taken: the ragged last tile is masked. Per step the order is
// the reference's: kv = k v, o += r (state + u kv), state = w state + kv, with
// FMA contraction and four partial sums for o. The serial time loop and
// B * H * V / COLS blocks (80 at B = 1 for 132 SMs) keep this far above its
// bound at prefill; the chunked form on tensor cores is later work.
#include <cuda_bf16.h>
#include "common.cuh"

namespace {

constexpr int COLS = 32;   // state columns (threads) a block
constexpr int TILE = 32;   // time steps staged at a time

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// one (row i, column) element of one step
__device__ __forceinline__ void step(float r, float w, float k, float u, float vv,
                                     float& s, float& acc) {
  const float kv = k * vv;
  acc = fmaf(r, fmaf(u, kv, s), acc);
  s = fmaf(w, s, kv);
}

template <typename T, int K>
__global__ void __launch_bounds__(COLS)
rwkv_kernel(const T* __restrict__ r, const float* __restrict__ w,
            const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ u, const float* h0, T* __restrict__ o,
            float* hout, int S, int H, int V) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, col = blockIdx.x * COLS + tid;
  const bool active = col < V;
  __shared__ __align__(16) float rs[TILE][K];
  __shared__ __align__(16) float ws[TILE][K];
  __shared__ __align__(16) float ks[TILE][K];
  __shared__ __align__(16) float us[K];
  __shared__ float vs[TILE][COLS];

  for (int i = tid; i < K; i += COLS) us[i] = u[h * K + i];

  const long long sbase = ((long long)b * H + h) * K * V + col;   // + i * V
  float st[K];
#pragma unroll
  for (int i = 0; i < K; ++i)
    st[i] = (active && h0 != nullptr) ? h0[sbase + (long long)i * V] : 0.f;

  const long long HK = (long long)H * K, HV = (long long)H * V;
  const long long kbase = (long long)b * S * HK + (long long)h * K;   // + t * HK + i
  const long long vbase = (long long)b * S * HV + (long long)h * V;   // + t * HV + col

  for (int t0 = 0; t0 < S; t0 += TILE) {
    const int n = min(TILE, S - t0);
    __syncthreads();               // the previous tile is consumed (and us is written)
    for (int idx = tid; idx < n * K; idx += COLS) {
      const int j = idx / K, i = idx % K;
      const long long off = kbase + (long long)(t0 + j) * HK + i;
      rs[j][i] = to_f(r[off]);
      ws[j][i] = w[off];
      ks[j][i] = to_f(k[off]);
    }
    for (int j = 0; j < n; ++j)
      vs[j][tid] = active ? to_f(v[vbase + (long long)(t0 + j) * HV + col]) : 0.f;
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < n; ++j) {
      const float vv = vs[j][tid];
      const float4* r4 = reinterpret_cast<const float4*>(rs[j]);
      const float4* w4 = reinterpret_cast<const float4*>(ws[j]);
      const float4* k4 = reinterpret_cast<const float4*>(ks[j]);
      const float4* u4 = reinterpret_cast<const float4*>(us);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {
        const float4 rr = r4[q], ww = w4[q], kk = k4[q], uu = u4[q];
        step(rr.x, ww.x, kk.x, uu.x, vv, st[4 * q + 0], a0);
        step(rr.y, ww.y, kk.y, uu.y, vv, st[4 * q + 1], a1);
        step(rr.z, ww.z, kk.z, uu.z, vv, st[4 * q + 2], a2);
        step(rr.w, ww.w, kk.w, uu.w, vv, st[4 * q + 3], a3);
      }
      store(o + vbase + (long long)(t0 + j) * HV + col, (a0 + a1) + (a2 + a3));
    }
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < K; ++i) hout[sbase + (long long)i * V] = st[i];
  }
}

template <typename T>
int launch(int K, const void* r, const float* w, const void* k, const void* v,
           const float* u, const float* h0, void* o, float* hout, int B, int S, int H,
           int V, cudaStream_t stream) {
  const dim3 grid((V + COLS - 1) / COLS, H, B);
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (K == 64)
    rwkv_kernel<T, 64><<<grid, COLS, 0, stream>>>(rt, w, kt, vt, u, h0, ot, hout, S, H, V);
  else if (K == 16)
    rwkv_kernel<T, 16><<<grid, COLS, 0, stream>>>(rt, w, kt, vt, u, h0, ot, hout, S, H, V);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_status();
}

}  // namespace

// dtype 0: fp32, 1: bf16 (r, k, v and o). K (the head width of r, w, k, u and
// of the state's rows) is 16 or 64, the ported configs' widths (rwkv6-3b and
// its smoke config); B, S, H, V > 0; h0 may be null (a zero state) and may
// equal hout. Returns a cudaError_t.
extern "C" int rwkv_scan(const void* r, const void* w, const void* k, const void* v,
                         const void* u, const void* h0, void* o, void* hout, int dtype,
                         int B, int S, int H, int K, int V, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || V <= 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(hout);
  if (dtype == 1)
    return launch<__nv_bfloat16>(K, r, wf, k, v, uf, h0f, o, hf, B, S, H, V, s);
  return launch<float>(K, r, wf, k, v, uf, h0f, o, hf, B, S, H, V, s);
}
