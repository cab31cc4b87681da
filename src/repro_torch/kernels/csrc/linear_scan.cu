// First-order recurrence scans for sm_90a: the Mamba selective scan and the
// RWKV6 scan. Each kernel's note says what it replaces, what bounds it on an
// H100 and what its design does about that.
//
// ---------------------------------------------------------------------------
// Mamba selective scan.
//
// Replaces src/repro/kernels/linear_scan.py `_mamba_kernel` / `mamba_scan` (the
// pallas_call at :74); the contract is src/repro/kernels/ref.py `mamba_scan`.
// For each (b, channel c), with the N-wide state starting at h0 (zeros when
// null):
//   h = exp(delta_t[c] A[c, :]) * h + (delta_t[c] x_t[c]) B_t;  y_t[c] = sum_n h C_t
// Inputs: delta, x (B, S, Di) and Bt, Ct (B, S, N) in bf16 or fp32; A (Di, N)
// fp32; h0 (B, Di, N) fp32 or null; all contiguous. Outputs: y (B, S, Di) in x's
// type and the final state hout (B, Di, N) fp32. hout may alias h0 (the decode
// step updates a cache slice in place): each thread reads and writes only its
// own channel's state. delta x is rounded to x's type before it is widened,
// as the reference and the Pallas kernel round it (__float2bfloat16_rn in
// bf16; the product of two bf16 values is exact in fp32, so this is the
// rounding of a bf16 multiply). expf, not __expf, keeps fp32 within 1e-5.
//
// Bound at the prefill shape (1, 1024, 8192), N = 16, bf16: bytes 51.4 MB
// (delta, x, y 50.3 MB; Bt, Ct, A and the state 1.1 MB) over 3.35 TB/s,
// 0.0154 ms; 6 FLOP a state element a step (delta A, exp(.) h, (delta x) B,
// the add, h C, the add), 0.805 GFLOP over the 67 TFLOP/s fp32 peak,
// 0.0120 ms; and B S Di N = 134M exponentials through the SFU, 16 a clock an
// SM for compute capability 9.0 (CUDA programming guide, arithmetic
// instructions), 4.18e12 a second at 132 SMs and 1.98 GHz, 0.0321 ms: the
// exponentials bind. At the decode shape (8, 1, 8192) the state read and
// written, 8.4 MB, ~0.0025 ms.
//
// Design. Channel c's N state values depend only on delta_t[c], x_t[c], A[c, :]
// and the shared B_t, C_t. So one thread owns one channel, with its N fp32
// state values and its row of A in registers, and y_t[c] is its own N-term dot
// product (four partial sums): nothing is reduced across threads. A block of
// MCOLS threads owns MCOLS channels of one b; the grid is (ceil(Di / MCOLS),
// B). The TPU walked time as the innermost sequential grid axis with the state
// in VMEM; here the time loop runs inside the block over tiles of MTILE steps:
// B_t and C_t (MTILE x N, shared by every channel of the block) and the
// block's delta and delta x (read coalesced across channels) are staged in
// shared memory as fp32, so the serial loop touches no global memory but its
// y stores. The (B, S, Di) layout is read in place (the Pallas kernel
// transposed A and h0) and any S >= 1 is taken: the ragged last tile is
// masked. MCOLS = 32: at B = 1 the 8192 channels make 256 one-warp blocks, so
// every one of the 132 SMs gets one or two (64 channels a block would leave 4
// SMs idle with the same 256 warps). With two warps an SM the serial chain of
// each step (exp, FMA into h, FMA into y) is exposed: the (channel, n) split
// across lanes with a shuffle reduction, or a chunked scan, is later work.
//
// ---------------------------------------------------------------------------
// RWKV6 scan.
//
// Matrix-state linear attention with a data-dependent decay and a bonus for
// the current token.
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

// ---- Mamba --------------------------------------------------------------------

constexpr int MCOLS = 32;  // channels (threads) a block
constexpr int MTILE = 64;  // time steps staged at a time

// x rounded to the type that the tag pointer points to
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T, int N>
__global__ void __launch_bounds__(MCOLS)
mamba_kernel(const T* __restrict__ delta, const T* __restrict__ x,
             const float* __restrict__ A, const T* __restrict__ Bt,
             const T* __restrict__ Ct, const float* h0, T* __restrict__ y,
             float* hout, int S, int Di) {
  const int b = blockIdx.y;
  const int tid = threadIdx.x, c = blockIdx.x * MCOLS + tid;
  const bool active = c < Di;
  __shared__ __align__(16) float bs[MTILE * N];
  __shared__ __align__(16) float cs[MTILE * N];
  __shared__ float ds[MTILE][MCOLS];
  __shared__ float dxs[MTILE][MCOLS];

  const long long sbase = ((long long)b * Di + c) * N;
  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = active ? A[(long long)c * N + n] : 0.f;
    h[n] = (active && h0 != nullptr) ? h0[sbase + n] : 0.f;
  }
  const long long xbase = (long long)b * S * Di + c;   // + t * Di
  const long long nbase = (long long)b * S * N;        // + t * N + n

  for (int t0 = 0; t0 < S; t0 += MTILE) {
    const int steps = min(MTILE, S - t0);
    __syncthreads();               // the previous tile is consumed
    for (int idx = tid; idx < steps * N; idx += MCOLS) {
      bs[idx] = to_f(Bt[nbase + (long long)t0 * N + idx]);
      cs[idx] = to_f(Ct[nbase + (long long)t0 * N + idx]);
    }
    for (int j = 0; j < steps; ++j) {
      float d = 0.f, dx = 0.f;
      if (active) {
        const long long off = xbase + (long long)(t0 + j) * Di;
        d = to_f(delta[off]);
        dx = round_to(d * to_f(x[off]), x);
      }
      ds[j][tid] = d;
      dxs[j][tid] = dx;
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < steps; ++j) {
      const float d = ds[j][tid], dx = dxs[j][tid];
      const float* bj = bs + j * N;
      const float* cj = cs + j * N;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = fmaf(expf(d * a[n]), h[n], dx * bj[n]);
        acc[n % 4] = fmaf(h[n], cj[n], acc[n % 4]);
      }
      store(y + xbase + (long long)(t0 + j) * Di, (acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < N; ++n) hout[sbase + n] = h[n];
  }
}

template <typename T>
int launch_mamba(int N, const void* delta, const void* x, const float* A,
                 const void* Bt, const void* Ct, const float* h0, void* y,
                 float* hout, int B, int S, int Di, cudaStream_t stream) {
  const dim3 grid((Di + MCOLS - 1) / MCOLS, B);
  const T* dt = static_cast<const T*>(delta);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bt);
  const T* ct = static_cast<const T*>(Ct);
  T* yt = static_cast<T*>(y);
  if (N == 16)
    mamba_kernel<T, 16><<<grid, MCOLS, 0, stream>>>(dt, xt, A, bt, ct, h0, yt, hout, S, Di);
  else if (N == 4)
    mamba_kernel<T, 4><<<grid, MCOLS, 0, stream>>>(dt, xt, A, bt, ct, h0, yt, hout, S, Di);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_status();
}

// ---- RWKV6 --------------------------------------------------------------------

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

// dtype 0: fp32, 1: bf16 (delta, x, Bt, Ct and y). N (the state size of A's
// rows and of the state) is 4 or 16, the ported configs' sizes (jamba-v0.1-52b's
// smoke config and jamba-v0.1-52b); B, S, Di > 0; h0 may be null (a zero state)
// and may equal hout. Returns a cudaError_t.
extern "C" int mamba_scan(const void* delta, const void* x, const void* A,
                          const void* Bt, const void* Ct, const void* h0, void* y,
                          void* hout, int dtype, int B, int S, int Di, int N,
                          void* stream) {
  if (B <= 0 || S <= 0 || Di <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(A);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(hout);
  if (dtype == 1)
    return launch_mamba<__nv_bfloat16>(N, delta, x, af, Bt, Ct, h0f, y, hf, B, S, Di, s);
  return launch_mamba<float>(N, delta, x, af, Bt, Ct, h0f, y, hf, B, S, Di, s);
}
