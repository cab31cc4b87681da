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
// Two routes, chosen by the wrapper (kernels/linear_scan.py `_route`).
//
// Serial route (rwkv_kernel): the S = 1 decode step, float32 (held to 1e-5)
// and the smoke config's K = 16. Column v of the state depends only on r_t,
// w_t, k_t (shared by all columns) and on v_t[v]. So one thread owns one
// column, with its K fp32 values in registers, and o_t[v] is that thread's
// own dot product: nothing is reduced across threads. A block of COLS
// threads owns COLS columns of one (b, h); the grid is (ceil(V / COLS), H, B).
// The TPU walked time as the innermost sequential grid axis with the state in
// VMEM; here the time loop runs inside the block. A tile of TILE steps of r,
// w, k (and v for the block's columns) is staged in shared memory as fp32
// with coalesced loads, u stays in shared memory, and each thread walks the
// tile reading r, w, k and u as broadcast float4s. Any S >= 1 is taken: the
// ragged last tile is masked. Per step the order is the reference's:
// kv = k v, o += r (state + u kv), state = w state + kv, with FMA contraction
// and four partial sums for o. At a prefill the serial time loop and 80
// blocks at B = 1 keep it 50x above its bound (0.64 ms at the shape above
// on an H100 80GB HBM3 at 700 W, chip_smoke.py's rwkv_scan yardstick).
//
// Chunked route (rwkv_chunk_*): bf16 at K = V = 64 with S >= 33, rwkv6-3b's
// prefills (shorter ones are faster on the serial kernel). The steps are
// cut into chunks of CH = 64 and those into sub-chunks of 16; three
// launches: the chunks' own state contributions in parallel (a block a
// chunk, the product on the tensor cores), the carry of the state across
// chunks (a thread a state element, one fma a chunk), and
// the outputs in parallel (a block a chunk, two warps a sub-chunk, the
// products on the tensor cores). At the prefill shape that is 640 blocks for
// each parallel pass where the serial route has 80. What bounds it then is
// bytes and latency: the passes move ~95 MB (the inputs twice, the fp32
// chunk states out, through the carry and back in) against the 32.1 MB of
// the bound, and each output block waits on step-by-step decay chains and a
// 16 x 16 diagonal block formed on the CUDA cores. The decay between two steps is
// only ever a product of w over the steps between them, split at sub-chunk
// boundaries (the sub-chunk scheme of the flash-linear-attention chunk_rwkv6
// kernels): the model's w = exp(-exp(z)) reaches 0 and denormals, so a
// prefix product over a chunk underflows and a quotient of two would be
// 0 / 0. The state keeps fp32's accuracy (the decayed k as tf32 hi + lo);
// each term of the output takes one tf32 rounding.
#include <cstdint>
#include <cuda_bf16.h>
#include "common.cuh"
#include "tensor_core.cuh"

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

// ---- RWKV6, chunked route -----------------------------------------------------

namespace tc = tensor_core;

constexpr int CH = 64;          // steps a chunk
constexpr int SUB = 16;         // steps a sub-chunk: one warp's query rows
constexpr int CW = 64;          // the head width K = V it is built for
constexpr int CTHREADS = 256;   // eight warps: a sub-chunk's rows x half the columns
constexpr int LDH = CW + 8;     // bf16 rows: 144 bytes, 16-byte aligned
constexpr int LDA = CW + 4;     // fp32 rows read as [row l / 4][col l % 4]
constexpr int LDB = CW + 8;     // fp32 rows read as [row l % 4][col l / 4]

__device__ __forceinline__ float bf(const __nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ uint32_t bf_tf32(const __nv_bfloat16 x) {
  return __float_as_uint(__bfloat162float(x));   // a bf16 value is exact in tf32
}

// Rows t0 .. t0 + CH - 1 of one (b, h) of a (B, S, H, CW) bf16 tensor into
// dst[CH][LDH] by 16-byte asynchronous copies; rows past S are zero.
__device__ __forceinline__ void copy_rows_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* __restrict__ src,
                                               long long base, long long stride, int t0,
                                               int S) {
  for (int idx = threadIdx.x; idx < CH * (CW / 8); idx += blockDim.x) {
    const int t = idx / (CW / 8), part = idx % (CW / 8);
    const bool valid = t0 + t < S;
    const __nv_bfloat16* from =
        valid ? src + base + (long long)(t0 + t) * stride + 8 * part : src;
    tc::cp_async16(tc::smem_addr(dst + t * LDH + 8 * part), from, valid ? 16 : 0);
  }
}

// The decays of rows t0 .. t0 + CH - 1 into dst[CH][ld] the same way; rows
// past S are 1, so that a ragged chunk's missing steps decay nothing.
__device__ __forceinline__ void copy_rows_w(float* dst, int ld, const float* __restrict__ src,
                                            long long base, long long stride, int t0, int S) {
  for (int idx = threadIdx.x; idx < CH * (CW / 4); idx += blockDim.x) {
    const int t = idx / (CW / 4), part = idx % (CW / 4);
    if (t0 + t < S)
      tc::cp_async16(tc::smem_addr(dst + t * ld + 4 * part),
                     src + base + (long long)(t0 + t) * stride + 4 * part, 16);
    else
      *reinterpret_cast<float4*>(dst + t * ld + 4 * part) = make_float4(1.f, 1.f, 1.f, 1.f);
  }
}

// Pass 1, a block per (chunk c, h, b): the chunk's own contribution to the
// state, U_c = sum_j (k_j * prod_{j<s<C} w_s) v_j^T, and its whole decay
// P_c = prod_{s<C} w_s. The decay after j is taken step by step within j's
// sub-chunk and times the later sub-chunks' whole decays, never as a
// quotient; U_c's product runs on the tensor cores with the decayed k split
// into tf32 hi + lo (v is exact in tf32), so U_c keeps ~2^-21 of fp32.
struct StateSmem {
  __nv_bfloat16 k[CH][LDH], v[CH][LDH];
  float wk[CH][LDB];             // w_j, then in its place k_j prod_{j<s<C} w_s
  float wsub[CH / SUB][CW];      // W_p, sub-chunk p's whole decay
};

__global__ void __launch_bounds__(CTHREADS)
rwkv_chunk_state_kernel(const float* __restrict__ w, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, float* __restrict__ U,
                        float* __restrict__ P, int S, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StateSmem& sm = *reinterpret_cast<StateSmem*>(smem_raw);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, NC = gridDim.x;
  const int tid = threadIdx.x, t0 = c * CH;
  const long long stride = (long long)H * CW;
  const long long base = (long long)b * S * stride + (long long)h * CW;
  copy_rows_bf16(&sm.k[0][0], k, base, stride, t0, S);
  copy_rows_bf16(&sm.v[0][0], v, base, stride, t0, S);
  copy_rows_w(&sm.wk[0][0], LDB, w, base, stride, t0, S);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  const long long blk = ((long long)b * H + h) * NC + c;
  // thread (i, sub-chunk p): the decay after j within p, step by step ...
  const int di = tid % CW, dp = tid / CW;
  {
    float q = 1.f;
#pragma unroll
    for (int j = SUB * (dp + 1) - 1; j >= SUB * dp; --j) {
      const float wj = sm.wk[j][di];
      sm.wk[j][di] = bf(sm.k[j][di]) * q;
      q *= wj;
    }
    sm.wsub[dp][di] = q;
  }
  __syncthreads();
  // ... times the whole decays of the sub-chunks after p
  {
    float after = 1.f;
    for (int p = CH / SUB - 1; p > dp; --p) after *= sm.wsub[p][di];
#pragma unroll
    for (int j = SUB * dp; j < SUB * (dp + 1); ++j) sm.wk[j][di] *= after;
    if (dp == 0) P[blk * CW + di] = after * sm.wsub[0][di];
  }
  __syncthreads();
  const float(&kq)[CH][LDB] = sm.wk;
  const __nv_bfloat16 (&vs)[CH][LDH] = sm.v;
  // warp: state rows 16 (warp % 4) .., columns 32 (warp / 4) ..
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int i0 = SUB * (warp % 4), n0 = (CW / 16) * (warp / 4);
  float acc[CW / 16][4];
#pragma unroll
  for (int nt = 0; nt < CW / 16; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < CH / 8; ++ks) {
    const int j = 8 * ks + t4;
    uint32_t hi[4], lo[4];
    tc::split_tf32(kq[j][i0 + g], hi[0], lo[0]);
    tc::split_tf32(kq[j][i0 + g + 8], hi[1], lo[1]);
    tc::split_tf32(kq[j + 4][i0 + g], hi[2], lo[2]);
    tc::split_tf32(kq[j + 4][i0 + g + 8], hi[3], lo[3]);
#pragma unroll
    for (int nt = 0; nt < CW / 16; ++nt) {
      const int col = 8 * (n0 + nt) + g;
      const uint32_t b0 = bf_tf32(vs[j][col]), b1 = bf_tf32(vs[j + 4][col]);
      tc::mma_tf32(acc[nt], lo[0], lo[1], lo[2], lo[3], b0, b1);
      tc::mma_tf32(acc[nt], hi[0], hi[1], hi[2], hi[3], b0, b1);
    }
  }
  float* u = U + blk * CW * CW;
#pragma unroll
  for (int nt = 0; nt < CW / 16; ++nt) {
    const int col = 8 * (n0 + nt) + 2 * t4;
    *reinterpret_cast<float2*>(u + (i0 + g) * CW + col) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(u + (i0 + g + 8) * CW + col) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// Pass 2, a thread per state element of (b, h): the carry across chunks,
// S_0 = h0 (zeros when null), S_{c+1} = P_c S_c + U_c, one fma a chunk in
// fp32. U_c's slot receives S_c, the state chunk c starts from, and the final
// state goes to hout. hout may alias h0: each thread reads its own element of
// h0 before it writes that element of hout.
constexpr int CARRY_THREADS = 256;
constexpr int CARRY_AHEAD = 16;                  // U loads in flight a thread

__global__ void __launch_bounds__(CARRY_THREADS)
rwkv_chunk_carry_kernel(const float* h0, float* __restrict__ U,
                        const float* __restrict__ P, float* hout, int NC, int H) {
  const int e = blockIdx.x * CARRY_THREADS + threadIdx.x;   // i * CW + column
  const int i = e / CW;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  float s = h0 != nullptr ? h0[bh * CW * CW + e] : 0.f;
  float* u = U + bh * NC * CW * CW + e;
  const float* p = P + bh * NC * CW + i;
  for (int c0 = 0; c0 < NC; c0 += CARRY_AHEAD) {
    float uu[CARRY_AHEAD], pp[CARRY_AHEAD];
#pragma unroll
    for (int a = 0; a < CARRY_AHEAD; ++a) {
      if (c0 + a < NC) {
        uu[a] = u[(long long)(c0 + a) * CW * CW];
        pp[a] = p[(long long)(c0 + a) * CW];
      }
    }
#pragma unroll
    for (int a = 0; a < CARRY_AHEAD; ++a) {
      if (c0 + a < NC) {
        u[(long long)(c0 + a) * CW * CW] = s;
        s = fmaf(pp[a], s, uu[a]);
      }
    }
  }
  hout[bh * CW * CW + e] = s;
}

// Pass 3, a block per (chunk c, h, b), warps q and q + 4 owning the chunk's
// query rows 16 q .. 16 q + 15, one half of the output columns each. With L_t the product of the decays of t's sub-chunk
// before t, and S_c the state the chunk starts from:
//   o_t = (r_t L_t prod_{p<q} W_p) S_c                 (earlier chunks)
//       + sum_{p<q} [(r_t L_t G_pq) . (k_j B_j)] v_j   (earlier sub-chunks)
//       + sum_{j<=t in q} A_tj v_j                     (the diagonal block)
// where W_p is sub-chunk p's whole decay, G_pq = prod_{p<s<q} W_s, B_j the
// product over j's sub-chunk after j, and A_tj = sum_i r_ti k_ji
// prod_{j<s<t} w_si (j < t) or sum_i r_ti u_i k_ti (j = t). Every factor is a
// product of decays over a range, so each is <= 1 and none is a quotient: a
// decay of 0 or a denormal zeroes exactly the terms it should. The products
// run on the tensor cores in tf32: in each, one operand is rounded to tf32
// once and the other is exact in it (v) or carried as hi + lo (S_c, k B, the
// scores), two products into one accumulator. The diagonal block is formed
// per i on the CUDA cores in fp32.
struct OutSmem {
  __nv_bfloat16 r[CH][LDH], k[CH][LDH], v[CH][LDH];
  float w[CH][CW];
  float rl[CH][LDA];             // r_t L_t
  float kb[CH][LDA];             // k_j B_j
  float s[CW][LDB];              // S_c
  float wsub[CH / SUB][CW];      // W_p
  float u[CW];
  float diag[CH / SUB][2][SUB][SUB + 1];   // the two column halves' partial sums
};

// acc (16 rows x 32 columns of o from 8 n0) += scores @ v over 8 steps j:
// the scores as a tf32 hi + lo A fragment whose k index l % 4 stands for
// j = 2 (l % 4) and l % 4 + 4 for j = 2 (l % 4) + 1 (where a score
// accumulator holds them), and rows v0 (j = 2 (l % 4)) and v1 (the next) of
// v, exact in tf32
__device__ __forceinline__ void value_product(float (&acc)[CW / 16][4], const uint32_t (&hi)[4],
                                              const uint32_t (&lo)[4],
                                              const __nv_bfloat16* v0,
                                              const __nv_bfloat16* v1, int g, int n0) {
#pragma unroll
  for (int nn = 0; nn < CW / 16; ++nn) {
    const int col = 8 * (n0 + nn) + g;
    const uint32_t b0 = bf_tf32(v0[col]), b1 = bf_tf32(v1[col]);
    tc::mma_tf32(acc[nn], lo[0], lo[1], lo[2], lo[3], b0, b1);
    tc::mma_tf32(acc[nn], hi[0], hi[1], hi[2], hi[3], b0, b1);
  }
}

__global__ void __launch_bounds__(CTHREADS)
rwkv_chunk_out_kernel(const __nv_bfloat16* __restrict__ r, const float* __restrict__ w,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ u,
                      const float* __restrict__ Sc, __nv_bfloat16* __restrict__ o, int S,
                      int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  OutSmem& sm = *reinterpret_cast<OutSmem*>(smem_raw);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, NC = gridDim.x;
  const int tid = threadIdx.x, t0 = c * CH;
  const long long stride = (long long)H * CW;
  const long long base = (long long)b * S * stride + (long long)h * CW;
  copy_rows_bf16(&sm.r[0][0], r, base, stride, t0, S);
  copy_rows_bf16(&sm.k[0][0], k, base, stride, t0, S);
  copy_rows_bf16(&sm.v[0][0], v, base, stride, t0, S);
  copy_rows_w(&sm.w[0][0], CW, w, base, stride, t0, S);
  const float* sc = Sc + (((long long)b * H + h) * NC + c) * CW * CW;
  for (int idx = tid; idx < CW * (CW / 4); idx += CTHREADS) {
    const int i = idx / (CW / 4), part = idx % (CW / 4);
    tc::cp_async16(tc::smem_addr(&sm.s[i][4 * part]), sc + i * CW + 4 * part, 16);
  }
  if (tid < CW / 4)
    tc::cp_async16(tc::smem_addr(&sm.u[4 * tid]), u + h * CW + 4 * tid, 16);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  // the decays within each sub-chunk, step by step, thread (i, sub-chunk):
  // forward for r (and W_p), backward for k
  {
    const int i = tid % CW, p = tid / CW;
    float l = 1.f;
#pragma unroll
    for (int t = SUB * p; t < SUB * (p + 1); ++t) {
      sm.rl[t][i] = bf(sm.r[t][i]) * l;
      l *= sm.w[t][i];
    }
    sm.wsub[p][i] = l;
    float q = 1.f;
#pragma unroll
    for (int j = SUB * (p + 1) - 1; j >= SUB * p; --j) {
      sm.kb[j][i] = bf(sm.k[j][i]) * q;
      q *= sm.w[j][i];
    }
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int sq = warp % (CH / SUB), half_v = warp / (CH / SUB);
  const int tq = SUB * sq, n0 = (CW / 16) * half_v;   // rows; first 8-column tile
  float acc[CW / 16][4];
#pragma unroll
  for (int nt = 0; nt < CW / 16; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  // dec[x]: a decay of the i column that A fragment register x holds,
  // i = t4 + 8 (x / 2) + 4 (x % 2); first prod_{p<q} W_p
  float dec[2 * (CW / 8)];
#pragma unroll
  for (int x = 0; x < 2 * (CW / 8); ++x) {
    const int i = t4 + 4 * (x & 1) + 8 * (x >> 1);
    float d = 1.f;
    for (int p = 0; p < sq; ++p) d *= sm.wsub[p][i];
    dec[x] = d;
  }
  // earlier chunks: (r L prod W) @ S_c
#pragma unroll
  for (int ks = 0; ks < CW / 8; ++ks) {
    const int i = 8 * ks + t4;
    const uint32_t a0 = tc::to_tf32(sm.rl[tq + g][i] * dec[2 * ks]);
    const uint32_t a1 = tc::to_tf32(sm.rl[tq + g + 8][i] * dec[2 * ks]);
    const uint32_t a2 = tc::to_tf32(sm.rl[tq + g][i + 4] * dec[2 * ks + 1]);
    const uint32_t a3 = tc::to_tf32(sm.rl[tq + g + 8][i + 4] * dec[2 * ks + 1]);
#pragma unroll
    for (int nt = 0; nt < CW / 16; ++nt) {
      const int col = 8 * (n0 + nt) + g;
      uint32_t b0, b1, l0, l1;
      tc::split_tf32(sm.s[i][col], b0, l0);
      tc::split_tf32(sm.s[i + 4][col], b1, l1);
      tc::mma_tf32(acc[nt], a0, a1, a2, a3, l0, l1);
      tc::mma_tf32(acc[nt], a0, a1, a2, a3, b0, b1);
    }
  }

  // earlier sub-chunks p = q - 1 .. 0, G_pq growing by W_p after each
#pragma unroll
  for (int x = 0; x < 2 * (CW / 8); ++x) dec[x] = 1.f;
  for (int p = sq - 1; p >= 0; --p) {
    float score[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < CW / 8; ++ks) {
      const int i = 8 * ks + t4;
      const uint32_t a0 = tc::to_tf32(sm.rl[tq + g][i] * dec[2 * ks]);
      const uint32_t a1 = tc::to_tf32(sm.rl[tq + g + 8][i] * dec[2 * ks]);
      const uint32_t a2 = tc::to_tf32(sm.rl[tq + g][i + 4] * dec[2 * ks + 1]);
      const uint32_t a3 = tc::to_tf32(sm.rl[tq + g + 8][i + 4] * dec[2 * ks + 1]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = SUB * p + 8 * nt + g;
        uint32_t b0, b1, l0, l1;
        tc::split_tf32(sm.kb[j][i], b0, l0);
        tc::split_tf32(sm.kb[j][i + 4], b1, l1);
        tc::mma_tf32(score[nt], a0, a1, a2, a3, l0, l1);
        tc::mma_tf32(score[nt], a0, a1, a2, a3, b0, b1);
      }
    }
    // scores (t, j) @ v_j, each 8 j from the score accumulator as it stands
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int j = SUB * p + 8 * nt + 2 * t4;
      uint32_t hi[4], lo[4];
      tc::split_tf32(score[nt][0], hi[0], lo[0]);
      tc::split_tf32(score[nt][2], hi[1], lo[1]);
      tc::split_tf32(score[nt][1], hi[2], lo[2]);
      tc::split_tf32(score[nt][3], hi[3], lo[3]);
      value_product(acc, hi, lo, sm.v[j], sm.v[j + 1], g, n0);
    }
#pragma unroll
    for (int x = 0; x < 2 * (CW / 8); ++x)
      dec[x] *= sm.wsub[p][t4 + 4 * (x & 1) + 8 * (x >> 1)];
  }

  // the diagonal block: lane (t = l % 16, half = l / 16) of warp half_v sums
  // over i = 4 m + 2 half_v + half, the decay between j and t taken step by
  // step from j = t - 1 down; the two warps of a sub-chunk then add their
  // partial blocks in a fixed order
  {
    const int t = lane & (SUB - 1), half = lane >> 4;
    float a[SUB];
#pragma unroll
    for (int j = 0; j < SUB; ++j) a[j] = 0.f;
    // selects, not branches: lanes of one warp hold different t
    for (int m = 0; m < CW / 4; ++m) {
      const int i = 4 * m + 2 * half_v + half;
      const float rr = bf(sm.r[tq + t][i]), ru = rr * sm.u[i];
      float pr = 1.f;
#pragma unroll
      for (int j = SUB - 1; j >= 0; --j) {
        const float kk = bf(sm.k[tq + j][i]), wj = sm.w[tq + j][i];
        const float coef = j < t ? rr * pr : (j == t ? ru : 0.f);
        a[j] = fmaf(coef, kk, a[j]);
        pr = j < t ? pr * wj : pr;
      }
    }
#pragma unroll
    for (int j = 0; j < SUB; ++j) a[j] += __shfl_xor_sync(0xffffffffu, a[j], 16);
    if (half == 0) {
#pragma unroll
      for (int j = 0; j < SUB; ++j) sm.diag[sq][half_v][t][j] = a[j];
    }
    __syncthreads();                             // both halves' partials
    const float(&d0)[SUB][SUB + 1] = sm.diag[sq][0];
    const float(&d1)[SUB][SUB + 1] = sm.diag[sq][1];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int jj = 8 * nt + 2 * t4;
      uint32_t hi[4], lo[4];
      tc::split_tf32(d0[g][jj] + d1[g][jj], hi[0], lo[0]);
      tc::split_tf32(d0[g + 8][jj] + d1[g + 8][jj], hi[1], lo[1]);
      tc::split_tf32(d0[g][jj + 1] + d1[g][jj + 1], hi[2], lo[2]);
      tc::split_tf32(d0[g + 8][jj + 1] + d1[g + 8][jj + 1], hi[3], lo[3]);
      value_product(acc, hi, lo, sm.v[tq + jj], sm.v[tq + jj + 1], g, n0);
    }
  }

  // o rows 16 q + g and + 8, this warp's 32 columns, as bf16 pairs
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = t0 + tq + g + 8 * half;
    if (t >= S) continue;
    __nv_bfloat16* orow = o + base + (long long)t * stride;
#pragma unroll
    for (int nn = 0; nn < CW / 16; ++nn)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * (n0 + nn) + 2 * t4) =
          __floats2bfloat162_rn(acc[nn][2 * half], acc[nn][2 * half + 1]);
  }
}

int launch_chunk(const __nv_bfloat16* r, const float* w, const __nv_bfloat16* k,
                 const __nv_bfloat16* v, const float* u, const float* h0, __nv_bfloat16* o,
                 float* hout, float* U, float* P, int B, int S, int H, cudaStream_t stream) {
  static bool opted_in = false;                  // shared-memory opt-in, once
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        rwkv_chunk_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(StateSmem)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(rwkv_chunk_out_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(sizeof(OutSmem)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int NC = (S + CH - 1) / CH;
  const dim3 grid(NC, H, B);
  rwkv_chunk_state_kernel<<<grid, CTHREADS, sizeof(StateSmem), stream>>>(w, k, v, U, P, S,
                                                                          H);
  int rc = launch_status();
  if (rc != 0) return rc;
  rwkv_chunk_carry_kernel<<<dim3(CW * CW / CARRY_THREADS, H, B), CARRY_THREADS, 0, stream>>>(
      h0, U, P, hout, NC, H);
  rc = launch_status();
  if (rc != 0) return rc;
  rwkv_chunk_out_kernel<<<grid, CTHREADS, sizeof(OutSmem), stream>>>(r, w, k, v, u, U, o, S,
                                                                     H);
  return launch_status();
}

}  // namespace

// The chunked route: bf16 r, k, v and o, K = V = 64, S >= 1, B, H <= 65535;
// w, u, h0 (or null, a zero state; may equal hout) and hout fp32. Workspaces
// U (B, H, ceil(S / 64), 64, 64) and P (B, H, ceil(S / 64), 64) fp32, 16-byte
// aligned like every other pointer. Three launches on the stream. Returns a
// cudaError_t.
extern "C" int rwkv_scan_chunk(const void* r, const void* w, const void* k, const void* v,
                               const void* u, const void* h0, void* o, void* hout, void* U,
                               void* P, int B, int S, int H, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_chunk(static_cast<const __nv_bfloat16*>(r), static_cast<const float*>(w),
                      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
                      static_cast<const float*>(u), static_cast<const float*>(h0),
                      static_cast<__nv_bfloat16*>(o), static_cast<float*>(hout),
                      static_cast<float*>(U), static_cast<float*>(P), B, S, H,
                      static_cast<cudaStream_t>(stream));
}

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
