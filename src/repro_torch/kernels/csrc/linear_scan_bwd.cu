// Backward kernels of the two first-order recurrence scans for sm_90a: the
// Mamba selective scan and the RWKV6 scan (forwards in linear_scan.cu).
//
// They replace no TPU kernel: the JAX package differentiates its XLA scans
// (src/repro/kernels/ops.py `_xla_mamba_scan` at :263 and `_xla_rwkv_scan` at
// :325) by autodiff, and its Pallas scans (src/repro/kernels/linear_scan.py, the
// pallas_calls at :74 and :147) have no backward. A reverse-time recurrence is
// neither an elementwise pass nor a plain reduction, so each is written here.
// The wrappers (kernels/linear_scan.py `mamba_scan_bwd`, `rwkv_scan_bwd`) hold
// the formulas in plain PyTorch beside them (`*_bwd_plain`).
//
// Both take the checkpoints their forward wrote when asked: the state before
// steps 0, CK, 2 CK, ... (CK = 64). Each block walks the chunks from the last
// to the first: it recomputes the chunk's states forward from its checkpoint,
// writing the state before each step into a history that only the writing
// thread reads back (global memory, so ~L2: no shared memory is large enough
// for 64 steps of state), then walks the chunk backwards with the adjoint of
// the state in registers. No state is ever stepped backwards by dividing by a
// decay: decays of 0 and denormals are what the models produce. Reductions
// across threads are warp shuffles in a fixed order, across blocks partial
// sums in a workspace added up in a fixed order by a second launch
// (sum_parts_kernel): no float atomics, so a result is the same from run to
// run.
//
// ---------------------------------------------------------------------------
// Mamba. Forward h_t = a_t h_{t-1} + (dx)_t B_t, a_t = exp(delta_t A),
// (dx)_t = delta_t x_t rounded to x's type, y_t = sum_n h_t C_t. With the
// adjoint g_t = dL/dh_t = dy_t C_t + a_{t+1} g_{t+1}, seeded by the final
// state's gradient:
//   dC_t = sum_Di dy_t h_t,   dB_t = sum_Di g_t (dx)_t,
//   d(dx)_t = sum_N g_t B_t (passed straight through the rounding, as a convert
//   is in JAX: d delta_t += d(dx)_t x_t, dx_t = d(dx)_t delta_t),
//   d delta_t += sum_N g_t h_{t-1} a_t A,  dA = sum_{b,t} g_t h_{t-1} a_t delta_t,
//   dh0 = a_0 g_0.
// One thread owns one (b, channel) with its N states, its adjoint and its dA
// sums in registers, as the forward's serial route; a block is one warp of 32
// channels. dB and dC reduce over Di: each warp sums its 32 channels by a
// reduce-scatter over the lanes (N / 2 + N / 4 + ... shuffles, then a butterfly
// over the rest: 16 a quantity at N = 16 rather than 80), writes one partial
// a (warp, b, t, n), and sum_parts_kernel adds the ceil(Di / 32) partials in
// warp order. dA adds the B per-row sums the same way.
// Bound at jamba's training shape (4, 1024, 8192), N = 16, bf16: ~18 FLOP and
// one exponential a state element a step (537M element-steps): 9.7 GFLOP over
// the 67 TFLOP/s fp32 peak, 0.144 ms; the exponentials 0.128 ms on the SFU;
// bytes ~0.1 ms. What bounds this design is latency: 1,024 one-warp blocks of
// a serial chain of 2 S steps each, and the history's traffic (two passes of
// 64 B a thread a step). It takes 2.92 ms there in bf16 (H100 80GB HBM3 at
// 700 W, chip_smoke.py's time_scan_bwd), 20x the bound.
//
// ---------------------------------------------------------------------------
// RWKV6. Forward kv_t = k_t v_t^T, o_t = r_t^T (S_{t-1} + diag(u) kv_t),
// S_t = diag(w_t) S_{t-1} + kv_t. With G_t = dL/dS_t, G_{t-1} = diag(w_t) G_t
// + r_t do_t^T seeded by the final state's gradient:
//   dr_t = S_{t-1} do_t + u k_t (v_t . do_t),  dk_t = G_t v_t + u r_t (v_t . do_t),
//   dv_t = G_t^T k_t + (r_t . (u k_t)) do_t,  dw_t = rowsum(G_t o S_{t-1}),
//   du = sum_{b,t} r_t k_t (v_t . do_t),  dh0 = G_{-1}.
// A block owns one (b, head): K x RQ threads, thread (i, q) row i of G and of
// the state, columns [q K / RQ, (q + 1) K / RQ) (16 at K = 64), in registers.
// dr, dk, dw reduce over the RQ = 4 threads of a row (two shuffles); dv over
// the K rows: a butterfly over the 8 rows of a warp, then the warps' partials
// of RT steps in shared memory summed by the block after the tile; du over
// (b, t): each row's sum over t in a register, then over b by sum_parts_kernel.
// Bound at rwkv6-3b's training shape (4, 1024, 40, 64), bf16 with fp32 w:
// ~12 FLOP a state element a step, 8.1 GFLOP, 0.12 ms at the fp32 peak; bytes
// ~0.08 ms. What bounds this design is latency: 160 blocks of 256 threads, a
// serial chain of 2 S steps each, and the history's traffic. It takes 4.52 ms
// there (H100 80GB HBM3 at 700 W, chip_smoke.py's time_scan_bwd), 38x the
// bound.
#include <cuda_bf16.h>
#include "common.cuh"

namespace {

constexpr int CK = 64;                  // steps between checkpoints
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// x rounded to the type that the tag pointer points to
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// out[e] = sum_{p < P} in[p * pstride + e], p in order, for e < E
template <typename T>
__global__ void __launch_bounds__(256)
sum_parts_kernel(const float* __restrict__ in, T* __restrict__ out, int P, long long E,
                 long long pstride) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += in[p * pstride + e];
  store(out + e, s);
}

template <typename T>
int sum_parts(const float* in, T* out, int P, long long E, long long pstride,
              cudaStream_t stream) {
  const long long blocks = (E + 255) / 256;
  sum_parts_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(in, out, P, E,
                                                                         pstride);
  return launch_status();
}

// ---- Mamba -----------------------------------------------------------------------

// One round of the reduce-scatter: lanes whose MASK bit is set keep the upper
// half of v, the others the lower half, each adding its partner's copy.
template <int HS, int MASK, int N>
__device__ __forceinline__ void scatter_rounds(float (&v)[N], int lane) {
  if constexpr (HS >= 1) {
    const bool upper = (lane & MASK) != 0;
#pragma unroll
    for (int i = 0; i < HS; ++i) {
      const float send = upper ? v[i] : v[i + HS];
      const float keep = upper ? v[i + HS] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, MASK);
    }
    scatter_rounds<HS / 2, MASK / 2, N>(v, lane);
  }
}

// The sum over the warp's 32 lanes of v[n] for n = lane / (32 / N), on every
// lane (v is consumed)
template <int N>
__device__ __forceinline__ float warp_sum_scatter(float (&v)[N], int lane) {
  scatter_rounds<N / 2, 16, N>(v, lane);
  float s = v[0];
#pragma unroll
  for (int m = 16 / N; m >= 1; m /= 2) s += __shfl_xor_sync(FULL, s, m);
  return s;
}

template <typename T, int N>
__global__ void __launch_bounds__(32)
mamba_bwd_kernel(const T* __restrict__ delta, const T* __restrict__ x,
                 const float* __restrict__ A, const T* __restrict__ Bt,
                 const T* __restrict__ Ct, const float* __restrict__ ckpt,
                 const T* __restrict__ dy, const float* __restrict__ dhT,
                 T* __restrict__ ddelta, T* __restrict__ dx, float* __restrict__ dA_part,
                 float* __restrict__ dbc_part, float* __restrict__ dh0,
                 float* __restrict__ hist, int S, int Di) {
  static_assert(32 % N == 0, "N divides the warp");
  const int w = blockIdx.x, b = blockIdx.y, nw = gridDim.x, B = gridDim.y;
  const int lane = threadIdx.x, c = w * 32 + lane;
  const bool active = c < Di;
  const int NC = (S + CK - 1) / CK;
  float a[N], g[N], da[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = active ? A[(long long)c * N + n] : 0.f;
    g[n] = (active && dhT != nullptr) ? dhT[((long long)b * Di + c) * N + n] : 0.f;
    da[n] = 0.f;
  }
  // this warp's history, (CK, N, 32 lanes): the state before each step
  float* hw = hist + ((long long)b * nw + w) * CK * N * 32 + lane;
  const long long xbase = (long long)b * S * Di + c;        // + t Di
  const long long nbase = (long long)b * S * N;              // + t N + n
  const long long SN = (long long)S * N;
  for (int ch = NC - 1; ch >= 0; --ch) {
    const int t0 = ch * CK, steps = min(CK, S - t0);
    float h[N];
    const float* ck = ckpt + (((long long)b * NC + ch) * Di + c) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = active ? ck[n] : 0.f;
    // the chunk forward from its checkpoint
    for (int j = 0; j < steps; ++j) {
      const long long off = xbase + (long long)(t0 + j) * Di;
      float d = 0.f, dxv = 0.f;
      if (active) {
        d = to_f(delta[off]);
        dxv = round_to(d * to_f(x[off]), x);
      }
      const T* bt = Bt + nbase + (long long)(t0 + j) * N;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        hw[(j * N + n) * 32] = h[n];
        h[n] = fmaf(expf(d * a[n]), h[n], dxv * to_f(bt[n]));
      }
    }
    // ... and backwards through it
    for (int j = steps - 1; j >= 0; --j) {
      const int t = t0 + j;
      const long long off = xbase + (long long)t * Di;
      float d = 0.f, xv = 0.f, dxv = 0.f, dyv = 0.f;
      if (active) {
        d = to_f(delta[off]);
        xv = to_f(x[off]);
        dxv = round_to(d * xv, x);
        dyv = to_f(dy[off]);
      }
      const T* bt = Bt + nbase + (long long)t * N;
      const T* ct = Ct + nbase + (long long)t * N;
      float pb[N], pc[N], ddx = 0.f, dd = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float hp = hw[(j * N + n) * 32];
        const float e = expf(d * a[n]);
        const float bn = to_f(bt[n]);
        g[n] = fmaf(dyv, to_f(ct[n]), g[n]);          // g_t
        pc[n] = dyv * fmaf(e, hp, dxv * bn);          // dy_t h_t
        pb[n] = g[n] * dxv;
        ddx = fmaf(g[n], bn, ddx);
        const float geh = g[n] * e * hp;
        dd = fmaf(geh, a[n], dd);
        da[n] = fmaf(geh, d, da[n]);
        g[n] *= e;                                    // a_t g_t, into step t - 1
      }
      if (active) {
        store(ddelta + off, fmaf(ddx, xv, dd));
        store(dx + off, ddx * d);
      }
      const float sb = warp_sum_scatter<N>(pb, lane);
      const float sc = warp_sum_scatter<N>(pc, lane);
      if (lane % (32 / N) == 0) {
        const int n = lane / (32 / N);
        float* part = dbc_part + ((long long)w * 2 * B + b) * SN + (long long)t * N + n;
        part[0] = sb;                                 // dB's partial
        part[(long long)B * SN] = sc;                 // dC's
      }
    }
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      dh0[((long long)b * Di + c) * N + n] = g[n];
      dA_part[((long long)b * Di + c) * N + n] = da[n];
    }
  }
}

template <typename T, int N>
int launch_mamba_bwd(const void* delta, const void* x, const float* A, const void* Bt,
                     const void* Ct, const float* ckpt, const void* dy, const float* dhT,
                     void* ddelta, void* dx, float* dA, void* dBt, void* dCt, float* dh0,
                     float* hist, float* dbc_part, float* dA_part, int B, int S, int Di,
                     cudaStream_t stream) {
  const int nw = (Di + 31) / 32;
  mamba_bwd_kernel<T, N><<<dim3(nw, B), 32, 0, stream>>>(
      static_cast<const T*>(delta), static_cast<const T*>(x), A, static_cast<const T*>(Bt),
      static_cast<const T*>(Ct), ckpt, static_cast<const T*>(dy), dhT,
      static_cast<T*>(ddelta), static_cast<T*>(dx), dA_part, dbc_part, dh0, hist, S, Di);
  int rc = launch_status();
  if (rc != 0) return rc;
  const long long E = (long long)B * S * N;
  rc = sum_parts<T>(dbc_part, static_cast<T*>(dBt), nw, E, 2 * E, stream);
  if (rc != 0) return rc;
  rc = sum_parts<T>(dbc_part + E, static_cast<T*>(dCt), nw, E, 2 * E, stream);
  if (rc != 0) return rc;
  return sum_parts<float>(dA_part, dA, B, (long long)Di * N, (long long)Di * N, stream);
}

// ---- RWKV6 -----------------------------------------------------------------------

constexpr int RQ = 4;      // threads a state row (column groups)
constexpr int RT = 8;      // steps whose dv partials are staged before the block sums them

template <typename T, int K>
__global__ void __launch_bounds__(K * RQ)
rwkv_bwd_kernel(const T* __restrict__ r, const float* __restrict__ w,
                const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ u, const float* __restrict__ ckpt,
                const T* __restrict__ dout, const float* __restrict__ dhT,
                T* __restrict__ dr, float* __restrict__ dw, T* __restrict__ dk,
                T* __restrict__ dv, float* __restrict__ du_part, float* __restrict__ dh0,
                float* __restrict__ hist, int S, int H) {
  constexpr int CPT = K / RQ;               // columns a thread
  constexpr int NT = K * RQ, NWARP = NT / 32;
  static_assert(CPT % 4 == 0 && NT % 32 == 0, "float4 rows, whole warps");
  // dv partials of RT steps: [step][warp][column], column K the warp's
  // partial of r . (u k)
  __shared__ float red[RT][NWARP][K + 1];
  const int hh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int i = tid / RQ, q = tid % RQ, col0 = q * CPT;
  const int lane = tid % 32, warp = tid / 32;
  const int NC = (S + CK - 1) / CK;
  const long long bh = (long long)b * H + hh;
  const long long KK = (long long)K * K;
  const float ui = u[hh * K + i];
  float G[CPT];
  {
    const float* src = dhT != nullptr ? dhT + bh * KK + (long long)i * K + col0 : nullptr;
#pragma unroll
    for (int e = 0; e < CPT; ++e) G[e] = src != nullptr ? src[e] : 0.f;
  }
  float du_acc = 0.f;
  // this block's history, (CK, K, K): the state before each step
  float* hb = hist + bh * CK * KK + (long long)i * K + col0;     // + j KK
  const long long HK = (long long)H * K;
  for (int ch = NC - 1; ch >= 0; --ch) {
    const int t0 = ch * CK, steps = min(CK, S - t0);
    float st[CPT];
    {
      const float4* ck = reinterpret_cast<const float4*>(
          ckpt + (bh * NC + ch) * KK + (long long)i * K + col0);
#pragma unroll
      for (int e = 0; e < CPT / 4; ++e) {
        const float4 f = ck[e];
        st[4 * e] = f.x; st[4 * e + 1] = f.y; st[4 * e + 2] = f.z; st[4 * e + 3] = f.w;
      }
    }
    // the chunk forward from its checkpoint
    for (int j = 0; j < steps; ++j) {
      const long long row = ((long long)b * S + t0 + j) * HK + (long long)hh * K;
      const float wt = w[row + i], kt = to_f(k[row + i]);
      float4* hrow = reinterpret_cast<float4*>(hb + j * KK);
#pragma unroll
      for (int e = 0; e < CPT / 4; ++e)
        hrow[e] = make_float4(st[4 * e], st[4 * e + 1], st[4 * e + 2], st[4 * e + 3]);
#pragma unroll
      for (int e = 0; e < CPT; ++e) st[e] = fmaf(wt, st[e], kt * to_f(v[row + col0 + e]));
    }
    // ... and backwards through it, RT steps a tile
    for (int tile_end = steps; tile_end > 0; tile_end -= RT) {
      const int tile_begin = max(0, tile_end - RT);
      for (int j = tile_end - 1; j >= tile_begin; --j) {
        const int t = t0 + j;
        const long long row = ((long long)b * S + t) * HK + (long long)hh * K;
        const float rt = to_f(r[row + i]), wt = w[row + i], kt = to_f(k[row + i]);
        const float4* hrow = reinterpret_cast<const float4*>(hb + j * KK);
        float pr = 0.f, pk = 0.f, pw = 0.f, pvd = 0.f, pv[CPT];
#pragma unroll
        for (int e4 = 0; e4 < CPT / 4; ++e4) {
          const float4 f = hrow[e4];
          const float sp[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int e = 4 * e4 + m;
            const float vv = to_f(v[row + col0 + e]), dov = to_f(dout[row + col0 + e]);
            pr = fmaf(sp[m], dov, pr);
            pk = fmaf(G[e], vv, pk);
            pw = fmaf(G[e], sp[m], pw);
            pvd = fmaf(vv, dov, pvd);
            pv[e] = G[e] * kt;
            G[e] = fmaf(wt, G[e], rt * dov);          // G_{t-1}
          }
        }
        // over the row's RQ threads (adjacent lanes)
#pragma unroll
        for (int m = 1; m < RQ; m *= 2) {
          pr += __shfl_xor_sync(FULL, pr, m);
          pk += __shfl_xor_sync(FULL, pk, m);
          pw += __shfl_xor_sync(FULL, pw, m);
          pvd += __shfl_xor_sync(FULL, pvd, m);
        }
        if (q == 0) {
          store(dr + row + i, fmaf(ui * kt, pvd, pr));
          store(dk + row + i, fmaf(ui * rt, pvd, pk));
          dw[row + i] = pw;
          du_acc = fmaf(rt * kt, pvd, du_acc);
        }
        // dv over the warp's 8 rows, and r . (u k) beside it
        float ruk = q == 0 ? rt * ui * kt : 0.f;
#pragma unroll
        for (int m = RQ; m < 32; m *= 2) {
          ruk += __shfl_xor_sync(FULL, ruk, m);
#pragma unroll
          for (int e = 0; e < CPT; ++e) pv[e] += __shfl_xor_sync(FULL, pv[e], m);
        }
        if (lane < RQ) {
#pragma unroll
          for (int e = 0; e < CPT; ++e) red[j - tile_begin][warp][col0 + e] = pv[e];
          if (lane == 0) red[j - tile_begin][warp][K] = ruk;
        }
      }
      __syncthreads();                                // the tile's partials
      for (int idx = tid; idx < (tile_end - tile_begin) * K; idx += NT) {
        const int jj = idx / K, col = idx % K;
        float s = 0.f, su = 0.f;
#pragma unroll
        for (int wp = 0; wp < NWARP; ++wp) {
          s += red[jj][wp][col];
          su += red[jj][wp][K];
        }
        const long long row = ((long long)b * S + t0 + tile_begin + jj) * HK + (long long)hh * K;
        store(dv + row + col, fmaf(su, to_f(dout[row + col]), s));
      }
      __syncthreads();                                // red is read before the next tile
    }
  }
  float* out = dh0 + bh * KK + (long long)i * K + col0;
#pragma unroll
  for (int e = 0; e < CPT; ++e) out[e] = G[e];
  if (q == 0) du_part[bh * K + i] = du_acc;
}

template <typename T, int K>
int launch_rwkv_bwd(const void* r, const float* w, const void* k, const void* v,
                    const float* u, const float* ckpt, const void* dout, const float* dhT,
                    void* dr, float* dw, void* dk, void* dv, float* du, float* dh0,
                    float* hist, float* du_part, int B, int S, int H, cudaStream_t stream) {
  rwkv_bwd_kernel<T, K><<<dim3(H, B), K * RQ, 0, stream>>>(
      static_cast<const T*>(r), w, static_cast<const T*>(k), static_cast<const T*>(v), u,
      ckpt, static_cast<const T*>(dout), dhT, static_cast<T*>(dr), dw, static_cast<T*>(dk),
      static_cast<T*>(dv), du_part, dh0, hist, S, H);
  const int rc = launch_status();
  if (rc != 0) return rc;
  return sum_parts<float>(du_part, du, B, (long long)H * K, (long long)H * K, stream);
}

}  // namespace

// dtype 0: fp32, 1: bf16 (delta, x, Bt, Ct, dy and their gradients). N is 4 or
// 16; B, S, Di > 0. ckpt (B, ceil(S / 64), Di, N) fp32 from the forward; dhT
// (B, Di, N) fp32 or null (no gradient of the final state). Outputs ddelta, dx
// (B, S, Di), dBt, dCt (B, S, N), dA (Di, N) fp32, dh0 (B, Di, N) fp32.
// Workspaces: hist (B, ceil(Di / 32), 64, N, 32) fp32, dbc_part (ceil(Di / 32),
// 2, B, S, N) fp32, dA_part (B, Di, N) fp32. Four launches. Returns a
// cudaError_t.
extern "C" int mamba_scan_bwd(const void* delta, const void* x, const void* A,
                              const void* Bt, const void* Ct, const void* ckpt,
                              const void* dy, const void* dhT, void* ddelta, void* dx,
                              void* dA, void* dBt, void* dCt, void* dh0, void* hist,
                              void* dbc_part, void* dA_part, int dtype, int B, int S,
                              int Di, int N, void* stream) {
  if (B <= 0 || S <= 0 || Di <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(A);
  const float* ck = static_cast<const float*>(ckpt);
  const float* gT = static_cast<const float*>(dhT);
  float* dAf = static_cast<float*>(dA);
  float* d0 = static_cast<float*>(dh0);
  float* hs = static_cast<float*>(hist);
  float* pbc = static_cast<float*>(dbc_part);
  float* pa = static_cast<float*>(dA_part);
#define MAMBA_BWD(T, NN)                                                                   \
  return launch_mamba_bwd<T, NN>(delta, x, af, Bt, Ct, ck, dy, gT, ddelta, dx, dAf, dBt,   \
                                 dCt, d0, hs, pbc, pa, B, S, Di, s)
  if (dtype == 1 && N == 16) MAMBA_BWD(__nv_bfloat16, 16);
  if (dtype == 1 && N == 4) MAMBA_BWD(__nv_bfloat16, 4);
  if (dtype == 0 && N == 16) MAMBA_BWD(float, 16);
  if (dtype == 0 && N == 4) MAMBA_BWD(float, 4);
#undef MAMBA_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype 0: fp32, 1: bf16 (r, k, v, dout and their gradients); w, u fp32. K = V
// is 16 or 64; B, S, H > 0. ckpt (B, H, ceil(S / 64), K, K) fp32 from the
// forward, 16-byte aligned; dhT (B, H, K, K) fp32 or null. Outputs dr, dk
// (B, S, H, K), dv (B, S, H, K), dw (B, S, H, K) fp32, du (H, K) fp32, dh0
// (B, H, K, K) fp32. Workspaces: hist (B, H, 64, K, K) fp32, 16-byte aligned,
// du_part (B, H, K) fp32. Two launches. Returns a cudaError_t.
extern "C" int rwkv_scan_bwd(const void* r, const void* w, const void* k, const void* v,
                             const void* u, const void* ckpt, const void* dout,
                             const void* dhT, void* dr, void* dw, void* dk, void* dv,
                             void* du, void* dh0, void* hist, void* du_part, int dtype,
                             int B, int S, int H, int K, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* ck = static_cast<const float*>(ckpt);
  const float* gT = static_cast<const float*>(dhT);
  float* dwf = static_cast<float*>(dw);
  float* duf = static_cast<float*>(du);
  float* d0 = static_cast<float*>(dh0);
  float* hs = static_cast<float*>(hist);
  float* pu = static_cast<float*>(du_part);
#define RWKV_BWD(T, KK)                                                                    \
  return launch_rwkv_bwd<T, KK>(r, wf, k, v, uf, ck, dout, gT, dr, dwf, dk, dv, duf, d0, hs, \
                                pu, B, S, H, s)
  if (dtype == 1 && K == 64) RWKV_BWD(__nv_bfloat16, 64);
  if (dtype == 1 && K == 16) RWKV_BWD(__nv_bfloat16, 16);
  if (dtype == 0 && K == 64) RWKV_BWD(float, 64);
  if (dtype == 0 && K == 16) RWKV_BWD(float, 16);
#undef RWKV_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
