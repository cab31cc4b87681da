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
// Two routes each, chosen by the wrappers (`_rwkv_bwd_route`,
// `_mamba_bwd_route`): the chunked routes (below the serial kernels in this
// file) for bf16 RWKV6 at K = V = 64 and for Mamba at N = 16, at any S and
// behind any forward route (they read only the checkpoints, which every
// forward route writes), training's shapes among them; the serial kernels
// (rwkv_bwd_kernel, mamba_bwd_kernel) for the rest: float32 RWKV6 and the
// smoke configs' widths (K = 16, N = 4).
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
// bound. At B = 1 it takes two thirds of that (2.98 ms; the 42 MB history
// fits L2 there), and both serial kernels grow linearly with S
// (scripts/scan_bwd_times.py): the serial chain of a block is most of the
// time, the history's traffic the rest.
//
// ---------------------------------------------------------------------------
// The chunked routes. The state at every chunk start is already known: the
// forward leaves its checkpoints every CK = 64 steps. What is truly
// sequential across chunks is the adjoint, and it is a first-order linear
// recurrence too. So each backward runs in three steps, two of them
// parallel over (chunk, head or channel block, b):
//  (a) each chunk's own part of the adjoint it passes to the chunk before,
//      walked back from zero, and the chunk's whole decay;
//  (b) the reverse carry across chunks, seeded by the final state's
//      gradient, one thread an adjoint element and one fma a chunk; each
//      chunk's slot receives the adjoint after its last step, and the carry
//      ends at dh0;
//  (c) each chunk's gradients from its checkpoint and that adjoint.
// Step (c) keeps the chunk's history on chip: a first pass from the
// checkpoint keeps the state before every WIN = 8th step in shared memory
// (each thread its own part, so no barrier), then the windows are walked
// from the last, each window's 8 states recomputed into registers from its
// first and the adjoint stepped back through them. No state and no gradient
// is obtained by dividing by a decay, and no decay is a quotient: a decay
// across a range is the product of the range's decays (RWKV6, split at
// sub-chunk boundaries) or the exponential of its summed step sizes (Mamba).
// Sums across blocks are partials added in a fixed order (sum_parts_kernel),
// so a result is the same from run to run.
//
// RWKV6 (bf16 at K = V = 64, any S).
// (a) rwkv_bwd_adj_kernel, a block a (chunk, h, b): R_c = sum_j (r_j
// prod_{t0<=s<j} w_s) do_j^T and P_c = prod_c w_s, the mirror of the
// forward's rwkv_chunk_state_kernel (16-step sub-chunks; the product on
// mma.sync TF32 with the decayed r split hi + lo, do exact). (b)
// rwkv_bwd_carry_kernel: G_end(c - 1) = P_c G_end(c) + R_c in R's slots. (c)
// rwkv_bwd_grad_kernel, a block of 512 threads a (chunk, h, b), thread (row
// i, column group q) of the state and the adjoint, 8 columns each; 7
// window-first states (the first window's is the checkpoint) take 112 KB
// of shared memory, the chunk's r, k, v, do and w 48 KB, dv's partials
// 32 KB: one block an SM, 2,560 blocks at the training shape (16x the
// serial kernel's) and a chain of 3 x 64 steps a block (56 + 56 forward,
// 64 back) rather than 2 x 1,024. dr, dk and dw sum a row's 8 lanes once
// a window (a reduce-scatter of the window's 24 partials, lane q keeping
// step q's); dv sums the warp's four rows each step, then the block's 16
// warps once a window in shared memory, in warp order; dr, dk, dw go in
// place of r, k, w and out as whole rows. dw_t = rowsum(G_t o S_{t-1}) from
// G_t and S_{t-1} formed directly: the identity w_t dw_t = ... gives only
// w dw, and w reaches 0. Bound as above; what bounds the design is the
// issue rate of its CUDA-core work (about 170 instructions a thread a
// step, counted from the code: the window recompute and first pass, the
// walk back's four products of the 8 columns and dv's reduction), with 16
// warps an SM. (Widening v and do to fp32 in shared memory once, to save
// the conversions, made it slower: a thread's 8 fp32 columns make its
// 16-byte loads conflict two ways.) At the training shape the route takes
// 0.88 ms (step (c) 0.76 of it), 7.4x the bound, against the serial
// kernel's 4.53 ms in the same run (H100 80GB HBM3 at 700 W,
// chip_smoke.py's time_scan_bwd, scripts/scan_bwd_times.py --profile).
//
// Mamba (N = 16, bf16 and fp32, any S).
// (a) mamba_bwd_adj_kernel, a thread a channel with its 16 adjoint values, 64 channels a block: L_c = sum_{t in c} exp(A sum_{t0<=s
// <=t} delta_s) dy_t C_t from zero, and the chunk's summed step sizes; its
// exponentials are one SFU pass. (b) mamba_bwd_carry_kernel: X_{c-1} =
// exp(A sum_c delta) X_c + L_c, X the adjoint's part reaching a chunk's last
// step from the steps after it. (c) mamba_bwd_grad_kernel, a block a (64
// channels, chunk, b): lane 4 cl + q of a warp owns channel cl of the
// warp's 8 and its states n = 4 q .. 4 q + 3, so that a window's 8 states
// and 8 decays (64 registers) stay in registers; the window-first states
// take 32 KB of shared memory, the chunk's delta, x, dy, B_t, C_t 36 KB
// (bf16); two blocks an SM. d(dx) and d delta sum a channel's four lanes;
// dB and dC a warp's eight channels by a reduce-scatter, then the block's
// warps once a window in shared memory, in warp order, so the partials
// written are one a 64 channels (67 MB at the training shape, against the
// serial kernel's 134 MB, and no 134 MB history). Exponentials are
// ex2.approx of delta A log2 e (as the segmented forward's), kept from the
// window recompute for the walk back; the route does about 2.9 SFU passes
// (step (a), step (c)'s first pass and window recompute) against the
// function's one, 0.37 ms at the training shape, and its CUDA-core work is
// about 150 instructions a thread a step for 4 state elements (counted from
// the code). It takes 1.20 ms there (step (c) 0.95, step (a) 0.18), 8.3x the
// bound, against the serial kernel's 2.90 ms in the same run (as above).
#include <cstdint>
#include <cuda_bf16.h>
#include "common.cuh"
#include "scan_common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int CK = 64;                  // steps between checkpoints
constexpr unsigned FULL = 0xffffffffu;

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

// ---- the chunked routes: shared helpers ------------------------------------------

constexpr int SN = 16;                  // the Mamba state size the chunked route takes
constexpr int CW = 64;                  // the RWKV6 head width (K = V) it takes
constexpr int WIN = 8;                  // steps a window of step (c)
constexpr int NWIN = CK / WIN;          // windows a chunk
constexpr float kLog2e = 1.4426950408889634f;

namespace tc = tensor_core;

// Rows t0 .. t0 + CK - 1 of a (B S, ld_src)-strided tensor, columns
// [c0, c0 + cols) from base, into dst[CK][ld] by 16-byte asynchronous copies
// from every thread of the block; rows past S and columns past `limit` (a
// multiple of 16 bytes) are zero.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* __restrict__ src,
                                          long long base, long long stride, int t0, int S,
                                          int cols, int c0, int limit) {
  constexpr int EPC = 16 / sizeof(T);
  const int cpr = cols / EPC;
  for (int idx = threadIdx.x; idx < CK * cpr; idx += blockDim.x) {
    const int t = idx / cpr, col = (idx % cpr) * EPC;
    const bool valid = t0 + t < S && c0 + col < limit;
    const T* from = valid ? src + base + (long long)(t0 + t) * stride + c0 + col : src;
    tc::cp_async16(tc::smem_addr(dst + t * ld + col), from, valid ? 16 : 0);
  }
}

// The decays of rows t0 .. t0 + CK - 1 of one (b, h) into dst[CK][ld]; rows
// past S are 1, so that a ragged chunk's missing steps decay nothing.
__device__ __forceinline__ void copy_decays(float* dst, int ld, const float* __restrict__ src,
                                            long long base, long long stride, int t0, int S) {
  for (int idx = threadIdx.x; idx < CK * (CW / 4); idx += blockDim.x) {
    const int t = idx / (CW / 4), part = idx % (CW / 4);
    if (t0 + t < S)
      tc::cp_async16(tc::smem_addr(dst + t * ld + 4 * part),
                     src + base + (long long)(t0 + t) * stride + 4 * part, 16);
    else
      *reinterpret_cast<float4*>(dst + t * ld + 4 * part) = make_float4(1.f, 1.f, 1.f, 1.f);
  }
}

// One round of a reduce-scatter of v[2 HS] over the lanes that differ in
// MASK: the lanes with the MASK bit keep the upper half, the others the
// lower, each adding its partner's copy; v[0 .. HS) holds the result.
template <int HS, int MASK, int NV>
__device__ __forceinline__ void scatter_round(float (&v)[NV], int lane) {
  const bool upper = (lane & MASK) != 0;
#pragma unroll
  for (int i = 0; i < HS; ++i) {
    const float send = upper ? v[i] : v[i + HS];
    const float keep = upper ? v[i + HS] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, MASK);
  }
}

// ---- RWKV6, chunked route ---------------------------------------------------------

constexpr int SUB = 16;                 // steps a sub-chunk of step (a)
constexpr int ATHREADS = 256;           // step (a): eight warps
constexpr int LDH = CW + 8;             // bf16 rows of step (a): 144 bytes
constexpr int LDB = CW + 8;             // fp32 rows read as [row l % 4][col l / 4]
constexpr int CARRY_THREADS = 256;
constexpr int CARRY_AHEAD = 16;         // loads in flight a thread in the carries
constexpr int GQ = 8;                   // step (c): threads a state row
constexpr int GC = CW / GQ;             // ... and columns a thread
constexpr int GTHREADS = CW * GQ;       // 512
constexpr int GWARPS = GTHREADS / 32;

// Step (a), a block per (chunk c, h, b): the chunk's own contribution to the
// adjoint entering it from the chunk before, R_c = sum_j (r_j * prod_{t0<=s<j}
// w_s) do_j^T, and its whole decay P_c = prod_s w_s. The mirror of the
// forward's rwkv_chunk_state_kernel: the decay before j is taken step by step
// within j's sub-chunk and times the earlier sub-chunks' whole decays, never
// as a quotient; R_c's product runs on the tensor cores with the decayed r
// split into tf32 hi + lo (do is exact in tf32).
struct AdjSmem {
  __nv_bfloat16 r[CK][LDH], d[CK][LDH];
  float wr[CK][LDB];             // w_j, then in its place r_j prod_{t0<=s<j} w_s
  float wsub[CK / SUB][CW];      // sub-chunk p's whole decay
};

__global__ void __launch_bounds__(ATHREADS)
rwkv_bwd_adj_kernel(const __nv_bfloat16* __restrict__ r, const float* __restrict__ w,
                    const __nv_bfloat16* __restrict__ dout, float* __restrict__ R,
                    float* __restrict__ P, int S, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AdjSmem& sm = *reinterpret_cast<AdjSmem*>(smem_raw);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, NC = gridDim.x;
  const int tid = threadIdx.x, t0 = c * CK;
  const long long stride = (long long)H * CW;
  const long long base = (long long)b * S * stride + (long long)h * CW;
  copy_rows(&sm.r[0][0], LDH, r, base, stride, t0, S, CW, 0, CW);
  copy_rows(&sm.d[0][0], LDH, dout, base, stride, t0, S, CW, 0, CW);
  copy_decays(&sm.wr[0][0], LDB, w, base, stride, t0, S);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  const long long blk = ((long long)b * H + h) * NC + c;
  // thread (i, sub-chunk p): the decay before j within p, step by step ...
  const int di = tid % CW, dp = tid / CW;
  {
    float q = 1.f;
#pragma unroll
    for (int j = SUB * dp; j < SUB * (dp + 1); ++j) {
      const float wj = sm.wr[j][di];
      sm.wr[j][di] = bf(sm.r[j][di]) * q;
      q *= wj;
    }
    sm.wsub[dp][di] = q;
  }
  __syncthreads();
  // ... times the whole decays of the sub-chunks before p
  {
    float before = 1.f;
    for (int p = 0; p < dp; ++p) before *= sm.wsub[p][di];
#pragma unroll
    for (int j = SUB * dp; j < SUB * (dp + 1); ++j) sm.wr[j][di] *= before;
    if (dp == CK / SUB - 1) P[blk * CW + di] = before * sm.wsub[dp][di];
  }
  __syncthreads();
  // warp: rows 16 (warp % 4) .., columns 32 (warp / 4) ..
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int i0 = SUB * (warp % 4), n0 = (CW / 16) * (warp / 4);
  float acc[CW / 16][4];
#pragma unroll
  for (int nt = 0; nt < CW / 16; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < CK / 8; ++ks) {
    const int j = 8 * ks + t4;
    uint32_t hi[4], lo[4];
    tc::split_tf32(sm.wr[j][i0 + g], hi[0], lo[0]);
    tc::split_tf32(sm.wr[j][i0 + g + 8], hi[1], lo[1]);
    tc::split_tf32(sm.wr[j + 4][i0 + g], hi[2], lo[2]);
    tc::split_tf32(sm.wr[j + 4][i0 + g + 8], hi[3], lo[3]);
#pragma unroll
    for (int nt = 0; nt < CW / 16; ++nt) {
      const int col = 8 * (n0 + nt) + g;
      const uint32_t b0 = bf_tf32(sm.d[j][col]), b1 = bf_tf32(sm.d[j + 4][col]);
      tc::mma_tf32(acc[nt], lo[0], lo[1], lo[2], lo[3], b0, b1);
      tc::mma_tf32(acc[nt], hi[0], hi[1], hi[2], hi[3], b0, b1);
    }
  }
  float* out = R + blk * CW * CW;
#pragma unroll
  for (int nt = 0; nt < CW / 16; ++nt) {
    const int col = 8 * (n0 + nt) + 2 * t4;
    *reinterpret_cast<float2*>(out + (i0 + g) * CW + col) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(out + (i0 + g + 8) * CW + col) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// Step (b), a thread per adjoint element of (b, h): the reverse carry,
// G_end(NC - 1) = dhT (zeros when null), G_end(c - 1) = P_c G_end(c) + R_c, one
// fma a chunk in fp32. R_c's slot receives G_end(c), the adjoint after the
// chunk's last step; dh0 receives the adjoint before step 0.
__global__ void __launch_bounds__(CARRY_THREADS)
rwkv_bwd_carry_kernel(const float* __restrict__ dhT, float* __restrict__ R,
                      const float* __restrict__ P, float* __restrict__ dh0, int NC, int H) {
  const int e = blockIdx.x * CARRY_THREADS + threadIdx.x;   // i * CW + column
  const int i = e / CW;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  float gv = dhT != nullptr ? dhT[bh * CW * CW + e] : 0.f;
  float* rr = R + bh * NC * CW * CW + e;
  const float* p = P + bh * NC * CW + i;
  for (int top = NC - 1; top >= 0; top -= CARRY_AHEAD) {
    float uu[CARRY_AHEAD], pp[CARRY_AHEAD];
#pragma unroll
    for (int a = 0; a < CARRY_AHEAD; ++a) {
      if (top - a >= 0) {
        uu[a] = rr[(long long)(top - a) * CW * CW];
        pp[a] = p[(long long)(top - a) * CW];
      }
    }
#pragma unroll
    for (int a = 0; a < CARRY_AHEAD; ++a) {
      if (top - a >= 0) {
        rr[(long long)(top - a) * CW * CW] = gv;
        gv = fmaf(pp[a], gv, uu[a]);
      }
    }
  }
  dh0[bh * CW * CW + e] = gv;
}

// Step (c), a block per (chunk c, h, b), thread (row i, column group q) of
// the state and of the adjoint, GC = 8 columns each. The chunk's states are
// recomputed forward from its checkpoint S_c; the state before every WIN-th
// step is kept in shared memory (each thread keeps and reads back its own
// part, so no barrier), then the windows are walked from the last: a
// window's WIN states are recomputed into registers from its first, and the
// adjoint G (in registers, from G_end(c)) is stepped back through them. A
// row's partials of dr, dk and dw over the window's WIN steps are summed over
// its GQ lanes once a window by a reduce-scatter (lane q keeps step q's); dv's
// over the warp's four rows each step, then over the block's warps once a
// window in shared memory. dr, dk and dw go in place of r, k and w in shared
// memory (a row's window is read no more) and out as whole rows at the end.
struct GradSmem {
  float ws[NWIN - 1][CW][CW];            // the state before steps WIN, 2 WIN, ...
  float red[WIN][GWARPS][CW];            // dv's per-warp partials of a window
  float w[CK][CW];                       // w, then dw
  __nv_bfloat16 r[CK][CW], k[CK][CW];    // r and k, then dr and dk
  __nv_bfloat16 v[CK][CW], d[CK][CW];    // v and do
  float vdo[CK], ruk[CK];                // v_t . do_t and r_t . (u k_t)
};

__global__ void __launch_bounds__(GTHREADS, 1)
rwkv_bwd_grad_kernel(const __nv_bfloat16* __restrict__ r, const float* __restrict__ w,
                     const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ u, const float* __restrict__ ckpt,
                     const __nv_bfloat16* __restrict__ dout, const float* __restrict__ Gend,
                     __nv_bfloat16* __restrict__ dr, float* __restrict__ dw,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     float* __restrict__ du_part, int S, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GradSmem& sm = *reinterpret_cast<GradSmem*>(smem_raw);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, NC = gridDim.x;
  const int tid = threadIdx.x, i = tid / GQ, q = tid % GQ, col0 = q * GC;
  const int lane = tid % 32, warp = tid / 32;
  const int t0 = c * CK, steps = min(CK, S - t0), nwin = (steps + WIN - 1) / WIN;
  const long long stride = (long long)H * CW;
  const long long base = (long long)b * S * stride + (long long)h * CW;
  copy_rows(&sm.r[0][0], CW, r, base, stride, t0, S, CW, 0, CW);
  copy_rows(&sm.k[0][0], CW, k, base, stride, t0, S, CW, 0, CW);
  copy_rows(&sm.v[0][0], CW, v, base, stride, t0, S, CW, 0, CW);
  copy_rows(&sm.d[0][0], CW, dout, base, stride, t0, S, CW, 0, CW);
  copy_decays(&sm.w[0][0], CW, w, base, stride, t0, S);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  // the row-independent dot products of each step: thread (t, eighth)
  {
    const int t = tid / GQ, part = tid % GQ;
    float vd = 0.f, rk = 0.f;
#pragma unroll
    for (int e = 0; e < GC; ++e) {
      const int col = part * GC + e;
      vd = fmaf(bf(sm.v[t][col]), bf(sm.d[t][col]), vd);
      rk = fmaf(bf(sm.r[t][col]) * u[h * CW + col], bf(sm.k[t][col]), rk);
    }
#pragma unroll
    for (int m = 1; m < GQ; m *= 2) {
      vd += __shfl_xor_sync(FULL, vd, m);
      rk += __shfl_xor_sync(FULL, rk, m);
    }
    if (part == 0) {
      sm.vdo[t] = vd;
      sm.ruk[t] = rk;
    }
  }
  const float ui = u[h * CW + i];
  const long long blk = ((long long)b * H + h) * NC + c;
  const long long own = blk * CW * CW + (long long)i * CW + col0;   // this thread's 8 elements
  // pass 1: the state forward from the checkpoint, each later window's
  // first kept (the first window's is the checkpoint)
  {
    float st[GC];
    load8(ckpt + own, st);
    const int last = (nwin - 1) * WIN;
    for (int j = 0;; ++j) {
      if (j % WIN == 0 && j > 0) {
        float4* keep = reinterpret_cast<float4*>(&sm.ws[j / WIN - 1][i][col0]);
        keep[0] = make_float4(st[0], st[1], st[2], st[3]);
        keep[1] = make_float4(st[4], st[5], st[6], st[7]);
      }
      if (j == last) break;
      const float wt = sm.w[j][i], kt = bf(sm.k[j][i]);
      float vv[GC];
      load8(&sm.v[j][col0], vv);
#pragma unroll
      for (int e = 0; e < GC; ++e) st[e] = fmaf(wt, st[e], kt * vv[e]);
    }
  }
  float G[GC];
  load8(Gend + own, G);
  __syncthreads();                     // vdo and ruk
  float du_acc = 0.f;
  for (int win = nwin - 1; win >= 0; --win) {
    const int tw = win * WIN;
    // the window's states, hs[s] = S_{tw + s - 1}, recomputed from its first;
    // rows past S decay nothing and add nothing
    float hs[WIN][GC];
    if (win == 0)
      load8(ckpt + own, hs[0]);
    else
      load8(&sm.ws[win - 1][i][col0], hs[0]);
#pragma unroll
    for (int s = 0; s + 1 < WIN; ++s) {
      const float wt = sm.w[tw + s][i], kt = bf(sm.k[tw + s][i]);
      float vv[GC];
      load8(&sm.v[tw + s][col0], vv);
#pragma unroll
      for (int e = 0; e < GC; ++e) hs[s + 1][e] = fmaf(wt, hs[s][e], kt * vv[e]);
    }
    // back through the window, G = G_t at step t
    float part[3 * WIN];
#pragma unroll
    for (int s = WIN - 1; s >= 0; --s) {
      const int t = tw + s;
      const float rt = bf(sm.r[t][i]), wt = sm.w[t][i], kt = bf(sm.k[t][i]);
      float vv[GC], dd[GC], pv[GC];
      load8(&sm.v[t][col0], vv);
      load8(&sm.d[t][col0], dd);
      float pr = 0.f, pk = 0.f, pw = 0.f;
#pragma unroll
      for (int e = 0; e < GC; ++e) {
        pr = fmaf(hs[s][e], dd[e], pr);
        pk = fmaf(G[e], vv[e], pk);
        pw = fmaf(G[e], hs[s][e], pw);
        pv[e] = G[e] * kt;
        G[e] = fmaf(wt, G[e], rt * dd[e]);        // G_{t-1}
      }
      part[3 * s] = pr;
      part[3 * s + 1] = pk;
      part[3 * s + 2] = pw;
      // dv over the warp's four rows: lane (row 2 b4 + b3, q) keeps columns
      // col0 + 2 (2 b4 + b3) + {0, 1}
      scatter_round<4, 16>(pv, lane);
      scatter_round<2, 8>(pv, lane);
      *reinterpret_cast<float2*>(&sm.red[s][warp][col0 + 2 * (lane >> 3)]) =
          make_float2(pv[0], pv[1]);
    }
    // dr, dk, dw over the row's GQ lanes: lane q keeps step tw + q's three
    scatter_round<12, 4>(part, lane);
    scatter_round<6, 2>(part, lane);
    scatter_round<3, 1>(part, lane);
    {
      const int t = tw + q;
      const float rt = bf(sm.r[t][i]), kt = bf(sm.k[t][i]), vd = sm.vdo[t];
      du_acc = fmaf(rt * kt, vd, du_acc);
      __syncwarp();                    // the row's lanes have read the window's r, k, w
      sm.r[t][i] = __float2bfloat16_rn(fmaf(ui * kt, vd, part[0]));
      sm.k[t][i] = __float2bfloat16_rn(fmaf(ui * rt, vd, part[1]));
      sm.w[t][i] = part[2];
    }
    __syncthreads();                   // the window's dv partials
    {
      const int s = tid / CW, col = tid % CW, t = tw + s;
      float acc = 0.f;
#pragma unroll
      for (int wp = 0; wp < GWARPS; ++wp) acc += sm.red[s][wp][col];
      if (t0 + t < S)
        dv[base + (long long)(t0 + t) * stride + col] =
            __float2bfloat16_rn(fmaf(sm.ruk[t], bf(sm.d[t][col]), acc));
    }
    __syncthreads();                   // red is read before the next window writes it
  }
  // du's row sum over the chunk
#pragma unroll
  for (int m = 1; m < GQ; m *= 2) du_acc += __shfl_xor_sync(FULL, du_acc, m);
  if (q == 0) du_part[((long long)b * NC + c) * H * CW + (long long)h * CW + i] = du_acc;
  // dr, dk and dw as whole rows
  for (int idx = tid; idx < CK * (CW / 8); idx += GTHREADS) {
    const int t = idx / (CW / 8), col = 8 * (idx % (CW / 8));
    if (t0 + t >= S) continue;
    const long long off = base + (long long)(t0 + t) * stride + col;
    *reinterpret_cast<uint4*>(dr + off) = *reinterpret_cast<const uint4*>(&sm.r[t][col]);
    *reinterpret_cast<uint4*>(dk + off) = *reinterpret_cast<const uint4*>(&sm.k[t][col]);
    const float4* src = reinterpret_cast<const float4*>(&sm.w[t][col]);
    reinterpret_cast<float4*>(dw + off)[0] = src[0];
    reinterpret_cast<float4*>(dw + off)[1] = src[1];
  }
}

int launch_rwkv_bwd_chunk(const __nv_bfloat16* r, const float* w, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, const float* u, const float* ckpt,
                          const __nv_bfloat16* dout, const float* dhT, __nv_bfloat16* dr,
                          float* dw, __nv_bfloat16* dk, __nv_bfloat16* dv, float* du,
                          float* dh0, float* R, float* P, float* du_part, int B, int S, int H,
                          cudaStream_t stream) {
  static bool opted_in = false;        // shared-memory opt-in, once
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(rwkv_bwd_adj_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(sizeof(AdjSmem)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(rwkv_bwd_grad_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(sizeof(GradSmem)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(rwkv_bwd_grad_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int NC = (S + CK - 1) / CK;
  const dim3 grid(NC, H, B);
  rwkv_bwd_adj_kernel<<<grid, ATHREADS, sizeof(AdjSmem), stream>>>(r, w, dout, R, P, S, H);
  int rc = launch_status();
  if (rc != 0) return rc;
  rwkv_bwd_carry_kernel<<<dim3(CW * CW / CARRY_THREADS, H, B), CARRY_THREADS, 0, stream>>>(
      dhT, R, P, dh0, NC, H);
  rc = launch_status();
  if (rc != 0) return rc;
  rwkv_bwd_grad_kernel<<<grid, GTHREADS, sizeof(GradSmem), stream>>>(
      r, w, k, v, u, ckpt, dout, R, dr, dw, dk, dv, du_part, S, H);
  rc = launch_status();
  if (rc != 0) return rc;
  return sum_parts<float>(du_part, du, B * NC, (long long)H * CW, (long long)H * CW, stream);
}

// ---- Mamba, chunked route ---------------------------------------------------------

constexpr int ACH = 64;                 // step (a): channels (threads) a block
constexpr int MCH = 64;                 // step (c): channels a block, 8 a warp
constexpr int MTHREADS = 4 * MCH;       // four lanes a channel, 4 states each
constexpr int MWARPS = MTHREADS / 32;

// Step (a), a block per (ACH channels, chunk c, b), a thread per channel with
// its N = 16 adjoint values in registers: the chunk's own part of the adjoint
// it passes to the chunk before, walked back from zero,
// L_c = sum_{t in c} exp(A sum_{t0<=s<=t} delta_s) dy_t C_t, and the chunk's
// summed step sizes (its decay, exp(A sum_c delta), is formed by the carry).
// delta, dy and C_t of the chunk are staged in shared memory first.
template <typename T>
__global__ void __launch_bounds__(ACH)
mamba_bwd_adj_kernel(const T* __restrict__ delta, const float* __restrict__ A,
                     const T* __restrict__ Ct, const T* __restrict__ dy, float* __restrict__ L,
                     float* __restrict__ sumd, int S, int Di) {
  __shared__ __align__(16) T ds[CK][ACH];
  __shared__ __align__(16) T ys[CK][ACH];
  __shared__ __align__(16) T cs[CK][SN];
  const int c0 = blockIdx.x * ACH, ch = blockIdx.y, b = blockIdx.z, NC = gridDim.y;
  const int tid = threadIdx.x, c = c0 + tid;
  const bool active = c < Di;
  const int t0 = ch * CK, steps = min(CK, S - t0);
  const long long row0 = (long long)b * S;
  copy_rows(&ds[0][0], ACH, delta, row0 * Di, Di, t0, S, ACH, c0, Di);
  copy_rows(&ys[0][0], ACH, dy, row0 * Di, Di, t0, S, ACH, c0, Di);
  copy_rows(&cs[0][0], SN, Ct, row0 * SN, SN, t0, S, SN, 0, SN);
  tc::cp_async_commit();
  float a[SN], X[SN];
#pragma unroll
  for (int n = 0; n < SN; ++n) {
    a[n] = active ? kLog2e * A[(long long)c * SN + n] : 0.f;
    X[n] = 0.f;
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  float sd = 0.f;
  for (int j = steps - 1; j >= 0; --j) {
    const float d = to_f(ds[j][tid]), dyv = to_f(ys[j][tid]);
    float cv[SN];
    load8(&cs[j][0], cv);
    load8(&cs[j][8], cv + 8);
    sd += d;
#pragma unroll
    for (int n = 0; n < SN; ++n) X[n] = fmaf(dyv, cv[n], X[n]) * exp2_sfu(d * a[n]);
  }
  if (active) {
    float4* out = reinterpret_cast<float4*>(L + (((long long)b * NC + ch) * Di + c) * SN);
#pragma unroll
    for (int n4 = 0; n4 < SN / 4; ++n4)
      out[n4] = make_float4(X[4 * n4], X[4 * n4 + 1], X[4 * n4 + 2], X[4 * n4 + 3]);
    sumd[((long long)b * NC + ch) * Di + c] = sd;
  }
}

// Step (b), a thread per (channel, n) of one b: the reverse carry, X_{NC-1} =
// dhT (zeros when null), X_{c-1} = exp(A sum_c delta) X_c + L_c, where X_c is
// the adjoint's part that reaches the chunk's last step from the steps after
// it (a_{t+1} g_{t+1}). The decay is the exponential of the chunk's summed
// step sizes, never a quotient. L_c's slot receives X_c; dh0 = X_{-1} = a_0 g_0.
__global__ void __launch_bounds__(CARRY_THREADS)
mamba_bwd_carry_kernel(const float* __restrict__ A, const float* __restrict__ dhT,
                       float* __restrict__ L, const float* __restrict__ sumd,
                       float* __restrict__ dh0, int NC, int Di) {
  const int e = blockIdx.x * CARRY_THREADS + threadIdx.x;   // c * SN + n
  if (e >= Di * SN) return;
  const int c = e / SN, b = blockIdx.y;
  const long long DN = (long long)Di * SN;
  const float a = kLog2e * A[e];
  float X = dhT != nullptr ? dhT[b * DN + e] : 0.f;
  float* l = L + (long long)b * NC * DN + e;
  const float* sd = sumd + (long long)b * NC * Di + c;
  for (int top = NC - 1; top >= 0; top -= CARRY_AHEAD) {
    float ll[CARRY_AHEAD], dd[CARRY_AHEAD];
#pragma unroll
    for (int j = 0; j < CARRY_AHEAD; ++j) {
      if (top - j >= 0) {
        ll[j] = l[(long long)(top - j) * DN];
        dd[j] = sd[(long long)(top - j) * Di];
      }
    }
#pragma unroll
    for (int j = 0; j < CARRY_AHEAD; ++j) {
      if (top - j >= 0) {
        l[(long long)(top - j) * DN] = X;
        X = fmaf(exp2_sfu(a * dd[j]), X, ll[j]);
      }
    }
  }
  dh0[b * DN + e] = X;
}

// Step (c), a block per (MCH channels, chunk c, b): lane 4 cl + q of warp w
// owns channel 8 w + cl of the block and its states n = 4 q .. 4 q + 3. The
// chunk's states are recomputed from its checkpoint; the state before every
// WIN-th step is kept in shared memory (by the thread that reads it back),
// then the windows are walked from the last: a window's WIN states and
// decays are recomputed into registers from its first, and the adjoint
// (from X_c) is stepped back through them. d(dx) and d delta sum over a
// channel's four lanes (two shuffles each); dB and dC over the warp's eight
// channels by a reduce-scatter (lane 4 cl + q keeps (dB if cl < 4 else dC)
// at n = 4 q + cl % 4), then over the block's warps once a window in
// shared memory, in warp order. d delta and dx go in place of delta and x
// (a channel's row is read no more) and out as whole rows at the end.
template <typename T>
struct MGradSmem {
  T d[CK][MCH], x[CK][MCH], y[CK][MCH];   // delta, x, dy; delta and x become their gradients
  T braw[CK][SN], craw[CK][SN];
  float bf[CK][SN], cf[CK][SN];            // B_t and C_t widened once
  float4 ws[NWIN][MTHREADS];               // each thread's states before steps 0, WIN, ...
  float red[WIN][MWARPS][2 * SN];          // dB's and dC's per-warp partials of a window
};

template <typename T>
__global__ void __launch_bounds__(MTHREADS, 2)
mamba_bwd_grad_kernel(const T* __restrict__ delta, const T* __restrict__ x,
                      const float* __restrict__ A, const T* __restrict__ Bt,
                      const T* __restrict__ Ct, const float* __restrict__ ckpt,
                      const T* __restrict__ dy, const float* __restrict__ Xend,
                      T* __restrict__ ddelta, T* __restrict__ dx, float* __restrict__ dA_part,
                      float* __restrict__ dbc_part, int S, int Di) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MGradSmem<T>& sm = *reinterpret_cast<MGradSmem<T>*>(smem_raw);
  const int c0 = blockIdx.x * MCH, ch = blockIdx.y, b = blockIdx.z;
  const int NC = gridDim.y, B = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cl = lane / 4, q = lane % 4, cb = 8 * warp + cl, c = c0 + cb;
  const bool active = c < Di;          // whole warps: Di is a multiple of 8
  const int t0 = ch * CK, steps = min(CK, S - t0), nwin = (steps + WIN - 1) / WIN;
  const long long row0 = (long long)b * S;
  copy_rows(&sm.d[0][0], MCH, delta, row0 * Di, Di, t0, S, MCH, c0, Di);
  copy_rows(&sm.x[0][0], MCH, x, row0 * Di, Di, t0, S, MCH, c0, Di);
  copy_rows(&sm.y[0][0], MCH, dy, row0 * Di, Di, t0, S, MCH, c0, Di);
  copy_rows(&sm.braw[0][0], SN, Bt, row0 * SN, SN, t0, S, SN, 0, SN);
  copy_rows(&sm.craw[0][0], SN, Ct, row0 * SN, SN, t0, S, SN, 0, SN);
  tc::cp_async_commit();
  float a[4], an[4], h[4];
  const long long own = (((long long)b * NC + ch) * Di + c) * SN + 4 * q;
  {
    const float4 av = active ? *reinterpret_cast<const float4*>(A + (long long)c * SN + 4 * q)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    an[0] = av.x; an[1] = av.y; an[2] = av.z; an[3] = av.w;
    const float4 hv = active ? *reinterpret_cast<const float4*>(ckpt + own)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    h[0] = hv.x; h[1] = hv.y; h[2] = hv.z; h[3] = hv.w;
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) a[m] = kLog2e * an[m];
  tc::cp_async_wait<0>();
  __syncthreads();
  for (int idx = tid; idx < CK * SN; idx += MTHREADS) {
    (&sm.bf[0][0])[idx] = to_f((&sm.braw[0][0])[idx]);
    (&sm.cf[0][0])[idx] = to_f((&sm.craw[0][0])[idx]);
  }
  __syncthreads();
  // pass 1: the states forward from the checkpoint, each window's first kept
  {
    const int last = (nwin - 1) * WIN;
    for (int j = 0;; ++j) {
      if (j % WIN == 0) sm.ws[j / WIN][tid] = make_float4(h[0], h[1], h[2], h[3]);
      if (j == last) break;
      const float d = to_f(sm.d[j][cb]);
      const float dxv = round_to(d * to_f(sm.x[j][cb]), x);
      const float4 bv = *reinterpret_cast<const float4*>(&sm.bf[j][4 * q]);
      h[0] = fmaf(exp2_sfu(d * a[0]), h[0], dxv * bv.x);
      h[1] = fmaf(exp2_sfu(d * a[1]), h[1], dxv * bv.y);
      h[2] = fmaf(exp2_sfu(d * a[2]), h[2], dxv * bv.z);
      h[3] = fmaf(exp2_sfu(d * a[3]), h[3], dxv * bv.w);
    }
  }
  float g[4], da[4] = {0.f, 0.f, 0.f, 0.f};
  {
    const float4 xv = active ? *reinterpret_cast<const float4*>(Xend + own)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    g[0] = xv.x; g[1] = xv.y; g[2] = xv.z; g[3] = xv.w;
  }
  for (int win = nwin - 1; win >= 0; --win) {
    const int tw = win * WIN;
    // the window's states hs[s] = h_{tw + s - 1} (hs[WIN] the state after
    // it) and decays as[s] = a_{tw + s}, recomputed from its first; rows past
    // S decay nothing
    float hs[WIN + 1][4], as[WIN][4];
    {
      const float4 f = sm.ws[win][tid];
      float hh[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int s = 0; s < WIN; ++s) {
        const float d = to_f(sm.d[tw + s][cb]);
        const float dxv = round_to(d * to_f(sm.x[tw + s][cb]), x);
        const float4 bv = *reinterpret_cast<const float4*>(&sm.bf[tw + s][4 * q]);
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          hs[s][m] = hh[m];
          as[s][m] = exp2_sfu(d * a[m]);
          hh[m] = fmaf(as[s][m], hh[m], dxv * bb[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) hs[WIN][m] = hh[m];
    }
#pragma unroll
    for (int s = WIN - 1; s >= 0; --s) {
      const int t = tw + s;
      const float d = to_f(sm.d[t][cb]), xv = to_f(sm.x[t][cb]);
      const float dxv = round_to(d * xv, x), dyv = to_f(sm.y[t][cb]);
      const float4 bv4 = *reinterpret_cast<const float4*>(&sm.bf[t][4 * q]);
      const float4 cv4 = *reinterpret_cast<const float4*>(&sm.cf[t][4 * q]);
      const float bv[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
      const float cv[4] = {cv4.x, cv4.y, cv4.z, cv4.w};
      float pbc[8], ddx = 0.f, dd = 0.f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float hp = hs[s][m], e = as[s][m];
        g[m] = fmaf(dyv, cv[m], g[m]);               // g_t
        pbc[4 + m] = dyv * hs[s + 1][m];             // dy_t h_t
        pbc[m] = g[m] * dxv;
        ddx = fmaf(g[m], bv[m], ddx);
        const float ge = g[m] * e, geh = ge * hp;
        dd = fmaf(geh, an[m], dd);
        da[m] = fmaf(geh, d, da[m]);
        g[m] = ge;                                   // a_t g_t, into step t - 1
      }
      // d(dx) and d delta over the channel's four lanes
#pragma unroll
      for (int m = 1; m < 4; m *= 2) {
        ddx += __shfl_xor_sync(FULL, ddx, m);
        dd += __shfl_xor_sync(FULL, dd, m);
      }
      // dB and dC over the warp's eight channels: lane (cl, q) keeps entry cl
      scatter_round<4, 16>(pbc, lane);
      scatter_round<2, 8>(pbc, lane);
      scatter_round<1, 4>(pbc, lane);
      sm.red[s][warp][(cl / 4) * SN + 4 * q + cl % 4] = pbc[0];
      __syncwarp();                                  // the channel's lanes have read row t
      if (q == 0) {
        store(&sm.d[t][cb], fmaf(ddx, xv, dd));
        store(&sm.x[t][cb], ddx * d);
      }
    }
    __syncthreads();                   // the window's dB, dC partials
    {
      const int s = tid / 32, slot = tid % 32, t = t0 + tw + s;
      float acc = 0.f;
#pragma unroll
      for (int wp = 0; wp < MWARPS; ++wp) acc += sm.red[s][wp][slot];
      if (t < S)
        dbc_part[(((long long)blockIdx.x * 2 + slot / SN) * B + b) * S * SN +
                 (long long)t * SN + slot % SN] = acc;
    }
    __syncthreads();                   // red is read before the next window writes it
  }
  if (active)
    *reinterpret_cast<float4*>(dA_part + own) = make_float4(da[0], da[1], da[2], da[3]);
  // d delta and dx as whole rows
  constexpr int EPC = 16 / sizeof(T);
  for (int idx = tid; idx < CK * (MCH / EPC); idx += MTHREADS) {
    const int t = idx / (MCH / EPC), col = EPC * (idx % (MCH / EPC));
    if (t0 + t >= S || c0 + col >= Di) continue;
    const long long off = (row0 + t0 + t) * Di + c0 + col;
    *reinterpret_cast<uint4*>(ddelta + off) = *reinterpret_cast<const uint4*>(&sm.d[t][col]);
    *reinterpret_cast<uint4*>(dx + off) = *reinterpret_cast<const uint4*>(&sm.x[t][col]);
  }
}

template <typename T>
int launch_mamba_bwd_chunk(const void* delta, const void* x, const float* A, const void* Bt,
                           const void* Ct, const float* ckpt, const void* dy, const float* dhT,
                           void* ddelta, void* dx, float* dA, void* dBt, void* dCt, float* dh0,
                           float* L, float* sumd, float* dbc_part, float* dA_part, int B, int S,
                           int Di, cudaStream_t stream) {
  static bool opted_in = false;        // shared-memory opt-in, once an instance
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(mamba_bwd_grad_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(sizeof(MGradSmem<T>)));
    if (err == cudaSuccess)            // two blocks an SM need the largest carveout
      err = cudaFuncSetAttribute(mamba_bwd_grad_kernel<T>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int NC = (S + CK - 1) / CK;
  const T* dt = static_cast<const T*>(delta);
  const T* ct = static_cast<const T*>(Ct);
  const T* yt = static_cast<const T*>(dy);
  mamba_bwd_adj_kernel<T><<<dim3((Di + ACH - 1) / ACH, NC, B), ACH, 0, stream>>>(
      dt, A, ct, yt, L, sumd, S, Di);
  int rc = launch_status();
  if (rc != 0) return rc;
  mamba_bwd_carry_kernel<<<dim3((Di * SN + CARRY_THREADS - 1) / CARRY_THREADS, B),
                           CARRY_THREADS, 0, stream>>>(A, dhT, L, sumd, dh0, NC, Di);
  rc = launch_status();
  if (rc != 0) return rc;
  const int parts = (Di + MCH - 1) / MCH;
  mamba_bwd_grad_kernel<T><<<dim3(parts, NC, B), MTHREADS, sizeof(MGradSmem<T>), stream>>>(
      dt, static_cast<const T*>(x), A, static_cast<const T*>(Bt), ct, ckpt, yt, L,
      static_cast<T*>(ddelta), static_cast<T*>(dx), dA_part, dbc_part, S, Di);
  rc = launch_status();
  if (rc != 0) return rc;
  const long long E = (long long)B * S * SN;
  rc = sum_parts<T>(dbc_part, static_cast<T*>(dBt), parts, E, 2 * E, stream);
  if (rc != 0) return rc;
  rc = sum_parts<T>(dbc_part + E, static_cast<T*>(dCt), parts, E, 2 * E, stream);
  if (rc != 0) return rc;
  return sum_parts<float>(dA_part, dA, B * NC, (long long)Di * SN, (long long)Di * SN, stream);
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

// The chunked route of rwkv_scan_bwd: bf16 r, k, v, dout and dr, dk, dv at
// K = V = 64, S >= 1, B, H <= 65535; w, u, ckpt (B, H, ceil(S / 64), 64, 64),
// dhT (B, H, 64, 64) or null, dw, du (H, 64) and dh0 (B, H, 64, 64) fp32.
// Workspaces R (B, H, ceil(S / 64), 64, 64), P (B, H, ceil(S / 64), 64) and
// du_part (B, ceil(S / 64), H, 64) fp32; every pointer 16-byte aligned. Four
// launches. Returns a cudaError_t.
extern "C" int rwkv_scan_bwd_chunk(const void* r, const void* w, const void* k,
                                   const void* v, const void* u, const void* ckpt,
                                   const void* dout, const void* dhT, void* dr, void* dw,
                                   void* dk, void* dv, void* du, void* dh0, void* R, void* P,
                                   void* du_part, int B, int S, int H, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  return launch_rwkv_bwd_chunk(
      static_cast<const bf16*>(r), static_cast<const float*>(w), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(u),
      static_cast<const float*>(ckpt), static_cast<const bf16*>(dout),
      static_cast<const float*>(dhT), static_cast<bf16*>(dr), static_cast<float*>(dw),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float*>(du),
      static_cast<float*>(dh0), static_cast<float*>(R), static_cast<float*>(P),
      static_cast<float*>(du_part), B, S, H, static_cast<cudaStream_t>(stream));
}

// The chunked route of mamba_scan_bwd: the arguments of mamba_scan_bwd with
// N = 16, Di a multiple of 8, ceil(S / 64) <= 65535 and every pointer 16-byte
// aligned. Workspaces L (B, ceil(S / 64), Di, 16), sumd (B, ceil(S / 64), Di),
// dbc_part (ceil(Di / 64), 2, B, S, 16) and dA_part (B, ceil(S / 64), Di, 16)
// fp32. Six launches. Returns a cudaError_t.
extern "C" int mamba_scan_bwd_chunk(const void* delta, const void* x, const void* A,
                                    const void* Bt, const void* Ct, const void* ckpt,
                                    const void* dy, const void* dhT, void* ddelta, void* dx,
                                    void* dA, void* dBt, void* dCt, void* dh0, void* L,
                                    void* sumd, void* dbc_part, void* dA_part, int dtype,
                                    int B, int S, int Di, int N, void* stream) {
  if (B <= 0 || S <= 0 || Di <= 0 || B > 65535 || N != SN || Di % 8 != 0 ||
      (S + CK - 1) / CK > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(A);
  const float* ck = static_cast<const float*>(ckpt);
  const float* gT = static_cast<const float*>(dhT);
  float* dAf = static_cast<float*>(dA);
  float* d0 = static_cast<float*>(dh0);
  float* lf = static_cast<float*>(L);
  float* sd = static_cast<float*>(sumd);
  float* pbc = static_cast<float*>(dbc_part);
  float* pa = static_cast<float*>(dA_part);
  if (dtype == 1)
    return launch_mamba_bwd_chunk<__nv_bfloat16>(delta, x, af, Bt, Ct, ck, dy, gT, ddelta, dx,
                                                 dAf, dBt, dCt, d0, lf, sd, pbc, pa, B, S, Di,
                                                 s);
  return launch_mamba_bwd_chunk<float>(delta, x, af, Bt, Ct, ck, dy, gT, ddelta, dx, dAf, dBt,
                                       dCt, d0, lf, sd, pbc, pa, B, S, Di, s);
}
