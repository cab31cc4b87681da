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
// rounding of a bf16 multiply). expf, not __expf, keeps fp32 within 1e-5 on
// the serial and step routes; the segmented route's exponentials are below.
//
// Bound at the prefill shape (1, 1024, 8192), N = 16, bf16: bytes 51.4 MB
// (delta, x, y 50.3 MB; Bt, Ct, A and the state 1.1 MB) over 3.35 TB/s,
// 0.0154 ms; 6 FLOP a state element a step (delta A, exp(.) h, (delta x) B,
// the add, h C, the add), 0.805 GFLOP over the 67 TFLOP/s fp32 peak,
// 0.0120 ms; and B S Di N = 134M exponentials through the SFU, 16 a clock an
// SM for compute capability 9.0 (CUDA programming guide, arithmetic
// instructions), 4.18e12 a second at 132 SMs and 1.98 GHz, 0.0321 ms: the
// exponentials bind. At the decode shape (8, 1, 8192) the state read and
// written, 8.4 MB, 0.0025 ms: bytes bind.
//
// Three routes, chosen by the wrapper (kernels/linear_scan.py `_mamba_route`):
// the segmented scan for prefills of N = 16 from MAMBA_SEG_MIN_S steps, the
// lane-split step for S = 1 at N = 16, and the serial kernel for the rest
// (shorter prompts, the smoke config's N = 4). Mamba-1's decay is diagonal,
// exp(delta_t[c] A[c, n]) for each (channel, n): there is no matrix product
// for the tensor cores, so the routes gain by parallelism over time and by
// memory access.
//
// Serial route (mamba_kernel). One thread owns one channel, with its N fp32
// state values and its row of A in registers, and y_t[c] is its own N-term
// dot product (four partial sums). A block of MCOLS = 32
// threads owns 32 channels of one b; the time loop runs inside the block over
// tiles of MTILE steps, B_t, C_t, delta and delta x staged in shared memory as
// fp32. At B = 1 that is 256 one-warp blocks, two warps an SM: the serial
// chain of each step (exp, FMA into h, FMA into y) is exposed, 22x the SFU
// bound at the prefill shape.
//
// Segmented route (mamba_segmented_kernel). A block owns SCH = 32 channels
// of one b (a warp's lanes, so its loads of delta and x and its stores of y
// are coalesced across channels in the (B, S, Di) layout) and cuts S into
// SEGS = 16 segments of ceil(S / 16) steps, a warp each: at B = 1, 256 blocks
// of 16 warps, 16x the serial route's warps, two blocks (64 registers a
// thread) on each SM. Three phases:
//  (a) each warp scans its segment from a zero state, keeping its channel's
//      N state values and sum_t delta_t in registers; the segment's decay is
//      exp(A[c, n] sum_t delta_t), one exponential of a sum;
//  (b) the carry: the segments' decays and end states meet in shared memory,
//      and one thread for each (channel, n) walks the segments in order,
//      h_in(s + 1) = P(s) h_in(s) + h_end(s), from h0;
//  (c) each warp replays its segment from its true incoming state, y in the
//      serial route's four partial sums over n % 4, and writes y; the last
//      segment's warp writes the final state.
// No decay is ever a quotient of prefix products: jamba's A = -exp(A_log)
// reaches -16 and delta = softplus(.) is unbounded, so exp(delta A)
// underflows to denormals and 0, and a quotient would be 0 / 0. A decay
// across a range is the exponential of that range's sum.
// Each warp stages its steps STILE = 8 at a time with 16-byte cp.async into a
// double buffer of its own (delta, x, B_t and, in the replay, C_t), so the
// next tile's loads overlap this tile's arithmetic, and widens a bf16 tile's
// B_t and C_t rows to fp32 once (8 values a lane) rather than on every lane
// at every step; the buffers share their shared memory with the carry's
// arrays (phases (a) and (c) against (b)), 80 KB a block in bf16 and 96 KB in
// fp32, above the 48 KB default. The replay computes the exponentials again:
// the design's own SFU floor is 2 B S Di N exponentials, 0.0642 ms at the
// prefill shape, beside the function's 0.0321 ms bound. So each is one SFU
// instruction, 2^(delta A log2 e) by ex2.approx.f32 with A log2 e formed
// once (2 ulp; subnormal results kept, as expf keeps them), where expf
// spends ~8 FMA-pipe instructions beside its SFU one and made the FMA pipe
// the limit; fp32 stays within ~1e-7 of the largest y and state. The kernel
// takes 0.114 ms at the prefill shape in bf16 and fp32 (H100 80GB HBM3 at
// 700 W, chip_smoke.py's mamba_scan yardstick), 1.8x its own floor. Di must
// be a multiple of 8 (whole 16-byte chunks) and every pointer 16-byte
// aligned; the wrapper checks both.
//
// Step route (mamba_step_kernel), S = 1 at any B: four lanes own a channel,
// each loads and stores one float4 of its state (n = 4q .. 4q + 3), so a
// warp's state loads and stores are 512 contiguous bytes (the serial route
// read 16 scalars a thread, neighbouring lanes 64 bytes apart). y is the sum
// of the four lanes' partial dot products by two __shfl_xor_sync, in a fixed
// order, ((p0 + p1) + (p2 + p3)) on every lane. delta, x, B_t and C_t are read
// once per channel or row (one transaction a warp). hout may alias h0: each
// lane reads and writes only its own 16 bytes.
//
// Checkpoints for the backward (csrc/linear_scan_bwd.cu). Given a ckpt pointer
// (null when serving: nothing else changes), each route also writes the state
// every channel holds before steps 0, CK, 2 CK, ... (CK = 64, the wrapper's
// CHUNK) into ckpt (B, ceil(S / CK), Di, N) fp32: the serial route at the
// start of each of its MTILE = CK step tiles, the segmented route from its
// replay (phase (c); a second instantiation, so that the serving kernel keeps
// its code and registers: the check in its inner loop cost it 10% and four
// more bytes of spill), the step route its incoming state. 34 MB at jamba's
// training shape (4, 1024, 8192), N = 16.
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
//
// Checkpoints for the backward: the chunked route's carry already leaves
// the state each chunk starts from in its workspace U (B, H, ceil(S / 64),
// K, V), which the wrapper keeps; given a ckpt pointer the serial route
// writes the same states (before steps 0, CK, 2 CK, ...) into ckpt of that
// shape. 42 MB at rwkv6-3b's training shape (4, 1024, 40, 64).
#include <cstdint>
#include <cuda_bf16.h>
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

namespace tc = tensor_core;

constexpr int COLS = 32;   // state columns (threads) a block
constexpr int TILE = 32;   // time steps staged at a time

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// ---- Mamba --------------------------------------------------------------------

constexpr int MCOLS = 32;  // channels (threads) a block
constexpr int MTILE = 64;  // time steps staged at a time
constexpr int CK = 64;     // steps between checkpoints (linear_scan.py CHUNK)
static_assert(MTILE == CK && TILE * 2 == CK, "a checkpoint opens a tile");

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
             float* hout, float* __restrict__ ckpt, int S, int Di) {
  const int b = blockIdx.y;
  const int tid = threadIdx.x, c = blockIdx.x * MCOLS + tid;
  const bool active = c < Di;
  const int NC = (S + CK - 1) / CK;
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
    if (ckpt != nullptr && active) {
      float* ck = ckpt + (((long long)b * NC + t0 / CK) * Di + c) * N;
#pragma unroll
      for (int n = 0; n < N; ++n) ck[n] = h[n];
    }
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
                 float* hout, float* ckpt, int B, int S, int Di, cudaStream_t stream) {
  const dim3 grid((Di + MCOLS - 1) / MCOLS, B);
  const T* dt = static_cast<const T*>(delta);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bt);
  const T* ct = static_cast<const T*>(Ct);
  T* yt = static_cast<T*>(y);
  if (N == 16)
    mamba_kernel<T, 16><<<grid, MCOLS, 0, stream>>>(dt, xt, A, bt, ct, h0, yt, hout, ckpt, S,
                                                    Di);
  else if (N == 4)
    mamba_kernel<T, 4><<<grid, MCOLS, 0, stream>>>(dt, xt, A, bt, ct, h0, yt, hout, ckpt, S,
                                                   Di);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_status();
}

// ---- Mamba, segmented route ----------------------------------------------------

constexpr int SN = 16;                  // the state size the segmented and step routes take
constexpr int SEGS = 16;                // segments (warps) a block
constexpr int SCH = 32;                 // channels (lanes) a block
constexpr int STILE = 8;                // steps a staged tile
constexpr int SEG_THREADS = 32 * SEGS;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(SEG_THREADS == SCH * SN, "the carry gives each thread one (channel, n)");

// one warp's staged steps: delta and x for the block's channels, B_t and C_t;
// bf16 rows of B_t and C_t are widened to fp32 once a tile, not once a lane
template <typename T>
struct SegTile {
  T d[STILE][SCH];
  T x[STILE][SCH];
  T b[STILE][SN];
  T c[STILE][SN];
  float bf[STILE][SN];
  float cf[STILE][SN];
  __device__ const float* brow(int j) const { return bf[j]; }
  __device__ const float* crow(int j) const { return cf[j]; }
};
template <>
struct SegTile<float> {
  float d[STILE][SCH];
  float x[STILE][SCH];
  float b[STILE][SN];
  float c[STILE][SN];
  __device__ const float* brow(int j) const { return b[j]; }
  __device__ const float* crow(int j) const { return c[j]; }
};

// 2^x on the SFU, one instruction and its subnormal handling: results below
// 2^-126 stay denormals, as expf gives them (ex2.approx.ftz would flush them)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the scan and replay phases' double buffers share their bytes with the carry's
// arrays; rows of SN + 4 floats keep a quarter-warp's float4 accesses free of
// bank conflicts
template <typename T>
union SegSmem {
  SegTile<T> tile[SEGS][2];
  struct {
    float p[SEGS][SCH][SN + 4];         // each segment's decay
    float h[SEGS][SCH][SN + 4];         // its end state, then its incoming state
  } carry;
};

// 8 consecutive staged values (16-byte aligned) as fp32
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 u = reinterpret_cast<const float4*>(p)[0];
  const float4 v = reinterpret_cast<const float4*>(p)[1];
  out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
  out[4] = v.x; out[5] = v.y; out[6] = v.z; out[7] = v.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(pair[k]);
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

// One warp stages steps [t0, t0 + n) of batch row b (row0 = b S) for the
// block's channels [c0, c0 + SCH): 16-byte cp.async, zero-filled past the
// n steps and past Di (a multiple of 8, so a chunk is all in or all out).
template <typename T>
__device__ __forceinline__ void stage_tile(SegTile<T>& tile, const T* delta, const T* x,
                                           const T* Bt, const T* Ct, long long row0,
                                           int t0, int n, int c0, int Di, bool with_c,
                                           int lane) {
  constexpr int EPC = 16 / sizeof(T);   // values a chunk
  constexpr int CPR = SCH / EPC;        // chunks a row of delta or x
  constexpr int NPR = SN / EPC;         // chunks a row of B_t or C_t
  for (int i = lane; i < STILE * CPR; i += 32) {
    const int j = i / CPR, col = (i % CPR) * EPC;
    const bool ok = j < n && c0 + col < Di;
    const long long off = ok ? (row0 + t0 + j) * Di + c0 + col : 0;
    tc::cp_async16(tc::smem_addr(&tile.d[j][col]), delta + off, ok ? 16 : 0);
    tc::cp_async16(tc::smem_addr(&tile.x[j][col]), x + off, ok ? 16 : 0);
  }
  for (int i = lane; i < STILE * NPR; i += 32) {
    const int j = i / NPR, col = (i % NPR) * EPC;
    const bool ok = j < n;
    const long long off = ok ? (row0 + t0 + j) * SN + col : 0;
    tc::cp_async16(tc::smem_addr(&tile.b[j][col]), Bt + off, ok ? 16 : 0);
    if (with_c) tc::cp_async16(tc::smem_addr(&tile.c[j][col]), Ct + off, ok ? 16 : 0);
  }
}

// One warp walks its segment's `steps` steps from t_begin, lane = channel
// c0 + lane, state h in registers, a tile staged ahead of the one in use.
// The scan (REPLAY false) also sums delta; the replay (REPLAY true) writes y
// with the serial kernel's arithmetic and summation order and, with CKPT and
// where ck (this lane's channel of its row's checkpoints, stride Di SN) is not
// null, the state before every step t with t % CK == 0. CKPT is a template
// argument so that the serving kernel (CKPT false) is the code it was, with
// its registers.
template <bool REPLAY, bool CKPT, typename T>
__device__ __forceinline__ void walk_segment(SegTile<T> (&tiles)[2], const T* delta,
                                             const T* x, const T* Bt, const T* Ct, T* y,
                                             long long row0, int t_begin, int steps, int c0,
                                             int Di, int lane, const float (&a)[SN],
                                             float (&h)[SN], float& sumd, float* ck) {
  const int c = c0 + lane;
  if (steps > 0)
    stage_tile(tiles[0], delta, x, Bt, Ct, row0, t_begin, min(STILE, steps), c0, Di,
               REPLAY, lane);
  tc::cp_async_commit();
  for (int k = 0; k * STILE < steps; ++k) {
    const int next = (k + 1) * STILE;
    if (next < steps)
      stage_tile(tiles[(k + 1) & 1], delta, x, Bt, Ct, row0, t_begin + next,
                 min(STILE, steps - next), c0, Di, REPLAY, lane);
    tc::cp_async_commit();             // empty groups keep the count uniform
    tc::cp_async_wait<1>();            // tile k has landed (this lane's part)
    __syncwarp();                      // ... and every lane's
    SegTile<T>& tile = tiles[k & 1];
    if constexpr (sizeof(T) == 2) {
      // lanes 0-15 widen B's 8 x 16 values, 16-31 C's, 8 a lane
      const int j = (lane % 16) / 2, col = 8 * (lane % 2);
      if (lane < 16 || REPLAY) {
        float v[8];
        load8(lane < 16 ? &tile.b[j][col] : &tile.c[j][col], v);
        float4* out = reinterpret_cast<float4*>(lane < 16 ? &tile.bf[j][col]
                                                          : &tile.cf[j][col]);
        out[0] = make_float4(v[0], v[1], v[2], v[3]);
        out[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
      __syncwarp();
    }
    const int n = min(STILE, steps - k * STILE);
    for (int j = 0; j < n; ++j) {
      const float d = to_f(tile.d[j][lane]);
      const float dx = round_to(d * to_f(tile.x[j][lane]), x);
      if (!REPLAY) sumd += d;
      const int t = t_begin + k * STILE + j;
      if (CKPT && REPLAY && ck != nullptr && t % CK == 0) {
        float4* out = reinterpret_cast<float4*>(ck + (long long)(t / CK) * Di * SN);
#pragma unroll
        for (int q = 0; q < SN / 4; ++q)
          out[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
      }
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < SN / 8; ++i) {
        float bv[8], cv[8];
        load8(tile.brow(j) + 8 * i, bv);
        if (REPLAY) load8(tile.crow(j) + 8 * i, cv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int nn = 8 * i + e;   // a holds A log2(e): exp(d A) = 2^(d a)
          h[nn] = fmaf(exp2_sfu(d * a[nn]), h[nn], dx * bv[e]);
          if (REPLAY) acc[nn % 4] = fmaf(h[nn], cv[e], acc[nn % 4]);
        }
      }
      if (REPLAY && c < Di)
        store(y + (row0 + t_begin + k * STILE + j) * Di + c,
              (acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
    __syncwarp();                      // the tile is consumed before it is staged again
  }
  tc::cp_async_wait<0>();
}

template <typename T, bool CKPT>
__global__ void __launch_bounds__(SEG_THREADS, 2)
mamba_segmented_kernel(const T* __restrict__ delta, const T* __restrict__ x,
                       const float* __restrict__ A, const T* __restrict__ Bt,
                       const T* __restrict__ Ct, const float* h0, T* __restrict__ y,
                       float* hout, float* __restrict__ ckpt, int S, int Di) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SegSmem<T>& sm = *reinterpret_cast<SegSmem<T>*>(smem_raw);
  const int b = blockIdx.y, c0 = blockIdx.x * SCH;
  const int seg = threadIdx.x / 32, lane = threadIdx.x % 32, c = c0 + lane;
  const bool active = c < Di;
  const int len = (S + SEGS - 1) / SEGS;           // steps a segment
  const int nseg = (S + len - 1) / len;            // segments that have steps
  const int t_begin = seg * len;
  const int steps = max(0, min(S, t_begin + len) - t_begin);
  const long long row0 = (long long)b * S;
  float* ck = (ckpt != nullptr && active)
                  ? ckpt + ((long long)b * ((S + CK - 1) / CK) * Di + c) * SN : nullptr;

  float a[SN], h[SN];
#pragma unroll
  for (int i = 0; i < SN / 4; ++i) {
    const float4 v = active ? reinterpret_cast<const float4*>(A + (long long)c * SN)[i]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    a[4 * i] = kLog2e * v.x; a[4 * i + 1] = kLog2e * v.y;
    a[4 * i + 2] = kLog2e * v.z; a[4 * i + 3] = kLog2e * v.w;
  }
  // (a) the segment from a zero state, and its summed step sizes
#pragma unroll
  for (int n = 0; n < SN; ++n) h[n] = 0.f;
  float sumd = 0.f;
  walk_segment<false, false>(sm.tile[seg], delta, x, Bt, Ct, y, row0, t_begin, steps, c0, Di,
                      lane, a, h, sumd, nullptr);
  __syncthreads();                     // every warp is done with its tiles
  if (seg < nseg) {
#pragma unroll
    for (int i = 0; i < SN / 4; ++i) {
      // the decay over the segment: one exponential of the summed step
      // sizes, never a quotient of prefix products
      reinterpret_cast<float4*>(sm.carry.p[seg][lane])[i] =
          make_float4(exp2_sfu(a[4 * i] * sumd), exp2_sfu(a[4 * i + 1] * sumd),
                      exp2_sfu(a[4 * i + 2] * sumd), exp2_sfu(a[4 * i + 3] * sumd));
      reinterpret_cast<float4*>(sm.carry.h[seg][lane])[i] =
          make_float4(h[4 * i], h[4 * i + 1], h[4 * i + 2], h[4 * i + 3]);
    }
  }
  __syncthreads();
  // (b) the carry, one (channel, n) a thread, segment by segment from h0
  {
    const int cc = threadIdx.x / SN, n = threadIdx.x % SN, ch = c0 + cc;
    float hv = (h0 != nullptr && ch < Di) ? h0[((long long)b * Di + ch) * SN + n] : 0.f;
    for (int s = 0; s < nseg; ++s) {
      const float p = sm.carry.p[s][cc][n], e = sm.carry.h[s][cc][n];
      sm.carry.h[s][cc][n] = hv;
      hv = fmaf(p, hv, e);
    }
  }
  __syncthreads();
  if (seg < nseg) {
#pragma unroll
    for (int i = 0; i < SN / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(sm.carry.h[seg][lane])[i];
      h[4 * i] = v.x; h[4 * i + 1] = v.y; h[4 * i + 2] = v.z; h[4 * i + 3] = v.w;
    }
  }
  __syncthreads();                     // the incoming states are read before the tiles
  // (c) the replay from the incoming state: y, and the final state
  walk_segment<true, CKPT>(sm.tile[seg], delta, x, Bt, Ct, y, row0, t_begin, steps, c0, Di,
                     lane, a, h, sumd, ck);
  if (seg == nseg - 1 && active) {
    float4* out = reinterpret_cast<float4*>(hout + ((long long)b * Di + c) * SN);
#pragma unroll
    for (int i = 0; i < SN / 4; ++i)
      out[i] = make_float4(h[4 * i], h[4 * i + 1], h[4 * i + 2], h[4 * i + 3]);
  }
}

template <typename T, bool CKPT>
int launch_mamba_segmented_as(const void* delta, const void* x, const float* A,
                           const void* Bt, const void* Ct, const float* h0, void* y,
                           float* hout, float* ckpt, int B, int S, int Di,
                           cudaStream_t stream) {
  static bool opted_in = false;        // shared-memory opt-in, once an instance
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(mamba_segmented_kernel<T, CKPT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(sizeof(SegSmem<T>)));
    if (err == cudaSuccess)            // two blocks an SM need the largest carveout
      err = cudaFuncSetAttribute(mamba_segmented_kernel<T, CKPT>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid((Di + SCH - 1) / SCH, B);
  mamba_segmented_kernel<T, CKPT><<<grid, SEG_THREADS, sizeof(SegSmem<T>), stream>>>(
      static_cast<const T*>(delta), static_cast<const T*>(x), A, static_cast<const T*>(Bt),
      static_cast<const T*>(Ct), h0, static_cast<T*>(y), hout, ckpt, S, Di);
  return launch_status();
}

template <typename T>
int launch_mamba_segmented(const void* delta, const void* x, const float* A,
                           const void* Bt, const void* Ct, const float* h0, void* y,
                           float* hout, float* ckpt, int B, int S, int Di,
                           cudaStream_t stream) {
  if (ckpt != nullptr)
    return launch_mamba_segmented_as<T, true>(delta, x, A, Bt, Ct, h0, y, hout, ckpt, B, S,
                                              Di, stream);
  return launch_mamba_segmented_as<T, false>(delta, x, A, Bt, Ct, h0, y, hout, ckpt, B, S,
                                             Di, stream);
}

// ---- Mamba, step route ----------------------------------------------------------

constexpr int STEP_CH = 64;             // channels a block, four lanes each
constexpr int STEP_THREADS = 4 * STEP_CH;

template <typename T>
__global__ void __launch_bounds__(STEP_THREADS)
mamba_step_kernel(const T* __restrict__ delta, const T* __restrict__ x,
                  const float* __restrict__ A, const T* __restrict__ Bt,
                  const T* __restrict__ Ct, const float* h0, T* __restrict__ y,
                  float* hout, float* __restrict__ ckpt, int Di) {
  const int b = blockIdx.y, q = threadIdx.x % 4, n0 = 4 * q;
  const int c = blockIdx.x * STEP_CH + threadIdx.x / 4;
  const bool active = c < Di;          // every lane takes part in the shuffles
  const long long off = (long long)b * Di + c;     // channel (b, c) of delta, x, y
  float d = 0.f, dx = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), h = a;
  if (active) {
    d = to_f(delta[off]);
    dx = round_to(d * to_f(x[off]), x);
    a = *reinterpret_cast<const float4*>(A + (long long)c * SN + n0);
    if (h0 != nullptr) h = *reinterpret_cast<const float4*>(h0 + off * SN + n0);
    if (ckpt != nullptr) *reinterpret_cast<float4*>(ckpt + off * SN + n0) = h;
  }
  const T* bt = Bt + (long long)b * SN + n0;
  const T* ct = Ct + (long long)b * SN + n0;
  h.x = fmaf(expf(d * a.x), h.x, dx * to_f(bt[0]));
  h.y = fmaf(expf(d * a.y), h.y, dx * to_f(bt[1]));
  h.z = fmaf(expf(d * a.z), h.z, dx * to_f(bt[2]));
  h.w = fmaf(expf(d * a.w), h.w, dx * to_f(bt[3]));
  const float part = fmaf(h.y, to_f(ct[1]), h.x * to_f(ct[0]))
                   + fmaf(h.w, to_f(ct[3]), h.z * to_f(ct[2]));
  // (p0 + p1) + (p2 + p3) on every lane of the channel: the adds commute
  float sum = part + __shfl_xor_sync(0xffffffffu, part, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  if (active) {
    *reinterpret_cast<float4*>(hout + off * SN + n0) = h;
    if (q == 0) store(y + off, sum);
  }
}

template <typename T>
int launch_mamba_step(const void* delta, const void* x, const float* A, const void* Bt,
                      const void* Ct, const float* h0, void* y, float* hout,
                      float* ckpt, int B, int Di, cudaStream_t stream) {
  const dim3 grid((Di + STEP_CH - 1) / STEP_CH, B);
  mamba_step_kernel<T><<<grid, STEP_THREADS, 0, stream>>>(
      static_cast<const T*>(delta), static_cast<const T*>(x), A, static_cast<const T*>(Bt),
      static_cast<const T*>(Ct), h0, static_cast<T*>(y), hout, ckpt, Di);
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
            float* hout, float* __restrict__ ckpt, int S, int H, int V) {
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
    if (ckpt != nullptr && active && t0 % CK == 0) {
      const int NC = (S + CK - 1) / CK;
      float* ck = ckpt + ((((long long)b * H + h) * NC + t0 / CK) * K) * V + col;
#pragma unroll
      for (int i = 0; i < K; ++i) ck[(long long)i * V] = st[i];
    }
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
           const float* u, const float* h0, void* o, float* hout, float* ckpt, int B,
           int S, int H, int V, cudaStream_t stream) {
  const dim3 grid((V + COLS - 1) / COLS, H, B);
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (K == 64)
    rwkv_kernel<T, 64><<<grid, COLS, 0, stream>>>(rt, w, kt, vt, u, h0, ot, hout, ckpt, S, H,
                                                  V);
  else if (K == 16)
    rwkv_kernel<T, 16><<<grid, COLS, 0, stream>>>(rt, w, kt, vt, u, h0, ot, hout, ckpt, S, H,
                                                  V);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_status();
}

// ---- RWKV6, chunked route -----------------------------------------------------


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
// equal hout; ckpt null, or (B, H, ceil(S / 64), K, V) fp32 for the backward's
// checkpoints. Returns a cudaError_t.
extern "C" int rwkv_scan(const void* r, const void* w, const void* k, const void* v,
                         const void* u, const void* h0, void* o, void* hout, int dtype,
                         int B, int S, int H, int K, int V, void* ckpt, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || V <= 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(hout);
  float* ck = static_cast<float*>(ckpt);
  if (dtype == 1)
    return launch<__nv_bfloat16>(K, r, wf, k, v, uf, h0f, o, hf, ck, B, S, H, V, s);
  return launch<float>(K, r, wf, k, v, uf, h0f, o, hf, ck, B, S, H, V, s);
}

// dtype 0: fp32, 1: bf16 (delta, x, Bt, Ct and y). N (the state size of A's
// rows and of the state) is 4 or 16, the ported configs' sizes (jamba-v0.1-52b's
// smoke config and jamba-v0.1-52b); B, S, Di > 0; h0 may be null (a zero state)
// and may equal hout; ckpt null, or (B, ceil(S / 64), Di, N) fp32 for the
// backward's checkpoints. The serial route. Returns a cudaError_t.
extern "C" int mamba_scan(const void* delta, const void* x, const void* A,
                          const void* Bt, const void* Ct, const void* h0, void* y,
                          void* hout, int dtype, int B, int S, int Di, int N,
                          void* ckpt, void* stream) {
  if (B <= 0 || S <= 0 || Di <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(A);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(hout);
  float* ck = static_cast<float*>(ckpt);
  if (dtype == 1)
    return launch_mamba<__nv_bfloat16>(N, delta, x, af, Bt, Ct, h0f, y, hf, ck, B, S, Di, s);
  return launch_mamba<float>(N, delta, x, af, Bt, Ct, h0f, y, hf, ck, B, S, Di, s);
}

// The segmented route: the arguments of mamba_scan with N = 16, Di a multiple
// of 8 and every pointer 16-byte aligned. One launch. Returns a cudaError_t.
extern "C" int mamba_scan_segmented(const void* delta, const void* x, const void* A,
                                    const void* Bt, const void* Ct, const void* h0,
                                    void* y, void* hout, int dtype, int B, int S, int Di,
                                    int N, void* ckpt, void* stream) {
  if (B <= 0 || S <= 0 || Di <= 0 || B > 65535 || N != SN || Di % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(A);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(hout);
  float* ck = static_cast<float*>(ckpt);
  if (dtype == 1)
    return launch_mamba_segmented<__nv_bfloat16>(delta, x, af, Bt, Ct, h0f, y, hf, ck, B, S,
                                                 Di, s);
  return launch_mamba_segmented<float>(delta, x, af, Bt, Ct, h0f, y, hf, ck, B, S, Di, s);
}

// The step route: the arguments of mamba_scan with S = 1, N = 16 and A, h0,
// hout and ckpt 16-byte aligned. One launch. Returns a cudaError_t.
extern "C" int mamba_scan_step(const void* delta, const void* x, const void* A,
                               const void* Bt, const void* Ct, const void* h0, void* y,
                               void* hout, int dtype, int B, int S, int Di, int N,
                               void* ckpt, void* stream) {
  if (B <= 0 || S != 1 || Di <= 0 || B > 65535 || N != SN)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(A);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(hout);
  float* ck = static_cast<float*>(ckpt);
  if (dtype == 1)
    return launch_mamba_step<__nv_bfloat16>(delta, x, af, Bt, Ct, h0f, y, hf, ck, B, Di, s);
  return launch_mamba_step<float>(delta, x, af, Bt, Ct, h0f, y, hf, ck, B, Di, s);
}
