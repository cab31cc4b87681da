// Flash attention (prefill) for sm_90a: online softmax over K/V tiles.
//
// Replaces src/repro/kernels/flash_attention.py `_kernel` / `flash_attention`
// (the pallas_call at :115): q (B, Sq, H, D), k (B, Skv, KV, D),
// v (B, Skv, KV, Dv), bf16 or fp32, contiguous, in the reference's layout
// -> o (B, Sq, H, Dv) in q's type. Causal and sliding-window masks,
// q_offset, and GQA by kv head = h / (H / KV) with no KV expansion.
// Arithmetic as the reference: fp32 scores, masked scores set to
// NEG_INF = -1e30, fp32 running (m, l, acc), acc / max(l, 1e-30). Given a
// non-null lse (B, H, Sq) fp32, both routes also write each row's
// log-sum-exp of its scaled scores, m + ln l in natural-log units, which
// flash_attention_bwd.cu reads (a training forward asks for it).
//
// Bound: operations. A causal prefill of S tokens does 2 * S^2 * H * (D + Dv)
// / 2 FLOP against 2 * S * (H * (D + Dv) + 2 * KV * D) bytes (bf16): at
// S = 1024, H = 32 that is 8.6 GFLOP against 10.5 MB, ~500 FLOP a byte, so
// only the tensor cores (989 TFLOP/s bf16, against 67 fp32) can approach it.
// deepseek-v2's MLA prefill, (1, 1024, 128 heads, 192 | 128) with as many kv
// heads as query heads, moves more bytes a FLOP: 42.9 GFLOP against 168 MB,
// bound by the bytes (0.050 ms at 3.35 TB/s, 0.043 ms of tensor-core
// operations); on the CUDA cores its floor was 0.64 ms.
//
// Two routes, chosen by shape in the Python wrapper (`_route`):
//
// flash_attention_wgmma (bf16, D = Dv in {64, 128, 256}, and MLA's D = 192,
// Dv = 128: the kernel is a template on the pair (D, DV)): one block of two
// consumer warpgroups and one producer warpgroup per (128 q rows, head,
// batch), heaviest causal tiles launched first; each consumer warpgroup owns
// 64 rows (one wgmma M tile). One thread of the producer loads the Q tile
// once and K/V tiles of 64 keys into a ring by TMA, completed on "full" mbarriers;
// consumers release a stage on an "empty" mbarrier, so the two warpgroups
// never wait for each other (no block barrier in the loop). The ring has 3
// stages where they fit: up to D = 128, and at (192, 128), where Q takes
// 48 KB (three 64-wide boxes a row) and a K + V stage 40 KB (K three boxes,
// V two), ~169 KB in all, and each consumer thread holds O as 64 fp32
// registers, as at D = 128 (no spill). At D = 256 (gemma3) Q is 64 KB and
// a K + V stage 64 KB, so three stages (~257 KB) exceed the 227 KB a block
// may use and the ring has two (~193 KB). There each consumer thread holds
// O as 128 fp32
// registers beside the 32 of its score tile and 16 of P, more than the 168
// a thread ptxas gives this kernel, with 384 threads as with 288. The
// producer warpgroup lowers itself to 56 registers and the consumers raise
// themselves to 224 (setmaxnreg). ptxas still reports 168 and spills 428 B
// at D = 256 (none at D <= 128; chip_smoke.py prints its counts), but on
// the H100 one producer warp and no setmaxnreg spilled 940 B and took 1.69x
// the time at D = 256, the same time at D <= 128 (PERF.md, section 6).
// The tensor maps are rank 4, (D, heads, S, B), with boxes of
// (64, 1, rows, 1) and the 128-byte swizzle, so a ragged tail past Sq or Skv
// reads TMA's zero fill, never the next batch row; a row of D = 128 is two
// 64-element boxes, of D = 256 four. S = Q K^T is wgmma m64n64k16 with both
// operands in shared memory, K-major, unscaled bf16 products summed in fp32
// and multiplied by the scale after (in log2 units, for exp2). The softmax
// runs on the accumulator fragments: a lane holds 2 rows, so a row max is 2
// shuffles in the quad;
// masks are computed only on tiles that cross Skv, the diagonal or the
// window's edge.
// P is rounded to bf16 fragments in registers and O += P V is wgmma with A
// from registers and V read MN-major from shared memory (the transpose bit),
// one m64n64 product per 64 output columns. O, m and l stay in fp32
// registers; the epilogue divides, rounds and stores rows below Sq.
// The numerics differ from the reference in one place: P is rounded to bf16
// for P V (the reference multiplies in fp32); the tolerance budget is tested
// on the CPU (tests/test_torch_attention.py) and held on the card.
//
// flash_attention (fp32, and bf16 at other widths): the CUDA-core kernel
// below, one block of 256 threads per (q tile of 64 rows, head, batch), q
// scaled and transposed into shared memory as fp32; for each K/V tile of 64
// keys the block stages K (transposed) and V in shared memory, each thread
// computes a 4x4 block of scores (rows ty + 16 i, columns tx + 16 j), the 16
// threads of a row reduce max and sum by warp shuffles, P goes to shared
// memory over the spent K tile, and each thread accumulates 4 rows x VPT
// output columns of P @ V in registers: VPT = 8 for Dv <= 128, 16 for
// Dv <= 256 (gemma3's fp32 runs; ~194 KB of shared memory at D = Dv = 256,
// one block an SM).
//
// Both skip tiles wholly masked by causality or the window and mask ragged
// tiles themselves: rows past Sq are not stored, keys past Skv score NEG_INF.
#include <cuda.h>
#include <cuda_bf16.h>
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int BQ = 64, BK = 64;           // q rows and keys per tile
constexpr int TX = 16, TY = 16;           // 256 threads as 16 x 16
constexpr int RPT = BQ / TY;              // 4 rows a thread
constexpr int CPT = BK / TX;              // 4 score columns a thread
constexpr int MAX_DV = 256;               // VPT = 16 output columns a thread
constexpr int MAX_D = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T, int VPT>
__global__ void __launch_bounds__(TX * TY, VPT <= 8 ? 2 : 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int Sq, int Skv, int H, int KV, int D,
             int Dv, float scale, int causal, int window, int q_offset) {
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
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * Sq + r] = m[i] + logf(l[i]);
    T* orow = o + ((long long)(b * Sq + r) * H + h) * Dv;
#pragma unroll
    for (int e = 0; e < VPT; ++e) {
      const int col = tx + TX * e;
      if (col < Dv) store(orow + col, acc[i][e] / denom);
    }
  }
}

template <typename T, int VPT>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
           int Sq, int Skv, int H, int KV, int D, int Dv, float scale, int causal,
           int window, int q_offset, cudaStream_t stream) {
  const size_t rows_kp = D > BQ ? D : BQ;     // K tile rows, reused for P
  const size_t smem =
      sizeof(float) * ((size_t)D * (BQ + 1) + rows_kp * (BK + 1) + (size_t)BK * Dv);
  static size_t opted_in = 0;                 // shared-memory opt-in, once per size
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, VPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<T, VPT><<<grid, TX * TY, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Sq, Skv, H, KV, D, Dv, scale, causal, window,
      q_offset);
  return launch_status();
}

// Dv <= TX * VPT columns a thread owns
template <typename T>
int launch_dv(const void* q, const void* k, const void* v, void* o, float* lse, int B,
              int Sq, int Skv, int H, int KV, int D, int Dv, float scale, int causal,
              int window, int q_offset, cudaStream_t s) {
  if (Dv <= TX * 8)
    return launch<T, 8>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, Dv, scale, causal,
                        window, q_offset, s);
  return launch<T, 16>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, Dv, scale, causal,
                       window, q_offset, s);
}

// ---- tensor-core route: bf16, D = Dv in {64, 128, 256} ----------------------

namespace tc {

using namespace tensor_core;

constexpr int BQ = 128;            // q rows a block: two warpgroups of 64
constexpr int BK = 64;             // keys a K/V tile
constexpr int CONSUMERS = 256;     // two warpgroups; then a producer warpgroup
constexpr int THREADS = CONSUMERS + 128;
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;   // 128 x 56 + 256 x 224 <= 64 K
constexpr int BOX = 64;            // bf16 elements in one 128-byte swizzled row
constexpr int ROW = 128;           // bytes of that row
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

template <int D, int DV>
struct Smem {
  static constexpr int HALVES = D / BOX;              // 64-wide boxes a q or k row
  static constexpr int V_HALVES = DV / BOX;           // ... a v or o row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int K_BYTES = BK * D * 2;          // one K tile
  static constexpr int V_BYTES = BK * DV * 2;         // one V tile
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  // the K/V ring (see the note): three stages where they fit beside Q
  static constexpr int STAGES = Q_BYTES + 3 * STAGE_BYTES <= 200 * 1024 ? 3 : 2;
  static constexpr int BYTES = 1024 + Q_BYTES + STAGES * STAGE_BYTES;  // + alignment
};

// Shared memory, every tile 1024-aligned (the swizzle atom): Q as HALVES
// boxes of [BQ rows][64], then per stage K as HALVES and V as V_HALVES
// boxes of [BK keys][64]. A 64-wide box row is 128 bytes, its 16-byte chunks
// permuted by TMA as chunk ^ (row % 8); wgmma undoes it from the address.
template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Sq,
                   int Skv, int H, int KV, float scale_log2, int causal, int window,
                   int q_offset) {
  using S = Smem<D, DV>;
  constexpr int HALVES = S::HALVES, V_HALVES = S::V_HALVES, STAGES = S::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // full[s]: stage s loaded (TMA bytes); empty[s]: every consumer thread
  // is done with it; qbar: the Q tile loaded
  __shared__ uint64_t full[STAGES], empty[STAGES], qbar_mem;
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t skv = sq + S::Q_BYTES;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;

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
  const int n_tiles = max(0, kt_end - kt_begin);

  auto load_kv = [&](int j) {                  // tile j of the range into its stage
    const int s = j % STAGES;
    const uint32_t bar = smem_addr(&full[s]);
    const uint32_t kd = skv + s * S::STAGE_BYTES, vd = kd + S::K_BYTES;
    const int k0 = (kt_begin + j) * BK;
    mbar_arrive_expect_tx(bar, S::STAGE_BYTES);
    for (int hf = 0; hf < HALVES; ++hf)
      tma_load_4d(kd + hf * BK * ROW, &kmap, bar, hf * BOX, kvh, k0, b);
    for (int hf = 0; hf < V_HALVES; ++hf)
      tma_load_4d(vd + hf * BK * ROW, &vmap, bar, hf * BOX, kvh, k0, b);
  };

  const uint32_t qbar = smem_addr(&qbar_mem);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), CONSUMERS);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid >= CONSUMERS) {                      // the producer warpgroup: one
    warpgroup_reg_dealloc<PRODUCER_REGS>();    // thread keeps the ring full
    if (tid == CONSUMERS) {
      mbar_arrive_expect_tx(qbar, S::Q_BYTES);
      for (int hf = 0; hf < HALVES; ++hf)
        tma_load_4d(sq + hf * BQ * ROW, &qmap, qbar, hf * BOX, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        if (j >= STAGES)                       // the stage's last use released
          mbar_wait(smem_addr(&empty[j % STAGES]), (j / STAGES - 1) & 1);
        load_kv(j);
      }
    }
    return;
  }
  warpgroup_reg_alloc<CONSUMER_REGS>();

  // this lane's rows: row (accumulator entries 4 n + {0, 1}) and row + 8
  // (4 n + {2, 3}), columns 8 n + col + {0, 1}
  const int row = wg * 64 + warp * 16 + lane / 4;
  const int qpos = q0 + row + q_offset;
  const int col = 2 * (lane % 4);
  const uint32_t q_wg = sq + wg * 64 * ROW;
  float acc[V_HALVES][32];
#pragma unroll
  for (int hf = 0; hf < V_HALVES; ++hf)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[hf][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const int k0 = (kt_begin + j) * BK;
    const uint32_t kd = skv + s * S::STAGE_BYTES, vd = kd + S::K_BYTES;
    mbar_wait(smem_addr(&full[s]), (j / STAGES) & 1);

    // S = Q K^T: k steps of 16 walk 32 bytes along a 128-byte box row
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qa = q_wg + (kk / 4) * BQ * ROW + (kk % 4) * 32;
      const uint32_t ka = kd + (kk / 4) * BK * ROW + (kk % 4) * 32;
      wgmma_ss(sc, wgmma_desc(qa, 16, 1024), wgmma_desc(ka, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int e = 0; e < 32; ++e) reg_fence(sc[e]);

    // masks (only on a tile that crosses Skv, the diagonal or the window's
    // edge for some row of this warpgroup), then the online softmax in
    // log2 units
    float mx[2] = {m[0], m[1]};
    const int first = q0 + wg * 64 + q_offset;   // this warpgroup's positions
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > first) ||
                      (window > 0 && k0 <= first + 63 - window);
    if (edge) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + n * 8 + col + (e & 1);
          const int qp = qpos + 8 * (e >> 1);
          bool ok = kpos < Skv;
          if (causal) ok = ok && kpos <= qp;
          if (window > 0) ok = ok && kpos > qp - window;
          sc[n * 4 + e] = ok ? sc[n * 4 + e] * scale_log2 : NEG_INF;
        }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] *= scale_log2;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
    // P as bf16 A fragments: k block n / 2, registers {row, row + 8} of
    // its lower (n even) or upper (n odd) 8 keys
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float p0 = exp2f(sc[n * 4 + 0] - m[0]), p1 = exp2f(sc[n * 4 + 1] - m[0]);
      const float p2 = exp2f(sc[n * 4 + 2] - m[1]), p3 = exp2f(sc[n * 4 + 3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[n / 2][(n % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int hf = 0; hf < V_HALVES; ++hf)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[hf][e] *= alpha[(e >> 1) & 1];

    // O += P V: 16 keys a k step, 2048 bytes down the V box
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < BK / 16; ++kb)
#pragma unroll
      for (int hf = 0; hf < V_HALVES; ++hf)
        wgmma_rs_mn(acc[hf], pa[kb],
                    wgmma_desc(vd + hf * BK * ROW + kb * 16 * ROW, 1024, 1024));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int hf = 0; hf < V_HALVES; ++hf)
#pragma unroll
      for (int e = 0; e < 32; ++e) reg_fence(acc[hf][e]);
#pragma unroll
    for (int kb = 0; kb < BK / 16; ++kb)
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence(pa[kb][e]);
    mbar_arrive(smem_addr(&empty[s]));         // this thread is done with stage s
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + row + 8 * i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && (lane & 3) == 0)     // m is in log2 units here
      lse[((long long)b * H + h) * Sq + r] = (m[i] + log2f(l[i])) * LN2;
    __nv_bfloat16* orow = o + ((long long)(b * Sq + r) * H + h) * DV + col;
#pragma unroll
    for (int hf = 0; hf < V_HALVES; ++hf)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + hf * BOX + n * 8) =
            __floats2bfloat162_rn(acc[hf][n * 4 + 2 * i] / denom,
                                  acc[hf][n * 4 + 2 * i + 1] / denom);
  }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
           int Sq, int Skv, int H, int KV, float scale, int causal, int window,
           int q_offset, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int rc = encode(&qm, q, D, H, Sq, B, BQ);
  if (rc == 0) rc = encode(&km, k, D, KV, Skv, B, BK);
  if (rc == 0) rc = encode(&vm, v, DV, KV, Skv, B, BK);
  if (rc != 0) return rc;
  static bool opted_in = false;                // shared-memory opt-in, once
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<D, DV>::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_wgmma_kernel<D, DV><<<grid, THREADS, Smem<D, DV>::BYTES, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, Sq, Skv, H, KV,
      scale * LOG2E, causal, window, q_offset);
  return launch_status();
}

}  // namespace tc

}  // namespace

// dtype 0: fp32, 1: bf16. H % KV == 0, 0 < D <= 256, 0 < Dv <= 256,
// B * Sq > 0, Skv > 0; window <= 0 means no window; lse (B, H, Sq) fp32 or
// null. Returns a cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               void* lse, int dtype, int B, int Sq, int Skv, int H,
                               int KV, int D, int Dv, float scale, int causal,
                               int window, int q_offset, void* stream) {
  if (D <= 0 || D > MAX_D || Dv <= 0 || Dv > MAX_DV || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 1)
    return launch_dv<__nv_bfloat16>(q, k, v, o, l, B, Sq, Skv, H, KV, D, Dv, scale,
                                    causal, window, q_offset, s);
  return launch_dv<float>(q, k, v, o, l, B, Sq, Skv, H, KV, D, Dv, scale, causal,
                          window, q_offset, s);
}

// bf16 only; (D, Dv) in {(64, 64), (128, 128), (256, 256), (192, 128)};
// 16-byte aligned contiguous q, k, v; H % KV == 0, B * Sq > 0, Skv > 0;
// window <= 0 means no window; lse (B, H, Sq) fp32 or null. Returns a
// cudaError_t (cudaErrorNotSupported: no cuTensorMapEncodeTiled entry point).
extern "C" int flash_attention_wgmma(const void* q, const void* k, const void* v,
                                     void* o, void* lse, int B, int Sq, int Skv, int H,
                                     int KV, int D, int Dv, float scale, int causal,
                                     int window, int q_offset, void* stream) {
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (D == 64 && Dv == 64)
    return tc::launch<64, 64>(q, k, v, o, l, B, Sq, Skv, H, KV, scale, causal, window,
                              q_offset, s);
  if (D == 128 && Dv == 128)
    return tc::launch<128, 128>(q, k, v, o, l, B, Sq, Skv, H, KV, scale, causal,
                                window, q_offset, s);
  if (D == 256 && Dv == 256)
    return tc::launch<256, 256>(q, k, v, o, l, B, Sq, Skv, H, KV, scale, causal,
                                window, q_offset, s);
  if (D == 192 && Dv == 128)                   // MLA: nope 128 + rope 64 | v 128
    return tc::launch<192, 128>(q, k, v, o, l, B, Sq, Skv, H, KV, scale, causal,
                                window, q_offset, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
