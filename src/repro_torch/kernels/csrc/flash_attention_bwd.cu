// Flash attention backward for sm_90a: dQ, dK, dV of flash_attention.cu's
// forward.
//
// The TPU package has no backward kernel: its gradient is XLA's autodiff of
// its attention (src/repro/kernels/ops.py `_xla_attention`), so this file
// replaces no pallas_call; it computes the gradient of the forward that
// replaces src/repro/kernels/flash_attention.py:115. q, do (B, Sq, H, D|Dv),
// k (B, Skv, KV, D), v (B, Skv, KV, Dv), o the forward's output, lse
// (B, H, Sq) fp32 its rows' log-sum-exp of the scaled scores (natural log),
// all bf16 or fp32 but lse, contiguous; causal and sliding-window masks,
// q_offset, GQA by kv head = h / (H / KV): dK and dV sum over the G query
// heads of a kv head. D, Dv <= 128, and bf16 at (D, Dv) = (256, 256)
// (gemma3) and (192, 128) (deepseek-v2's MLA). The forward's formulas,
// fp32 sums:
//   P = exp(scale * q.k - lse) on the visible (q, k) pairs, 0 elsewhere
//   Delta = rowsum(dO o O)
//   dV = P^T dO,  dS = P o (dO V^T - Delta),  dK = scale dS^T Q,
//   dQ = scale dS K.
//
// Bound: operations. Each visible (q, k) pair takes 2 (3 D + 2 Dv) FLOP (S,
// dP, dV, dK, dQ) against one read of q, k, v, o, do and one write of
// dq, dk, dv; at llama3-8b's (4, 1024, 32 | 8, 128) causal that is 86 GFLOP
// against 0.1 GB in bf16, 0.087 ms at 989 TFLOP/s; at whisper's encoder
// (8, 1500, 20, 64), non-causal, 230 GFLOP, 0.233 ms; at gemma3's
// (4, 1024, 16 | 8, 256) causal 86 GFLOP, 0.087 ms; at MLA's
// (4, 1024, 128, 192 | 128) causal 447 GFLOP, 0.452 ms.
//
// Every route launches three kernels on the caller's stream: a row pass
// (one warp a row of (b, i, h): Delta, and on the wgmma routes lse log2 e
// too), the route's kernel, and, for bf16, a cast (the fp32 dQ buffer
// rounded into dq). Each kernel is one block per (key tile, kv head, batch
// row), low key tiles first (in a causal run they see the most q tiles; the
// kv128 route: within groups of (kv head, batch row) slices): it
// keeps the tile's dK, dV in registers over the G query heads of its kv head
// (GQA sums without atomics) and every q tile of 64 rows that sees one of
// its keys, and adds dS K into an fp32 dQ buffer (a q tile's rows are shared
// by every key tile, so dQ is the one sum that crosses blocks; its order
// across blocks is not fixed). Rows past Sq and keys past Skv are masked
// (P = 0) and not stored. Four routes, chosen by shape in the Python
// wrapper (`_bwd_route`):
//
// flash_attention_bwd_wgmma (bf16, D = Dv in {64, 128}: whisper's and the
// llama family's heads): tma_route::flash_bwd_wgmma_kernel below, two or
// three warpgroups of 64 keys, Q, dO and the rows' statistics in a 2-stage
// TMA ring, the five products on wgmma, dQ added a 64 x 64 fp32 tile at a
// time by one bulk reduce-add (its note below).
//
// flash_attention_bwd_split (bf16, (D, Dv) = (256, 256) or (192, 128)):
// split_route::flash_bwd_split_kernel below, the wgmma route's ring and dQ
// adds, but both warpgroups on the same 64 keys, one keeping dV and adding
// dQ, the other computing dS and keeping dK (its note below). The wrapper
// sends it gemma3's (256, 256); MLA's (192, 128) only when forced.
//
// flash_attention_bwd_kv128 (bf16, (D, Dv) = (192, 128): deepseek-v2's
// MLA): kv128_route::flash_bwd_kv128_kernel below, 128 keys a block, each
// warpgroup keeping dK and dV of its 64 keys, dQ split between them by
// columns and added 96 columns a warpgroup by one bulk reduce-add (its note
// below).
//
// flash_attention_bwd_mma (bf16, other D and Dv multiples of 16 to 128): tc::
// flash_bwd_mma_kernel below, 4 warps of 16 keys, mma.sync m16n8k16 for the
// five products (P and dS rounded to bf16, as the forward rounds P), dQ by
// per-element atomicAdd; ~72 KB of shared memory at 128.
//
// flash_attention_bwd (fp32, and bf16 at other widths): flash_bwd_kernel,
// 256 threads on the CUDA cores. It holds K and V transposed in shared
// memory as fp32 and its dK, dV accumulators in registers (4 keys x DPT
// columns a thread); for each q tile it stages Q and dO transposed, computes
// S and dP (each thread a 4 x 4 block of the 64 x 64 tile, rows ty + 16 i,
// columns tx + 16 j, as the forward's CUDA-core kernel), P and dS into shared
// memory, then P^T dO, dS^T Q and dS K. Shared memory: (2 D + 2 Dv) x 65 +
// 2 x 64 x 65 floats, 167 KB at D = Dv = 128, one block an SM; 100 KB at 64.
#include <cstdint>
#include <cuda_bf16.h>
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int BQ = 64, BK = 64;           // q rows and keys a tile
constexpr int TX = 16, TY = 16;           // 256 threads as 16 x 16
constexpr int THREADS = TX * TY;
constexpr int RPT = BQ / TY;              // 4 rows (or keys) a thread
constexpr int CPT = BK / TX;              // 4 columns a thread
constexpr int PAD = 65;                   // row stride of a transposed tile
constexpr int MAX_W = 128;                // widest D, Dv
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// four adjacent elements as floats: one 16-byte load in fp32, 8 in bf16
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Delta[b, h, i] = sum_e dO[b, i, h, e] O[b, i, h, e] into delta (B, H, Sp),
// one warp a row, zeros for the rows i in [Sq, Sp) (Sp >= Sq rounds Sq up to
// a tile where a route reads whole tiles of rows); with a non-null lse2 also
// lse2[b, h, i] = lse[b, h, i] log2 e (zeros past Sq), the exp2 form the
// wgmma routes read. Where Dv % 4 == 0 and both tensors are aligned to four
// elements, a lane reads four adjacent columns a load; else one
template <typename T>
__global__ void flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                                const float* __restrict__ lse, float* __restrict__ lse2,
                                float* __restrict__ delta, int Sq, int Sp, int H,
                                int Dv, long long rows) {
  const long long r = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;                     // r = (b * H + h) * Sp + i
  const long long i = r % Sp, bh = r / Sp, h = bh % H, b = bh / H;
  float s = 0.f;
  if (i < Sq) {
    const long long at = ((b * Sq + i) * H + h) * Dv;
    const bool vec = Dv % 4 == 0 && ((reinterpret_cast<uintptr_t>(o) |
                                      reinterpret_cast<uintptr_t>(dout)) %
                                     (4 * sizeof(T))) == 0;
    if (vec) {
      for (int e = 4 * lane; e < Dv; e += 128) {
        const float4 x = load4(o + at + e), g = load4(dout + at + e);
        s = fmaf(x.x, g.x, s);
        s = fmaf(x.y, g.y, s);
        s = fmaf(x.z, g.z, s);
        s = fmaf(x.w, g.w, s);
      }
    } else {
      for (int e = lane; e < Dv; e += 32) s = fmaf(to_f(o[at + e]), to_f(dout[at + e]), s);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    delta[r] = s;
    if (lse2 != nullptr) lse2[r] = i < Sq ? lse[bh * Sq + i] * LOG2E : 0.f;
  }
}

template <typename T>
__global__ void flash_bwd_cast(const float* __restrict__ src, T* __restrict__ dst,
                               long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) store(dst + i, src[i]);
}

// DPT: columns of D and Dv a thread owns in the dK, dV and dQ products
// (D, Dv <= TX * DPT)
template <typename T, int DPT>
__global__ void __launch_bounds__(THREADS, DPT <= 4 ? 2 : 1)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                 int Sq, int Skv, int H, int KV, int D, int Dv, float scale,
                 int causal, int window, int q_offset) {
  extern __shared__ float smem[];
  float* Kt = smem;                          // [D][PAD]: key c at column c
  float* Vt = Kt + D * PAD;                  // [Dv][PAD]
  float* Qt = Vt + Dv * PAD;                 // [D][PAD]: q row r at column r
  float* Gt = Qt + D * PAD;                  // [Dv][PAD]: dO
  float* Ps = Gt + Dv * PAD;                 // [BQ][PAD]: P
  float* Ds = Ps + BQ * PAD;                 // [BQ][PAD]: dS
  float* Ls = Ds + BQ * PAD;                 // [BQ]: lse of the tile's rows
  float* Es = Ls + BQ;                       // [BQ]: Delta

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int k0 = kt * BK;
  const int k_last = min(k0 + BK, Skv) - 1;

  for (int i = tid; i < BK * D; i += THREADS) {
    const int c = i / D, d = i % D;
    Kt[d * PAD + c] = k0 + c < Skv
        ? to_f(k[((long long)(b * Skv + k0 + c) * KV + kvh) * D + d]) : 0.f;
  }
  for (int i = tid; i < BK * Dv; i += THREADS) {
    const int c = i / Dv, e = i % Dv;
    Vt[e * PAD + c] = k0 + c < Skv
        ? to_f(v[((long long)(b * Skv + k0 + c) * KV + kvh) * Dv + e]) : 0.f;
  }

  // the q rows that see a key of this tile: row i sits at i + q_offset and
  // sees key c when c <= i + q_offset (causal) and c > i + q_offset - window
  int i_begin = 0, i_end = Sq;
  if (causal) i_begin = max(0, k0 - q_offset);
  if (window > 0) i_end = min(Sq, k_last + window - q_offset);
  const int qt_begin = i_begin / BQ;
  const int qt_end = i_end > i_begin ? (i_end + BQ - 1) / BQ : qt_begin;

  float adk[RPT][DPT], adv[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) adk[i][j] = adv[i][j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();                       // the last tile's Q, dO, P, dS are spent
      for (int i = tid; i < BQ * D; i += THREADS) {
        const int r = i / D, d = i % D;
        Qt[d * PAD + r] = q0 + r < Sq
            ? to_f(q[((long long)(b * Sq + q0 + r) * H + h) * D + d]) : 0.f;
      }
      for (int i = tid; i < BQ * Dv; i += THREADS) {
        const int r = i / Dv, e = i % Dv;
        Gt[e * PAD + r] = q0 + r < Sq
            ? to_f(dout[((long long)(b * Sq + q0 + r) * H + h) * Dv + e]) : 0.f;
      }
      if (tid < BQ) {
        const bool live = q0 + tid < Sq;
        const long long at = ((long long)b * H + h) * Sq + q0 + tid;
        Ls[tid] = live ? lse[at] : 0.f;
        Es[tid] = live ? delta[at] : 0.f;
      }
      __syncthreads();

      // S = Q K^T and dP = dO V^T on the thread's 4 x 4 block
      float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float a[RPT], bb[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) a[i] = Qt[d * PAD + ty + TY * i];
#pragma unroll
        for (int j = 0; j < CPT; ++j) bb[j] = Kt[d * PAD + tx + TX * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
      }
      for (int e = 0; e < Dv; ++e) {
        float a[RPT], bb[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) a[i] = Gt[e * PAD + ty + TY * i];
#pragma unroll
        for (int j = 0; j < CPT; ++j) bb[j] = Vt[e * PAD + tx + TX * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) dp[i][j] = fmaf(a[i], bb[j], dp[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = ty + TY * i;
        const int qpos = q0 + r + q_offset;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = tx + TX * j, kpos = k0 + c;
          bool ok = q0 + r < Sq && kpos < Skv;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          const float p = ok ? expf(s[i][j] * scale - Ls[r]) : 0.f;
          Ps[r * PAD + c] = p;
          Ds[r * PAD + c] = p * (dp[i][j] - Es[r]);
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q: keys ty + 16 i, columns tx + 16 j
      for (int r = 0; r < BQ; ++r) {
        float pv[RPT], dsv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = Ps[r * PAD + ty + TY * i];
          dsv[i] = Ds[r * PAD + ty + TY * i];
        }
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const int col = tx + TX * j;
          const float gv = col < Dv ? Gt[col * PAD + r] : 0.f;
          const float qv = col < D ? Qt[col * PAD + r] : 0.f;
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            adv[i][j] = fmaf(pv[i], gv, adv[i][j]);
            adk[i][j] = fmaf(dsv[i], qv, adk[i][j]);
          }
        }
      }

      // dQ += scale dS K: rows ty + 16 i, columns tx + 16 j, into the fp32
      // buffer that every key tile adds to
      float aq[RPT][DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) aq[i][j] = 0.f;
      for (int c = 0; c < BK; ++c) {
        float dsv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) dsv[i] = Ds[(ty + TY * i) * PAD + c];
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const int col = tx + TX * j;
          const float kv = col < D ? Kt[col * PAD + c] : 0.f;
#pragma unroll
          for (int i = 0; i < RPT; ++i) aq[i][j] = fmaf(dsv[i], kv, aq[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = q0 + ty + TY * i;
        if (r >= Sq) continue;
        float* row = dq + ((long long)(b * Sq + r) * H + h) * D;
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const int col = tx + TX * j;
          if (col < D) atomicAdd(row + col, aq[i][j] * scale);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int c = k0 + ty + TY * i;
    if (c >= Skv) continue;
    T* krow = dk + ((long long)(b * Skv + c) * KV + kvh) * D;
    T* vrow = dv + ((long long)(b * Skv + c) * KV + kvh) * Dv;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int col = tx + TX * j;
      if (col < D) store(krow + col, adk[i][j] * scale);
      if (col < Dv) store(vrow + col, adv[i][j]);
    }
  }
}

template <typename T, int DPT>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dq_acc, float* delta, void* dq,
           void* dk, void* dv, int B, int Sq, int Skv, int H, int KV, int D, int Dv,
           float scale, int causal, int window, int q_offset, cudaStream_t stream) {
  const long long q_elems = (long long)B * Sq * H * D;
  cudaError_t err = cudaMemsetAsync(dq_acc, 0, sizeof(float) * q_elems, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = (long long)B * Sq * H;
  flash_bwd_delta<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), nullptr, nullptr, delta,
      Sq, Sq, H, Dv, rows);
  int rc = launch_status();
  if (rc != 0) return rc;
  const size_t smem = sizeof(float) * ((size_t)(2 * D + 2 * Dv) * PAD +
                                       (size_t)2 * BQ * PAD + 2 * BQ);
  static size_t opted_in = 0;                 // shared-memory opt-in, once per size
  if (smem > opted_in) {
    err = cudaFuncSetAttribute(flash_bwd_kernel<T, DPT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  const dim3 grid((Skv + BK - 1) / BK, KV, B);
  flash_bwd_kernel<T, DPT><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, dq_acc, static_cast<T*>(dk),
      static_cast<T*>(dv), Sq, Skv, H, KV, D, Dv, scale, causal, window, q_offset);
  rc = launch_status();
  if (rc != 0 || static_cast<void*>(dq_acc) == dq) return rc;
  flash_bwd_cast<T><<<(unsigned)((q_elems + 255) / 256), 256, 0, stream>>>(
      dq_acc, static_cast<T*>(dq), q_elems);
  return launch_status();
}

template <typename T>
int by_width(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* dq_acc, float* delta,
             void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H, int KV,
             int D, int Dv, float scale, int causal, int window, int q_offset,
             cudaStream_t s) {
  if ((D > Dv ? D : Dv) <= TX * 4)
    return launch<T, 4>(q, k, v, o, dout, lse, dq_acc, delta, dq, dk, dv, B, Sq, Skv,
                        H, KV, D, Dv, scale, causal, window, q_offset, s);
  return launch<T, 8>(q, k, v, o, dout, lse, dq_acc, delta, dq, dk, dv, B, Sq, Skv, H,
                      KV, D, Dv, scale, causal, window, q_offset, s);
}


// ---- tensor-core route: bf16, D and Dv multiples of 16, up to 128 -----------

namespace tc {

using namespace tensor_core;

constexpr int BQ = 64, BK = 64;           // q rows and keys a tile
constexpr int WARPS = 4;                  // a warp owns 16 keys of the tile

// A [rows][DMAX] bf16 tile in shared memory, its 16-byte chunk c of row r
// stored at chunk c ^ (r & 7), so that ldmatrix's eight rows hit distinct
// banks; DMAX >= 64 (8 chunks a row)
template <int DMAX>
__device__ __forceinline__ uint32_t at(uint32_t base, int r, int c) {
  return base + r * (DMAX * 2) + ((c ^ (r & 7)) << 4);
}

template <int DMAX>
struct Smem {
  static constexpr int TILE = 64 * DMAX * 2;          // K, V, Q or dO
  static constexpr int DS = BK * BQ * 2;              // dS^T, [key][q] bf16
  static constexpr int BYTES = 4 * TILE + DS + 2 * BQ * 4;
};

// rows [row0, row0 + 64) of a (B, S, heads, W) bf16 tensor at head h into a
// tile, 16-byte cp.async copies; rows past S and columns past W zero-filled
template <int DMAX>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* src,
                                          int b, int row0, int S, int heads, int h,
                                          int W, int tid) {
  constexpr int CH = DMAX / 8;
  for (int i = tid; i < 64 * CH; i += WARPS * 32) {
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < S && c * 8 < W;
    const __nv_bfloat16* g =
        src + (((long long)b * S + (ok ? row0 + r : 0)) * heads + h) * W + (ok ? c * 8 : 0);
    cp_async16(at<DMAX>(tile, r, c), g, ok ? 16 : 0);
  }
}

// One block of 4 warps per (64-key tile, kv head, batch row); warp w owns keys
// 16 w .. 16 w + 15 of the tile and keeps their dK, dV rows in fp32 registers
// over the G query heads of the kv head and every q tile that sees a key of the
// tile. Per q tile, with K, V (staged once), Q and dO in shared memory:
//   S^T = K Q^T and dP^T = V dO^T (mma.sync m16n8k16, keys as rows), then
//   P^T = exp2(S^T scale log2e - lse log2e) on the visible pairs and
//   dS^T = P^T o (dP^T - Delta), in registers;
//   dV += P^T dO and dK += dS^T Q with P^T, dS^T repacked from the
//   accumulators as bf16 A fragments (no data exchange between lanes) and dO,
//   Q read transposed (ldmatrix.trans);
//   dS^T to shared memory as bf16, then dQ = dS K for the warp's 16 q rows
//   against all 64 keys, added to the fp32 dQ buffer with atomicAdd.
// P and dS are rounded to bf16 for the products, as the forward rounds P.
template <int DMAX>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H, int KV,
                     int D, int Dv, float scale, int causal, int window,
                     int q_offset) {
  using S = Smem<DMAX>;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t ks = smem_addr(smem), vs = ks + S::TILE, qs = vs + S::TILE;
  const uint32_t gs = qs + S::TILE, dss = gs + S::TILE;
  float* Ls = reinterpret_cast<float*>(smem + 4 * S::TILE + S::DS);
  float* Es = Ls + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4, mat = lane / 8;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int k0 = kt * BK;
  const int k_last = min(k0 + BK, Skv) - 1;
  const float scale_log2 = scale * LOG2E;

  load_tile<DMAX>(ks, k, b, k0, Skv, KV, kvh, D, tid);
  load_tile<DMAX>(vs, v, b, k0, Skv, KV, kvh, Dv, tid);
  cp_async_commit();

  // the q rows that see a key of this tile (as the CUDA-core kernel's)
  int i_begin = 0, i_end = Sq;
  if (causal) i_begin = max(0, k0 - q_offset);
  if (window > 0) i_end = min(Sq, k_last + window - q_offset);
  const int qt_begin = i_begin / BQ;
  const int qt_end = i_end > i_begin ? (i_end + BQ - 1) / BQ : qt_begin;

  float adk[DMAX / 8][4], adv[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  const int krow = 16 * warp;               // the warp's first key in the tile

  for (int gh = 0; gh < G; ++gh) {
    const int h = kvh * G + gh;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();                      // the last tile's Q, dO, dS^T are spent
      load_tile<DMAX>(qs, q, b, q0, Sq, H, h, D, tid);
      load_tile<DMAX>(gs, dout, b, q0, Sq, H, h, Dv, tid);
      cp_async_commit();
      if (tid < BQ) {
        const bool live = q0 + tid < Sq;
        const long long row = ((long long)b * H + h) * Sq + q0 + tid;
        Ls[tid] = live ? lse[row] * LOG2E : 0.f;
        Es[tid] = live ? delta[row] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 64 q rows
      float s[8][4], dp[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        if (kk * 16 < D) {
          uint32_t a[4];
          ldmatrix_x4(a, at<DMAX>(ks, krow + (mat % 2) * 8 + lane % 8, 2 * kk + mat / 2));
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t bq[4];
            ldmatrix_x4(bq, at<DMAX>(qs, 16 * j + (mat / 2) * 8 + lane % 8,
                                     2 * kk + mat % 2));
            mma_bf16(s[2 * j], a[0], a[1], a[2], a[3], bq[0], bq[1]);
            mma_bf16(s[2 * j + 1], a[0], a[1], a[2], a[3], bq[2], bq[3]);
          }
        }
        if (kk * 16 < Dv) {
          uint32_t a[4];
          ldmatrix_x4(a, at<DMAX>(vs, krow + (mat % 2) * 8 + lane % 8, 2 * kk + mat / 2));
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t bg[4];
            ldmatrix_x4(bg, at<DMAX>(gs, 16 * j + (mat / 2) * 8 + lane % 8,
                                     2 * kk + mat % 2));
            mma_bf16(dp[2 * j], a[0], a[1], a[2], a[3], bg[0], bg[1]);
            mma_bf16(dp[2 * j + 1], a[0], a[1], a[2], a[3], bg[2], bg[3]);
          }
        }
      }

      // P^T and dS^T on the fragments: entry e of block n is key
      // krow + g + 8 (e / 2), q row 8 n + 2 c + e % 2 of the tile
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + krow + g + 8 * (e >> 1);
          const int r = 8 * n + 2 * c + (e & 1);
          const int qpos = q0 + r + q_offset;
          bool ok = q0 + r < Sq && kpos < Skv;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          const float p = ok ? exp2f(s[n][e] * scale_log2 - Ls[r]) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - Es[r]);
        }
        pa[n / 2][(n % 2) * 2 + 0] = pack_bf16(s[n][0], s[n][1]);
        pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(s[n][2], s[n][3]);
        da[n / 2][(n % 2) * 2 + 0] = pack_bf16(dp[n][0], dp[n][1]);
        da[n / 2][(n % 2) * 2 + 1] = pack_bf16(dp[n][2], dp[n][3]);
      }
      // dS^T to shared memory for dQ: row key, 8 q a chunk
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint32_t lo = at<8 * 8>(dss, krow + g, n) + 4 * c;
        const uint32_t hi = at<8 * 8>(dss, krow + g + 8, n) + 4 * c;
        asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(lo), "r"(da[n / 2][(n % 2) * 2]));
        asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(hi), "r"(da[n / 2][(n % 2) * 2 + 1]));
      }

      // dV += P^T dO and dK += dS^T Q: k = the tile's 64 q rows
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < DMAX / 16; ++j) {
          if (j * 16 < Dv) {
            uint32_t bg[4];
            ldmatrix_x4_trans(bg, at<DMAX>(gs, 16 * kk + (mat % 2) * 8 + lane % 8,
                                           2 * j + mat / 2));
            mma_bf16(adv[2 * j], pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3], bg[0], bg[1]);
            mma_bf16(adv[2 * j + 1], pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3], bg[2],
                     bg[3]);
          }
          if (j * 16 < D) {
            uint32_t bq[4];
            ldmatrix_x4_trans(bq, at<DMAX>(qs, 16 * kk + (mat % 2) * 8 + lane % 8,
                                           2 * j + mat / 2));
            mma_bf16(adk[2 * j], da[kk][0], da[kk][1], da[kk][2], da[kk][3], bq[0], bq[1]);
            mma_bf16(adk[2 * j + 1], da[kk][0], da[kk][1], da[kk][2], da[kk][3], bq[2],
                     bq[3]);
          }
        }
      }
      __syncthreads();                      // every warp's dS^T is in place

      // dQ = dS K for q rows 16 w .. 16 w + 15 of the tile, 64 columns at a time
#pragma unroll
      for (int half = 0; half < DMAX / 64; ++half) {
        if (half * 64 >= D) break;
        float aq[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) aq[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t a[4];
          ldmatrix_x4_trans(a, at<8 * 8>(dss, 16 * kk + (mat / 2) * 8 + lane % 8,
                                         2 * warp + mat % 2));
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (half * 64 + j * 16 < D) {
              uint32_t bk[4];
              ldmatrix_x4_trans(bk, at<DMAX>(ks, 16 * kk + (mat % 2) * 8 + lane % 8,
                                             8 * half + 2 * j + mat / 2));
              mma_bf16(aq[2 * j], a[0], a[1], a[2], a[3], bk[0], bk[1]);
              mma_bf16(aq[2 * j + 1], a[0], a[1], a[2], a[3], bk[2], bk[3]);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = q0 + 16 * warp + g + 8 * (e >> 1);
            const int col = half * 64 + 8 * n + 2 * c + (e & 1);
            if (r < Sq && col < D)
              atomicAdd(dq + ((long long)(b * Sq + r) * H + h) * D + col, aq[n][e] * scale);
          }
      }
    }
  }
  cp_async_wait<0>();                       // K, V landed even if no q tile came

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + krow + g + 8 * i;
    if (key >= Skv) continue;
    __nv_bfloat16* krw = dk + ((long long)(b * Skv + key) * KV + kvh) * D;
    __nv_bfloat16* vrw = dv + ((long long)(b * Skv + key) * KV + kvh) * Dv;
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n) {
      const int col = 8 * n + 2 * c;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(krw + col) =
            __floats2bfloat162_rn(adk[n][2 * i] * scale, adk[n][2 * i + 1] * scale);
      if (col < Dv)
        *reinterpret_cast<__nv_bfloat162*>(vrw + col) =
            __floats2bfloat162_rn(adv[n][2 * i], adv[n][2 * i + 1]);
    }
  }
}

template <int DMAX>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dq_acc, float* delta, void* dq,
           void* dk, void* dv, int B, int Sq, int Skv, int H, int KV, int D, int Dv,
           float scale, int causal, int window, int q_offset, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const long long q_elems = (long long)B * Sq * H * D;
  cudaError_t err = cudaMemsetAsync(dq_acc, 0, sizeof(float) * q_elems, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = (long long)B * Sq * H;
  flash_bwd_delta<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), nullptr, nullptr, delta,
      Sq, Sq, H, Dv, rows);
  int rc = launch_status();
  if (rc != 0) return rc;
  static bool opted_in = false;               // shared-memory opt-in, once
  if (!opted_in) {
    err = cudaFuncSetAttribute(flash_bwd_mma_kernel<DMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Smem<DMAX>::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid((Skv + BK - 1) / BK, KV, B);
  flash_bwd_mma_kernel<DMAX><<<grid, WARPS * 32, Smem<DMAX>::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, dq_acc, static_cast<T*>(dk),
      static_cast<T*>(dv), Sq, Skv, H, KV, D, Dv, scale, causal, window, q_offset);
  rc = launch_status();
  if (rc != 0) return rc;
  flash_bwd_cast<T><<<(unsigned)((q_elems + 255) / 256), 256, 0, stream>>>(
      dq_acc, static_cast<T*>(dq), q_elems);
  return launch_status();
}

}  // namespace tc

// ---- wgmma route: bf16, D = Dv in {64, 128} --------------------------------

namespace tma_route {

using namespace tensor_core;

constexpr int BQ = 64;                    // q rows a tile of the ring
constexpr int STAGES = 2;                 // the Q / dO / row-statistics ring
constexpr int ROW = 128;                  // bytes of a 64-wide bf16 box row
constexpr int TILE = 64 * ROW;            // one [64 rows][64] bf16 box
constexpr int DQ_TILE = BQ * 64 * 4;      // one [64 q][64] fp32 dQ chunk

// Shared memory, every bf16 tile 1024-aligned (the 128-byte swizzle atom):
// K and V of the block (a warpgroup's 64 keys as HALVES boxes each), the
// ring's stages (Q, then dO, HALVES boxes each), dS^T of the last two q
// tiles (one [64 keys][64 q] tile a warpgroup each), one fp32 dQ chunk a
// warpgroup, and the ring's row statistics (lse log2 e, Delta: 64 floats
// each a stage).
template <int D>
struct Smem {
  // warpgroups a block, 64 keys each, and no producer warps (see below)
  static constexpr int CONSUMERS = D <= 64 ? 3 : 2;
  static constexpr int HALVES = D / 64;
  static constexpr int KV_TILE = HALVES * TILE;          // a warpgroup's K or V
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + CONSUMERS * KV_TILE;
  static constexpr int STAGE = 2 * HALVES * TILE;        // Q and dO
  static constexpr int Q_OFF = V_OFF + CONSUMERS * KV_TILE;
  static constexpr int DS_OFF = Q_OFF + STAGES * STAGE;
  static constexpr int DQ_OFF = DS_OFF + 2 * CONSUMERS * TILE;
  static constexpr int ROWS_OFF = DQ_OFF + CONSUMERS * DQ_TILE;
  static constexpr int ROWS = 2 * BQ * 4;                // a stage's statistics
  static constexpr int BYTES = 1024 + ROWS_OFF + STAGES * ROWS;   // + alignment
};

// S^T = K Q^T for a warpgroup's 64 keys from k0 (K at ks) x the q tile's
// 64 rows (Q at qs; wgmma, both operands K-major, k steps of 16 walking 32
// bytes along a 128-byte box row) and P^T = exp2(S^T scale log2 e - lse
// log2 e) from it, 0 on the masked pairs, as bf16 A fragments: entry e of
// block n is key kpos + 8 (e / 2), q row 8 n + col + e % 2 of the tile.
// Only a tile that crosses Sq, Skv, the diagonal or the window's edge
// tests the mask. acc is left holding S^T, for the caller to reuse as the
// next product's accumulators.
template <int D>
__device__ __forceinline__ void probs_t(uint32_t (&pa)[4][4], float (&acc)[32],
                                        uint32_t ks, uint32_t qs, const float* lse2,
                                        int k0, int q0, int kpos, int col, int Sq,
                                        int Skv, float scale_log2, int causal,
                                        int window, int q_offset) {
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * TILE + (kk % 4) * 32;
    wgmma_ss(acc, wgmma_desc(ks + off, 16, 1024), wgmma_desc(qs + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int e = 0; e < 32; ++e) reg_fence(acc[e]);
  const int qp0 = q0 + q_offset;
  const bool edge = q0 + BQ > Sq || k0 + 64 > Skv || (causal && k0 + 63 > qp0) ||
                    (window > 0 && k0 <= qp0 + BQ - 1 - window);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 8 * n + col + (e & 1);
      p[e] = exp2f(fmaf(acc[n * 4 + e], scale_log2, -lse2[r]));
      if (edge) {
        const int kp = kpos + 8 * (e >> 1), qp = qp0 + r;
        bool ok = q0 + r < Sq && kp < Skv;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        if (!ok) p[e] = 0.f;
      }
    }
    pa[n / 2][(n % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
    pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
}

// dS^T = P^T o (dP^T - Delta) from P^T as rounded to bf16 (0 where masked)
// and dP^T in acc, as bf16 A fragments and into a [key][q] dS^T tile with
// the 128-byte swizzle (16-byte chunk n of row r at chunk n ^ (r % 8); rows
// row and row + 8 share r % 8); the caller fences it for the async proxy
__device__ __forceinline__ void ds_t(uint32_t (&da)[4][4], const uint32_t (&pa)[4][4],
                                     const float (&acc)[32], const float* dlt,
                                     uint32_t tile, int row, int col) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t pp = pa[n / 2][(n % 2) * 2 + i];
      const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pp));
      const int r = 8 * n + col;
      da[n / 2][(n % 2) * 2 + i] = pack_bf16(p.x * (acc[n * 4 + 2 * i] - dlt[r]),
                                             p.y * (acc[n * 4 + 2 * i + 1] - dlt[r + 1]));
    }
    const uint32_t at = tile + row * ROW + ((n ^ (row & 7)) << 4) + 2 * col;
    asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(at), "r"(da[n / 2][(n % 2) * 2]));
    asm volatile("st.shared.b32 [%0], %1;\n"
                 :: "r"(at + 8 * ROW), "r"(da[n / 2][(n % 2) * 2 + 1]));
  }
}

// a warpgroup's 64 x 64 fp32 dQ chunk (dqa times scale) through its fp32
// chunk in shared memory (dq_s, at dq_a) into the tiled dQ buffer at dst by
// one bulk reduce-add issued by the warpgroup's first thread (leader);
// named barrier bar of its 128 threads keeps the chunk from being written
// before the last add has read it
__device__ __forceinline__ void add_dq_chunk(const float (&dqa)[32], float scale,
                                             float* dq_s, uint32_t dq_a, float* dst,
                                             int row, int col, bool leader, int bar) {
  if (leader) bulk_wait_read();
  named_barrier(bar, 128);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<float2*>(dq_s + row * 64 + 8 * n + col) =
        make_float2(dqa[n * 4] * scale, dqa[n * 4 + 1] * scale);
    *reinterpret_cast<float2*>(dq_s + (row + 8) * 64 + 8 * n + col) =
        make_float2(dqa[n * 4 + 2] * scale, dqa[n * 4 + 3] * scale);
  }
  fence_proxy_async();
  named_barrier(bar, 128);
  if (leader) bulk_reduce_add_f32(dst, dq_a, DQ_TILE);
}

// One block per (key tile, kv head, batch row), the key tiles slowest so
// that a causal run's heaviest blocks (the low key tiles see the most q
// tiles) start first; a key tile is 64 keys a warpgroup, with two
// warpgroups at D = 128 and three at D = 64 (whose registers allow a third,
// below). Warpgroup w owns keys 64 w .. 64 w + 63 of the tile
// and keeps their dK, dV in fp32 registers over the block's (G head, q
// tile) iterations. Thread 0 loads K and V once and keeps the iterations'
// Q, dO, lse and Delta tiles in flight in a 2-stage ring (TMA and bulk
// copies on "full" mbarriers): it refills a stage with iteration j + 2 as
// soon as the warpgroups' barrier of iteration j shows every thread done
// with it, so the loads run under the rest of iteration j and all of
// j + 1. Per iteration each warpgroup, on its 64 keys x 64 q rows:
//   S^T = K Q^T: wgmma, both operands K-major in shared memory;
//   P^T = exp2(S^T scale log2 e - lse log2 e) on the visible pairs, 0
//   elsewhere, on the fragments, rounded to bf16;
//   dP^T = V dO^T into the same accumulators, in one group with dV += P^T dO
//   (wgmma with A from registers, the accumulators repacked as bf16
//   fragments, and dO read MN-major through the transpose bit);
//   dS^T = P^T o (dP^T - Delta), rounded to bf16 into shared memory (for
//   dQ), then dK += dS^T Q (A from registers, Q MN-major);
//   after a barrier of the warpgroups (every dS^T in place), dQ's
//   64-column chunk c by warpgroup (c - j) mod n (n warpgroups, j the
//   iteration, so that at D = 64, one chunk, they take turns) of the q tile
//   over all the block's keys: dQ = dS K, wgmma with dS^T and K both MN-major,
//   scaled into the warpgroup's fp32 chunk in shared memory and added to
//   the (B, H, Sp / 64, D / 64, 64, 64) fp32 dQ buffer by one bulk
//   reduce-add of the 16 KB chunk.
// A warpgroup whose keys no row of the q tile sees (causality, the window,
// keys past Skv) skips its products, and dQ skips its dS^T. dS^T is double
// buffered, so one barrier an iteration keeps a warpgroup from overwriting
// a tile the other still reads. P and dS are rounded to bf16 for the
// products, as the forward rounds P, and dS is computed from the rounded P,
// so that a thread holds dK and dV (2 x D / 2 fp32), one 32-float
// accumulator tile and P's 16 fragment registers. Registers set the block's
// shape: ptxas gives a block of more than 256 threads 168 registers a
// thread, whatever setmaxnreg asks for (a producer warpgroup with 40 | 232
// or 24 | 240, or one producer warp, all spilled at D = 128 on the
// H100's nvcc), and dK, dV alone take 128 of them at D = 128; so the block
// is its consumer warpgroups alone: two at D = 128 (255 registers a
// thread), three at D = 64 (168, of which it needs ~150).
template <int D>
__global__ void __launch_bounds__(128 * Smem<D>::CONSUMERS, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap domap,
                       const float* __restrict__ rows, float* __restrict__ dq,
                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                       int Sq, int Sp, int Skv, int H, int KV, float scale,
                       int causal, int window, int q_offset) {
  using S = Smem<D>;
  constexpr int HALVES = S::HALVES, CONSUMERS = S::CONSUMERS, BK = 64 * CONSUMERS;
  extern __shared__ uint8_t smem_raw[];
  // full[s]: stage s loaded (TMA and bulk bytes); kvbar: K and V loaded
  __shared__ uint64_t full[STAGES], kvbar_mem;
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);    // the same bytes, generic

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int kvh = blockIdx.x % KV, b = blockIdx.x / KV, kt = blockIdx.y;
  const int B = gridDim.x / KV, G = H / KV;
  const int k0 = kt * BK;
  const int k_last = min(k0 + BK, Skv) - 1;

  // the q rows that see a key of this tile (as the other routes')
  int i_begin = 0, i_end = Sq;
  if (causal) i_begin = max(0, k0 - q_offset);
  if (window > 0) i_end = min(Sq, k_last + window - q_offset);
  const int qt_begin = i_begin / BQ;
  const int n_qt = i_end > i_begin ? (i_end + BQ - 1) / BQ - qt_begin : 0;
  const int n_iter = G * n_qt;

  // iteration jj's Q, dO, lse and Delta tiles into its stage (thread 0)
  auto load_stage = [&](int jj) {
    const int s = jj % STAGES;
    const int h = kvh * G + jj / n_qt, q0 = (qt_begin + jj % n_qt) * BQ;
    const uint32_t bar = smem_addr(&full[s]);
    const uint32_t st = base + S::Q_OFF + s * S::STAGE;
    const uint32_t rs = base + S::ROWS_OFF + s * S::ROWS;
    const long long at = ((long long)b * H + h) * Sp + q0;
    mbar_arrive_expect_tx(bar, S::STAGE + S::ROWS);
    for (int hf = 0; hf < HALVES; ++hf) {
      tma_load_4d(st + hf * TILE, &qmap, bar, hf * 64, h, q0, b);
      tma_load_4d(st + (HALVES + hf) * TILE, &domap, bar, hf * 64, h, q0, b);
    }
    bulk_load(rs, rows + at, BQ * 4, bar);
    bulk_load(rs + BQ * 4, rows + (long long)B * H * Sp + at, BQ * 4, bar);
  };

  const uint32_t kvbar = smem_addr(&kvbar_mem);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_addr(&full[s]), 1);
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(kvbar, 2 * CONSUMERS * S::KV_TILE);
    for (int w = 0; w < CONSUMERS; ++w)
      for (int hf = 0; hf < HALVES; ++hf) {
        const uint32_t at = w * S::KV_TILE + hf * TILE;
        tma_load_4d(base + S::K_OFF + at, &kmap, kvbar, hf * 64, kvh, k0 + 64 * w, b);
        tma_load_4d(base + S::V_OFF + at, &vmap, kvbar, hf * 64, kvh, k0 + 64 * w, b);
      }
    for (int jj = 0; jj < min(STAGES, n_iter); ++jj) load_stage(jj);
  }

  // this lane's keys: row (accumulator entries 4 n + {0, 1}) and row + 8
  // (4 n + {2, 3}) of the warpgroup's 64; columns 8 n + col + {0, 1}
  const int row = warp * 16 + lane / 4, col = 2 * (lane % 4);
  const int kw0 = k0 + 64 * wg;                // the warpgroup's first key
  const int kpos = kw0 + row;
  const int tw = tid % 128;                    // thread within the warpgroup
  const uint32_t kw = base + S::K_OFF + wg * S::KV_TILE;
  const uint32_t vw = base + S::V_OFF + wg * S::KV_TILE;
  const float scale_log2 = scale * LOG2E;
  float* const dq_s = reinterpret_cast<float*>(gbase + S::DQ_OFF + wg * DQ_TILE);
  const uint32_t dq_a = base + S::DQ_OFF + wg * DQ_TILE;

  // does any row of the q tile at q0 see a key of warpgroup t's 64?
  auto live = [&](int t, int q0) {
    const int first = k0 + 64 * t, last = min(first + 63, Skv - 1);
    const int qp0 = q0 + q_offset, qp1 = min(q0 + BQ, Sq) - 1 + q_offset;
    bool ok = first < Skv;
    if (causal) ok = ok && first <= qp1;
    if (window > 0) ok = ok && last > qp0 - window;
    return ok;
  };

  float dka[HALVES][32], dva[HALVES][32];
#pragma unroll
  for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
    for (int e = 0; e < 32; ++e) dka[hf][e] = dva[hf][e] = 0.f;

  mbar_wait(kvbar, 0);
  for (int j = 0; j < n_iter; ++j) {
    const int s = j % STAGES;
    const int h = kvh * G + j / n_qt, qt = qt_begin + j % n_qt, q0 = qt * BQ;
    const uint32_t qs = base + S::Q_OFF + s * S::STAGE, dos = qs + HALVES * TILE;
    const float* lse2 = reinterpret_cast<const float*>(gbase + S::ROWS_OFF + s * S::ROWS);
    const float* dlt = lse2 + BQ;
    const uint32_t ds_own = base + S::DS_OFF + ((j & 1) * CONSUMERS + wg) * TILE;
    mbar_wait(smem_addr(&full[s]), (j / STAGES) & 1);

    if (live(wg, q0)) {
      uint32_t pa[4][4];
      float acc[32];
      probs_t<D>(pa, acc, kw, qs, lse2, kw0, q0, kpos, col, Sq, Skv, scale_log2,
                 causal, window, q_offset);

      // dP^T = V dO^T into the same accumulators, and dV += P^T dO (16 q
      // rows a k step, 2048 bytes down a box), one group
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * TILE + (kk % 4) * 32;
        wgmma_ss(acc, wgmma_desc(vw + off, 16, 1024), wgmma_desc(dos + off, 16, 1024),
                 kk > 0);
      }
#pragma unroll
      for (int kb = 0; kb < BQ / 16; ++kb)
#pragma unroll
        for (int hf = 0; hf < HALVES; ++hf)
          wgmma_rs_mn(dva[hf], pa[kb],
                      wgmma_desc(dos + hf * TILE + kb * 16 * ROW, 1024, 1024));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int e = 0; e < 32; ++e) reg_fence(acc[e]);
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
        for (int e = 0; e < 32; ++e) reg_fence(dva[hf][e]);
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
#pragma unroll
        for (int e = 0; e < 4; ++e) reg_fence(pa[kb][e]);

      // dS^T, as A fragments and into this warpgroup's dS^T tile
      uint32_t da[4][4];
      ds_t(da, pa, acc, dlt, ds_own, row, col);
      fence_proxy_async();

      // dK += dS^T Q
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < BQ / 16; ++kb)
#pragma unroll
        for (int hf = 0; hf < HALVES; ++hf)
          wgmma_rs_mn(dka[hf], da[kb],
                      wgmma_desc(qs + hf * TILE + kb * 16 * ROW, 1024, 1024));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
        for (int e = 0; e < 32; ++e) reg_fence(dka[hf][e]);
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
#pragma unroll
        for (int e = 0; e < 4; ++e) reg_fence(da[kb][e]);
    }
    // every live dS^T is in place, and every thread is done with stage s:
    // thread 0 refills it with iteration j + STAGES
    named_barrier(1, CONSUMERS * 128);
    if (tid == 0 && j + STAGES < n_iter) load_stage(j + STAGES);

    // dQ chunk c = dS K over the block's keys (the live warpgroups' tiles)
    // (the chunks rotate over the warpgroups from one iteration to the
    // next, so that at D = 64, one chunk, each takes its turn)
    for (int c = (wg + j) % CONSUMERS; c < HALVES; c += CONSUMERS) {
      float dqa[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) dqa[e] = 0.f;
      bool any = false;
      wgmma_fence();
      for (int t = 0; t < CONSUMERS; ++t) {
        if (!live(t, q0)) continue;
        const uint32_t dst = base + S::DS_OFF + ((j & 1) * CONSUMERS + t) * TILE;
        const uint32_t kt_c = base + S::K_OFF + t * S::KV_TILE + c * TILE;
#pragma unroll
        for (int kb = 0; kb < 4; ++kb)
          wgmma_ss_mn(dqa, wgmma_desc(dst + kb * 16 * ROW, 1024, 1024),
                      wgmma_desc(kt_c + kb * 16 * ROW, 1024, 1024), any || kb > 0);
        any = true;
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int e = 0; e < 32; ++e) reg_fence(dqa[e]);
      if (!any) continue;
      add_dq_chunk(dqa, scale, dq_s, dq_a,
                   dq + ((((long long)b * H + h) * (Sp / BQ) + qt) * HALVES + c) * (BQ * 64),
                   row, col, tw == 0, 2 + wg);
    }
  }
  if (tw == 0) bulk_wait();                    // the adds are done with shared memory

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kpos + 8 * i;
    if (key >= Skv) continue;
    __nv_bfloat16* krw = dk + ((long long)(b * Skv + key) * KV + kvh) * D + col;
    __nv_bfloat16* vrw = dv + ((long long)(b * Skv + key) * KV + kvh) * D + col;
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(krw + hf * 64 + n * 8) = __floats2bfloat162_rn(
            dka[hf][n * 4 + 2 * i] * scale, dka[hf][n * 4 + 2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(vrw + hf * 64 + n * 8) = __floats2bfloat162_rn(
            dva[hf][n * 4 + 2 * i], dva[hf][n * 4 + 2 * i + 1]);
      }
  }
}

// dq (B, Sq, H, D) bf16 from the tiled fp32 buffer (B, H, Sp / 64, D / 64,
// 64, 64); one thread an output pair
__global__ void flash_bwd_cast_tiles(const float* __restrict__ acc,
                                     __nv_bfloat16* __restrict__ dq, int Sq, int Sp,
                                     int H, int D, long long n_pairs) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pairs) return;
  const long long e = 2 * p;                   // e = ((b * Sq + i) * H + h) * D + d
  const int d = e % D;
  const long long bih = e / D, h = bih % H, bi = bih / H, i = bi % Sq, b = bi / Sq;
  const float* t = acc + (((b * H + h) * (Sp / BQ) + i / BQ) * (D / 64) + d / 64) * (BQ * 64)
                   + (i % BQ) * 64 + d % 64;
  *reinterpret_cast<__nv_bfloat162*>(dq + e) = __floats2bfloat162_rn(t[0], t[1]);
}

// A wgmma route's launches: the four tensor maps (64-column boxes of BQ q
// rows or 64 keys), the zeroed tiled dQ buffer (B, H, Sp / 64, D / 64, 64,
// 64), the row pass (rows (2, B, H, Sp): lse log2 e, Delta), `kernel` on a
// grid of (KV * B, key tiles of block_keys) with `threads` threads and
// `smem` bytes of shared memory (opted into once, through opted_in), and
// dQ's cast
template <int D, int DV, typename Kernel>
int launch_tiled(Kernel kernel, int threads, int block_keys, int smem, bool& opted_in,
                 const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* dq_acc, float* rows, void* dq,
                 void* dk, void* dv, int B, int Sq, int Skv, int H, int KV, float scale,
                 int causal, int window, int q_offset, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const int Sp = (Sq + BQ - 1) / BQ * BQ;
  CUtensorMap qm, km, vm, dom;
  int rc = encode(&qm, q, D, H, Sq, B, BQ);
  if (rc == 0) rc = encode(&km, k, D, KV, Skv, B, 64);
  if (rc == 0) rc = encode(&vm, v, DV, KV, Skv, B, 64);
  if (rc == 0) rc = encode(&dom, dout, DV, H, Sq, B, BQ);
  if (rc != 0) return rc;
  cudaError_t err = cudaMemsetAsync(dq_acc, 0, sizeof(float) * B * H * Sp * D, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_rows = (long long)B * H * Sp;
  flash_bwd_delta<T><<<(unsigned)((n_rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, rows, rows + n_rows,
      Sq, Sp, H, DV, n_rows);
  rc = launch_status();
  if (rc != 0) return rc;
  if (!opted_in) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid(KV * B, (Skv + block_keys - 1) / block_keys);
  kernel<<<grid, threads, smem, stream>>>(
      qm, km, vm, dom, rows, dq_acc, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sp,
      Skv, H, KV, scale, causal, window, q_offset);
  rc = launch_status();
  if (rc != 0) return rc;
  const long long n_pairs = (long long)B * Sq * H * D / 2;
  flash_bwd_cast_tiles<<<(unsigned)((n_pairs + 255) / 256), 256, 0, stream>>>(
      dq_acc, static_cast<T*>(dq), Sq, Sp, H, D, n_pairs);
  return launch_status();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dq_acc, float* rows, void* dq,
           void* dk, void* dv, int B, int Sq, int Skv, int H, int KV, float scale,
           int causal, int window, int q_offset, cudaStream_t stream) {
  static bool opted_in = false;                // shared-memory opt-in, once
  constexpr int N = Smem<D>::CONSUMERS;
  return launch_tiled<D, D>(flash_bwd_wgmma_kernel<D>, 128 * N, 64 * N, Smem<D>::BYTES,
                            opted_in, q, k, v, o, dout, lse, dq_acc, rows, dq, dk, dv, B,
                            Sq, Skv, H, KV, scale, causal, window, q_offset, stream);
}

}  // namespace tma_route

// ---- wgmma split route: bf16, (D, Dv) in {(256, 256), (192, 128)} ----------

namespace split_route {

using namespace tensor_core;
using tma_route::add_dq_chunk;
using tma_route::BQ;
using tma_route::DQ_TILE;
using tma_route::ds_t;
using tma_route::probs_t;
using tma_route::ROW;
using tma_route::STAGES;
using tma_route::TILE;

// Shared memory, every bf16 tile 1024-aligned: K and V of the block's 64
// keys (DB and VB boxes of 64 columns), the ring's stages (Q in DB boxes,
// then dO in VB), dS^T of the last two q tiles, the dV warpgroup's one fp32
// dQ chunk and the ring's row statistics. At (256, 256): 32 + 32 KB of K
// and V, two 64 KB stages, 16 KB of dS^T, 16 KB of dQ, 1 KB of statistics
// and 1 KB of alignment, 226 KB of the 227 a block may have.
template <int D, int DV>
struct Smem {
  static constexpr int DB = D / 64, VB = DV / 64;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + DB * TILE;
  static constexpr int Q_OFF = V_OFF + VB * TILE;
  static constexpr int STAGE = (DB + VB) * TILE;         // Q and dO
  static constexpr int DS_OFF = Q_OFF + STAGES * STAGE;
  static constexpr int DQ_OFF = DS_OFF + 2 * TILE;
  static constexpr int ROWS_OFF = DQ_OFF + DQ_TILE;
  static constexpr int ROWS = 2 * BQ * 4;                // a stage's statistics
  static constexpr int BYTES = 1024 + ROWS_OFF + STAGES * ROWS;   // + alignment
  static_assert(BYTES + 64 <= 232448, "a block has 227 KB of shared memory");
};

// One block of two warpgroups per (64-key tile, kv head, batch row), the key
// tiles slowest (as the wgmma route's). At these widths one thread cannot
// hold both dK and dV of its keys (at D = Dv = 256 they alone would take
// 256 registers, and a block of two warpgroups has 255 a thread), so the
// two warpgroups take the same 64 keys and split the accumulators: per
// (G head, q tile) iteration
//   warpgroup 0 (dV): S^T = K Q^T -> P^T, dV += P^T dO; after the block's
//   barrier, dQ = dS K from warpgroup 1's dS^T, a 64-column chunk at a
//   time through one fp32 chunk in shared memory, each added to the
//   tiled (B, H, Sp / 64, D / 64, 64, 64) fp32 dQ buffer by one bulk
//   reduce-add;
//   warpgroup 1 (dK): S^T -> P^T, dP^T = V dO^T, dS^T = P^T o (dP^T -
//   Delta) rounded to bf16 into shared memory, dK += dS^T Q.
// Each warpgroup keeps one accumulator (64 x Dv or 64 x D fp32, 128
// registers at 256) and recomputes S (about a fifth more FLOPs); in
// m64n64k16 steps a q tile costs warpgroup 0 D/16 + Dv/16 + D/16 and
// warpgroup 1 D/16 + Dv/16 + D/16, so the two stay balanced between
// barriers. Thread 0 loads K and V once and keeps Q, dO, lse and Delta in
// the 2-stage TMA ring, refilling a stage after the iteration's barrier
// (both warpgroups are then done with it). dS^T is double buffered: the
// dK warpgroup writes iteration j + 2's into the buffer warpgroup 0 read
// for dQ of iteration j only after the barrier of j + 1, which warpgroup 0
// reaches once that product has completed. P and dS are rounded to bf16
// for the products, dS from the rounded P, as on the wgmma route, so both
// warpgroups' P^T are the same bits.
template <int D, int DV>
__global__ void __launch_bounds__(256, 1)
flash_bwd_split_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap domap,
                       const float* __restrict__ rows, float* __restrict__ dq,
                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                       int Sq, int Sp, int Skv, int H, int KV, float scale,
                       int causal, int window, int q_offset) {
  using S = Smem<D, DV>;
  constexpr int DB = S::DB, VB = S::VB;
  extern __shared__ uint8_t smem_raw[];
  // full[s]: stage s loaded (TMA and bulk bytes); kvbar: K and V loaded
  __shared__ uint64_t full[STAGES], kvbar_mem;
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);    // the same bytes, generic

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int kvh = blockIdx.x % KV, b = blockIdx.x / KV, kt = blockIdx.y;
  const int B = gridDim.x / KV, G = H / KV;
  const int k0 = kt * 64;
  const int k_last = min(k0 + 64, Skv) - 1;

  // the q rows that see a key of this tile (as the other routes'); every q
  // tile in the range sees one of the block's keys
  int i_begin = 0, i_end = Sq;
  if (causal) i_begin = max(0, k0 - q_offset);
  if (window > 0) i_end = min(Sq, k_last + window - q_offset);
  const int qt_begin = i_begin / BQ;
  const int n_qt = i_end > i_begin ? (i_end + BQ - 1) / BQ - qt_begin : 0;
  const int n_iter = G * n_qt;

  // iteration jj's Q, dO, lse and Delta tiles into its stage (thread 0)
  auto load_stage = [&](int jj) {
    const int s = jj % STAGES;
    const int h = kvh * G + jj / n_qt, q0 = (qt_begin + jj % n_qt) * BQ;
    const uint32_t bar = smem_addr(&full[s]);
    const uint32_t st = base + S::Q_OFF + s * S::STAGE;
    const uint32_t rs = base + S::ROWS_OFF + s * S::ROWS;
    const long long at = ((long long)b * H + h) * Sp + q0;
    mbar_arrive_expect_tx(bar, S::STAGE + S::ROWS);
    for (int hf = 0; hf < DB; ++hf) tma_load_4d(st + hf * TILE, &qmap, bar, hf * 64, h, q0, b);
    for (int hf = 0; hf < VB; ++hf)
      tma_load_4d(st + (DB + hf) * TILE, &domap, bar, hf * 64, h, q0, b);
    bulk_load(rs, rows + at, BQ * 4, bar);
    bulk_load(rs + BQ * 4, rows + (long long)B * H * Sp + at, BQ * 4, bar);
  };

  const uint32_t kvbar = smem_addr(&kvbar_mem);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_addr(&full[s]), 1);
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(kvbar, (DB + VB) * TILE);
    for (int hf = 0; hf < DB; ++hf)
      tma_load_4d(base + S::K_OFF + hf * TILE, &kmap, kvbar, hf * 64, kvh, k0, b);
    for (int hf = 0; hf < VB; ++hf)
      tma_load_4d(base + S::V_OFF + hf * TILE, &vmap, kvbar, hf * 64, kvh, k0, b);
    for (int jj = 0; jj < min(STAGES, n_iter); ++jj) load_stage(jj);
  }

  // this lane's keys: row (accumulator entries 4 n + {0, 1}) and row + 8
  // (4 n + {2, 3}) of the block's 64; columns 8 n + col + {0, 1}
  const int row = warp * 16 + lane / 4, col = 2 * (lane % 4);
  const int kpos = k0 + row;
  const uint32_t ks = base + S::K_OFF, vs = base + S::V_OFF;
  const float scale_log2 = scale * LOG2E;
  mbar_wait(kvbar, 0);

  if (wg == 0) {
    // ---- dV, then dQ ----
    float* const dq_s = reinterpret_cast<float*>(gbase + S::DQ_OFF);
    const uint32_t dq_a = base + S::DQ_OFF;
    float dva[VB][32];
#pragma unroll
    for (int hf = 0; hf < VB; ++hf)
#pragma unroll
      for (int e = 0; e < 32; ++e) dva[hf][e] = 0.f;
    for (int j = 0; j < n_iter; ++j) {
      const int s = j % STAGES;
      const int h = kvh * G + j / n_qt, qt = qt_begin + j % n_qt, q0 = qt * BQ;
      const uint32_t qs = base + S::Q_OFF + s * S::STAGE, dos = qs + DB * TILE;
      const float* lse2 =
          reinterpret_cast<const float*>(gbase + S::ROWS_OFF + s * S::ROWS);
      mbar_wait(smem_addr(&full[s]), (j / STAGES) & 1);
      uint32_t pa[4][4];
      float acc[32];
      probs_t<D>(pa, acc, ks, qs, lse2, k0, q0, kpos, col, Sq, Skv, scale_log2, causal,
                 window, q_offset);
      // dV += P^T dO (16 q rows a k step, 2048 bytes down a box)
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < BQ / 16; ++kb)
#pragma unroll
        for (int hf = 0; hf < VB; ++hf)
          wgmma_rs_mn(dva[hf], pa[kb],
                      wgmma_desc(dos + hf * TILE + kb * 16 * ROW, 1024, 1024));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int hf = 0; hf < VB; ++hf)
#pragma unroll
        for (int e = 0; e < 32; ++e) reg_fence(dva[hf][e]);
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
#pragma unroll
        for (int e = 0; e < 4; ++e) reg_fence(pa[kb][e]);
      // warpgroup 1's dS^T of iteration j is in place, and both are done
      // with stage s: thread 0 refills it with iteration j + STAGES
      named_barrier(1, 256);
      if (tid == 0 && j + STAGES < n_iter) load_stage(j + STAGES);

      // dQ chunk c = dS K[:, 64 c : 64 c + 64], dS^T and K both MN-major
      const uint32_t dst = base + S::DS_OFF + (j & 1) * TILE;
      for (int c = 0; c < DB; ++c) {
        float dqa[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) dqa[e] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < 4; ++kb)
          wgmma_ss_mn(dqa, wgmma_desc(dst + kb * 16 * ROW, 1024, 1024),
                      wgmma_desc(ks + c * TILE + kb * 16 * ROW, 1024, 1024), kb > 0);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int e = 0; e < 32; ++e) reg_fence(dqa[e]);
        add_dq_chunk(dqa, scale, dq_s, dq_a,
                     dq + ((((long long)b * H + h) * (Sp / BQ) + qt) * DB + c) * (BQ * 64),
                     row, col, tid == 0, 2);
      }
    }
    if (tid == 0) bulk_wait();                   // the adds are done with shared memory
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = kpos + 8 * i;
      if (key >= Skv) continue;
      __nv_bfloat16* vrw = dv + ((long long)(b * Skv + key) * KV + kvh) * DV + col;
#pragma unroll
      for (int hf = 0; hf < VB; ++hf)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(vrw + hf * 64 + n * 8) =
              __floats2bfloat162_rn(dva[hf][n * 4 + 2 * i], dva[hf][n * 4 + 2 * i + 1]);
    }
  } else {
    // ---- dS^T and dK ----
    float dka[DB][32];
#pragma unroll
    for (int hf = 0; hf < DB; ++hf)
#pragma unroll
      for (int e = 0; e < 32; ++e) dka[hf][e] = 0.f;
    for (int j = 0; j < n_iter; ++j) {
      const int s = j % STAGES;
      const int q0 = (qt_begin + j % n_qt) * BQ;
      const uint32_t qs = base + S::Q_OFF + s * S::STAGE, dos = qs + DB * TILE;
      const float* lse2 =
          reinterpret_cast<const float*>(gbase + S::ROWS_OFF + s * S::ROWS);
      const float* dlt = lse2 + BQ;
      const uint32_t ds_own = base + S::DS_OFF + (j & 1) * TILE;
      mbar_wait(smem_addr(&full[s]), (j / STAGES) & 1);
      uint32_t pa[4][4];
      float acc[32];
      probs_t<D>(pa, acc, ks, qs, lse2, k0, q0, kpos, col, Sq, Skv, scale_log2, causal,
                 window, q_offset);
      // dP^T = V dO^T into the same accumulators
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        const uint32_t off = (kk / 4) * TILE + (kk % 4) * 32;
        wgmma_ss(acc, wgmma_desc(vs + off, 16, 1024), wgmma_desc(dos + off, 16, 1024),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int e = 0; e < 32; ++e) reg_fence(acc[e]);
      // dS^T, as A fragments and into this iteration's dS^T tile
      uint32_t da[4][4];
      ds_t(da, pa, acc, dlt, ds_own, row, col);
      fence_proxy_async();
      // dK += dS^T Q
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < BQ / 16; ++kb)
#pragma unroll
        for (int hf = 0; hf < DB; ++hf)
          wgmma_rs_mn(dka[hf], da[kb],
                      wgmma_desc(qs + hf * TILE + kb * 16 * ROW, 1024, 1024));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int hf = 0; hf < DB; ++hf)
#pragma unroll
        for (int e = 0; e < 32; ++e) reg_fence(dka[hf][e]);
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
#pragma unroll
        for (int e = 0; e < 4; ++e) reg_fence(da[kb][e]);
      named_barrier(1, 256);                     // dS^T in place, stage s spent
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = kpos + 8 * i;
      if (key >= Skv) continue;
      __nv_bfloat16* krw = dk + ((long long)(b * Skv + key) * KV + kvh) * D + col;
#pragma unroll
      for (int hf = 0; hf < DB; ++hf)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(krw + hf * 64 + n * 8) = __floats2bfloat162_rn(
              dka[hf][n * 4 + 2 * i] * scale, dka[hf][n * 4 + 2 * i + 1] * scale);
    }
  }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dq_acc, float* rows, void* dq,
           void* dk, void* dv, int B, int Sq, int Skv, int H, int KV, float scale,
           int causal, int window, int q_offset, cudaStream_t stream) {
  static bool opted_in = false;                // shared-memory opt-in, once
  return tma_route::launch_tiled<D, DV>(
      flash_bwd_split_kernel<D, DV>, 256, 64, Smem<D, DV>::BYTES, opted_in, q, k, v, o,
      dout, lse, dq_acc, rows, dq, dk, dv, B, Sq, Skv, H, KV, scale, causal, window,
      q_offset, stream);
}

}  // namespace split_route

// ---- wgmma kv128 route: bf16, (D, Dv) = (192, 128) ---------------------------

namespace kv128_route {

using namespace tensor_core;
using tma_route::BQ;
using tma_route::ROW;
using tma_route::STAGES;
using tma_route::TILE;

constexpr int D = 192, DV = 128;
constexpr int DB = D / 64, VB = DV / 64;   // 64-column boxes of K and Q, of V and dO
constexpr int CW = D / 2;                  // dQ columns a warpgroup
constexpr int DQ_CHUNK = BQ * CW * 4;      // a warpgroup's [64 q][96] fp32 dQ chunk
// the dQ rows (fp32) the blocks in flight together add into, at most: the
// L2 keeps them, where a block order with the key tiles slowest over every
// slice sends each bulk reduce-add to device memory (the whole buffer,
// 403 MB at MLA's training shape, is 8x the L2)
constexpr int DQ_L2_BYTES = 8 << 20;

// Shared memory, every bf16 tile 1024-aligned: K and V of the block's 128
// keys (a warpgroup's 64 keys as DB and VB boxes), the ring's stages (Q in
// DB boxes, then dO in VB), a [64 keys][64 q] bf16 tile a warpgroup (P^T,
// then dS^T of the current q tile; single-buffered: a barrier keeps the
// next iteration's from overwriting them before every dQ product has read
// them), one fp32 dQ
// chunk a warpgroup, and the ring's row statistics: 48 + 32 KB of K and V,
// two 40 KB stages, 16 KB of dS^T, 48 KB of dQ, 1 KB of statistics and
// 1 KB of alignment, 226 KB of the 227 a block may have.
struct Smem {
  static constexpr int K_W = DB * TILE, V_W = VB * TILE;  // a warpgroup's K, V
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + 2 * K_W;
  static constexpr int Q_OFF = V_OFF + 2 * V_W;
  static constexpr int STAGE = (DB + VB) * TILE;          // Q and dO
  static constexpr int DS_OFF = Q_OFF + STAGES * STAGE;
  static constexpr int DQ_OFF = DS_OFF + 2 * TILE;
  static constexpr int ROWS_OFF = DQ_OFF + 2 * DQ_CHUNK;
  static constexpr int ROWS = 2 * BQ * 4;                 // a stage's statistics
  static constexpr int BYTES = 1024 + ROWS_OFF + STAGES * ROWS;   // + alignment
  static_assert(BYTES + 64 <= 232448, "a block has 227 KB of shared memory");
};

// A (64 keys x W) x B (64 q rows x W)^T into acc, both K-major 64-column
// boxes at a and b (as tma_route::issue_kt), its first k step writing acc
// without reading it: S^T = K Q^T at W = D, dP^T = V dO^T at W = Dv
template <int W>
__device__ __forceinline__ void issue_kt_fresh(float (&acc)[32], uint32_t a, uint32_t b) {
  wgmma_ss_first(acc, wgmma_desc(a, 16, 1024), wgmma_desc(b, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < W / 16; ++kk) {
    const uint32_t off = (kk / 4) * TILE + (kk % 4) * 32;
    wgmma_ss(acc, wgmma_desc(a + off, 16, 1024), wgmma_desc(b + off, 16, 1024), 1);
  }
}

// Shared memory through 32-bit addresses: the kernel reads the rows'
// statistics and stages dQ with these rather than through generic
// pointers, whose 64-bit addresses (one for each of the iteration's 24
// staged pairs and 32 statistics) the compiler kept in registers across
// the loop
__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr));
  return x;
}
__device__ __forceinline__ void sts_f32x2(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" :: "r"(addr), "f"(x), "f"(y));
}

// P^T = exp2(S^T scale log2 e - lse log2 e) from S^T in acc, 0 on the
// masked pairs, as tma_route::probs_from_s computes it (lse log2 e of q row
// r at lse2 + 4 r in shared memory), rounded to bf16 into a [key][q] tile
// with the 128-byte swizzle (16-byte chunk n of row r at chunk n ^ (r % 8);
// rows row and row + 8 share r % 8)
__device__ __forceinline__ void p_t_store(const float (&acc)[32], uint32_t lse2, int k0,
                                          int q0, int kpos, int col, int Sq, int Skv,
                                          float scale_log2, int causal, int window,
                                          int q_offset, uint32_t tile, int row) {
  const int qp0 = q0 + q_offset;
  const bool edge = q0 + BQ > Sq || k0 + 64 > Skv || (causal && k0 + 63 > qp0) ||
                    (window > 0 && k0 <= qp0 + BQ - 1 - window);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 8 * n + col + (e & 1);
      p[e] = exp2f(fmaf(acc[n * 4 + e], scale_log2, -lds_f32(lse2 + 4 * r)));
      if (edge) {
        const int kp = kpos + 8 * (e >> 1), qp = qp0 + r;
        bool ok = q0 + r < Sq && kp < Skv;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        if (!ok) p[e] = 0.f;
      }
    }
    const uint32_t at = tile + row * ROW + ((n ^ (row & 7)) << 4) + 2 * col;
    asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(at), "r"(pack_bf16(p[0], p[1])));
    asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(at + 8 * ROW), "r"(pack_bf16(p[2], p[3])));
  }
}

// dS^T = P^T o (dP^T - Delta) as tma_route::ds_t computes it, from P^T as
// p_t_store left it in the tile (each thread reads back what it wrote),
// dP^T in acc and Delta of q row r at dlt + 4 r, rounded to bf16 over P^T
// in the tile
__device__ __forceinline__ void ds_t_in_place(const float (&acc)[32], uint32_t dlt,
                                              uint32_t tile, int row, int col) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const uint32_t at = tile + row * ROW + ((n ^ (row & 7)) << 4) + 2 * col;
    const int r = 8 * n + col;
    const float d0 = lds_f32(dlt + 4 * r), d1 = lds_f32(dlt + 4 * r + 4);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t pp;
      asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(pp) : "r"(at + i * 8 * ROW));
      const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pp));
      const uint32_t d = pack_bf16(p.x * (acc[n * 4 + 2 * i] - d0),
                                   p.y * (acc[n * 4 + 2 * i + 1] - d1));
      asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(at + i * 8 * ROW), "r"(d));
    }
  }
}

// Column c of row r of a warpgroup's dQ chunk sits at (c + 8 (r % 8)) % 96
// of the row: the eight rows a warp's lanes stage at once then fall on
// distinct banks
__device__ __forceinline__ int dq_slot(int r, int c) { return (c + 8 * (r & 7)) % CW; }

// One block of two warpgroups per (128-key tile, kv head, batch row), the
// key tiles slowest within a group of slices (above). At (192, 128) a thread
// can hold both dK (64 x 192 fp32 over a warpgroup: 96 registers) and dV
// (64) of its keys, so, as on the wgmma route, warpgroup w owns keys
// 64 w .. 64 w + 63 of the tile and S^T is computed once. Per (G head, q
// tile) iteration each warpgroup, on its 64 keys x 64 q rows:
//   S^T = K Q^T, then P^T from it, rounded to bf16 into the warpgroup's
//   tile in shared memory;
//   dP^T = V dO^T into the same accumulators and dV += P^T dO (P^T from
//   the tile), one group;
//   dS^T = P^T o (dP^T - Delta) rounded to bf16 over P^T in the tile;
//   dK += dS^T Q issued from shared memory (dS^T K-major, Q MN-major) and
//   left running;
//   after a barrier of both warpgroups (both dS^T tiles in place), dQ for
//   the q tile's 64 rows over the block's 128 keys, split by columns:
//   warpgroup 0 columns 0-95 (m64n64 on K's first box, then m64n32 on the
//   first half of its second), warpgroup 1 columns 96-191 (m64n64 on the
//   third box, then m64n32 on the second half of the second), dS^T and K
//   both MN-major, each product scaled into the warpgroup's 64 x 96 fp32
//   chunk in shared memory once it is done;
//   a second barrier (stage s and both dS^T tiles free: thread 0 refills
//   the stage with iteration j + 2), then the chunk into the (B, H, Sp /
//   64, 2, 64, 96) fp32 dQ buffer by one bulk reduce-add, which runs under
//   the next iteration's products (the chunk is written again one
//   iteration later, after a wait for the add to have read it).
// Registers set the order: dK and dV take 160 a thread. With S^T and
// dP^T in flight together (two accumulator tiles) ptxas took the kernel to
// 255 registers, 148 bytes of spill and serialized its wgmma; with one
// tile and P^T and dS^T as A fragments in registers (as on the wgmma
// route) it still spilled 404 bytes and serialized them for want of
// registers. So P^T and dS^T pass through the warpgroup's tile in shared
// memory (P^T first, dS^T written over it once dV has read it) and dV and
// dK read them from there: a thread holds dK, dV and one accumulator tile.
// A persistent grid (a block an SM walking the items round-robin, loading
// the next item's K, V and first stages under the current one's last
// iterations) ran slower on the H100 at MLA's training shape (2.356 ms
// against 2.204 in another call): a static walk balances the causal
// items' 2 to 16 iterations worse than the block scheduler does.
// The order of every fp32 sum in a block is fixed; only dQ's adds across
// key tiles land in no fixed order. A warpgroup whose keys no row of the q
// tile sees skips its products, and dQ skips its dS^T tile. P and dS are
// rounded to bf16 for the products, dS from the rounded P, as on the
// other wgmma routes.
__global__ void __launch_bounds__(256, 1)
flash_bwd_kv128_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap domap,
                       const float* __restrict__ rows, float* __restrict__ dq,
                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                       int Sq, int Sp, int Skv, int H, int KV, float scale,
                       int causal, int window, int q_offset) {
  using S = Smem;
  extern __shared__ uint8_t smem_raw[];
  // full[s]: stage s loaded (TMA and bulk bytes); kvbar: K and V loaded
  __shared__ uint64_t full[STAGES], kvbar_mem;
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int B = gridDim.x / KV, G = H / KV;
  // the block's (key tile, kv head, batch row): slices (kv head, batch
  // row) in groups whose dQ rows fit DQ_L2_BYTES, the key tiles slowest
  // within a group (a causal run's heaviest first), so that the blocks in
  // flight together add into few slices' dQ, which then stays in the L2
  const int n_sl = gridDim.x, n_kt = gridDim.y;
  const int group = max(1, min(n_sl, DQ_L2_BYTES / (G * Sp * D * 4)));
  const int lin = blockIdx.x + blockIdx.y * n_sl;
  const int g0 = lin / (group * n_kt) * group, gs = min(group, n_sl - g0);
  const int kt = (lin - g0 * n_kt) / gs, sl = g0 + (lin - g0 * n_kt) % gs;
  const int kvh = sl % KV, b = sl / KV;
  const int k0 = kt * 128;
  const int k_last = min(k0 + 128, Skv) - 1;

  // the q rows that see a key of this tile (as the other routes'); every q
  // tile in the range sees one of the block's keys
  int i_begin = 0, i_end = Sq;
  if (causal) i_begin = max(0, k0 - q_offset);
  if (window > 0) i_end = min(Sq, k_last + window - q_offset);
  const int qt_begin = i_begin / BQ;
  const int n_qt = i_end > i_begin ? (i_end + BQ - 1) / BQ - qt_begin : 0;
  const int n_iter = G * n_qt;

  // iteration jj's Q, dO, lse and Delta tiles into its stage (thread 0)
  auto load_stage = [&](int jj) {
    const int s = jj % STAGES;
    const int h = kvh * G + jj / n_qt, q0 = (qt_begin + jj % n_qt) * BQ;
    const uint32_t bar = smem_addr(&full[s]);
    const uint32_t st = base + S::Q_OFF + s * S::STAGE;
    const uint32_t rs = base + S::ROWS_OFF + s * S::ROWS;
    const long long at = ((long long)b * H + h) * Sp + q0;
    mbar_arrive_expect_tx(bar, S::STAGE + S::ROWS);
    for (int hf = 0; hf < DB; ++hf) tma_load_4d(st + hf * TILE, &qmap, bar, hf * 64, h, q0, b);
    for (int hf = 0; hf < VB; ++hf)
      tma_load_4d(st + (DB + hf) * TILE, &domap, bar, hf * 64, h, q0, b);
    bulk_load(rs, rows + at, BQ * 4, bar);
    bulk_load(rs + BQ * 4, rows + (long long)B * H * Sp + at, BQ * 4, bar);
  };

  const uint32_t kvbar = smem_addr(&kvbar_mem);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_addr(&full[s]), 1);
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(kvbar, 2 * (DB + VB) * TILE);
    for (int w = 0; w < 2; ++w) {
      for (int hf = 0; hf < DB; ++hf)
        tma_load_4d(base + S::K_OFF + w * S::K_W + hf * TILE, &kmap, kvbar, hf * 64, kvh,
                    k0 + 64 * w, b);
      for (int hf = 0; hf < VB; ++hf)
        tma_load_4d(base + S::V_OFF + w * S::V_W + hf * TILE, &vmap, kvbar, hf * 64, kvh,
                    k0 + 64 * w, b);
    }
    for (int jj = 0; jj < min(STAGES, n_iter); ++jj) load_stage(jj);
  }

  // this lane's keys: row (accumulator entries 4 n + {0, 1}) and row + 8
  // (4 n + {2, 3}) of the warpgroup's 64; columns 8 n + col + {0, 1}
  const int row = warp * 16 + lane / 4, col = 2 * (lane % 4);
  const int kw0 = k0 + 64 * wg;                // the warpgroup's first key
  const int kpos = kw0 + row;
  const int tw = tid % 128;                    // thread within the warpgroup
  const float scale_log2 = scale * LOG2E;
  // the warpgroup's dQ columns: an n64 and an n32 product, at these columns
  // of its chunk
  const int c64 = wg == 0 ? 0 : 32, c32 = wg == 0 ? 64 : 0;

  // does any row of the q tile at q0 see a key of warpgroup t's 64?
  auto live = [&](int t, int q0) {
    const int first = k0 + 64 * t, last = min(first + 63, Skv - 1);
    const int qp0 = q0 + q_offset, qp1 = min(q0 + BQ, Sq) - 1 + q_offset;
    bool ok = first < Skv;
    if (causal) ok = ok && first <= qp1;
    if (window > 0) ok = ok && last > qp0 - window;
    return ok;
  };

  float dka[DB][32], dva[VB][32];
#pragma unroll
  for (int hf = 0; hf < DB; ++hf)
#pragma unroll
    for (int e = 0; e < 32; ++e) dka[hf][e] = 0.f;
#pragma unroll
  for (int hf = 0; hf < VB; ++hf)
#pragma unroll
    for (int e = 0; e < 32; ++e) dva[hf][e] = 0.f;

  mbar_wait(kvbar, 0);
  for (int j = 0; j < n_iter; ++j) {
    // the iteration's shared-memory addresses from an opaque copy of base,
    // so that the compiler builds the wgmma descriptors where they are
    // used instead of hoisting the loop-invariant ones (some 40 of them, 2
    // registers each) out of the loop, which took it past 255 registers
    uint32_t bj = base;
    asm volatile("" : "+r"(bj));
    const uint32_t kw = bj + S::K_OFF + wg * S::K_W;
    const uint32_t vw = bj + S::V_OFF + wg * S::V_W;
    const uint32_t ds_own = bj + S::DS_OFF + wg * TILE;
    const uint32_t dq_a = bj + S::DQ_OFF + wg * DQ_CHUNK;
    // the warpgroup's n64 and n32 dQ products at these byte offsets into a
    // warpgroup's K
    const uint32_t k64 = wg == 0 ? 0 : 2 * TILE, k32 = wg == 0 ? TILE : TILE + 64;
    const int s = j % STAGES;
    const int h = kvh * G + j / n_qt, qt = qt_begin + j % n_qt, q0 = qt * BQ;
    const uint32_t qs = bj + S::Q_OFF + s * S::STAGE, dos = qs + DB * TILE;
    const uint32_t lse2 = bj + S::ROWS_OFF + s * S::ROWS, dlt = lse2 + BQ * 4;
    mbar_wait(smem_addr(&full[s]), (j / STAGES) & 1);

    const bool mine = live(wg, q0);
    if (mine) {
      // S^T = K Q^T (its first k step writes acc without reading it: no
      // accumulator is written by other instructions while a product is in
      // flight, and acc is live only from here)
      float acc[32];
      wgmma_fence();
      issue_kt_fresh<D>(acc, kw, qs);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int e = 0; e < 32; ++e) reg_fence(acc[e]);
      // P^T, rounded to bf16, into the warpgroup's tile (which holds its
      // dS^T later in the iteration), for dV to read as a K-major A
      p_t_store(acc, lse2, kw0, q0, kpos, col, Sq, Skv, scale_log2, causal, window,
                q_offset, ds_own, row);
      fence_proxy_async();
      named_barrier(2 + wg, 128);              // the warpgroup's P^T in place
      // dP^T = V dO^T into the same accumulators, and dV += P^T dO (P^T
      // K-major from the tile, dO MN-major: 16 q rows a k step), one group
      wgmma_fence();
      issue_kt_fresh<DV>(acc, vw, dos);
#pragma unroll
      for (int kb = 0; kb < BQ / 16; ++kb)
#pragma unroll
        for (int hf = 0; hf < VB; ++hf)
          wgmma_ss_kmn(dva[hf], wgmma_desc(ds_own + kb * 32, 16, 1024),
                       wgmma_desc(dos + hf * TILE + kb * 16 * ROW, 1024, 1024));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int e = 0; e < 32; ++e) reg_fence(acc[e]);
#pragma unroll
      for (int hf = 0; hf < VB; ++hf)
#pragma unroll
        for (int e = 0; e < 32; ++e) reg_fence(dva[hf][e]);
      // dS^T over P^T in the tile, each thread on the entries it wrote
      ds_t_in_place(acc, dlt, ds_own, row, col);
      fence_proxy_async();
      named_barrier(2 + wg, 128);              // the warpgroup's dS^T in place
      // dK += dS^T Q, dS^T K-major from the tile and Q MN-major, left
      // running under the block's barrier and dQ's products
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < BQ / 16; ++kb)
#pragma unroll
        for (int hf = 0; hf < DB; ++hf)
          wgmma_ss_kmn(dka[hf], wgmma_desc(ds_own + kb * 32, 16, 1024),
                       wgmma_desc(qs + hf * TILE + kb * 16 * ROW, 1024, 1024));
      wgmma_commit();
    }
    named_barrier(1, 256);                     // both warpgroups' dS^T in place

    // dQ, this warpgroup's 96 columns over the live warpgroups' keys, in
    // two products (the n64 columns, then the n32 ones: one accumulator
    // tile at a time), each scaled into the warpgroup's fp32 chunk in
    // shared memory once its product is done; the chunk is free once the
    // last iteration's add has read it
    // (t0 the first live warpgroup: any row that sees a block key sees one
    // of warpgroup 0's unless causality or Skv leaves it warpgroup 1's only)
    const bool any = live(0, q0) || live(1, q0);
    if (any) {
      const int t0 = live(0, q0) ? 0 : 1;
      const bool both = t0 == 0 && live(1, q0);
      const uint32_t ds0 = bj + S::DS_OFF + t0 * TILE, k_0 = bj + S::K_OFF + t0 * S::K_W;
      const uint32_t ds1 = bj + S::DS_OFF + TILE, k_1 = bj + S::K_OFF + S::K_W;
      if (tw == 0) bulk_wait_read();
      named_barrier(2 + wg, 128);
      {
        float dq64[32];
        wgmma_fence();
        wgmma_ss_mn_first(dq64, wgmma_desc(ds0, 1024, 1024), wgmma_desc(k_0 + k64, 1024, 1024));
#pragma unroll
        for (int kb = 1; kb < 4; ++kb)
          wgmma_ss_mn(dq64, wgmma_desc(ds0 + kb * 16 * ROW, 1024, 1024),
                      wgmma_desc(k_0 + k64 + kb * 16 * ROW, 1024, 1024), 1);
        if (both) {
#pragma unroll
          for (int kb = 0; kb < 4; ++kb)
            wgmma_ss_mn(dq64, wgmma_desc(ds1 + kb * 16 * ROW, 1024, 1024),
                        wgmma_desc(k_1 + k64 + kb * 16 * ROW, 1024, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait_all();                      // dK and these columns done
#pragma unroll
        for (int e = 0; e < 32; ++e) reg_fence(dq64[e]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = row + 8 * i;
#pragma unroll
          for (int n = 0; n < 8; ++n)
            sts_f32x2(dq_a + 4 * (r * CW + dq_slot(r, c64 + 8 * n + col)),
                      dq64[n * 4 + 2 * i] * scale, dq64[n * 4 + 2 * i + 1] * scale);
        }
      }
      {
        float dq32[16];
        wgmma_fence();
        wgmma_ss_mn_n32<true>(dq32, wgmma_desc(ds0, 1024, 1024),
                              wgmma_desc(k_0 + k32, 1024, 1024));
#pragma unroll
        for (int kb = 1; kb < 4; ++kb)
          wgmma_ss_mn_n32(dq32, wgmma_desc(ds0 + kb * 16 * ROW, 1024, 1024),
                          wgmma_desc(k_0 + k32 + kb * 16 * ROW, 1024, 1024));
        if (both) {
#pragma unroll
          for (int kb = 0; kb < 4; ++kb)
            wgmma_ss_mn_n32(dq32, wgmma_desc(ds1 + kb * 16 * ROW, 1024, 1024),
                            wgmma_desc(k_1 + k32 + kb * 16 * ROW, 1024, 1024));
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int e = 0; e < 16; ++e) reg_fence(dq32[e]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = row + 8 * i;
#pragma unroll
          for (int n = 0; n < 4; ++n)
            sts_f32x2(dq_a + 4 * (r * CW + dq_slot(r, c32 + 8 * n + col)),
                      dq32[n * 4 + 2 * i] * scale, dq32[n * 4 + 2 * i + 1] * scale);
        }
      }
      fence_proxy_async();
    }
    if (mine) {
#pragma unroll
      for (int hf = 0; hf < DB; ++hf)
#pragma unroll
        for (int e = 0; e < 32; ++e) reg_fence(dka[hf][e]);
    }
    // every product of iteration j is done and both warpgroups' chunks are
    // staged: stage s and both dS^T tiles are free (thread 0 refills the
    // stage with iteration j + STAGES), and each warpgroup's first thread
    // adds its chunk into the dQ buffer, to run under the next iteration
    named_barrier(1, 256);
    if (tid == 0 && j + STAGES < n_iter) load_stage(j + STAGES);
    if (any && tw == 0)
      bulk_reduce_add_f32(dq + ((((long long)b * H + h) * (Sp / BQ) + qt) * 2 + wg) * (BQ * CW),
                          dq_a, DQ_CHUNK);
  }
  if (tw == 0) bulk_wait();                    // the adds are done with shared memory

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kpos + 8 * i;
    if (key >= Skv) continue;
    __nv_bfloat16* krw = dk + ((long long)(b * Skv + key) * KV + kvh) * D + col;
    __nv_bfloat16* vrw = dv + ((long long)(b * Skv + key) * KV + kvh) * DV + col;
#pragma unroll
    for (int hf = 0; hf < DB; ++hf)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(krw + hf * 64 + n * 8) = __floats2bfloat162_rn(
            dka[hf][n * 4 + 2 * i] * scale, dka[hf][n * 4 + 2 * i + 1] * scale);
#pragma unroll
    for (int hf = 0; hf < VB; ++hf)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(vrw + hf * 64 + n * 8) =
            __floats2bfloat162_rn(dva[hf][n * 4 + 2 * i], dva[hf][n * 4 + 2 * i + 1]);
  }
}

// dq (B, Sq, H, 192) bf16 from the kernel's fp32 buffer (B, H, Sp / 64, 2,
// 64, 96), each chunk's rows rotated as dq_slot says; one thread eight
// adjacent columns (two 16-byte reads: eight columns never straddle a
// chunk or a rotation's wrap), one 16-byte write
__global__ void flash_bwd_cast_kv128(const float* __restrict__ acc,
                                     __nv_bfloat16* __restrict__ dq, int Sq, int Sp,
                                     int H, long long n_groups) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_groups) return;
  const long long e = 8 * g;                   // e = ((b * Sq + i) * H + h) * D + d
  const int d = e % D;
  const long long bih = e / D, h = bih % H, bi = bih / H, i = bi % Sq, b = bi / Sq;
  const int r = i % BQ;
  const float* t = acc + ((((b * H + h) * (Sp / BQ) + i / BQ) * 2 + d / CW) * BQ + r) * CW
                   + dq_slot(r, d % CW);
  const float4 x = *reinterpret_cast<const float4*>(t);
  const float4 y = *reinterpret_cast<const float4*>(t + 4);
  uint4 out;
  out.x = pack_bf16(x.x, x.y);
  out.y = pack_bf16(x.z, x.w);
  out.z = pack_bf16(y.x, y.y);
  out.w = pack_bf16(y.z, y.w);
  *reinterpret_cast<uint4*>(dq + e) = out;
}

// The route's launches, as tma_route::launch_tiled's but with this
// route's dQ layout and cast: the four tensor maps, the zeroed dQ buffer,
// the shared row pass, the kernel on (KV * B, 128-key tiles) blocks, and
// dQ's cast
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* dq_acc, float* rows, void* dq, void* dk, void* dv,
           int B, int Sq, int Skv, int H, int KV, float scale, int causal, int window,
           int q_offset, cudaStream_t stream) {
  using T = __nv_bfloat16;
  static bool opted_in = false;                // shared-memory opt-in, once
  const int Sp = (Sq + BQ - 1) / BQ * BQ;
  CUtensorMap qm, km, vm, dom;
  int rc = encode(&qm, q, D, H, Sq, B, BQ);
  if (rc == 0) rc = encode(&km, k, D, KV, Skv, B, 64);
  if (rc == 0) rc = encode(&vm, v, DV, KV, Skv, B, 64);
  if (rc == 0) rc = encode(&dom, dout, DV, H, Sq, B, BQ);
  if (rc != 0) return rc;
  cudaError_t err = cudaMemsetAsync(dq_acc, 0, sizeof(float) * B * H * Sp * D, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_rows = (long long)B * H * Sp;
  flash_bwd_delta<T><<<(unsigned)((n_rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, rows, rows + n_rows,
      Sq, Sp, H, DV, n_rows);
  rc = launch_status();
  if (rc != 0) return rc;
  if (!opted_in) {
    err = cudaFuncSetAttribute(flash_bwd_kv128_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid(KV * B, (Skv + 127) / 128);
  flash_bwd_kv128_kernel<<<grid, 256, Smem::BYTES, stream>>>(
      qm, km, vm, dom, rows, dq_acc, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sp, Skv,
      H, KV, scale, causal, window, q_offset);
  rc = launch_status();
  if (rc != 0) return rc;
  const long long n_groups = (long long)B * Sq * H * D / 8;
  flash_bwd_cast_kv128<<<(unsigned)((n_groups + 255) / 256), 256, 0, stream>>>(
      dq_acc, static_cast<T*>(dq), Sq, Sp, H, n_groups);
  return launch_status();
}

}  // namespace kv128_route
}  // namespace

// dtype 0: fp32, 1: bf16. H % KV == 0, 0 < D, Dv <= 128, B * Sq > 0, Skv > 0;
// window <= 0 means no window. lse (B, H, Sq) fp32 from the forward; dq_acc
// (B, Sq, H, D) and delta (B, H, Sq) fp32 workspaces; dq may be dq_acc itself
// (fp32: no cast launch). Returns a cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const void* lse,
                                   void* dq_acc, void* delta, void* dq, void* dk,
                                   void* dv, int dtype, int B, int Sq, int Skv, int H,
                                   int KV, int D, int Dv, float scale, int causal,
                                   int window, int q_offset, void* stream) {
  if (D <= 0 || D > MAX_W || Dv <= 0 || Dv > MAX_W || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* acc = static_cast<float*>(dq_acc);
  float* dl = static_cast<float*>(delta);
  if (dtype == 1)
    return by_width<__nv_bfloat16>(q, k, v, o, dout, l, acc, dl, dq, dk, dv, B, Sq, Skv,
                                   H, KV, D, Dv, scale, causal, window, q_offset, s);
  return by_width<float>(q, k, v, o, dout, l, acc, dl, dq, dk, dv, B, Sq, Skv, H, KV, D,
                         Dv, scale, causal, window, q_offset, s);
}

// bf16 only: D and Dv multiples of 16, up to 128; 16-byte aligned contiguous
// q, k, v, o, dout, dk, dv; otherwise as flash_attention_bwd (dq is the bf16
// output, dq_acc its fp32 buffer). Returns a cudaError_t.
extern "C" int flash_attention_bwd_mma(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       void* dq_acc, void* delta, void* dq, void* dk,
                                       void* dv, int B, int Sq, int Skv, int H, int KV,
                                       int D, int Dv, float scale, int causal,
                                       int window, int q_offset, void* stream) {
  if (D <= 0 || D > MAX_W || Dv <= 0 || Dv > MAX_W || D % 16 || Dv % 16 || KV <= 0 ||
      H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* acc = static_cast<float*>(dq_acc);
  float* dl = static_cast<float*>(delta);
  if ((D > Dv ? D : Dv) <= 64)
    return tc::launch<64>(q, k, v, o, dout, l, acc, dl, dq, dk, dv, B, Sq, Skv, H, KV, D,
                          Dv, scale, causal, window, q_offset, s);
  return tc::launch<128>(q, k, v, o, dout, l, acc, dl, dq, dk, dv, B, Sq, Skv, H, KV, D,
                         Dv, scale, causal, window, q_offset, s);
}

// bf16 only: D = Dv in {64, 128}; 16-byte aligned contiguous q, k, v, o,
// dout, dk, dv; dq_acc (B, H, Sp, D) and rows (2, B, H, Sp) fp32
// workspaces, Sp = Sq rounded up to 64; otherwise as flash_attention_bwd
// (dq is the bf16 output). Returns a cudaError_t (cudaErrorNotSupported: no
// cuTensorMapEncodeTiled entry point).
extern "C" int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout,
                                         const void* lse, void* dq_acc, void* rows,
                                         void* dq, void* dk, void* dv, int B, int Sq,
                                         int Skv, int H, int KV, int D, float scale,
                                         int causal, int window, int q_offset,
                                         void* stream) {
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* acc = static_cast<float*>(dq_acc);
  float* rs = static_cast<float*>(rows);
  if (D == 64)
    return tma_route::launch<64>(q, k, v, o, dout, l, acc, rs, dq, dk, dv, B, Sq, Skv, H, KV,
                          scale, causal, window, q_offset, s);
  if (D == 128)
    return tma_route::launch<128>(q, k, v, o, dout, l, acc, rs, dq, dk, dv, B, Sq, Skv, H, KV,
                           scale, causal, window, q_offset, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 only: (D, Dv) in {(256, 256), (192, 128)}; 16-byte aligned contiguous
// q, k, v, o, dout, dk, dv; dq_acc (B, H, Sp, D) and rows (2, B, H, Sp)
// fp32 workspaces, Sp = Sq rounded up to 64; otherwise as
// flash_attention_bwd (dq is the bf16 output). Returns a cudaError_t
// (cudaErrorNotSupported: no cuTensorMapEncodeTiled entry point).
extern "C" int flash_attention_bwd_split(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout,
                                         const void* lse, void* dq_acc, void* rows,
                                         void* dq, void* dk, void* dv, int B, int Sq,
                                         int Skv, int H, int KV, int D, int Dv,
                                         float scale, int causal, int window,
                                         int q_offset, void* stream) {
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* acc = static_cast<float*>(dq_acc);
  float* rs = static_cast<float*>(rows);
  if (D == 256 && Dv == 256)
    return split_route::launch<256, 256>(q, k, v, o, dout, l, acc, rs, dq, dk, dv, B, Sq,
                                         Skv, H, KV, scale, causal, window, q_offset, s);
  if (D == 192 && Dv == 128)
    return split_route::launch<192, 128>(q, k, v, o, dout, l, acc, rs, dq, dk, dv, B, Sq,
                                         Skv, H, KV, scale, causal, window, q_offset, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 only: (D, Dv) = (192, 128) (deepseek-v2's MLA); 16-byte aligned
// contiguous q, k, v, o, dout, dk, dv; dq_acc (B, H, Sp, D) and rows (2, B,
// H, Sp) fp32 workspaces, Sp = Sq rounded up to 64; otherwise as
// flash_attention_bwd (dq is the bf16 output). Returns a cudaError_t
// (cudaErrorNotSupported: no cuTensorMapEncodeTiled entry point).
extern "C" int flash_attention_bwd_kv128(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout,
                                         const void* lse, void* dq_acc, void* rows,
                                         void* dq, void* dk, void* dv, int B, int Sq,
                                         int Skv, int H, int KV, int D, int Dv,
                                         float scale, int causal, int window,
                                         int q_offset, void* stream) {
  if (KV <= 0 || H % KV != 0 || D != kv128_route::D || Dv != kv128_route::DV)
    return static_cast<int>(cudaErrorInvalidValue);
  return kv128_route::launch(q, k, v, o, dout, static_cast<const float*>(lse),
                             static_cast<float*>(dq_acc), static_cast<float*>(rows), dq, dk,
                             dv, B, Sq, Skv, H, KV, scale, causal, window, q_offset,
                             static_cast<cudaStream_t>(stream));
}
