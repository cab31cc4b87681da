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
// Both routes split L across blocks so that B * KV * n_split blocks fill the
// card (the TPU walked L sequentially in one grid row; 8 rows x 8 kv heads
// alone give 64 blocks for 132 SMs). A block of 4 warps owns one (kv head,
// row, split) and reads only keys in [max(0, kv_len - window), kv_len):
// blocks past kv_len read nothing. Each warp keeps its own online softmax
// (m, l, acc) for the G heads in registers; the 4 warps combine in shared
// memory; with one split the block writes o, else it writes (m, l, acc) and
// decode_combine merges the splits. Two routes, chosen by shape in the
// Python wrapper (`_route`):
//
// decode_attention_mma (bf16, D and Dv multiples of 16): each warp takes
// tiles of 16 keys in turn and stages each tile's K and V rows in its own
// 3-stage ring in shared memory with 16-byte cp.async copies (a key row of
// 256 bytes is 16 lanes' copies; chunks permuted as chunk ^ (row % 8) so
// that ldmatrix reads hit distinct banks). Scores are mma.sync m16n8k16
// bf16 -> fp32 with A = the G query heads in rows 0..G-1, zero-padded to
// 16 (the tensor cores have cycles to spare), and K^T fragments by ldmatrix;
// the scale multiplies the fp32 score after the product. The softmax runs on
// the fragments (the 4 lanes of a quad hold a row: 2 shuffles a tile, not a
// reduction per score), P is rounded to bf16 in registers and O += P V is
// mma.sync with V by ldmatrix.trans.
//
// decode_attention (fp32, and bf16 at other widths): each lane holds DPL =
// D / 32 consecutive elements of a key, a warp takes 4 keys at a time, and a
// score is the lane partial dot reduced by shuffles.
#include <cuda_bf16.h>
#include "common.cuh"
#include "tensor_core.cuh"

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

// The (G, DPL) pairs of the ported configs: llama3-8b and jamba (G = 4,
// D = 128), qwen2.5-14b (G = 5, D = 128), chameleon-34b (G = 8, D = 128),
// granite-moe-3b (G = 3, D = 64) and the smoke configs (G = 2, D = 16).
// Another config adds its pair here, in decode_attention_mma below and in
// WIDTHS (kernels/decode_attention.py).
template <typename T>
int by_shape(int G, const void* q, const void* k, const void* v, const int* kv_len,
             void* o, float* part, int B, int L, int KV, int D, int Dv, float scale,
             int window, int n_split, cudaStream_t s) {
  const int w = D > Dv ? D : Dv;
  if (G == 2 && w <= 32)
    return launch<T, 2, 1>(q, k, v, kv_len, o, part, B, L, KV, D, Dv, scale, window, n_split, s);
  if (G == 3 && w <= 64)
    return launch<T, 3, 2>(q, k, v, kv_len, o, part, B, L, KV, D, Dv, scale, window, n_split, s);
  if (G == 4 && w <= 128)
    return launch<T, 4, 4>(q, k, v, kv_len, o, part, B, L, KV, D, Dv, scale, window, n_split, s);
  if (G == 5 && w <= 128)
    return launch<T, 5, 4>(q, k, v, kv_len, o, part, B, L, KV, D, Dv, scale, window, n_split, s);
  if (G == 8 && w <= 128)
    return launch<T, 8, 4>(q, k, v, kv_len, o, part, B, L, KV, D, Dv, scale, window, n_split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- tensor-core route: bf16, D and Dv multiples of 16 ----------------------

namespace tc {

using namespace tensor_core;

constexpr int KT = 16;             // keys a warp tile: one k step of P V
constexpr int STAGES = 3;          // tiles in flight a warp
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

// A warp's ring: STAGES x (K tile, V tile), each [KT keys][DMAX] bf16, the
// 16-byte chunk c of row r stored at chunk c ^ (r & SWM)
template <int DMAX>
struct Ring {
  static constexpr int CH = DMAX / 8;                 // 16-byte chunks a row
  static constexpr int SWM = (CH < 8 ? CH : 8) - 1;
  static constexpr int TILE = KT * DMAX * 2;          // bytes of one K or V tile
  static constexpr int WARP_BYTES = STAGES * 2 * TILE;
  static constexpr int BYTES = WARPS * WARP_BYTES;
  __device__ static uint32_t at(int r, int c) { return r * CH * 16 + (c ^ (r & SWM)) * 16; }
};

template <int G, int DMAX>
__global__ void __launch_bounds__(WARPS * 32)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ o,
                  float* __restrict__ part, int L, int KV, int D, int Dv,
                  float scale_log2, int window, int chunk, int n_split) {
  static_assert(G >= 1 && G <= 8, "the G heads are fragment rows lane / 4 = 0..7");
  using R = Ring<DMAX>;
  extern __shared__ __align__(16) uint8_t ring[];
  __shared__ float sm_m[WARPS][G], sm_l[WARPS][G];
  __shared__ float sm_acc[WARPS][G][DMAX];
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane / 4, c = lane % 4;        // fragment row (head) and column pair
  const int H = KV * G;
  const int len = min(max(kv_len[b], 0), L);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int s0 = max(lo, split * chunk), s1 = min(len, (split + 1) * chunk);
  const int n_tiles = s1 > s0 ? (s1 - s0 + KT - 1) / KT : 0;
  const int mine = n_tiles > warp ? (n_tiles - warp + WARPS - 1) / WARPS : 0;

  // q as A fragments (registers a0 and a2; a1 and a3, rows 8..15, are zero)
  uint32_t qa[DMAX / 16][2];
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    const bool live = g < G && kk * 16 < D;
    const __nv_bfloat16* qr = q + ((long long)b * H + kvh * G + (live ? g : 0)) * D
                            + (live ? kk * 16 + 2 * c : 0);
    qa[kk][0] = live ? *reinterpret_cast<const uint32_t*>(qr) : 0u;
    qa[kk][1] = live ? *reinterpret_cast<const uint32_t*>(qr + 8) : 0u;
  }

  const uint32_t wbase = smem_addr(ring) + warp * R::WARP_BYTES;
  const long long krow = (long long)KV * D, vrow = (long long)KV * Dv;
  const __nv_bfloat16* kb = k + (long long)b * L * krow + (long long)kvh * D;
  const __nv_bfloat16* vb = v + (long long)b * L * vrow + (long long)kvh * Dv;
  const int kch = D / 8, vch = Dv / 8;

  // the warp's i-th tile (keys s0 + (warp + WARPS i) KT ..) into stage i % STAGES;
  // keys past s1 are zero-filled and read nothing
  auto issue = [&](int i) {
    const int key0 = s0 + (warp + WARPS * i) * KT;
    const uint32_t kd = wbase + (i % STAGES) * 2 * R::TILE, vd = kd + R::TILE;
    for (int x = lane; x < KT * kch; x += 32) {
      const int r = x / kch, cc = x % kch, key = key0 + r;
      const bool ok = key < s1;
      cp_async16(kd + R::at(r, cc), kb + (ok ? key : s0) * krow + cc * 8, ok ? 16 : 0);
    }
    for (int x = lane; x < KT * vch; x += 32) {
      const int r = x / vch, cc = x % vch, key = key0 + r;
      const bool ok = key < s1;
      cp_async16(vd + R::at(r, cc), vb + (ok ? key : s0) * vrow + cc * 8, ok ? 16 : 0);
    }
  };

  float m = NEG_INF, l = 0.f;                  // row g (rows >= G are padding)
  float acc[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < mine) issue(i);
    cp_async_commit();                         // empty groups keep the count uniform
  }
  for (int i = 0; i < mine; ++i) {
    if (i + STAGES - 1 < mine) issue(i + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();               // tile i has landed (this lane's part)
    __syncwarp();                              // ... and every lane's
    const uint32_t kd = wbase + (i % STAGES) * 2 * R::TILE, vd = kd + R::TILE;
    const int key0 = s0 + (warp + WARPS * i) * KT;
    const int mat = lane / 8;                  // ldmatrix: lane gives a row of matrix mat

    // scores of the tile's keys 8 n + 2 c + {0, 1} (entries 0, 1 of sc[n])
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk * 16 < D) {
        uint32_t bk[4];                        // {keys 0-7, 8-15} x {d low, high 8}
        ldmatrix_x4(bk, kd + R::at((mat / 2) * 8 + lane % 8, kk * 2 + mat % 2));
        mma_bf16(sc[0], qa[kk][0], 0u, qa[kk][1], 0u, bk[0], bk[1]);
        mma_bf16(sc[1], qa[kk][0], 0u, qa[kk][1], 0u, bk[2], bk[3]);
      }
    }
    float x[2][2], mx = m;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + n * 8 + 2 * c + e;
        x[n][e] = key < s1 ? sc[n][e] * scale_log2 : NEG_INF;
        mx = fmaxf(mx, x[n][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = exp2f(m - mx);
    m = mx;
    float p[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) p[n][e] = exp2f(x[n][e] - m);
    l = l * alpha + (p[0][0] + p[0][1]) + (p[1][0] + p[1][1]);
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha;

    // O += P V: P's A fragment is {keys 0-7, 0, keys 8-15, 0}
    const uint32_t pa0 = pack_bf16(p[0][0], p[0][1]), pa2 = pack_bf16(p[1][0], p[1][1]);
#pragma unroll
    for (int nb = 0; nb < DMAX / 16; ++nb) {
      if (nb * 16 < Dv) {
        uint32_t bv[4];                        // {keys 0-7, 8-15} x {columns 16 nb, + 8}
        ldmatrix_x4_trans(bv, vd + R::at((mat % 2) * 8 + lane % 8, nb * 2 + mat / 2));
        mma_bf16(acc[2 * nb], pa0, 0u, pa2, 0u, bv[0], bv[1]);
        mma_bf16(acc[2 * nb + 1], pa0, 0u, pa2, 0u, bv[2], bv[3]);
      }
    }
    __syncwarp();                              // every lane is done with the stage
  }
  cp_async_wait<0>();

  // combine the warps (m in log2 units here)
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (g < G) {
    if (c == 0) {
      sm_m[warp][g] = m;
      sm_l[warp][g] = l;
    }
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
      if (n * 8 < Dv) {
        sm_acc[warp][g][n * 8 + 2 * c] = acc[n][0];
        sm_acc[warp][g][n * 8 + 2 * c + 1] = acc[n][1];
      }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * Dv; idx += WARPS * 32) {
    const int gg = idx / Dv, e = idx % Dv;
    float mm = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, sm_m[w][gg]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2f(sm_m[w][gg] - mm);
      ll = fmaf(sm_l[w][gg], f, ll);
      aa = fmaf(sm_acc[w][gg][e], f, aa);
    }
    if (n_split == 1) {
      o[((long long)b * H + kvh * G + gg) * Dv + e] = __float2bfloat16_rn(aa / fmaxf(ll, 1e-30f));
    } else {                                   // decode_combine works in natural units
      float* row = part + ((((long long)b * KV + kvh) * n_split + split) * G + gg) * (2 + Dv);
      row[2 + e] = aa;
      if (e == 0) {
        row[0] = mm * LN2;
        row[1] = ll;
      }
    }
  }
}

template <int G, int DMAX>
int launch(const void* q, const void* k, const void* v, const int* kv_len, void* o,
           float* part, int B, int L, int KV, int D, int Dv, float scale, int window,
           int n_split, cudaStream_t stream) {
  static bool opted_in = false;                // shared-memory opt-in, once
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_mma_kernel<G, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Ring<DMAX>::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int chunk = (L + n_split - 1) / n_split;
  decode_mma_kernel<G, DMAX><<<dim3(KV, B, n_split), WARPS * 32, Ring<DMAX>::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), kv_len, static_cast<__nv_bfloat16*>(o), part,
      L, KV, D, Dv, scale * LOG2E, window, chunk, n_split);
  if (n_split > 1) {
    const int rc = launch_status();
    if (rc != 0) return rc;
    decode_combine<__nv_bfloat16><<<B * KV * G, Dv, 0, stream>>>(
        part, static_cast<__nv_bfloat16*>(o), KV, G, Dv, n_split);
  }
  return launch_status();
}

}  // namespace tc

}  // namespace

// dtype 0: fp32, 1: bf16. G = H / KV = 2 with D, Dv <= 32, G = 3 with D, Dv <= 64,
// or G = 4, 5, 8 with D, Dv <= 128; B, L > 0; part holds B * KV * n_split * G * (2 + Dv) floats when n_split > 1
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

// bf16 only: G = H / KV = 2 with D, Dv <= 32, G = 3 with D, Dv <= 64, or G = 4, 5, 8
// with D, Dv <= 128, each a multiple of 16; B, L > 0; part as for decode_attention.
// The G query heads fill rows 0..G-1 of the 16-row A tile (G <= 8: the fragment rows
// g = lane / 4 hold them; rows 8..15 are the zero registers a1, a3). Returns a cudaError_t.
extern "C" int decode_attention_mma(const void* q, const void* k, const void* v,
                                    const void* kv_len, void* o, void* part, int B,
                                    int L, int H, int KV, int D, int Dv, float scale,
                                    int window, int n_split, void* stream) {
  if (KV <= 0 || H % KV != 0 || D <= 0 || Dv <= 0 || D % 16 || Dv % 16 || n_split < 1 ||
      (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / KV, w = D > Dv ? D : Dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(kv_len);
  float* p = static_cast<float*>(part);
  if (G == 2 && w <= 32)
    return tc::launch<2, 32>(q, k, v, len, o, p, B, L, KV, D, Dv, scale, window, n_split, s);
  if (G == 3 && w <= 64)
    return tc::launch<3, 64>(q, k, v, len, o, p, B, L, KV, D, Dv, scale, window, n_split, s);
  if (G == 4 && w <= 128)
    return tc::launch<4, 128>(q, k, v, len, o, p, B, L, KV, D, Dv, scale, window, n_split, s);
  if (G == 5 && w <= 128)
    return tc::launch<5, 128>(q, k, v, len, o, p, B, L, KV, D, Dv, scale, window, n_split, s);
  if (G == 8 && w <= 128)
    return tc::launch<8, 128>(q, k, v, len, o, p, B, L, KV, D, Dv, scale, window, n_split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
