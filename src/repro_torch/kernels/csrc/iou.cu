// Pairwise IoU of candidate boxes for sm_90a (the dense half of NMS).
//
// Replaces src/repro/kernels/preproc.py `_iou_kernel` / `iou_matrix` (the
// pallas_call at :156): boxes (4, N) component-major fp32 [y0, x0, y1, x1]
// -> iou (N, N) fp32, iou[i][j] = inter / max(area_i + area_j - inter, 1e-12).
//
// Exact contract: the keep decisions of NMS compare these values with a
// threshold, so they must equal the host's (src/repro/preprocess/host.py
// iou_matrix) bit for bit. Every operation is written with the round-to-
// nearest intrinsics (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn), which nvcc
// never contracts into an FMA, in the host's order: area = (y1 - y0) *
// (x1 - x0), ih = max(0, min(y1) - max(y0)), iw likewise, inter = ih * iw,
// union = (area_i + area_j) - inter, then the clamp and one IEEE division.
//
// Symmetry: iou[i][j] and iou[j][i] are the same value. fminf and fmaxf of
// two floats, area_i + area_j and ih * iw are commutative in IEEE float32
// (each is one correctly rounded operation, or a pick of one operand), so
// the two orders run the same operations on the same values. The only
// freedom is the sign of a zero (min or max of +0 and -0), and -0 == +0:
// NMS compares with >, and the checks compare values. So each unordered
// pair is computed once and stored at (i, j) and at (j, i);
// tests/test_torch_kernels.py holds the plain version equal to its
// transpose on ties, zero-area boxes and signed zeros.
//
// Bound: bytes. The output is N^2 * 4 bytes (67 MB at N = 4096, 20 us at
// 3.35 TB/s; it does not fit in the 50 MB L2) against ~13 operations an
// element, half of them computed once for two outputs. One more cost: an
// IEEE division whose numerator is 0 (two boxes that do not overlap: most
// pairs) leaves __fdiv_rn's fast path for its slow one, so a pair with
// inter == 0 returns inter itself, which is the quotient's exact value
// (a signed zero over a positive denominator).
// Design: one block per 32x32 tile (ti, tj) of the upper triangle,
// ti <= tj: T (T + 1) / 2 blocks for T = ceil(N / 32), 8,256 at N = 4096.
// The tile's 32 row and 32 column boxes, with their areas, are staged in
// shared memory once (one load a thread); each of the 256 threads computes
// one row x 4 adjacent columns and stores them as one 16-byte float4 (8
// lanes along a row: a warp writes 4 rows of 128 contiguous bytes). An
// off-diagonal tile is also written to a padded 32 x 33 shared tile and
// stored transposed at (tj, ti), float4s again; with a row stride of 1
// word mod 32 and 8 lanes along a row, both shared passes are free of bank
// conflicts. Diagonal tiles store once. The ragged edge is masked (and its
// pairs not computed); N % 4 != 0 (or an unaligned output) takes scalar
// stores in the same kernel. Why 32x32: 64x64 tiles of 4 rows a thread
// run 16 divisions in series a thread and are slower up to N = 1,024; at
// N = 4,096 (two launches a device-NMS run) they save only a few us.
#include <cstdint>
#include "common.cuh"

namespace {

// The upper-triangle tile of block b, tiles numbered column by column:
// b = tj (tj + 1) / 2 + ti with 0 <= ti <= tj.
__device__ __forceinline__ void tile_of(long long b, int& ti, int& tj) {
  long long c = static_cast<long long>((sqrtf(8.f * b + 1.f) - 1.f) * 0.5f);
  while (c * (c + 1) / 2 > b) --c;
  while ((c + 1) * (c + 2) / 2 <= b) ++c;
  tj = static_cast<int>(c);
  ti = static_cast<int>(b - c * (c + 1) / 2);
}

__device__ __forceinline__ float iou_pair(float ay0, float ax0, float ay1,
                                          float ax1, float area_a, float by0,
                                          float bx0, float by1, float bx1,
                                          float area_b) {
  const float ih = fmaxf(0.f, __fsub_rn(fminf(ay1, by1), fmaxf(ay0, by0)));
  const float iw = fmaxf(0.f, __fsub_rn(fminf(ax1, bx1), fmaxf(ax0, bx0)));
  const float inter = __fmul_rn(ih, iw);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  if (inter == 0.f) return inter;     // = inter / max(uni, 1e-12), exactly
  return __fdiv_rn(inter, fmaxf(uni, 1e-12f));
}

template <bool kVec>
__device__ __forceinline__ void store_quad(float* __restrict__ out, int n,
                                           int row, int c0, const float* v) {
  if (row >= n || c0 >= n) return;
  float* o = out + (long long)row * n + c0;
  if (kVec) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c0 + c < n) o[c] = v[c];
  }
}

constexpr int kTile = 32, kThreads = 256;   // 1 row x 4 columns a thread

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
iou_sym_kernel(const float* __restrict__ boxes, float* __restrict__ out, int n) {
  static_assert(kThreads == 2 * 4 * kTile && kThreads == kTile * kTile / 4,
                "one box load a thread, 4 outputs a thread");
  __shared__ __align__(16) float rows[5][kTile];  // y0, x0, y1, x1, area
  __shared__ __align__(16) float cols[5][kTile];
  __shared__ float mirror[kTile][kTile + 1];
  int ti, tj;
  tile_of(blockIdx.x, ti, tj);
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int t = threadIdx.x;
  {
    const int c = (t / kTile) % 4, k = t % kTile;
    if (t < 4 * kTile) rows[c][k] = i0 + k < n ? boxes[(long long)c * n + i0 + k] : 0.f;
    else cols[c][k] = j0 + k < n ? boxes[(long long)c * n + j0 + k] : 0.f;
  }
  __syncthreads();
  if (t < 2 * kTile) {
    float (*bx)[kTile] = t < kTile ? rows : cols;
    const int k = t % kTile;
    bx[4][k] = __fmul_rn(__fsub_rn(bx[2][k], bx[0][k]), __fsub_rn(bx[3][k], bx[1][k]));
  }
  __syncthreads();

  // lanes 0-7 of a warp take the 8 column quads of one row, lanes 8-15 the
  // next row, ...: thread t has row lr = t / 8, columns 4 cq .. 4 cq + 3
  const int cq = t % 8, lr = t / 8;
  const float4 by0 = *reinterpret_cast<const float4*>(&cols[0][4 * cq]);
  const float4 bx0 = *reinterpret_cast<const float4*>(&cols[1][4 * cq]);
  const float4 by1 = *reinterpret_cast<const float4*>(&cols[2][4 * cq]);
  const float4 bx1 = *reinterpret_cast<const float4*>(&cols[3][4 * cq]);
  const float4 bar = *reinterpret_cast<const float4*>(&cols[4][4 * cq]);
  const float cy0[4] = {by0.x, by0.y, by0.z, by0.w};
  const float cx0[4] = {bx0.x, bx0.y, bx0.z, bx0.w};
  const float cy1[4] = {by1.x, by1.y, by1.z, by1.w};
  const float cx1[4] = {bx1.x, bx1.y, bx1.z, bx1.w};
  const float car[4] = {bar.x, bar.y, bar.z, bar.w};
  const bool live = j0 + 4 * cq < n && i0 + lr < n;
  const float ay0 = rows[0][lr], ax0 = rows[1][lr];
  const float ay1 = rows[2][lr], ax1 = rows[3][lr], aar = rows[4][lr];
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    v[c] = live ? iou_pair(ay0, ax0, ay1, ax1, aar, cy0[c], cx0[c], cy1[c],
                           cx1[c], car[c])
                : 0.f;
  store_quad<kVec>(out, n, i0 + lr, j0 + 4 * cq, v);
  if (ti == tj) return;
#pragma unroll
  for (int c = 0; c < 4; ++c) mirror[lr][4 * cq + c] = v[c];
  __syncthreads();
  float m[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) m[k] = mirror[4 * cq + k][lr];
  store_quad<kVec>(out, n, j0 + lr, i0 + 4 * cq, m);
}

}  // namespace

// boxes (4, n) and out (n, n): contiguous fp32, n > 0.
extern "C" int iou_f32(const void* boxes, void* out, int n, void* stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  const unsigned blocks = static_cast<unsigned>(tiles * (tiles + 1) / 2);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(boxes);
  float* o = static_cast<float*>(out);
  if (vec) iou_sym_kernel<true><<<blocks, kThreads, 0, s>>>(b, o, n);
  else iou_sym_kernel<false><<<blocks, kThreads, 0, s>>>(b, o, n);
  return launch_status();
}
