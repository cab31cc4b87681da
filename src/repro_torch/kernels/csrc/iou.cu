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
// Bound: bytes. The output is N^2 * 4 bytes (67 MB at N = 4096, 20 us at
// 3.35 TB/s) against ~13 operations an element.
// Design: one 32x32 output tile per block of 32x8 threads; the tile's 32 row
// boxes and 32 column boxes, with their areas, are staged in shared memory
// once, and each thread writes 4 rows of one column, so a warp stores 128
// contiguous bytes. The ragged edge (N not a multiple of 32) is masked here;
// the caller pads nothing.
#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;   // threadIdx.y extent; each thread does kTile / kRows rows

__global__ void __launch_bounds__(kTile * kRows)
iou_kernel(const float* __restrict__ boxes, float* __restrict__ out, int n) {
  __shared__ float row_box[5][kTile];   // y0, x0, y1, x1, area of the tile's rows
  __shared__ float col_box[5][kTile];   // the same for its columns
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (ty < 4) {
    // rows: threads (tx, ty < 4) load component ty of row box i0 + tx
    row_box[ty][tx] = i0 + tx < n ? boxes[(long long)ty * n + i0 + tx] : 0.f;
  } else {
    const int c = ty - 4;
    col_box[c][tx] = j0 + tx < n ? boxes[(long long)c * n + j0 + tx] : 0.f;
  }
  __syncthreads();
  if (ty == 0) {
    row_box[4][tx] = __fmul_rn(__fsub_rn(row_box[2][tx], row_box[0][tx]),
                               __fsub_rn(row_box[3][tx], row_box[1][tx]));
  } else if (ty == 1) {
    col_box[4][tx] = __fmul_rn(__fsub_rn(col_box[2][tx], col_box[0][tx]),
                               __fsub_rn(col_box[3][tx], col_box[1][tx]));
  }
  __syncthreads();
  const int j = j0 + tx;
  if (j >= n) return;
  const float by0 = col_box[0][tx], bx0 = col_box[1][tx];
  const float by1 = col_box[2][tx], bx1 = col_box[3][tx];
  const float area_b = col_box[4][tx];
#pragma unroll
  for (int r = ty; r < kTile; r += kRows) {
    const int i = i0 + r;
    if (i >= n) break;
    const float ih = fmaxf(0.f, __fsub_rn(fminf(row_box[2][r], by1),
                                          fmaxf(row_box[0][r], by0)));
    const float iw = fmaxf(0.f, __fsub_rn(fminf(row_box[3][r], bx1),
                                          fmaxf(row_box[1][r], bx0)));
    const float inter = __fmul_rn(ih, iw);
    const float uni = __fsub_rn(__fadd_rn(row_box[4][r], area_b), inter);
    out[(long long)i * n + j] = __fdiv_rn(inter, fmaxf(uni, 1e-12f));
  }
}

}  // namespace

// boxes (4, n) and out (n, n): contiguous fp32, n > 0.
extern "C" int iou_f32(const void* boxes, void* out, int n, void* stream) {
  const int tiles = (n + kTile - 1) / kTile;
  iou_kernel<<<dim3(tiles, tiles), dim3(kTile, kRows), 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<float*>(out), n);
  return launch_status();
}
