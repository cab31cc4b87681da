// Bilinear resize (align_corners=False) for sm_90a.
//
// Replaces src/repro/kernels/resize.py `_kernel` / `resize_bilinear` (the
// pallas_call at :65): img (N, H, W, C) fp32 -> (N, out_h, out_w, C), per
// channel plane out = Ry @ plane @ Rx^T with the interpolation operators
// Ry (out_h, H) and Rx (out_w, W) built on the host. Each operator row has
// at most 2 non-zeros, so the kernel takes them as 2-tap tables, idx int32
// (n, 2) and w float32 (n, 2), read off the non-zeros in ascending column
// order (kernels/resize.py interp_taps).
//
// Bound: on the face path (the unfused chain's (8, 48, 48, 3) crop stack to
// (8, 32, 32, 3)) the function reads 0.22 MB and writes 0.1 MB, ~0.1 us at
// 3.35 TB/s, and does ~0.4 MFLOP, so launch latency sets its time.
//
// Design: one launch and no intermediate, which is the whole design at this
// size. One thread an output pixel (n, i, j) loads its 2 x 2 taps and, for
// each of the C channels, gathers the four inputs from the channel-last
// image in place, with the letterbox kernel's chain: row pass
// t = fma(wy1, x[iy1], wy0 * x[iy0]) at both input columns, then column pass
// v = fma(wx1, t1, wx0 * t0), in explicit intrinsics. That is the dense
// fmaf chain in ascending column order with its exact +0 terms left out, so
// on finite inputs it gives the same bits as the dense product. Adjacent
// threads take adjacent pixels, so a warp's loads and stores are contiguous
// runs of C floats.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
resize_kernel(const float* __restrict__ img, const int* __restrict__ iy,
              const float* __restrict__ wy, const int* __restrict__ ix,
              const float* __restrict__ wx, float* __restrict__ out, int N,
              int H, int W, int C, int out_h, int out_w) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)N * out_h * out_w) return;
  const int j = p % out_w;
  const long long r = p / out_w;
  const int i = r % out_h;
  const long long n = r / out_h;
  const int y0 = __ldg(iy + 2 * i), y1 = __ldg(iy + 2 * i + 1);
  const float wy0 = __ldg(wy + 2 * i), wy1 = __ldg(wy + 2 * i + 1);
  const int x0 = __ldg(ix + 2 * j), x1 = __ldg(ix + 2 * j + 1);
  const float wx0 = __ldg(wx + 2 * j), wx1 = __ldg(wx + 2 * j + 1);
  const float* a0 = img + ((n * H + y0) * W) * C;   // input row iy0
  const float* a1 = img + ((n * H + y1) * W) * C;   // input row iy1
  float* o = out + p * C;
  for (int c = 0; c < C; ++c) {
    const float t0 = __fmaf_rn(wy1, __ldg(a1 + (long long)x0 * C + c),
                               __fmul_rn(wy0, __ldg(a0 + (long long)x0 * C + c)));
    const float t1 = __fmaf_rn(wy1, __ldg(a1 + (long long)x1 * C + c),
                               __fmul_rn(wy0, __ldg(a0 + (long long)x1 * C + c)));
    o[c] = __fmaf_rn(wx1, t1, __fmul_rn(wx0, t0));
  }
}

}  // namespace

// img (N, H, W, C) fp32; row taps iy, wy (out_h, 2) and column taps ix, wx
// (out_w, 2), int32 indices and fp32 weights; out (N, out_h, out_w, C) fp32;
// all contiguous, N * out_h * out_w * C > 0.
extern "C" int resize_bilinear_f32(const void* img, const void* iy, const void* wy,
                                   const void* ix, const void* wx, void* out,
                                   int N, int H, int W, int C, int out_h,
                                   int out_w, void* stream) {
  const int threads = 256;
  const long long pixels = (long long)N * out_h * out_w;
  resize_kernel<<<(unsigned)((pixels + threads - 1) / threads), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const int*>(iy),
      static_cast<const float*>(wy), static_cast<const int*>(ix),
      static_cast<const float*>(wx), static_cast<float*>(out), N, H, W, C,
      out_h, out_w);
  return launch_status();
}
