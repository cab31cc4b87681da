// Bilinear resize (align_corners=False) for sm_90a.
//
// Replaces src/repro/kernels/resize.py `_kernel` / `resize_bilinear` (the
// pallas_call at :65): img (N, H, W, C) fp32 -> (N, out_h, out_w, C), per
// channel plane out = Ry @ plane @ Rx^T with the interpolation operators
// Ry (out_h, H) and Rx (out_w, W) built on the host.
//
// Bound: on the face path (the unfused chain's (8, 48, 48, 3) crop stack to
// (8, 32, 32, 3)) the whole problem is ~0.1 MB and ~6 MFLOP, so it is bound
// by launch latency rather than by bytes or operations.
//
// Design: the two products of the separable resize are two launches of the
// plane product shared with the letterbox kernel (separable.cuh), one block
// per plane at this size. The channel-last image is read in place through
// strides (plane z = n * C + c), where the TPU wrapper transposed it to
// planes first; the (out_h, W) intermediate goes through global memory.
#include "common.cuh"
#include "separable.cuh"

// img (N, H, W, C), ry (out_h, H), rx (out_w, W), tmp (N * C, out_h, W),
// out (N, out_h, out_w, C): contiguous fp32, N * C > 0.
extern "C" int resize_bilinear_f32(const void* img, const void* ry, const void* rx,
                                   void* tmp, void* out, int N, int H, int W,
                                   int C, int out_h, int out_w, void* stream) {
  using namespace separable;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l_ry{0, 0, H, 1};
  const Layout l_img{(long long)H * W * C, 1, (long long)W * C, C};
  const Layout l_tmp{(long long)C * out_h * W, (long long)out_h * W, W, 1};
  const Layout l_rx_t{0, 0, 1, W};
  const Layout l_out{(long long)out_h * out_w * C, 1, (long long)out_w * C, C};
  // pass 1: tmp[z] = Ry @ plane[z]
  plane_gemm<float, Identity><<<plane_grid(out_h, W, N * C), THREADS, 0, s>>>(
      static_cast<const float*>(ry), l_ry, static_cast<const float*>(img), l_img,
      static_cast<float*>(tmp), l_tmp, C, out_h, W, H, Identity{});
  // pass 2: out[z] = tmp[z] @ Rx^T
  plane_gemm<float, Identity><<<plane_grid(out_h, out_w, N * C), THREADS, 0, s>>>(
      static_cast<const float*>(tmp), l_tmp, static_cast<const float*>(rx), l_rx_t,
      static_cast<float*>(out), l_out, C, out_h, out_w, W, Identity{});
  return launch_status();
}
