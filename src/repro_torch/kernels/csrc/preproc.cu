// Frame pre-processing kernels for sm_90a: planar YUV -> RGB decode and the
// fused letterbox resize + normalisation.
//
// yuv_to_rgb replaces src/repro/kernels/preproc.py `_yuv_kernel` /
// `yuv_to_rgb` (the pallas_call at :56): (B, 3, H, W) uint8 planar BT.601
// full-range YUV -> (B, H, W, 3) uint8 RGB.
//   Bound: bytes. 3 bytes in and 3 out per pixel against ~20 flops, so
//   12.4 MB per 1080p frame, ~3.7 us at 3.35 TB/s.
//   Design: one thread per 4 pixels reads a uchar4 from each plane and
//   writes its 12 interleaved output bytes as three 32-bit words, so a warp
//   reads 128 contiguous bytes per plane and stores 384 contiguous bytes.
//   The arithmetic is the exact contract of the host decode: the fused
//   chain r = fma(1.402, v, y), g = fma(-0.714136, v, fma(-0.344136, u, y)),
//   b = fma(1.772, u, y) with float32 constants, u and v centred on 128,
//   rintf (round half to even; roundf would round half away from zero),
//   then a clamp to [0, 255]. The separately rounded expression differs
//   from the host on 4,387 of the 256^3 triples; this chain on none.
//
// letterbox_normalize replaces src/repro/kernels/preproc.py
// `_letterbox_kernel` / `letterbox_normalize` (the pallas_call at :111):
// per plane, out = inside ? (Ly @ plane @ Lx^T) * scale + offset : pad,
// with letterbox-embedded interpolation operators Ly (out_h, H) and
// Lx (out_w, W), per-plane [scale, offset] and the content window from
// the geometry (content_h, content_w, top, left).
//   Bound: operations. Taken densely, as the function's arguments are, one
//   1080p frame (3 planes, 1080x1920 -> 540x960) is 12.7 GFLOP: ~190 us at
//   67 TFLOP/s fp32, against 12.4 MB of bytes (~4 us). The operators have
//   only 2 non-zeros per row; using that changes the arguments and is left
//   for a later kernel.
//   Design: two launches of the shared plane product (separable.cuh): pass
//   1 writes T = Ly @ plane (out_h, W) to global memory, reading the uint8
//   plane directly; pass 2 computes T @ Lx^T with the scale, offset and pad
//   mask applied in the epilogue before the single store. The TPU kept a
//   (128, W) intermediate in VMEM; at W = 1920 that is 983 KB, which no SM
//   holds. The affine step is a separately rounded multiply and add, as on
//   the TPU and in the plain version.
#include <cstdint>
#include "common.cuh"
#include "separable.cuh"

namespace {

__device__ __forceinline__ uint32_t yuv_pixel(uint32_t Y, uint32_t U, uint32_t V) {
  const float y = static_cast<float>(Y);
  const float u = static_cast<float>(U) - 128.f;
  const float v = static_cast<float>(V) - 128.f;
  float r = __fmaf_rn(1.402f, v, y);
  float g = __fmaf_rn(-0.714136f, v, __fmaf_rn(-0.344136f, u, y));
  float b = __fmaf_rn(1.772f, u, y);
  r = fminf(fmaxf(rintf(r), 0.f), 255.f);
  g = fminf(fmaxf(rintf(g), 0.f), 255.f);
  b = fminf(fmaxf(rintf(b), 0.f), 255.f);
  return static_cast<uint32_t>(r) | (static_cast<uint32_t>(g) << 8) |
         (static_cast<uint32_t>(b) << 16);
}

// vec: the frame size is a multiple of 4 and both buffers are 4-byte aligned,
// so every group of 4 pixels lies in one frame and can move as words.
__global__ void yuv_to_rgb_kernel(const uint8_t* __restrict__ yuv,
                                  uint8_t* __restrict__ rgb, long long hw,
                                  long long n_pix, int vec) {
  const long long g0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (g0 >= n_pix) return;
  if (vec && g0 + 4 <= n_pix) {
    const long long f = g0 / hw, p = g0 - f * hw;
    const uint8_t* plane = yuv + f * 3 * hw + p;
    const uchar4 Y = *reinterpret_cast<const uchar4*>(plane);
    const uchar4 U = *reinterpret_cast<const uchar4*>(plane + hw);
    const uchar4 V = *reinterpret_cast<const uchar4*>(plane + 2 * hw);
    const uint32_t p0 = yuv_pixel(Y.x, U.x, V.x);
    const uint32_t p1 = yuv_pixel(Y.y, U.y, V.y);
    const uint32_t p2 = yuv_pixel(Y.z, U.z, V.z);
    const uint32_t p3 = yuv_pixel(Y.w, U.w, V.w);
    uint32_t* o = reinterpret_cast<uint32_t*>(rgb + g0 * 3);
    o[0] = p0 | (p1 << 24);            // r0 g0 b0 r1
    o[1] = (p1 >> 8) | (p2 << 16);     // g1 b1 r2 g2
    o[2] = (p2 >> 16) | (p3 << 8);     // b2 r3 g3 b3
    return;
  }
  const long long g_end = g0 + 4 < n_pix ? g0 + 4 : n_pix;
  for (long long g = g0; g < g_end; ++g) {
    const long long f = g / hw, p = g - f * hw;
    const uint8_t* plane = yuv + f * 3 * hw + p;
    const uint32_t px = yuv_pixel(plane[0], plane[hw], plane[2 * hw]);
    rgb[g * 3] = px & 0xff;
    rgb[g * 3 + 1] = (px >> 8) & 0xff;
    rgb[g * 3 + 2] = (px >> 16) & 0xff;
  }
}

struct LetterboxEpilogue {
  const float* sb;   // (planes, 2): [scale, offset] per plane
  int top, ch, left, cw;
  float pad_value;
  __device__ __forceinline__ float operator()(int z, int i, int j, float v) const {
    const bool inside = i >= top && i < top + ch && j >= left && j < left + cw;
    return inside ? __fadd_rn(__fmul_rn(v, sb[2 * z]), sb[2 * z + 1]) : pad_value;
  }
};

}  // namespace

// yuv (B, 3, H, W) and rgb (B, H, W, 3), contiguous uint8, B * H * W > 0.
extern "C" int yuv_to_rgb_u8(const void* yuv, void* rgb, int B, int H, int W,
                             void* stream) {
  const long long hw = (long long)H * W, n_pix = (long long)B * hw;
  const int vec = hw % 4 == 0 && reinterpret_cast<uintptr_t>(yuv) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(rgb) % 4 == 0;
  const int threads = 256;
  const long long groups = (n_pix + 3) / 4;
  yuv_to_rgb_kernel<<<(unsigned)((groups + threads - 1) / threads), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(yuv), static_cast<uint8_t*>(rgb), hw, n_pix, vec);
  return launch_status();
}

// planes (NB, H, W) uint8; ly (out_h, H), lx (out_w, W), sb (NB, 2) fp32;
// tmp (NB, out_h, W) and out (NB, out_h, out_w) fp32; all contiguous.
extern "C" int letterbox_normalize_f32(const void* planes, const void* ly,
                                       const void* lx, const void* sb, void* tmp,
                                       void* out, int NB, int H, int W,
                                       int out_h, int out_w, int top, int ch,
                                       int left, int cw, float pad_value,
                                       void* stream) {
  using namespace separable;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l_ly{0, 0, H, 1};                              // shared by all planes
  const Layout l_plane{(long long)H * W, 0, W, 1};
  const Layout l_tmp{(long long)out_h * W, 0, W, 1};
  const Layout l_lx_t{0, 0, 1, W};                            // Lx^T read in place
  const Layout l_out{(long long)out_h * out_w, 0, out_w, 1};
  // pass 1: tmp[n] = Ly @ plane[n]
  plane_gemm<uint8_t, Identity><<<plane_grid(out_h, W, NB), THREADS, 0, s>>>(
      static_cast<const float*>(ly), l_ly, static_cast<const uint8_t*>(planes),
      l_plane, static_cast<float*>(tmp), l_tmp, 1, out_h, W, H, Identity{});
  // pass 2: out[n] = mask ? (tmp[n] @ Lx^T) * scale + offset : pad
  const LetterboxEpilogue epi{static_cast<const float*>(sb), top, ch, left, cw,
                              pad_value};
  plane_gemm<float, LetterboxEpilogue><<<plane_grid(out_h, out_w, NB), THREADS, 0, s>>>(
      static_cast<const float*>(tmp), l_tmp, static_cast<const float*>(lx),
      l_lx_t, static_cast<float*>(out), l_out, 1, out_h, out_w, W, epi);
  return launch_status();
}
