// Frame pre-processing kernels for sm_90a: planar YUV -> RGB decode and the
// fused letterbox resize + normalisation.
//
// yuv_to_rgb replaces src/repro/kernels/preproc.py `_yuv_kernel` /
// `yuv_to_rgb` (the pallas_call at :56): (B, 3, H, W) uint8 planar BT.601
// full-range YUV -> (B, H, W, 3) uint8 RGB.
//   Bound: bytes. 3 bytes in and 3 out per pixel against ~20 flops, so
//   12.4 MB per 1080p frame, ~3.7 us at 3.35 TB/s. Two costs can hide
//   that bound. (1) Conversions: int -> float, rintf and float -> int are
//   9 instructions a pixel on the conversion pipe, which runs 16 a clock
//   an SM (~4.5 us a 1080p frame); here each is exact integer or fp32 work
//   instead: a byte becomes 2^23 + byte by putting it under the bit pattern
//   of 2^23 (one __byte_perm), and after the clamp, adding 1.5 * 2^23 rounds
//   to the nearest even integer and leaves it in the low byte of the sum's
//   bits. (2) Stores: a thread's own bytes lie at a stride of 48, so its
//   stores write half of every 32-byte sector they touch.
//   Design, three routes chosen by the wrapper (kernels/preproc.py
//   _yuv_route): "vec16" when a frame is a multiple of 16 pixels and both
//   buffers are 16-byte aligned (1080p and the all-triples frame): one
//   thread per 16 pixels reads a uint4 from each plane, packs its 48
//   output bytes into three uint4s with __byte_perm, and a warp passes its
//   96 uint4s through shared memory to store them as three contiguous
//   512-byte rows; a warp reads 512 contiguous bytes per plane, and a 1080p
//   frame is 129,600 threads, one wave. "vec4" (a multiple of 4 pixels,
//   4-byte aligned): one thread per 4 pixels, a word per plane and three
//   32-bit stores; "scalar" for the rest. A group never spans two frames.
//
// letterbox_normalize replaces src/repro/kernels/preproc.py
// `_letterbox_kernel` / `letterbox_normalize` (the pallas_call at :111):
// per plane, out = inside ? (Ly @ plane @ Lx^T) * scale + offset : pad,
// with letterbox-embedded interpolation operators Ly (out_h, H) and
// Lx (out_w, W), per-plane [scale, offset] and the content window from
// the geometry (content_h, content_w, top, left).
//   The operators have at most 2 non-zeros a row, so the kernel takes them
//   as 2-tap tables, idx int32 (n, 2) and w float32 (n, 2), read off the
//   operators' non-zeros in ascending column order (padded with weight 0).
//   Bound: bytes. A 1080p frame (3 planes, 1080x1920 -> 540x960) reads
//   6.2 MB of uint8 and writes 6.2 MB of fp32: ~3.7 us at 3.35 TB/s,
//   against ~15 flops an output (~0.35 us at 67 TFLOP/s fp32). The dense
//   product the TPU ran (12.7 GFLOP a frame) is not the function's work.
//   Tensor cores do not apply: ~6 flops against 8 bytes an output is far
//   below their ~295 flops a byte, and TF32 would round the operators'
//   exact weights.
//   Design: one launch, no intermediate in global memory. A block of 32 x 8
//   threads covers 128 output columns of 8 rows of one plane; it stages the
//   128 columns' taps in shared memory once, and each thread makes 4
//   adjacent outputs of one row, stored as one 16-byte float4 (scalar
//   stores when out_w % 4 != 0 or out is not 16-byte aligned). For each
//   output column it gathers its two input columns from the row's two
//   input rows through the read-only path; at the path's 0.5 scale a warp
//   reads 256 contiguous bytes of each of two input rows, and every input
//   byte is read once. Rows and columns outside the content window store
//   pad_value and load nothing.
//   Numerics (explicit intrinsics, so the compiler cannot contract the
//   chain another way): row pass t = fma(wy1, x[iy1], wy0 * x[iy0]) at
//   each of the two columns, column pass v = fma(wx1, t1, wx0 * t0), then
//   v * scale + offset as a separately rounded multiply and add (as on the
//   TPU and in the plain version). This is the dense fmaf chain over the
//   full row with its exact +0 terms left out, so on finite inputs it
//   gives the same bits as the dense product in ascending column order.
#include <cstdint>
#include "common.cuh"

namespace {

// __byte_perm selectors. byte_perm(x, y, s): nibble k of s picks byte k of
// the result from the 8 bytes x (0-3), y (4-7). tests/test_torch_kernels.py
// reads every k...Sel constant here and models the kernels' byte logic.
constexpr unsigned kLiftSel = 0x7440u;  // | k: [byte k of x, 0, 0, 0x4B] of y = 2^23
constexpr unsigned kRgSel = 0x0040u;    // [r, g, r, r] from the low bytes of r, g
constexpr unsigned kRgbSel = 0x0410u;   // [r, g, b, r]: byte 3 is never read
// 4 pixels p[0..3] (each r | g << 8 | b << 16) -> 3 words of interleaved
// RGB: word m = byte_perm(p[m], p[m + 1], kPackSelm)
constexpr unsigned kPackSel0 = 0x4210u;   // r0 g0 b0 r1
constexpr unsigned kPackSel1 = 0x5421u;   // g1 b1 r2 g2
constexpr unsigned kPackSel2 = 0x6542u;   // b2 r3 g3 b3

// 2^23 + byte k of w, as a float (exact)
__device__ __forceinline__ float lift(uint32_t w, int k) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, kLiftSel | k));
}

// The pixel in byte k of the Y, U and V words -> r | g << 8 | b << 16 in
// bytes 0-2 of the result (byte 3 is undefined).
__device__ __forceinline__ uint32_t yuv_pixel(uint32_t Y, uint32_t U,
                                              uint32_t V, int k) {
  const float y = __fsub_rn(lift(Y, k), 8388608.f);   // 2^23
  const float u = __fsub_rn(lift(U, k), 8388736.f);   // 2^23 + 128
  const float v = __fsub_rn(lift(V, k), 8388736.f);
  float r = __fmaf_rn(1.402f, v, y);
  float g = __fmaf_rn(-0.714136f, v, __fmaf_rn(-0.344136f, u, y));
  float b = __fmaf_rn(1.772f, u, y);
  r = __fadd_rn(fminf(fmaxf(r, 0.f), 255.f), 12582912.f);  // 1.5 * 2^23
  g = __fadd_rn(fminf(fmaxf(g, 0.f), 255.f), 12582912.f);
  b = __fadd_rn(fminf(fmaxf(b, 0.f), 255.f), 12582912.f);
  return __byte_perm(__byte_perm(__float_as_uint(r), __float_as_uint(g), kRgSel),
                     __float_as_uint(b), kRgbSel);
}

// 4 pixels -> their 12 interleaved RGB bytes as 3 words
__device__ __forceinline__ void pack4(const uint32_t* p, uint32_t* w) {
  w[0] = __byte_perm(p[0], p[1], kPackSel0);
  w[1] = __byte_perm(p[1], p[2], kPackSel1);
  w[2] = __byte_perm(p[2], p[3], kPackSel2);
}

constexpr int kYuvThreads = 256;

// route "vec16": the frame size is a multiple of 16 and both buffers are
// 16-byte aligned, so every group of 16 pixels lies in one frame and moves
// as one uint4 a plane in and three uint4s out; group t's output is the
// 48 bytes at 48 t.
__global__ void __launch_bounds__(kYuvThreads)
yuv_to_rgb_vec16_kernel(const uint8_t* __restrict__ yuv,
                        uint8_t* __restrict__ rgb, long long hw,
                        long long n_groups) {
  __shared__ uint4 stage[kYuvThreads / 32][96];
  const int lane = threadIdx.x % 32;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long first = t - lane;          // the warp's first group
  if (first >= n_groups) return;             // the whole warp
  // a lane past the end decodes the last group again and stores nothing
  const long long g0 = (t < n_groups ? t : n_groups - 1) * 16;
  const long long f = g0 / hw, p = g0 - f * hw;
  const uint8_t* plane = yuv + f * 3 * hw + p;
  const uint4 Y = *reinterpret_cast<const uint4*>(plane);
  const uint4 U = *reinterpret_cast<const uint4*>(plane + hw);
  const uint4 V = *reinterpret_cast<const uint4*>(plane + 2 * hw);
  const uint32_t ys[4] = {Y.x, Y.y, Y.z, Y.w};
  const uint32_t us[4] = {U.x, U.y, U.z, U.w};
  const uint32_t vs[4] = {V.x, V.y, V.z, V.w};
  uint32_t w[12];
#pragma unroll
  for (int q = 0; q < 4; ++q) {   // pixels 4q .. 4q + 3: word q of each plane
    uint32_t px[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) px[k] = yuv_pixel(ys[q], us[q], vs[q], k);
    pack4(px, w + 3 * q);
  }
  // the warp's 32 groups are 96 contiguous uint4s: lane l's three go to
  // stage[3l .. 3l + 2] (8 lanes a phase, 48 bytes apart: no bank
  // conflict), then the warp stores stage[32k + l], k = 0, 1, 2
  uint4* st = stage[threadIdx.x / 32];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    st[3 * lane + k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
  __syncwarp();
  const long long valid = 3 * (n_groups - first < 32 ? n_groups - first : 32);
  uint4* o = reinterpret_cast<uint4*>(rgb) + 3 * first;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (32 * k + lane < valid) o[32 * k + lane] = st[32 * k + lane];
}

// routes "vec4" (vec = 1: the frame size is a multiple of 4 and both buffers
// are 4-byte aligned, so every group of 4 pixels lies in one frame and can
// move as words) and "scalar" (vec = 0).
__global__ void yuv_to_rgb_kernel(const uint8_t* __restrict__ yuv,
                                  uint8_t* __restrict__ rgb, long long hw,
                                  long long n_pix, int vec) {
  const long long g0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (g0 >= n_pix) return;
  if (vec && g0 + 4 <= n_pix) {
    const long long f = g0 / hw, p = g0 - f * hw;
    const uint8_t* plane = yuv + f * 3 * hw + p;
    const uint32_t Y = *reinterpret_cast<const uint32_t*>(plane);
    const uint32_t U = *reinterpret_cast<const uint32_t*>(plane + hw);
    const uint32_t V = *reinterpret_cast<const uint32_t*>(plane + 2 * hw);
    uint32_t px[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) px[k] = yuv_pixel(Y, U, V, k);
    pack4(px, reinterpret_cast<uint32_t*>(rgb + g0 * 3));
    return;
  }
  const long long g_end = g0 + 4 < n_pix ? g0 + 4 : n_pix;
  for (long long g = g0; g < g_end; ++g) {
    const long long f = g / hw, p = g - f * hw;
    const uint8_t* plane = yuv + f * 3 * hw + p;
    const uint32_t px = yuv_pixel(plane[0], plane[hw], plane[2 * hw], 0);
    rgb[g * 3] = px & 0xff;
    rgb[g * 3 + 1] = (px >> 8) & 0xff;
    rgb[g * 3 + 2] = (px >> 16) & 0xff;
  }
}

constexpr int LB_TX = 32;               // column quads a block
constexpr int LB_TY = 8;                // rows a block
constexpr int LB_COLS = 4 * LB_TX;      // output columns a block

__device__ __forceinline__ float row_pass(const uint8_t* __restrict__ r0,
                                          const uint8_t* __restrict__ r1,
                                          int x, float wy0, float wy1) {
  return __fmaf_rn(wy1, static_cast<float>(__ldg(r1 + x)),
                   __fmul_rn(wy0, static_cast<float>(__ldg(r0 + x))));
}

// grid (row tiles * NB, column tiles); blockIdx.x = plane * row tiles + tile
__global__ void __launch_bounds__(LB_TX * LB_TY)
letterbox_kernel(const uint8_t* __restrict__ planes, const int* __restrict__ iy,
                 const float* __restrict__ wy, const int* __restrict__ ix,
                 const float* __restrict__ wx, const float* __restrict__ sb,
                 float* __restrict__ out, int H, int W, int out_h, int out_w,
                 int top, int ch, int left, int cw, float pad_value,
                 int row_tiles, int vec) {
  // the block's column taps, split by tap so that a thread reads its 4
  // columns' values as one 16-byte word each
  __shared__ __align__(16) int s_ix[2][LB_COLS];
  __shared__ __align__(16) float s_wx[2][LB_COLS];
  const int tid = threadIdx.y * LB_TX + threadIdx.x;
  const int z = blockIdx.x / row_tiles;
  const int i = (blockIdx.x - z * row_tiles) * LB_TY + threadIdx.y;
  const int c0 = blockIdx.y * LB_COLS;
  for (int e = tid; e < 2 * LB_COLS; e += LB_TX * LB_TY) {
    const int j = c0 + e / 2, k = e % 2;
    s_ix[k][e / 2] = j < out_w ? __ldg(ix + 2 * j + k) : 0;
    s_wx[k][e / 2] = j < out_w ? __ldg(wx + 2 * j + k) : 0.f;
  }
  __syncthreads();
  const int q = 4 * threadIdx.x;          // first of the thread's columns
  const int j0 = c0 + q;
  if (i >= out_h || j0 >= out_w) return;

  float v[4] = {pad_value, pad_value, pad_value, pad_value};
  if (i >= top && i < top + ch) {
    const uint8_t* plane = planes + (long long)z * H * W;
    const uint8_t* r0 = plane + (long long)__ldg(iy + 2 * i) * W;
    const uint8_t* r1 = plane + (long long)__ldg(iy + 2 * i + 1) * W;
    const float wy0 = __ldg(wy + 2 * i), wy1 = __ldg(wy + 2 * i + 1);
    const float scale = __ldg(sb + 2 * z), offset = __ldg(sb + 2 * z + 1);
    const int4 x0 = *reinterpret_cast<const int4*>(&s_ix[0][q]);
    const int4 x1 = *reinterpret_cast<const int4*>(&s_ix[1][q]);
    const float4 w0 = *reinterpret_cast<const float4*>(&s_wx[0][q]);
    const float4 w1 = *reinterpret_cast<const float4*>(&s_wx[1][q]);
    const int xa[4] = {x0.x, x0.y, x0.z, x0.w}, xb[4] = {x1.x, x1.y, x1.z, x1.w};
    const float wa[4] = {w0.x, w0.y, w0.z, w0.w}, wb[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + c;
      if (j < out_w && j >= left && j < left + cw) {
        const float t0 = row_pass(r0, r1, xa[c], wy0, wy1);
        const float t1 = row_pass(r0, r1, xb[c], wy0, wy1);
        const float s = __fmaf_rn(wb[c], t1, __fmul_rn(wa[c], t0));
        v[c] = __fadd_rn(__fmul_rn(s, scale), offset);
      }
    }
  }
  float* o = out + ((long long)z * out_h + i) * out_w + j0;
  if (vec) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (j0 + c < out_w) o[c] = v[c];
  }
}

}  // namespace

// yuv (B, 3, H, W) and rgb (B, H, W, 3), contiguous uint8, B * H * W > 0;
// route 2 = "vec16", 1 = "vec4", 0 = "scalar", as kernels/preproc.py
// _yuv_route picks it (a route whose conditions do not hold is refused).
extern "C" int yuv_to_rgb_u8(const void* yuv, void* rgb, int B, int H, int W,
                             int route, void* stream) {
  const long long hw = (long long)H * W, n_pix = (long long)B * hw;
  const uintptr_t align = reinterpret_cast<uintptr_t>(yuv) |
                          reinterpret_cast<uintptr_t>(rgb);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(yuv);
  uint8_t* out = static_cast<uint8_t*>(rgb);
  if (route == 2) {
    if (hw % 16 != 0 || align % 16 != 0) return cudaErrorInvalidValue;
    const long long groups = n_pix / 16;
    yuv_to_rgb_vec16_kernel<<<(unsigned)((groups + kYuvThreads - 1) / kYuvThreads),
                              kYuvThreads, 0, s>>>(in, out, hw, groups);
    return launch_status();
  }
  if (route == 1 && (hw % 4 != 0 || align % 4 != 0)) return cudaErrorInvalidValue;
  const long long groups = (n_pix + 3) / 4;
  yuv_to_rgb_kernel<<<(unsigned)((groups + kYuvThreads - 1) / kYuvThreads),
                      kYuvThreads, 0, s>>>(in, out, hw, n_pix, route == 1);
  return launch_status();
}

// planes (NB, H, W) uint8; row taps iy, wy (out_h, 2) and column taps
// ix, wx (out_w, 2), int32 indices and fp32 weights; sb (NB, 2) fp32;
// out (NB, out_h, out_w) fp32; all contiguous, NB * out_h * out_w > 0.
extern "C" int letterbox_normalize_f32(const void* planes, const void* iy,
                                       const void* wy, const void* ix,
                                       const void* wx, const void* sb,
                                       void* out, int NB, int H, int W,
                                       int out_h, int out_w, int top, int ch,
                                       int left, int cw, float pad_value,
                                       void* stream) {
  const int row_tiles = (out_h + LB_TY - 1) / LB_TY;
  const int vec = out_w % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((unsigned)row_tiles * NB, (out_w + LB_COLS - 1) / LB_COLS);
  letterbox_kernel<<<grid, dim3(LB_TX, LB_TY), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), static_cast<const int*>(iy),
      static_cast<const float*>(wy), static_cast<const int*>(ix),
      static_cast<const float*>(wx), static_cast<const float*>(sb),
      static_cast<float*>(out), H, W, out_h, out_w, top, ch, left, cw,
      pad_value, row_tiles, vec);
  return launch_status();
}
