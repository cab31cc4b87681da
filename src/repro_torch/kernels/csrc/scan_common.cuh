// Helpers shared by the two scan libraries, linear_scan.cu (the forwards)
// and linear_scan_bwd.cu (the backwards): conversions between the scans'
// storage types and fp32, the forwards' rounding of delta x, the SFU
// exponential, and 8 values loaded as 16 bytes.
#pragma once
#include <cstdint>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ float bf(const __nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ uint32_t bf_tf32(const __nv_bfloat16 x) {
  return __float_as_uint(__bfloat162float(x));   // a bf16 value is exact in tf32
}

// x rounded to the type that the tag pointer points to
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 2^x on the SFU, one instruction and its subnormal handling: results below
// 2^-126 stay denormals, as expf gives them (ex2.approx.ftz would flush them)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 8 consecutive values (16-byte aligned) as fp32
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

}  // namespace
