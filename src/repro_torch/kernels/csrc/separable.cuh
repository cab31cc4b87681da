// Batched, strided fp32 plane product: the device function that the
// letterbox (preproc.cu) and bilinear resize (resize.cu) kernels share.
//
// Both TPU kernels compute a separable resize as two dense products per
// image plane, Ry @ plane @ Rx^T. Here each of the two products is one
// launch of plane_gemm over all planes (blockIdx.z), so the (out_h, W)
// intermediate goes through global memory instead of VMEM: at W = 1920 a
// 128-row intermediate is 983 KB, more than one SM's 227 KB of shared
// memory. Layouts are strided so that channel-last images (resize) and
// transposed operators (Rx^T) are read in place without a copy.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace separable {

constexpr int TM = 64;        // output rows per block
constexpr int TN = 64;        // output columns per block
constexpr int TK = 16;        // K tile staged in shared memory
constexpr int THREADS = 256;  // a 16 x 16 grid of threads, 4 x 4 outputs each

// Element (z, i, j) of a batch of matrices lives at
//   (z / zdiv) * outer + (z % zdiv) * inner + i * row + j * col
// where zdiv is shared by the three operands of one launch.
struct Layout {
  long long outer, inner, row, col;
};

struct Identity {
  __device__ __forceinline__ float operator()(int, int, int, float v) const { return v; }
};

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(uint8_t v) { return static_cast<float>(v); }

// C[z] = epi(z, i, j, (A[z] @ B[z])[i, j]) for every plane z = blockIdx.z,
// with A (M, K) fp32, B (K, N) fp32 or uint8, C (M, N) fp32.
template <typename TB, typename Epi>
__global__ void __launch_bounds__(THREADS)
plane_gemm(const float* __restrict__ A, Layout la, const TB* __restrict__ B,
           Layout lb, float* __restrict__ C, Layout lc, int zdiv, int M, int N,
           int K, Epi epi) {
  __shared__ __align__(16) float As[TK][TM + 4];
  __shared__ __align__(16) float Bs[TK][TN + 4];

  const int tid = threadIdx.x;
  const int z = blockIdx.z, zq = z / zdiv, zr = z % zdiv;
  const int i0 = blockIdx.y * TM, j0 = blockIdx.x * TN;
  const int ty = tid / 16, tx = tid % 16;
  const long long a0 = zq * la.outer + zr * la.inner;
  const long long b0 = zq * lb.outer + zr * lb.inner;
  const long long c0 = zq * lc.outer + zr * lc.inner;
  // map neighbouring threads to the operand's contiguous axis
  const bool a_k_fast = la.col == 1;
  const bool b_j_fast = lb.col == 1;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = tid; e < TM * TK; e += THREADS) {
      const int ii = a_k_fast ? e / TK : e % TM;
      const int kk = a_k_fast ? e % TK : e / TM;
      const int gi = i0 + ii, gk = k0 + kk;
      As[kk][ii] = (gi < M && gk < K) ? A[a0 + gi * la.row + gk * la.col] : 0.f;
    }
    for (int e = tid; e < TK * TN; e += THREADS) {
      const int jj = b_j_fast ? e % TN : e / TK;
      const int kk = b_j_fast ? e / TN : e % TK;
      const int gk = k0 + kk, gj = j0 + jj;
      Bs[kk][jj] = (gk < K && gj < N) ? as_f32(B[b0 + gk * lb.row + gj * lb.col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a4[r], b4[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gi = i0 + ty * 4 + r;
    if (gi >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gj = j0 + tx * 4 + c;
      if (gj < N) C[c0 + gi * lc.row + gj * lc.col] = epi(z, gi, gj, acc[r][c]);
    }
  }
}

inline dim3 plane_grid(int M, int N, int planes) {
  return dim3((N + TN - 1) / TN, (M + TM - 1) / TM, planes);
}

}  // namespace separable
