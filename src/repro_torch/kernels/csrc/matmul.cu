// fp32 matmul with a fused bias + tanh epilogue, for sm_90a.
//
// Replaces: src/repro/kernels/matmul.py, `_kernel` / `matmul` (the
// pallas_call at :106). out = epilogue(a @ b + bias), a (M, K), b (K, N),
// bias (N,) optional, epilogue "none" or "tanh", fp32 in, accumulate and out.
//
// What bounds it on an H100: on the face path M is a pow2-bucketed face
// batch (<= 8) and K is 6912 or 256, so the product is a skinny GEMV-like
// read of the weight matrix (7.08 MB for (6912, 256)): bytes, not FLOPs.
// At 3.35 TB/s the weight read alone is ~2 us, which only a grid that keeps
// every SM loading can approach.
//
// Design: the TPU grid walked K sequentially and carried the sum in VMEM;
// on Hopper blocks run in parallel, so each block owns one BM x BN output
// tile and loops over its K range itself. With M <= 8 there are only
// ceil(N / BN) output tiles, far fewer than 132 SMs, so K is split across
// blockIdx.z: each split writes its fp32 partial tile to a workspace and a
// second pass sums the splits in a fixed order (deterministic) and applies
// bias + tanh exactly once. When one split is enough the epilogue is fused
// into the main kernel. Ragged M, K and N are masked on load and store;
// nothing is padded on the host. Plain fp32 FMAs, no tensor cores (and so
// no TF32): wgmma/TMA are for a later kernel.
#include <cstdint>
#include "common.cuh"

namespace {

// kernels/matmul.py repeats BM, BN and BK to size the split-K grid
constexpr int BM = 16;       // output rows per block (face batches are <= 8)
constexpr int BN = 64;       // output columns per block
constexpr int BK = 32;       // K tile staged in shared memory
constexpr int THREADS = 256; // thread t owns row t / 16, columns 4 * (t % 16) + 0..3

__device__ __forceinline__ float epilogue_fn(float v, const float* bias, int n,
                                             int tanh_epilogue) {
  if (bias != nullptr) v += bias[n];
  if (tanh_epilogue) v = tanhf(v);
  return v;
}

__global__ void __launch_bounds__(THREADS)
matmul_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ bias, float* __restrict__ out,
                   float* __restrict__ partial, int M, int N, int K,
                   int k_chunk, int tanh_epilogue) {
  __shared__ float As[BK][BM];                 // A tile, K-major for broadcast reads
  __shared__ __align__(16) float Bs[BK][BN];   // B tile, row-major

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int r = tid / 16;
  const int c = (tid % 16) * 4;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // neighbouring threads read neighbouring addresses: along K for A ...
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int ar = i / BK, ak = i % BK;
      const int gr = row0 + ar, gk = k0 + ak;
      As[ak][ar] = (gr < M && gk < k_end) ? a[(size_t)gr * K + gk] : 0.f;
    }
    // ... and along N for B
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int bk = i / BN, bn = i % BN;
      const int gk = k0 + bk, gn = col0 + bn;
      Bs[bk][bn] = (gk < k_end && gn < N) ? b[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float av = As[kk][r];
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][c]);
      acc[0] = fmaf(av, bv.x, acc[0]);
      acc[1] = fmaf(av, bv.y, acc[1]);
      acc[2] = fmaf(av, bv.z, acc[2]);
      acc[3] = fmaf(av, bv.w, acc[3]);
    }
    __syncthreads();
  }

  const int gr = row0 + r;
  if (gr >= M) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gn = col0 + c + j;
    if (gn >= N) continue;
    if (partial != nullptr) {
      partial[((size_t)blockIdx.z * M + gr) * N + gn] = acc[j];
    } else {
      out[(size_t)gr * N + gn] = epilogue_fn(acc[j], bias, gn, tanh_epilogue);
    }
  }
}

// Second pass of a split-K product: sum the splits in order, then the
// epilogue, once per output element.
__global__ void matmul_reduce_kernel(const float* __restrict__ partial,
                                     const float* __restrict__ bias,
                                     float* __restrict__ out, int M, int N,
                                     int splits, int tanh_epilogue) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[z * mn + i];
  out[i] = epilogue_fn(s, bias, (int)(i % N), tanh_epilogue);
}

}  // namespace

// a (M, K), b (K, N), bias (N,) or null, out (M, N): contiguous fp32.
// splits > 1 needs partial (splits, M, N); k_chunk is a multiple of BK with
// (splits - 1) * k_chunk < K, so that no split is empty.
extern "C" int matmul_f32(const void* a, const void* b, const void* bias,
                          void* out, void* partial, int M, int N, int K,
                          int splits, int k_chunk, int tanh_epilogue,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  float* ws = splits > 1 ? static_cast<float*>(partial) : nullptr;
  matmul_tile_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(bias), static_cast<float*>(out), ws, M, N, K,
      k_chunk, tanh_epilogue);
  if (splits > 1) {
    const int threads = 256;
    const size_t mn = (size_t)M * N;
    matmul_reduce_kernel<<<(unsigned)((mn + threads - 1) / threads), threads, 0, s>>>(
        ws, static_cast<const float*>(bias), static_cast<float*>(out), M, N,
        splits, tanh_epilogue);
  }
  return launch_status();
}
