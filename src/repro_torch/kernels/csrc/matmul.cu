// fp32 matmul with a fused bias + tanh epilogue, for sm_90a: three kernels,
// chosen by the wrapper (kernels/matmul.py `_route`) by the row count M.
//
// Replaces: src/repro/kernels/matmul.py, `_kernel` / `matmul` (the
// pallas_call at :106). out = epilogue(a @ b + bias), a (M, K), b (K, N),
// bias (N,) optional, epilogue "none" or "tanh", fp32 in, accumulate and out.
// Plain fp32 FMAs in every kernel: no tensor cores, and so no TF32.
//
// What bounds it on an H100: on the face path M is a pow2-bucketed face
// batch (<= 8) and K is 6912, 3072 or 256, so the product is a skinny
// GEMV-like read of the weight matrix (7.08 MB for (6912, 256)): bytes, not
// FLOPs. At 3.35 TB/s the weight read alone is ~2 us, which only a grid that
// keeps every SM loading can approach, in one launch.
//
// Skinny route, M <= 8 (matmul_skinny_kernel). A block owns a slab of B: a
// K range times SN = 16 columns. All M rows of A for its K range are staged
// in shared memory (by asynchronous copies, S_KT rows a pass); thread t
// owns the 4 adjacent columns 4 (t % 4) .. + 3 and every 64th K row from
// t / 4, holds M x 4 fp32 accumulators, and reads its rows of B with
// 16-byte loads, all S_ROWS of a pass in flight together with the copies of
// A before it multiplies, so a block waits for memory about once (a ragged
// N or a misaligned B takes scalar loads). The K split is a thread-block
// cluster along K (up to 8 blocks, gridDim.x): the block sums its 64 K lanes
// in a fixed order (a shuffle tree within each warp, then the warps in
// order), then rank 0 of the cluster reads every rank's partial tile through
// distributed shared memory in rank order, applies bias + tanh once and
// writes out. No workspace, no counter, no second launch, and the same bits
// on every run.
//
// Rows route, 9 <= M <= 64 (matmul_rows_kernel): the skinny kernel's
// structure for every row of a serving cluster's replica batch. A block owns
// a slab of B, a K range times RN = 16 columns, for all M rows, so the grid
// reads B from device memory once. Its K range goes through a 4-stage ring
// of passes of 64 K rows in shared memory, A's rows (16-byte cp.async along
// K) and B's (16-byte cp.async along N) kept in flight three passes ahead.
// Thread t of 256 owns columns 4 (t % 4) .. + 3, the K lane (t / 4) % 16
// (rows 4 lane .. 4 lane + 3 of every pass) and the row group t / 64 (MT =
// M / 4 rounded up to 4, 8, 12 or 16 rows), and holds MT x 4 fp32
// accumulators: each 16-byte read of A feeds 16 FMAs and each of B 4 MT.
// (512 threads of 8 row groups, half the rows a thread, ran slower on the
// H100: 0.031037 ms at 64 rows against 0.023484.) The K split is a
// thread-block cluster along K (up to 8 blocks; the wrapper's plans take
// up to 6, which ran faster at the cluster batches' shapes), summed as the skinny
// kernel sums it: the 16 K lanes by a shuffle tree within each warp and the
// two warps of a row group in order, then every rank's partial tile read
// through distributed shared memory in rank order, bias + tanh applied once.
// One launch, no workspace, the same bits on every run. At 64 rows the
// route's bound is its FMAs' (226 MFLOP over 67 TFLOP/s, 3.4 us), at 16
// B's bytes; on the H100 its copies (A comes from the L2 once for each of
// the 16 column slabs) and its FMAs add up rather than overlap
// (scripts/matmul_rows_parts.py times each alone).
//
// Tile route, M > 64 (matmul_tile_kernel): each block owns one BM x BN output
// tile and loops over its K range; when the output has few tiles, K is split
// across blockIdx.z, each split writes its fp32 partial tile to a workspace
// and a second pass (matmul_reduce_kernel) sums the splits in a fixed order
// and applies bias + tanh exactly once. When one split is enough the epilogue
// is fused into the main kernel. Ragged M, K and N are masked on load and
// store; nothing is padded on the host.
#include <cstdint>
#include <cooperative_groups.h>
#include "common.cuh"
#include "tensor_core.cuh"

namespace cg = cooperative_groups;

namespace {

// kernels/matmul.py repeats BM, BN and BK to size the split-K grid
constexpr int BM = 16;       // output rows per block
constexpr int BN = 64;       // output columns per block
constexpr int BK = 32;       // K tile staged in shared memory
constexpr int THREADS = 256; // thread t owns row t / 16, columns 4 * (t % 16) + 0..3

// the skinny kernel's slab; kernels/matmul.py repeats SN and MAX_CLUSTER
constexpr int SKINNY_M = 8;                  // most rows of A it takes
constexpr int SN = 16;                       // output columns per block
constexpr int S_THREADS = 256;               // column group t % 4, K lane t / 4
constexpr int S_LANES = S_THREADS / 4;       // 64 K rows a pass
constexpr int S_WARPS = S_THREADS / 32;
constexpr int S_KT = 1024;                   // K rows a pass: A staged, B in flight
constexpr int S_ROWS = S_KT / S_LANES;       // 16-byte B loads in flight a thread
constexpr int MAX_CLUSTER = 8;               // the portable cluster size

// the rows kernel's slab and ring; kernels/matmul.py repeats ROWS_M and RN
constexpr int ROWS_M = 64;                   // most rows of A it takes
constexpr int RN = 16;                       // output columns per block
constexpr int R_THREADS = 256;               // column group, K lane, row group
constexpr int R_GROUPS = 4;                  // row groups of 64 threads
constexpr int R_LANES = 16;                  // K lanes of 4 rows a pass
constexpr int R_KT = 4 * R_LANES;            // 64 K rows a pass
constexpr int R_STAGES = 4;                  // passes in the ring
constexpr int A_PITCH = R_KT + 4;            // floats a row of A's stage
constexpr int B_PITCH = RN + 4;              // floats a row of B's stage

__device__ __forceinline__ float epilogue_fn(float v, const float* bias, int n,
                                             int tanh_epilogue) {
  if (bias != nullptr) v += bias[n];
  if (tanh_epilogue) v = tanhf(v);
  return v;
}

// ---- skinny route -------------------------------------------------------

// four adjacent columns c .. c + 3 of row k of b (N columns); zero past N
template <bool VEC>
__device__ __forceinline__ float4 load_b4(const float* __restrict__ b, int k, int c,
                                          int N) {
  const float* row = b + (size_t)k * N;
  if (VEC) {   // N % 4 == 0 and b 16-byte aligned: c < N means c + 3 < N
    return c < N ? __ldg(reinterpret_cast<const float4*>(row + c))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  return make_float4(c < N ? __ldg(row + c) : 0.f, c + 1 < N ? __ldg(row + c + 1) : 0.f,
                     c + 2 < N ? __ldg(row + c + 2) : 0.f,
                     c + 3 < N ? __ldg(row + c + 3) : 0.f);
}

template <int MR, bool VEC>
__global__ void __launch_bounds__(S_THREADS)
matmul_skinny_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ bias, float* __restrict__ out, int N,
                     int K, int k_chunk, int tanh_epilogue) {
  __shared__ float As[MR][S_KT];
  __shared__ float red[S_WARPS][MR][SN];
  __shared__ float part[MR][SN];               // this block's partial tile

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, group = tid & 3, lane_k = tid >> 2;
  const int col0 = blockIdx.y * SN;
  const int c = col0 + 4 * group;
  const int k_begin = rank * k_chunk, k_end = min(K, k_begin + k_chunk);

  float acc[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

  // a pass: the rows of A as asynchronous copies and all S_ROWS rows of B
  // this thread reads as loads in flight together, then the FMAs
  for (int k0 = k_begin; k0 < k_end; k0 += S_KT) {
    const int kn = min(S_KT, k_end - k0);
    __syncthreads();                           // the previous rows of A are used
    for (int m = 0; m < MR; ++m)
      for (int kk = tid; kk < kn; kk += S_THREADS)
        tensor_core::cp_async4(tensor_core::smem_addr(&As[m][kk]),
                               a + (size_t)m * K + k0 + kk);
    tensor_core::cp_async_commit();
    float4 bv[S_ROWS];
#pragma unroll
    for (int u = 0; u < S_ROWS; ++u) {
      const int kk = lane_k + u * S_LANES;
      bv[u] = kk < kn ? load_b4<VEC>(b, k0 + kk, c, N) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    tensor_core::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int u = 0; u < S_ROWS; ++u) {
      const int kk = lane_k + u * S_LANES;
      if (kk >= kn) break;
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const float av = As[m][kk];
        acc[m][0] = fmaf(av, bv[u].x, acc[m][0]);
        acc[m][1] = fmaf(av, bv[u].y, acc[m][1]);
        acc[m][2] = fmaf(av, bv[u].z, acc[m][2]);
        acc[m][3] = fmaf(av, bv[u].w, acc[m][3]);
      }
    }
  }

  // the block's sum over its 64 K lanes: lanes 4 apart hold the same columns
#pragma unroll
  for (int m = 0; m < MR; ++m) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  }
  const int warp = tid >> 5;
  if ((tid & 31) < 4) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[warp][m][4 * group + j] = acc[m][j];
  }
  __syncthreads();
  if (tid < MR * SN) {
    const int m = tid / SN, n = tid % SN;
    float s = red[0][m][n];
#pragma unroll
    for (int w = 1; w < S_WARPS; ++w) s += red[w][m][n];
    part[m][n] = s;
  }
  cluster.sync();                              // every partial tile is written
  if (rank == 0 && tid < MR * SN) {
    const int m = tid / SN, n = tid % SN, gn = col0 + n;
    float s = 0.f;
    const int ranks = static_cast<int>(cluster.num_blocks());
    for (int r = 0; r < ranks; ++r) s += *cluster.map_shared_rank(&part[m][n], r);
    if (gn < N) out[(size_t)m * N + gn] = epilogue_fn(s, bias, gn, tanh_epilogue);
  }
  cluster.sync();                              // rank 0 has read every partial
}

template <int MR, bool VEC>
cudaError_t launch_skinny(const float* a, const float* b, const float* bias, float* out,
                          int N, int K, int cluster, int k_chunk, int tanh_epilogue,
                          cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (N + SN - 1) / SN, 1);
  cfg.blockDim = dim3(S_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, matmul_skinny_kernel<MR, VEC>, a, b, bias, out, N, K,
                            k_chunk, tanh_epilogue);
}

template <bool VEC>
cudaError_t dispatch_skinny(int M, const float* a, const float* b, const float* bias,
                            float* out, int N, int K, int cluster, int k_chunk,
                            int tanh_epilogue, cudaStream_t s) {
  switch (M) {
#define SKINNY_CASE(MR) \
    case MR: return launch_skinny<MR, VEC>(a, b, bias, out, N, K, cluster, k_chunk, tanh_epilogue, s);
    SKINNY_CASE(1) SKINNY_CASE(2) SKINNY_CASE(3) SKINNY_CASE(4)
    SKINNY_CASE(5) SKINNY_CASE(6) SKINNY_CASE(7) SKINNY_CASE(8)
#undef SKINNY_CASE
    default: return cudaErrorInvalidValue;
  }
}

// ---- rows route ---------------------------------------------------------

// a stage of the ring: A's R_GROUPS MT rows x R_KT K, then B's R_KT K x RN,
// floats
template <int MT>
struct RowsSmem {
  static constexpr int A = R_GROUPS * MT * A_PITCH;
  static constexpr int STAGE = A + R_KT * B_PITCH;
  static constexpr int BYTES = R_STAGES * STAGE * 4;
};

// 4 bytes global -> shared; src_bytes = 0 writes a zero and reads nothing
__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const float* src,
                                                int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// one pass's copies into stage st: A's rows [0, R_GROUPS MT) (zeros past M) and
// B's columns [col0, col0 + RN) (zeros past N), K rows [k0, k0 + R_KT)
// (zeros past k_end); VEC: 16-byte copies (K, N multiples of 4 and a, b
// 16-byte aligned; k0 and k_end then multiples of 4 too)
template <int MT, bool VEC>
__device__ __forceinline__ void rows_stage(float* st, const float* __restrict__ a,
                                           const float* __restrict__ b, int M, int N,
                                           int K, int k0, int k_end, int col0, int tid) {
  float* As = st;
  float* Bs = st + RowsSmem<MT>::A;
  for (int c = tid; c < R_GROUPS * MT * (R_KT / 4); c += R_THREADS) {
    const int r = c / (R_KT / 4), kc = 4 * (c % (R_KT / 4)), k = k0 + kc;
    const uint32_t dst = tensor_core::smem_addr(As + r * A_PITCH + kc);
    const float* src = a + (size_t)min(r, M - 1) * K;
    if (VEC) {
      const bool ok = r < M && k < k_end;
      tensor_core::cp_async16(dst, ok ? src + k : a, ok ? 16 : 0);
    } else {
      for (int e = 0; e < 4; ++e) {
        const bool ok = r < M && k + e < k_end;
        cp_async4_zfill(dst + 4 * e, ok ? src + k + e : a, ok ? 4 : 0);
      }
    }
  }
  if (tid < R_KT * (RN / 4)) {               // 256 chunks
    const int kr = tid / (RN / 4), nc = 4 * (tid % (RN / 4));
    const int k = k0 + kr, n = col0 + nc;
    const uint32_t dst = tensor_core::smem_addr(Bs + kr * B_PITCH + nc);
    if (VEC) {
      const bool ok = k < k_end && n < N;
      tensor_core::cp_async16(dst, ok ? b + (size_t)k * N + n : b, ok ? 16 : 0);
    } else {
      for (int e = 0; e < 4; ++e) {
        const bool ok = k < k_end && n + e < N;
        cp_async4_zfill(dst + 4 * e, ok ? b + (size_t)k * N + n + e : b, ok ? 4 : 0);
      }
    }
  }
}

template <int MT, bool VEC>
__global__ void __launch_bounds__(R_THREADS)
matmul_rows_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ bias, float* __restrict__ out, int M, int N,
                   int K, int k_chunk, int tanh_epilogue) {
  using S = RowsSmem<MT>;
  extern __shared__ __align__(16) float ring[];
  __shared__ float part[R_GROUPS * MT][RN];    // this block's partial tile

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, group = tid & 3, lane_k = (tid >> 2) & (R_LANES - 1);
  const int rg = tid >> 6, warp = tid >> 5;
  const int col0 = blockIdx.y * RN;
  const int k_begin = rank * k_chunk, k_end = min(K, k_begin + k_chunk);
  const int n_pass = k_end > k_begin ? (k_end - k_begin + R_KT - 1) / R_KT : 0;

  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // the ring: passes p + 1 .. p + R_STAGES - 1 in flight while pass p is
  // multiplied (one commit group a pass, empty ones past the last)
#pragma unroll
  for (int p = 0; p < R_STAGES - 1; ++p) {
    if (p < n_pass)
      rows_stage<MT, VEC>(ring + p * S::STAGE, a, b, M, N, K, k_begin + p * R_KT, k_end,
                          col0, tid);
    tensor_core::cp_async_commit();
  }
  for (int p = 0; p < n_pass; ++p) {
    tensor_core::cp_async_wait<R_STAGES - 2>();
    __syncthreads();                           // pass p landed; pass p - 1 is used
    const int pn = p + R_STAGES - 1;
    if (pn < n_pass)
      rows_stage<MT, VEC>(ring + (pn % R_STAGES) * S::STAGE, a, b, M, N, K,
                          k_begin + pn * R_KT, k_end, col0, tid);
    tensor_core::cp_async_commit();
    const float* As = ring + (p % R_STAGES) * S::STAGE;
    const float* Bs = As + S::A;
    float4 bv[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      bv[kk] = *reinterpret_cast<const float4*>(Bs + (4 * lane_k + kk) * B_PITCH + 4 * group);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float4 av =
          *reinterpret_cast<const float4*>(As + (rg * MT + i) * A_PITCH + 4 * lane_k);
      const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc[i][0] = fmaf(ak[kk], bv[kk].x, acc[i][0]);
        acc[i][1] = fmaf(ak[kk], bv[kk].y, acc[i][1]);
        acc[i][2] = fmaf(ak[kk], bv[kk].z, acc[i][2]);
        acc[i][3] = fmaf(ak[kk], bv[kk].w, acc[i][3]);
      }
    }
  }
  tensor_core::cp_async_wait<0>();
  __syncthreads();                             // the ring is free for the sums

  // the block's sum over its 16 K lanes: lanes 4, 8 and 16 apart within a
  // warp hold the same columns (K lanes 8 w' .. 8 w' + 7), then the row
  // group's two warps in order
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = acc[i][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[i][j] = v;
    }
  }
  float* red = ring;                           // [2 R_GROUPS warps][MT][RN]
  if ((tid & 31) < 4) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[(warp * MT + i) * RN + 4 * group + j] = acc[i][j];
  }
  __syncthreads();
  for (int e = tid; e < R_GROUPS * MT * RN; e += R_THREADS) {
    const int r = e / RN, n = e % RN, g = r / MT, i = r % MT;
    part[r][n] = red[(2 * g * MT + i) * RN + n] + red[((2 * g + 1) * MT + i) * RN + n];
  }
  cluster.sync();                              // every partial tile is written
  const int ranks = static_cast<int>(cluster.num_blocks());
  for (int e = rank * R_THREADS + tid; e < M * RN; e += ranks * R_THREADS) {
    const int m = e / RN, n = e % RN, gn = col0 + n;
    float s = 0.f;
    for (int r = 0; r < ranks; ++r) s += *cluster.map_shared_rank(&part[m][n], r);
    if (gn < N) out[(size_t)m * N + gn] = epilogue_fn(s, bias, gn, tanh_epilogue);
  }
  cluster.sync();                              // every rank has read every partial
}

template <int MT, bool VEC>
cudaError_t launch_rows(const float* a, const float* b, const float* bias, float* out,
                        int M, int N, int K, int cluster, int k_chunk, int tanh_epilogue,
                        cudaStream_t stream) {
  static bool opted_in = false;                // dynamic shared memory above 48 KB
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        matmul_rows_kernel<MT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        RowsSmem<MT>::BYTES);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (N + RN - 1) / RN, 1);
  cfg.blockDim = dim3(R_THREADS, 1, 1);
  cfg.dynamicSmemBytes = RowsSmem<MT>::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, matmul_rows_kernel<MT, VEC>, a, b, bias, out, M, N, K,
                            k_chunk, tanh_epilogue);
}

template <bool VEC>
cudaError_t dispatch_rows(int M, const float* a, const float* b, const float* bias,
                          float* out, int N, int K, int cluster, int k_chunk,
                          int tanh_epilogue, cudaStream_t s) {
  const int mt = (M + R_GROUPS - 1) / R_GROUPS;   // rows a row group
  if (mt <= 4)
    return launch_rows<4, VEC>(a, b, bias, out, M, N, K, cluster, k_chunk, tanh_epilogue, s);
  if (mt <= 8)
    return launch_rows<8, VEC>(a, b, bias, out, M, N, K, cluster, k_chunk, tanh_epilogue, s);
  if (mt <= 12)
    return launch_rows<12, VEC>(a, b, bias, out, M, N, K, cluster, k_chunk, tanh_epilogue, s);
  return launch_rows<16, VEC>(a, b, bias, out, M, N, K, cluster, k_chunk, tanh_epilogue, s);
}

// ---- tile route ---------------------------------------------------------

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

// Skinny route. a (M, K), b (K, N), bias (N,) or null, out (M, N):
// contiguous fp32, 1 <= M <= 8. cluster (1..8) blocks split K into chunks of
// k_chunk rows, none empty: (cluster - 1) * k_chunk < K <= cluster * k_chunk
// (cluster 1 and k_chunk 0 when K = 0).
extern "C" int matmul_skinny_f32(const void* a, const void* b, const void* bias,
                                 void* out, int M, int N, int K, int cluster,
                                 int k_chunk, int tanh_epilogue, void* stream) {
  if (M < 1 || M > SKINNY_M || N < 1 || K < 0 || cluster < 1 || cluster > MAX_CLUSTER
      || (N + SN - 1) / SN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const cudaError_t err =
      vec ? dispatch_skinny<true>(M, af, bf, cf, of, N, K, cluster, k_chunk, tanh_epilogue, s)
          : dispatch_skinny<false>(M, af, bf, cf, of, N, K, cluster, k_chunk, tanh_epilogue, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_status();
}

// Rows route. a (M, K), b (K, N), bias (N,) or null, out (M, N): contiguous
// fp32, 9 <= M <= 64 (any M >= 1 runs). cluster (1..8) blocks split K into
// chunks of k_chunk rows, a multiple of 4, none empty: (cluster - 1) *
// k_chunk < K <= cluster * k_chunk (cluster 1 and k_chunk 0 when K = 0).
extern "C" int matmul_rows_f32(const void* a, const void* b, const void* bias, void* out,
                               int M, int N, int K, int cluster, int k_chunk,
                               int tanh_epilogue, void* stream) {
  if (M < 1 || M > ROWS_M || N < 1 || K < 0 || cluster < 1 || cluster > MAX_CLUSTER ||
      k_chunk % 4 != 0 || (N + RN - 1) / RN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  const bool vec = K % 4 == 0 && N % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const cudaError_t err =
      vec ? dispatch_rows<true>(M, af, bf, cf, of, N, K, cluster, k_chunk, tanh_epilogue, s)
          : dispatch_rows<false>(M, af, bf, cf, of, N, K, cluster, k_chunk, tanh_epilogue, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_status();
}

// Tile route. a (M, K), b (K, N), bias (N,) or null, out (M, N): contiguous
// fp32. splits > 1 needs partial (splits, M, N); k_chunk is a multiple of BK
// with (splits - 1) * k_chunk < K, so that no split is empty.
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
