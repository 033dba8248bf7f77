// P3: one iteration of one-hot GEMM routing, C [M, N] = A [M, K] @ B [K, N]
// + 1, f32 row-major. The wrapper (nbldpc_tpu_torch/kernels/micro.py,
// onehot_gemm) launches it once per iteration between two buffers.
//
// Replaces: benchmarks/micro_pallas.py, matmul_kernel / run_matmul (P3,
// call :108), which routed with a one-hot matrix on the TPU's MXU
// (A[i, perm[i]] = 1, x <- A @ x + 1).
//
// What bounds it on the H100: operations. The dense product the probe asks
// about is 2 M N K = 2 x 6528^2 x 128 = 10.9 GFLOP per iteration: 0.163 ms
// at 67 TFLOP/s in f32 outside the tensor cores; A (170.5 MB) read once is
// 0.051 ms at 3.35 TB/s. The same routing as a gather (P1) moves 3.34 MB.
//
// Design: a hand-written SIMT GEMM, deliberately not TF32 tensor cores
// (TF32 would round x to 10 mantissa bits and the one-hot product would no
// longer be exact). A 64 x 64 tile of C per block of 256 threads, each
// thread a 4 x 4 sub-tile at rows ty + 16 i and columns tx + 16 j (so a
// warp reads shared memory without bank conflicts); K in steps of 16, the
// tiles of A (transposed) and B staged in shared memory, ragged edges read
// as 0. Each thread sums its products in ascending k with fmaf: with A one
// hot every product is exact (0 or x), so the sum is x[perm[i]] exactly,
// whatever the order, and equals the plain version (cuBLAS, TF32 off).
// The +1 is the epilogue. At M = 6528, N = 128: 102 x 2 = 204 blocks.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
onehot_gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ C, int M, int N, int K) {
  __shared__ float As[kBK][kBM];
  __shared__ float Bs[kBK][kBN];
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A tile [kBM, kBK]: consecutive threads on consecutive k
#pragma unroll
    for (int l = 0; l < kBM * kBK / kThreads; ++l) {
      const int idx = t + l * kThreads;
      const int i = idx / kBK, kk = idx % kBK;
      const int m = m0 + i, k = k0 + kk;
      As[kk][i] = (m < M && k < K) ? A[(size_t)m * K + k] : 0.f;
    }
    // B tile [kBK, kBN]: consecutive threads on consecutive n
#pragma unroll
    for (int l = 0; l < kBK * kBN / kThreads; ++l) {
      const int idx = t + l * kThreads;
      const int kk = idx / kBN, j = idx % kBN;
      const int k = k0 + kk, n = n0 + j;
      Bs[kk][j] = (k < K && n < N) ? B[(size_t)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) C[(size_t)m * N + n] = acc[i][j] + 1.0f;
    }
  }
}

}  // namespace

extern "C" int micro_onehot_gemm(const float* A, const float* B, float* C, int M, int N,
                                 int K, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  onehot_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, B, C, M, N, K);
  return cudaGetLastError();
}
