// P1 and P2: ITERS row permutations of x [R = E * Q rows, BT frames] f32,
// each followed by +1, frames innermost. Two routing probes:
//   micro_flat_gather  x[r, :] <- x[perm[r], :] + 1          (one flat table)
//   micro_row_moves    x[e, s, :] <- x[pi[e], perms[e, s], :] + 1
//                      (a partner row per edge and a slot permutation per
//                      edge, read from their two tables every iteration)
//
// Replaces: benchmarks/micro_pallas.py, flat_gather_kernel /
// run_flat_gather (P1, call :63) and row_moves_kernel / run_row_moves (P2,
// call :86). The TPU asked whether a static gather lowers at all inside a
// kernel; on Hopper a gather from shared memory is native, and the probes
// ask what one costs.
//
// What bounds them on the H100: bytes. x is read once and written once
// (2 x 3.34 MB at E = 408, Q = 16, BT = 128) and the tables once: about
// 2.0 us at 3.35 TB/s, against 20 x R x BT adds = 0.25 us at 67 TFLOP/s.
//
// Design: the frames are independent, so one block owns one frame. It
// loads the frame's R values (26 KB at R = 6528) and the index tables into
// shared memory once, runs every iteration there (gather from one buffer
// by the table, +1, into the other; one barrier; swap) and writes the
// frame once. The loads and stores are strided by BT, once per call; the
// iterations touch only shared memory. Plain versions:
// nbldpc_tpu_torch/kernels/micro.py, flat_gather_plain and row_moves_plain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultShared = 48 * 1024;

// Allow `bytes` of dynamic shared memory for `kernel` (above the 48 KB a
// launch gets without asking).
template <typename K>
cudaError_t allow_shared(K kernel, size_t bytes) {
  if (bytes <= kDefaultShared) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

__global__ void __launch_bounds__(kThreads)
flat_gather_kernel(const float* __restrict__ x, float* __restrict__ out,
                   const int* __restrict__ perm, int R, int BT, int iters) {
  extern __shared__ float smem[];
  float* a = smem;
  float* c = smem + R;
  int* idx = reinterpret_cast<int*>(smem + 2 * R);
  const int b = blockIdx.x;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    a[r] = x[(size_t)r * BT + b];
    idx[r] = perm[r];
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int r = threadIdx.x; r < R; r += blockDim.x) c[r] = a[idx[r]] + 1.0f;
    __syncthreads();  // the reads of `a` of this iteration are done as well
    float* t = a;
    a = c;
    c = t;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) out[(size_t)r * BT + b] = a[r];
}

__global__ void __launch_bounds__(kThreads)
row_moves_kernel(const float* __restrict__ x, float* __restrict__ out,
                 const int* __restrict__ pi, const int* __restrict__ perms,
                 int E, int Q, int BT, int iters) {
  extern __shared__ float smem[];
  const int R = E * Q;
  float* a = smem;
  float* c = smem + R;
  int* spi = reinterpret_cast<int*>(smem + 2 * R);
  int* sperms = spi + E;
  const int b = blockIdx.x;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    a[r] = x[(size_t)r * BT + b];
    sperms[r] = perms[r];
  }
  for (int e = threadIdx.x; e < E; e += blockDim.x) spi[e] = pi[e];
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      const int e = r / Q;
      c[r] = a[spi[e] * Q + sperms[r]] + 1.0f;
    }
    __syncthreads();
    float* t = a;
    a = c;
    c = t;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) out[(size_t)r * BT + b] = a[r];
}

}  // namespace

extern "C" int micro_flat_gather(const float* x, float* out, const int* perm, int R,
                                 int BT, int iters, void* stream) {
  const size_t smem = (size_t)R * (2 * sizeof(float) + sizeof(int));
  cudaError_t err = allow_shared(flat_gather_kernel, smem);
  if (err != cudaSuccess) return err;
  flat_gather_kernel<<<BT, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, out, perm, R, BT, iters);
  return cudaGetLastError();
}

extern "C" int micro_row_moves(const float* x, float* out, const int* pi, const int* perms,
                               int E, int Q, int BT, int iters, void* stream) {
  const size_t smem = (size_t)E * Q * (2 * sizeof(float) + sizeof(int)) + E * sizeof(int);
  cudaError_t err = allow_shared(row_moves_kernel, smem);
  if (err != cudaSuccess) return err;
  row_moves_kernel<<<BT, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, out, pi, perms, E, Q, BT, iters);
  return cudaGetLastError();
}
