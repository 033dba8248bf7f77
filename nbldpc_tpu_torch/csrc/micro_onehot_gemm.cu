// P3: one iteration of one-hot GEMM routing, C [M, N] = A [M, K] @ B [K, N]
// + 1, f32 row-major. The wrapper (nbldpc_tpu_torch/kernels/micro.py,
// onehot_gemm) calls it once per iteration between two buffers.
//
// Replaces: benchmarks/micro_pallas.py, matmul_kernel / run_matmul (P3,
// call :108), which routed with a one-hot matrix on the TPU's MXU
// (A[i, perm[i]] = 1, x <- A @ x + 1).
//
// What bounds it on the H100: operations. The f32 product the probe asks
// about is 2 M N K = 2 x 6528^2 x 128 = 10.9 GFLOP per iteration: 0.163 ms
// at 67 TFLOP/s outside the tensor cores; A (170.5 MB) read once is 0.051
// ms at 3.35 TB/s. This kernel does the product as three TF32 tensor-core
// products (32.7 GFLOP): 0.066 ms at 495 TFLOP/s.
//
// Exactness: A's entries are 0 or 1 with at most one 1 per row (the probe's
// operator), so every output is x[perm[i]] (or 0) plus 1. B is split
// exactly into three TF32 values per entry, hi + mid + lo = x (hi keeps the
// top 11 significant bits, mid the next 11, lo the last 2), and all three
// products go into one f32 accumulator: each partial sum of hi, mid and lo
// fits in x's 24 bits, and the other products are zeros, so the sum is x
// exactly in any order, as in the plain version (cuBLAS SGEMM, TF32 off).
// The wrapper checks both preconditions and raises otherwise: A one-hot,
// and x finite with each entry 0 or of magnitude >= 2^-103, so that hi, mid
// and lo are all normal (an infinite x would give inf - inf in split3).
// After the first iteration every entry is x + 1 or 1, so it stays so.
//
// Design: mma.sync m16n8k8 TF32 on a 128 x 128 tile of C per block (N = 128
// is one tile, so A streams from HBM once per iteration), 8 warps of 64 x
// 32, K in steps of 32 through a 3-stage cp.async ring (16-byte copies when
// K and N are multiples of 4, else 4-byte ones; ragged edges zero-filled).
// Shared rows are padded (A by 4 floats, B by 8) so each fragment load hits
// 32 distinct banks. Two blocks fit an SM. The K range is split over
// blockIdx.z until the grid fills two blocks per SM (51 tiles x 5 splits at
// M = 6528): C is zeroed, each split adds its partial sum with atomicAdd,
// and split 0 adds the +1 to its own partial (acc + 1). With one nonzero
// partial per output the result is RN(x + 1) in any order, the plain
// version's rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kThreads = 256;                 // 2 x 4 warps of 64 x 32
constexpr int kLdA = kBK + 4;                 // padded rows of the A tile
constexpr int kLdB = kBN + 8;                 // padded rows of the B tile
constexpr int kStageFloats = kBM * kLdA + kBK * kLdB;
constexpr size_t kSmemBytes = (size_t)kStages * kStageFloats * sizeof(float);

// cp.async of kChunk floats (16 or 4 bytes), zero-filled when !ok
template <int kChunk>
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? 4 * kChunk : 0;
  if constexpr (kChunk == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(n));
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + mid + lo exactly, each a TF32 value (low 13 mantissa bits zero)
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  const float r = x - __uint_as_float(hi);
  mid = __float_as_uint(r) & 0xffffe000u;
  lo = __float_as_uint(r - __uint_as_float(mid));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int kChunk>
__global__ void __launch_bounds__(kThreads, 2)
onehot_gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ C, int M, int N, int K, int kt_per_split) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;   // the warp's tile
  const int g = lane >> 2, t = lane & 3;                   // mma fragment coordinates
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kt_total = (K + kBK - 1) / kBK;
  const int kt0 = blockIdx.z * kt_per_split;
  const int nk = min(kt_total, kt0 + kt_per_split) - kt0;

  auto load = [&](int stage, int kt) {
    float* As = smem + stage * kStageFloats;
    float* Bs = As + kBM * kLdA;
    const int k0 = kt * kBK;
#pragma unroll
    for (int c = tid; c < kBM * kBK / kChunk; c += kThreads) {
      const int r = c / (kBK / kChunk), kk = c % (kBK / kChunk) * kChunk;
      const bool ok = m0 + r < M && k0 + kk < K;
      copy_async<kChunk>(As + r * kLdA + kk, ok ? A + (size_t)(m0 + r) * K + k0 + kk : A, ok);
    }
#pragma unroll
    for (int c = tid; c < kBK * kBN / kChunk; c += kThreads) {
      const int r = c / (kBN / kChunk), nn = c % (kBN / kChunk) * kChunk;
      const bool ok = k0 + r < K && n0 + nn < N;
      copy_async<kChunk>(Bs + r * kLdB + nn, ok ? B + (size_t)(k0 + r) * N + n0 + nn : B, ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, kt0 + s);
    commit();
  }
  for (int i = 0; i < nk; ++i) {
    wait_groups<kStages - 2>();
    __syncthreads();                  // stage i landed; stage i - 1 no longer read
    if (i + kStages - 1 < nk) load((i + kStages - 1) % kStages, kt0 + i + kStages - 1);
    commit();
    const float* As = smem + (i % kStages) * kStageFloats;
    const float* Bs = As + kBM * kLdA;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float* p = As + (wm + mt * 16 + g) * kLdA + kk + t;
        a[mt][0] = __float_as_uint(p[0]);
        a[mt][1] = __float_as_uint(p[8 * kLdA]);
        a[mt][2] = __float_as_uint(p[4]);
        a[mt][3] = __float_as_uint(p[8 * kLdA + 4]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* p = Bs + (kk + t) * kLdB + wn + nt * 8 + g;
        uint32_t h0, m0_, l0, h1, m1, l1;
        split3(p[0], h0, m0_, l0);
        split3(p[4 * kLdB], h1, m1, l1);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_tf32(acc[mt][nt], a[mt], h0, h1);
          mma_tf32(acc[mt][nt], a[mt], m0_, m1);
          mma_tf32(acc[mt][nt], a[mt], l0, l1);
        }
      }
    }
  }

  const bool split = gridDim.z > 1;
  const float one = blockIdx.z == 0 ? 1.0f : 0.0f;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int m = m0 + wm + mt * 16 + g + (v >> 1) * 8;
        const int n = n0 + wn + nt * 8 + 2 * t + (v & 1);
        if (m >= M || n >= N) continue;
        if (split) {
          atomicAdd(C + (size_t)m * N + n, acc[mt][nt][v] + one);
        } else {
          C[(size_t)m * N + n] = acc[mt][nt][v] + 1.0f;
        }
      }
}

template <int kChunk>
cudaError_t launch(const float* A, const float* B, float* C, int M, int N, int K,
                   dim3 grid, int kt_per_split, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(onehot_gemm_kernel<kChunk>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  onehot_gemm_kernel<kChunk><<<grid, kThreads, kSmemBytes, stream>>>(A, B, C, M, N, K,
                                                                       kt_per_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" int micro_onehot_gemm(const float* A, const float* B, float* C, int M, int N,
                                 int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1 || (M + kBM - 1) / kBM > 65535) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // split K until the grid fills two blocks per SM, no split left empty
  const int tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  const int kt_total = (K + kBK - 1) / kBK;
  int splits = 2 * sms / (tiles_m * tiles_n);
  splits = splits < 1 ? 1 : (splits > kt_total ? kt_total : splits);
  const int per = (kt_total + splits - 1) / splits;
  splits = (kt_total + per - 1) / per;
  if (splits > 1) {
    err = cudaMemsetAsync(C, 0, (size_t)M * N * sizeof(float), s);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(tiles_n, tiles_m, splits);
  const bool vec = K % 4 == 0 && N % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B)) % 16 == 0;
  return vec ? launch<4>(A, B, C, M, N, K, grid, per, s)
             : launch<1>(A, B, C, M, N, K, grid, per, s);
}
