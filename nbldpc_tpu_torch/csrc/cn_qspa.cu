// One QSPA check-node phase, batch-last: U [M, dc, q, B] f32 -> same.
//
// Replaces: nbldpc_tpu/kernels/cn_qspa.py, _cn_kernel / cn_update_pallas
// (the Pallas K1 kernel).
//
// Math, per check m, slot j, frame b (identical to the plain version,
// nbldpc_tpu_torch/kernels/cn_qspa.py:cn_update_plain):
//   P  = softmax over q of U (max-subtracted)
//   F  = WHT(P)                                  spectra, |F| <= 1
//   G  = (prod_k sign F_k) sign F_j * exp(sum_k log|F_k| - log|F_j|)
//   Q  = WHT(G) / q, floored at 1e-12, log, minus its max over q
// Pad slots arrive as log-delta0 (spectrum all ones), so no masks.
//
// What bounds it on the H100: memory traffic. Each element is read once
// and written twice (the spectra are parked in the output buffer between
// the two passes over dc, then read back), about 16 bytes per element and
// some 30 flops, far below the card's flop/byte balance.
//
// Design: one thread per (check, frame), consecutive threads on
// consecutive frames, so every load and store of a symbol row is
// coalesced. The q-vector being transformed lives in a per-thread array:
// registers for q <= 32, local memory (L1-cached) for q = 64..256. The
// leave-one-out sums lsum/ssum are per-thread arrays of q as well. The
// WHT is the same butterfly order as the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kProbFloor = 1e-12f;
constexpr float kMagTiny = 1e-30f;
constexpr int kThreads = 128;

__device__ __forceinline__ void butterfly(float* x, int lo_i, int hi_i) {
  const float lo = x[lo_i];
  const float hi = x[hi_i];
  x[lo_i] = lo + hi;
  x[hi_i] = lo - hi;
}

// Butterfly stages h = 1, 2, ..., Q/2 writing (lo + hi, lo - hi). Fully
// unrolled (the vector stays in registers) for Q <= 32; a plain loop over
// the local-memory vector above that.
template <int Q>
__device__ __forceinline__ void wht_inplace(float* x) {
  if constexpr (Q <= 32) {
#pragma unroll
    for (int h = 1; h < Q; h <<= 1) {
#pragma unroll
      for (int base = 0; base < Q; base += 2 * h) {
#pragma unroll
        for (int i = 0; i < h; ++i) butterfly(x, base + i, base + h + i);
      }
    }
  } else {
#pragma unroll 1
    for (int h = 1; h < Q; h <<= 1) {
#pragma unroll 1
      for (int base = 0; base < Q; base += 2 * h) {
#pragma unroll 4
        for (int i = 0; i < h; ++i) butterfly(x, base + i, base + h + i);
      }
    }
  }
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
cn_qspa_kernel(const float* __restrict__ U, float* __restrict__ out,
               int dc, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t js = (size_t)Q * B;                  // stride between slots
  const size_t base = (size_t)blockIdx.y * dc * js + b;
  const float* u = U + base;
  float* o = out + base;

  float v[Q], lsum[Q], ssum[Q];
#pragma unroll
  for (int a = 0; a < Q; ++a) {
    lsum[a] = 0.f;
    ssum[a] = 1.f;
  }
  // pass 1: softmax -> WHT spectra, parked in `out`
  for (int j = 0; j < dc; ++j) {
#pragma unroll
    for (int a = 0; a < Q; ++a) v[a] = u[j * js + (size_t)a * B];
    float mx = v[0];
#pragma unroll
    for (int a = 1; a < Q; ++a) mx = fmaxf(mx, v[a]);
    float s = 0.f;
#pragma unroll
    for (int a = 0; a < Q; ++a) {
      v[a] = expf(v[a] - mx);
      s += v[a];
    }
#pragma unroll
    for (int a = 0; a < Q; ++a) v[a] = v[a] / s;
    wht_inplace<Q>(v);
#pragma unroll
    for (int a = 0; a < Q; ++a) {
      o[j * js + (size_t)a * B] = v[a];
      lsum[a] += logf(fabsf(v[a]) + kMagTiny);
      ssum[a] *= (v[a] < 0.f) ? -1.f : 1.f;
    }
  }
  // pass 2: leave-one-out product -> inverse WHT -> floor -> log -> renorm
  for (int j = 0; j < dc; ++j) {
#pragma unroll
    for (int a = 0; a < Q; ++a) {
      const float f = o[j * js + (size_t)a * B];
      const float sg = (f < 0.f) ? -1.f : 1.f;
      const float lm = logf(fabsf(f) + kMagTiny);
      v[a] = (ssum[a] * sg) * expf(lsum[a] - lm);
    }
    wht_inplace<Q>(v);
    float mx = -INFINITY;
#pragma unroll
    for (int a = 0; a < Q; ++a) {
      v[a] = logf(fmaxf(v[a] / (float)Q, kProbFloor));
      mx = fmaxf(mx, v[a]);
    }
#pragma unroll
    for (int a = 0; a < Q; ++a) o[j * js + (size_t)a * B] = v[a] - mx;
  }
}

template <int Q>
cudaError_t launch(const float* U, float* out, int M, int dc, int B,
                   cudaStream_t stream) {
  const dim3 grid((B + kThreads - 1) / kThreads, M);
  cn_qspa_kernel<Q><<<grid, kThreads, 0, stream>>>(U, out, dc, B);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cn_qspa_update(const float* U, float* out, int M, int dc, int q,
                              int B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q) {
    case 2: return launch<2>(U, out, M, dc, B, s);
    case 4: return launch<4>(U, out, M, dc, B, s);
    case 8: return launch<8>(U, out, M, dc, B, s);
    case 16: return launch<16>(U, out, M, dc, B, s);
    case 32: return launch<32>(U, out, M, dc, B, s);
    case 64: return launch<64>(U, out, M, dc, B, s);
    case 128: return launch<128>(U, out, M, dc, B, s);
    case 256: return launch<256>(U, out, M, dc, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// Shared by every entry point of the library: message for a returned code.
extern "C" const char* nbldpc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
