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
// Pad slots arrive as log-delta0 (spectrum all ones), so no masks. Every
// add is the plain version's: the WHT runs its stages in the plain order
// h = 1, 2, ..., q/2 as single lo + hi and lo - hi whichever lane holds
// them, and the softmax sum takes the association the plain version
// spells out (_softmax_sum): for q >= 32 the symbols of each residue mod
// 32 left to right, then a pairwise tree over the 32 residues; below, left
// to right.
//
// What bounds it on the H100: memory traffic. Each element is read once
// and written once (8 bytes) against some 30 flops, far below the card's
// flop/byte balance.
//
// Design: L lanes hold one (check, frame), lane gl of them holding the
// symbols gl, gl + L, ... (S = q / L a lane).
//  - q >= 32: L = 32 (a warp) at q = 128 and 256, L = 16 (two frames a
//    warp) at q = 32 and 64, the faster on an H100 (benchmarks/kernel_ab.py
//    builds k1_l32 and k1_l16: 1.04 against 1.18 ms at [96,12,64,2048],
//    4.19 against 5.15 ms at [80,7,256,4096]). WHT stages h < L run across lanes by
//    __shfl_xor_sync, the stages above in registers; a full warp's maxima
//    are __reduce_max_sync of order-preserving keys. A block of up to 8
//    warps takes consecutive frames of one check and stages each [q,
//    frames] slab through shared memory (slab.cuh), so loads and stores
//    run along B. Block barriers come only at the slab exchanges.
//  - q < 32: a thread per (check, frame) (L = 1), consecutive threads on
//    consecutive frames, so every access is coalesced as it stands.
// The next slot's loads are in flight while one is transformed (two slots
// ahead measured no faster). Pass 1
// keeps each slot's log-magnitudes and sign mask in shared memory (a
// thread's words at stride blockDim, so a warp's accesses meet no bank
// conflict), and pass 2 reads no global memory; about 70 registers a
// thread leave three 8-warp blocks an SM at q = 256, dc = 7. A block
// shrinks to one warp before its dc slots outgrow shared memory; past that
// (dc > ~190 at q = 256) the spectra are parked in `out` and read back, as
// the first design of this kernel did for every shape. Logs of normal
// inputs (the 1e-30 offset and the 1e-12 floor keep them so) run
// log_normal, logf's arithmetic without its special-case branches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "log_normal.cuh"
#include "slab.cuh"

namespace {

constexpr float kProbFloor = 1e-12f;
constexpr float kMagTiny = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // per-block dynamic shared memory, sm_90

// L lanes a (check, frame), S symbols a lane; for L > 1 each lane holds R
// of the softmax sum's 32 partials (symbols equal mod 32)
template <int Q>
struct Lay {
  static constexpr int L = Q < 32 ? 1 : (Q <= 64 ? 16 : 32);
  static constexpr int S = Q / L;
  static constexpr int R = L == 1 ? 1 : 32 / L;
};

__device__ __forceinline__ unsigned okey(float f) {
  unsigned u = __float_as_uint(f);
  u = u == 0x80000000u ? 0u : u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float ofloat(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// max over the frame's q symbols
template <int Q>
__device__ __forceinline__ float qmax(const float (&x)[Lay<Q>::S]) {
  float m = x[0];
#pragma unroll
  for (int s = 1; s < Lay<Q>::S; ++s) m = fmaxf(m, x[s]);
  if constexpr (Lay<Q>::L == 32) {
    m = ofloat(__reduce_max_sync(kFull, okey(m)));
  } else {
#pragma unroll
    for (int h = 1; h < Lay<Q>::L; h <<= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, h));
  }
  return m;
}

// Unnormalized WHT in the plain stage order h = 1, 2, ..., Q/2. Symbol
// gl + L s (gl: the lane's place among the frame's L lanes): stages h < L
// pair lanes (shuffles), stages h >= L pair the registers s and s + h / L.
template <int Q>
__device__ __forceinline__ void wht(float (&x)[Lay<Q>::S], int lane) {
  constexpr int L = Lay<Q>::L, S = Lay<Q>::S;
#pragma unroll
  for (int h = 1; h < L; h <<= 1) {
    const bool lo = (lane & h) == 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float y = __shfl_xor_sync(kFull, x[s], h);
      x[s] = lo ? x[s] + y : y - x[s];
    }
  }
#pragma unroll
  for (int h = 1; h < S; h <<= 1) {
#pragma unroll
    for (int base = 0; base < S; base += 2 * h) {
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float lo = x[base + i], hi = x[base + h + i];
        x[base + i] = lo + hi;
        x[base + h + i] = lo - hi;
      }
    }
  }
}

// In place: x -> WHT(softmax(x)). The sum in the plain version's
// association (_softmax_sum): for q >= 32, partial m (symbols m, m + 32,
// ... left to right) for each m < 32, then the tree over m, m ^ h at h =
// 1, 2, ..., 16: its steps h < L by shuffles, the rest between the R
// partials a lane holds (m = gl + L r: symbols s = r, r + R, ...).
template <int Q>
__device__ __forceinline__ void spectrum(float (&x)[Lay<Q>::S], int lane) {
  constexpr int L = Lay<Q>::L, S = Lay<Q>::S, R = Lay<Q>::R;
  const float mx = qmax<Q>(x);
#pragma unroll
  for (int s = 0; s < S; ++s) x[s] = expf(x[s] - mx);
  float part[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    part[r] = x[r];
#pragma unroll
    for (int s = r + R; s < S; s += R) part[r] = part[r] + x[s];
  }
#pragma unroll
  for (int h = 1; h < L; h <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) part[r] = part[r] + __shfl_xor_sync(kFull, part[r], h);
  }
#pragma unroll
  for (int h = 1; h < R; h <<= 1) {
#pragma unroll
    for (int r = 0; r < R; r += 2 * h) part[r] = part[r] + part[r + h];
  }
#pragma unroll
  for (int s = 0; s < S; ++s) x[s] = x[s] / part[0];
  wht<Q>(x, lane);
}

// In place: leave-one-out G -> log(max(WHT(G) / Q, floor)) - its max.
template <int Q>
__device__ __forceinline__ void finish(float (&v)[Lay<Q>::S], int lane) {
  wht<Q>(v, lane);
#pragma unroll
  for (int s = 0; s < Lay<Q>::S; ++s) v[s] = log_normal(fmaxf(v[s] / (float)Q, kProbFloor));
  const float mx = qmax<Q>(v);
#pragma unroll
  for (int s = 0; s < Lay<Q>::S; ++s) v[s] = v[s] - mx;
}

// PARK: the spectra parked in `out` instead of shared memory. 2^lg_fb
// frames a block: blockDim / L.
template <int Q, bool PARK>
__global__ void __launch_bounds__(Lay<Q>::L == 1 ? 128 : 256, Lay<Q>::L == 1 ? 6 : 3)
cn_qspa_kernel(const float* __restrict__ U, float* __restrict__ out, int dc, int B,
               int lg_fb) {
  constexpr int L = Lay<Q>::L, S = Lay<Q>::S;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int gl = lane & (L - 1);                     // symbols gl + L s
  const int w = threadIdx.x / L;                     // the block's frame
  const int b0 = blockIdx.x << lg_fb;
  const int b = b0 + threadIdx.x;                    // L = 1: the thread's frame
  const int ld = (1 << lg_fb) + 1;
  if (L == 1 && b >= B) return;                      // no barriers when L = 1
  const size_t js = (size_t)Q * B;                   // stride between slots
  const float* Um = U + (size_t)blockIdx.y * dc * js;
  float* Om = out + (size_t)blockIdx.y * dc * js;
  float* slab = smem;
  // [dc][S] log-magnitudes, then [dc] sign masks, a thread's at stride blockDim
  float* kept = smem + (L == 1 ? 0 : Q * ld) + threadIdx.x;
  unsigned* sgn = reinterpret_cast<unsigned*>(kept + (size_t)dc * S * blockDim.x);

  // slot j of src -> next (L > 1: the thread's share of the slab)
  float next[S];
  auto fetch = [&](const float* src, int j) {
    if constexpr (L == 1) {
#pragma unroll
      for (int s = 0; s < S; ++s) next[s] = src[j * js + (size_t)s * B + b];
    } else {
      slab_fetch<S>(next, src + j * js, B, b0, lg_fb);
    }
  };
  // x = slot j (fetched into next), then slot j + 1's loads in flight
  auto load = [&](const float* src, int j, float (&x)[S]) {
    if constexpr (L == 1) {
#pragma unroll
      for (int s = 0; s < S; ++s) x[s] = next[s];
    } else {
      slab_put<S>(slab, next, lg_fb);
#pragma unroll
      for (int s = 0; s < S; ++s) x[s] = slab[(gl + L * s) * ld + w];
    }
    if (j + 1 < dc) fetch(src, j + 1);
  };
  auto store = [&](float* dst, int j, const float (&x)[S]) {
    if constexpr (L == 1) {
#pragma unroll
      for (int s = 0; s < S; ++s) dst[j * js + (size_t)s * B + b] = x[s];
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) slab[(gl + L * s) * ld + w] = x[s];
      slab_store<S>(slab, dst + j * js, B, b0, lg_fb);
    }
  };
  // the log-magnitudes of spectrum x, and its sign mask
  auto logmag = [&](const float (&x)[S], float (&lm)[S]) {
    unsigned sg = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      lm[s] = log_normal(fabsf(x[s]) + kMagTiny);
      sg |= (x[s] < 0.f ? 1u : 0u) << s;
    }
    return sg;
  };

  // pass 1: softmax -> WHT spectra -> log-magnitude sums and signs
  float lsum[S];
  unsigned ssum = 0;                                 // bit s: sign of the product
#pragma unroll
  for (int s = 0; s < S; ++s) lsum[s] = 0.f;
  fetch(Um, 0);
  for (int j = 0; j < dc; ++j) {
    float x[S], lm[S];
    load(Um, j, x);
    spectrum<Q>(x, lane);
    const unsigned sg = logmag(x, lm);
#pragma unroll
    for (int s = 0; s < S; ++s) lsum[s] += lm[s];
    ssum ^= sg;
    if constexpr (PARK) {
      store(Om, j, x);
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) kept[(j * S + s) * blockDim.x] = lm[s];
      sgn[j * blockDim.x] = sg;
    }
  }
  // pass 2: leave-one-out product -> inverse WHT -> floor -> log -> renorm
  if constexpr (PARK) fetch(Om, 0);
  for (int j = 0; j < dc; ++j) {
    float v[S], lm[S];
    unsigned sg;
    if constexpr (PARK) {
      load(Om, j, v);
      sg = logmag(v, lm);
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) lm[s] = kept[(j * S + s) * blockDim.x];
      sg = sgn[j * blockDim.x];
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float e = expf(lsum[s] - lm[s]);
      v[s] = ((ssum ^ sg) >> s) & 1u ? -e : e;
    }
    finish<Q>(v, lane);
    store(Om, j, v);
  }
}

// Bytes of shared memory for blocks of `threads`, with the spectra kept.
template <int Q>
size_t smem_bytes(int threads, int dc) {
  constexpr int L = Lay<Q>::L, S = Lay<Q>::S;
  const size_t slab = L == 1 ? 0 : (size_t)Q * (threads / L + 1);
  return (slab + (size_t)threads * dc * (S + 1)) * sizeof(float);
}

template <int Q>
cudaError_t launch(const float* U, float* out, int M, int dc, int B, cudaStream_t stream) {
  constexpr int L = Lay<Q>::L;
  if (M > 65535) return cudaErrorInvalidValue;
  int threads = L == 1 ? 128 : 256;
  while (threads > 32 && smem_bytes<Q>(threads, dc) > kMaxSmem) threads /= 2;
  const bool park = smem_bytes<Q>(threads, dc) > kMaxSmem;
  const size_t bytes = park ? smem_bytes<Q>(threads, 0) : smem_bytes<Q>(threads, dc);
  const int fb = threads / L;
  auto kernel = park ? cn_qspa_kernel<Q, true> : cn_qspa_kernel<Q, false>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3((B + fb - 1) / fb, M), threads, bytes, stream>>>(U, out, dc, B,
                                                                 __builtin_ctz(fb));
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
