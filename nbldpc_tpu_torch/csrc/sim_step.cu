// The Monte-Carlo step's work around the decode, f32 and int32: the channel,
// decode_bl's entry and the error counters.
//
// Replaces no Pallas kernel: JAX's jitted sim step (nbldpc_tpu/sim.py:141-167)
// leaves all three to XLA, which fuses each into a loop or two on the TPU:
// the noise and `llr_init` (sim.py:151-152, channel.py:46-59), the transpose,
// normalization and first decision of decode_bl (decoders/common.py:200-204)
// and the counters (sim.py:153-167). The port ran them as chains of PyTorch
// ops: p products and p - 1 adds of a whole [S, B, N, q] tensor for the
// channel, an amax, a subtraction, a transposing copy and an argmax for the
// entry, about fifteen small launches for the counters.
//
// channel_llr: noise [S, B, N, p], sig [S], scale [S], cw [S, B, N] or none
//   -> llr [S, B, N, q]
//   y_t = x_t + sig_s noise_t, x_t = 1 - 2 bit_t(cw) (1 with no codeword);
//   acc(a) = y_0 bit_0(a), then acc(a) = acc(a) + y_t bit_t(a) for t = 1 ..
//   p - 1; llr(a) = scale_s (-acc(a)), scale_s = 2 / sig_s^2 computed by the
//   wrapper with the plain version's torch ops. Each product y_t bit_t(a) is
//   formed as the plain version forms it (bit_t(a) a float 0 or 1), so signed
//   zeros agree too.
// prior_bl: llr [B, N, q] -> prior [N, q, B] = llr - max over q, and hard0
//   [N, B], the first index of the largest normalized value (a NaN counts as
//   largest, as in torch.argmax).
// count_errors: hard [S B, N], cw [S, B, N] or none, iters [S B], done [S B]
//   -> out [6, S] int64 (zeroed by the wrapper): frames, frames with a
//   symbol error, symbol errors, bit errors (the popcount of the low p bits
//   of hard ^ cw), the iteration sum and the converged frames.
// Only IEEE adds, subtractions and products in the plain versions'
// association, a max and an argmax, and the build has no fused
// multiply-adds: the two float kernels agree with the plain versions bit
// for bit. The counters are integer sums, exact in any order.
//
// What bounds them on the H100: bytes. channel_llr reads p floats a row and
// writes q; at config 5's step (GF(256), 4096 frames of N = 255) it writes
// 1.07 GB (0.33 ms at 3.35 TB/s). prior_bl reads and writes the same 1.07 GB
// once more (0.64 ms). count_errors reads 4 bytes a symbol (8 with a
// codeword): microseconds, where the launches count more than the bytes.
//
// Design: channel_llr gives a warp one row at q >= 32, lanes across the
// symbols (q / 32 a lane), or 32 / q rows below that, so that every warp
// writes 32 contiguous floats an instruction; the p values of y sit in
// registers, read once a row (one broadcast load a value). prior_bl gives a
// block one variable and tiles of 32 frames: the 32 rows of q floats are read
// into shared memory along q, a warp takes the max and argmax of a frame by
// shuffles, and the tile leaves along B, 32 frames (128 bytes) a row. The
// shared tile is padded to q + 1 columns, so neither pass has a bank
// conflict. count_errors gives a block 64 frames of one SNR slot, a warp a
// frame at a time with lanes across N; the warps' sums meet in shared memory
// and one thread adds the block's six to the output with 64-bit atomics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // a block: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;             // prior_bl: frames a tile
constexpr int kCountFrames = 64;      // count_errors: frames a block
constexpr int kMaxGrid = 65535;       // more rows or tiles than this loop in a block
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int log2i(int q) { return q <= 1 ? 0 : 1 + log2i(q / 2); }

// the max as torch.amax takes it: a NaN wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// whether (x, i) beats (y, j) in torch.argmax: a NaN beats any number (the
// first NaN wins), a larger value beats a smaller one, a tie goes to the
// lower index
__device__ __forceinline__ bool beats(float x, int i, float y, int j) {
  if (x != x) return y != y ? i < j : true;
  if (y != y) return false;
  return x == y ? i < j : x > y;
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
channel_llr_kernel(const float* __restrict__ noise, const float* __restrict__ sig,
                   const float* __restrict__ scale, const int* __restrict__ cw,
                   float* __restrict__ llr, long long rows, long long rows_per_slot) {
  constexpr int P = log2i(Q);
  constexpr int L = Q < 32 ? Q : 32;          // lanes a row
  constexpr int RW = 32 / L;                  // rows a warp
  constexpr int SL = Q / L;                   // symbols a lane
  const int lane = threadIdx.x & 31;
  const int sub = lane / L, a0 = lane % L;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r0 = warp * RW; r0 < rows; r0 += warps * RW) {
    const long long row = r0 + sub;
    if (row >= rows) continue;
    const long long s = row / rows_per_slot;
    const float sg = sig[s], sc = scale[s];
    const float* nz = noise + row * P;
    const int c = cw == nullptr ? 0 : cw[row];
    float y[P];
#pragma unroll
    for (int t = 0; t < P; ++t) {
      const float x = cw == nullptr ? 1.f : 1.f - 2.f * static_cast<float>((c >> t) & 1);
      y[t] = x + sg * nz[t];
    }
    float* out = llr + row * Q;
#pragma unroll
    for (int k = 0; k < SL; ++k) {
      const int a = a0 + k * L;
      float acc = y[0] * static_cast<float>(a & 1);
#pragma unroll
      for (int t = 1; t < P; ++t) acc = acc + y[t] * static_cast<float>((a >> t) & 1);
      out[a] = sc * -acc;
    }
  }
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
prior_bl_kernel(const float* __restrict__ llr, float* __restrict__ prior,
                int* __restrict__ hard, int N, int B) {
  constexpr int KP = Q < 32 ? 1 : Q / 32;     // symbols a lane
  __shared__ float v[kTile][Q + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x;
  const int tiles = (B + kTile - 1) / kTile;
  for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
    const int b0 = t * kTile;
    const int nb = B - b0 < kTile ? B - b0 : kTile;
    for (int i = threadIdx.x; i < nb * Q; i += kThreads) {
      const int f = i / Q, a = i % Q;
      v[f][a] = llr[(static_cast<size_t>(b0 + f) * N + n) * Q + a];
    }
    __syncthreads();
    for (int f = warp; f < nb; f += kWarps) {
      // below q = 32 the lanes past q repeat symbols: neither the max nor
      // the argmax changes, and only the first q lanes write back
      float x[KP];
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        x[k] = v[f][Q < 32 ? lane % Q : lane + 32 * k];
        m = nan_max(m, x[k]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_xor_sync(kFull, m, off));
      float best = 0.f;
      int bi = -1;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int a = Q < 32 ? lane % Q : lane + 32 * k;
        x[k] = x[k] - m;
        if (bi < 0 || beats(x[k], a, best, bi)) {
          best = x[k];
          bi = a;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        if (beats(ob, oi, best, bi)) {
          best = ob;
          bi = oi;
        }
      }
      __syncwarp();
      if (Q >= 32 || lane < Q) {
#pragma unroll
        for (int k = 0; k < KP; ++k) v[f][Q < 32 ? lane : lane + 32 * k] = x[k];
      }
      if (lane == 0) hard[static_cast<size_t>(n) * B + b0 + f] = bi;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < Q * kTile; i += kThreads) {
      const int a = i / kTile, f = i % kTile;
      if (f < nb) prior[(static_cast<size_t>(n) * Q + a) * B + b0 + f] = v[f][a];
    }
    __syncthreads();                            // v is rewritten next tile
  }
}

__global__ void __launch_bounds__(kThreads)
count_errors_kernel(const int* __restrict__ hard, const int* __restrict__ cw,
                    const int* __restrict__ iters, const uint8_t* __restrict__ done,
                    unsigned long long* __restrict__ out, int S, int B, int N, int mask) {
  __shared__ long long part[kWarps][6];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = blockIdx.y;
  const int f0 = blockIdx.x * kCountFrames;
  const int f1 = B - f0 < kCountFrames ? B : f0 + kCountFrames;
  long long acc[6] = {0, 0, 0, 0, 0, 0};
  for (int f = f0 + warp; f < f1; f += kWarps) {
    const size_t row = static_cast<size_t>(s) * B + f;
    const int* h = hard + row * N;
    const int* c = cw == nullptr ? nullptr : cw + row * N;
    unsigned sym = 0, bits = 0;
    for (int n = lane; n < N; n += 32) {
      const int d = c == nullptr ? h[n] : h[n] ^ c[n];
      sym += d != 0;
      bits += __popc(d & mask);
    }
    sym = __reduce_add_sync(kFull, sym);
    bits = __reduce_add_sync(kFull, bits);
    acc[0] += 1;
    acc[1] += sym != 0;
    acc[2] += sym;
    acc[3] += bits;
    acc[4] += iters[row];
    acc[5] += done[row] != 0;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) part[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += part[w][threadIdx.x];
    atomicAdd(out + static_cast<size_t>(threadIdx.x) * S + s,
              static_cast<unsigned long long>(total));
  }
}

int grid_for(long long units, int per_block) {
  const long long blocks = (units + per_block - 1) / per_block;
  return static_cast<int>(blocks < kMaxGrid ? blocks : kMaxGrid);
}

template <int Q>
cudaError_t launch_channel(const float* noise, const float* sig, const float* scale,
                           const int* cw, float* llr, int S, int B, int N,
                           cudaStream_t stream) {
  if (S < 1 || B < 1 || N < 1) return cudaErrorInvalidValue;
  constexpr int RW = Q < 32 ? 32 / Q : 1;
  const long long rows = static_cast<long long>(S) * B * N;
  channel_llr_kernel<Q><<<grid_for(rows, kWarps * RW), kThreads, 0, stream>>>(
      noise, sig, scale, cw, llr, rows, static_cast<long long>(B) * N);
  return cudaGetLastError();
}

template <int Q>
cudaError_t launch_prior(const float* llr, float* prior, int* hard, int N, int B,
                         cudaStream_t stream) {
  if (N < 1 || B < 1) return cudaErrorInvalidValue;
  const int tiles = (B + kTile - 1) / kTile;
  const dim3 grid(N, tiles < kMaxGrid ? tiles : kMaxGrid);
  prior_bl_kernel<Q><<<grid, kThreads, 0, stream>>>(llr, prior, hard, N, B);
  return cudaGetLastError();
}

}  // namespace

#define SIM_STEP_DISPATCH(call)                   \
  switch (q) {                                    \
    case 2: return call(2);                       \
    case 4: return call(4);                       \
    case 8: return call(8);                       \
    case 16: return call(16);                     \
    case 32: return call(32);                     \
    case 64: return call(64);                     \
    case 128: return call(128);                   \
    case 256: return call(256);                   \
    default: return cudaErrorInvalidValue;        \
  }

// noise [S, B, N, p], sig and scale [S] f32, cw [S, B, N] int32 or null ->
// llr [S, B, N, q]
extern "C" int channel_llr(const float* noise, const float* sig, const float* scale,
                           const int* cw, float* llr, int S, int B, int N, int q,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CHANNEL(Q) launch_channel<Q>(noise, sig, scale, cw, llr, S, B, N, st)
  SIM_STEP_DISPATCH(CHANNEL)
#undef CHANNEL
}

// llr [B, N, q] f32 -> prior [N, q, B] f32, hard [N, B] int32
extern "C" int prior_bl(const float* llr, float* prior, int* hard, int N, int q, int B,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PRIOR(Q) launch_prior<Q>(llr, prior, hard, N, B, st)
  SIM_STEP_DISPATCH(PRIOR)
#undef PRIOR
}

// hard [S B, N] int32, cw [S B, N] int32 or null, iters [S B] int32, done
// [S B] bool -> out [6, S] int64, added to (the caller zeroes it)
extern "C" int count_errors(const int* hard, const int* cw, const int* iters,
                            const uint8_t* done, long long* out, int S, int B, int N, int p,
                            void* stream) {
  if (S < 1 || S > kMaxGrid || B < 1 || N < 0 || p < 1 || p > 30) return cudaErrorInvalidValue;
  const int blocks = (B + kCountFrames - 1) / kCountFrames;
  count_errors_kernel<<<dim3(blocks, S), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      hard, cw, iters, done, reinterpret_cast<unsigned long long*>(out), S, B, N,
      (1 << p) - 1);
  return cudaGetLastError();
}
