// The routing of one decode_bl iteration, batch-last, f32: the two halves
// around the check-node update.
//
// Replaces no Pallas kernel: JAX's decode_bl (nbldpc_tpu/decoders/common.py,
// the loop body's "vn_update" scope, :215-218, and its "posterior" scope,
// :221-223) leaves both to XLA, which fuses each scope into a few loops on
// the TPU. The port ran them as a chain of PyTorch ops, each writing a whole
// message tensor to device memory.
//
// route_down (vn_update): posterior [N, q, B], Cv [N, dv, q, B] -> U [M, dc, q, B]
//   for a real CN slot (m, j) and symbol x, with (n, k, s) the source row
//   down_idx[m, j, x] = (n dv + k) q + s:
//     V(s) = posterior[n, s] - Cv[n, k, s];   U[m, j, x] = V(s) - max_s V
//   a pad CN slot gets log-delta0: 0 at x = 0, PAD_NEG elsewhere.
// route_up (posterior): Chat [M, dc, q, B], llr [N, q, B] -> Cv, posterior
//   Cv[n, k, s] = Chat row up_idx[n, k, s] (0 on a pad VN slot);
//   posterior[n, s] = llr[n, s] + the sum over k of Cv[n, k, s]
// Only subtractions, a max and adds, each in the association of the plain
// versions (kernels/route.py), and the build has no fused multiply-adds,
// so the kernels agree with the plain versions on the card bit for bit
// (signed zeros aside: a max over +0 and -0 may keep either, and the two
// compare equal). The plain sum is torch's CUDA reduction over the slots,
// which keeps four accumulators: slot k goes to accumulator k mod 4, each
// adds its slots in order starting from 0, and the four are added in order,
// ((a0 + a1) + a2) + a3. For dv <= 4 that is left to right, as torch's CPU
// sum and XLA's; above, the card's plain version and this kernel round
// alike, and the CPU's in another order.
//
// What bounds them on the H100: bytes. Every input row is read once and
// every output row written once; at config 5's step (GF(256) (255,175), 4096
// frames) route_down moves 5.56 GB (1.66 ms at 3.35 TB/s) and route_up 6.42
// GB (1.92 ms).
//
// Design: a block owns one CN slot (route_down) or one variable (route_up)
// and tiles of 32 frames, lane = frame, so every row read or written is 32
// contiguous floats (128 bytes) and a warp moves one row an instruction;
// the block's W = min(q, 8) warps take the rows w, w + W, ... . route_down
// keeps the slot's V rows in shared memory (q x 32 floats, 32 KB at q =
// 256): its first pass reads each source row once and forms V and each
// lane's max over the warp's rows, the W partial maxima meet in shared
// memory, and the second pass writes U row x from V row s(x), with no second
// read of device memory. The q rows of a CN slot are a permutation of one
// VN slot's q rows, so the max over them is the max over s and the kernel
// needs no inverse table. route_up needs no shared memory: a warp keeps its
// q / W posterior sums in registers and gathers slot by slot, all its rows
// of a slot in flight at once (for dv > 4, torch's association needs four
// sums a row: there it takes a row at a time).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;             // frames a tile: a warp's lanes
constexpr int kMaxGridY = 65535;      // more tiles than this loop in a block
constexpr float kPadNeg = -1e30f;     // graph.PAD_NEG
constexpr int kSumAcc = 4;            // torch's CUDA reduction: accumulators a thread

template <int Q>
struct Shape {
  static constexpr int kWarps = Q < 8 ? Q : 8;
  static constexpr int kRows = Q / kWarps;      // rows a warp
};

// the max as torch.amax takes it: a NaN wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

template <int Q>
__global__ void __launch_bounds__(32 * Shape<Q>::kWarps)
route_down_kernel(const float* __restrict__ post, const float* __restrict__ cv,
                  float* __restrict__ U, const int* __restrict__ down_idx,
                  const uint8_t* __restrict__ cn_mask, int dv, int B) {
  constexpr int W = Shape<Q>::kWarps, R = Shape<Q>::kRows;
  __shared__ float v[Q][kTile];
  __shared__ float part[W][kTile];
  __shared__ int src[Q];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t slot = blockIdx.x;
  float* out = U + slot * Q * (size_t)B;
  const int tiles = (B + kTile - 1) / kTile;
  if (!cn_mask[slot]) {                          // pad slot: log-delta0
    for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
      const int b = t * kTile + lane;
      if (b >= B) continue;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int x = warp + i * W;
        out[(size_t)x * B + b] = x == 0 ? 0.f : kPadNeg;
      }
    }
    return;
  }
  for (int x = threadIdx.x; x < Q; x += blockDim.x) src[x] = down_idx[slot * Q + x];
  __syncthreads();
  const int vrow = src[0] / Q;                   // the VN slot n dv + k
  const int base = vrow * Q;
  const float* P = post + (size_t)(vrow / dv) * Q * B;
  const float* C = cv + (size_t)base * B;
  for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
    const int b = t * kTile + lane;
    const bool in = b < B;
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int s = warp + i * W;
      const float val = in ? P[(size_t)s * B + b] - C[(size_t)s * B + b] : 0.f;
      v[s][lane] = val;
      mx = nan_max(mx, val);
    }
    part[warp][lane] = mx;
    __syncthreads();
    mx = part[0][lane];
#pragma unroll
    for (int w = 1; w < W; ++w) mx = nan_max(mx, part[w][lane]);
    if (in) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int x = warp + i * W;
        out[(size_t)x * B + b] = v[src[x] - base][lane] - mx;
      }
    }
    __syncthreads();                             // v and part are rewritten next tile
  }
}

template <int Q>
__global__ void __launch_bounds__(32 * Shape<Q>::kWarps)
route_up_kernel(const float* __restrict__ chat, const float* __restrict__ llr,
                float* __restrict__ cv, float* __restrict__ post,
                const int* __restrict__ up_idx, const uint8_t* __restrict__ vn_mask,
                int dv, int B) {
  constexpr int W = Shape<Q>::kWarps, R = Shape<Q>::kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t n = blockIdx.x;
  const int tiles = (B + kTile - 1) / kTile;
  for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
    const int b = t * kTile + lane;
    if (b >= B) continue;
    if (dv > kSumAcc) {                          // a row at a time, kSumAcc accumulators
      for (int i = 0; i < R; ++i) {
        const int s = warp + i * W;
        float part[kSumAcc] = {0.f, 0.f, 0.f, 0.f};
        for (int k0 = 0; k0 < dv; k0 += kSumAcc) {
#pragma unroll
          for (int j = 0; j < kSumAcc; ++j) {
            if (k0 + j >= dv) break;
            const size_t e = n * dv + k0 + j;
            const float c = vn_mask[e] ? chat[(size_t)up_idx[e * Q + s] * B + b] : 0.f;
            cv[(e * Q + s) * B + b] = c;
            part[j] = part[j] + c;
          }
        }
        const size_t at = (n * Q + s) * B + b;
        post[at] = llr[at] + (((part[0] + part[1]) + part[2]) + part[3]);
      }
      continue;
    }
    // dv <= kSumAcc: the slots left to right, all the warp's rows at once
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
    for (int k = 0; k < dv; ++k) {
      const size_t e = n * dv + k;
      const bool real = vn_mask[e] != 0;
      const int* idx = up_idx + e * Q;
      float* out = cv + e * Q * (size_t)B + b;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int s = warp + i * W;
        const float c = real ? chat[(size_t)idx[s] * B + b] : 0.f;
        out[(size_t)s * B] = c;
        acc[i] = acc[i] + c;
      }
    }
    const size_t row = n * Q;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const size_t at = (row + warp + i * W) * B + b;
      post[at] = llr[at] + acc[i];
    }
  }
}

template <int Q>
cudaError_t launch_down(const float* post, const float* cv, float* U, const int* down_idx,
                        const uint8_t* cn_mask, int slots, int dv, int B,
                        cudaStream_t stream) {
  if (slots < 1 || dv < 1 || B < 1) return cudaErrorInvalidValue;
  const int tiles = (B + kTile - 1) / kTile;
  const dim3 grid(slots, tiles < kMaxGridY ? tiles : kMaxGridY);
  route_down_kernel<Q><<<grid, 32 * Shape<Q>::kWarps, 0, stream>>>(
      post, cv, U, down_idx, cn_mask, dv, B);
  return cudaGetLastError();
}

template <int Q>
cudaError_t launch_up(const float* chat, const float* llr, float* cv, float* post,
                      const int* up_idx, const uint8_t* vn_mask, int N, int dv, int B,
                      cudaStream_t stream) {
  if (N < 1 || dv < 1 || B < 1) return cudaErrorInvalidValue;
  const int tiles = (B + kTile - 1) / kTile;
  const dim3 grid(N, tiles < kMaxGridY ? tiles : kMaxGridY);
  route_up_kernel<Q><<<grid, 32 * Shape<Q>::kWarps, 0, stream>>>(
      chat, llr, cv, post, up_idx, vn_mask, dv, B);
  return cudaGetLastError();
}

}  // namespace

#define ROUTE_DISPATCH(call)                      \
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

// slots = M dc_max; down_idx [M, dc_max, q] int32, cn_mask [M, dc_max] bool
extern "C" int route_down(const float* post, const float* cv, float* U, const int* down_idx,
                          const uint8_t* cn_mask, int slots, int dv, int q, int B,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DOWN(Q) launch_down<Q>(post, cv, U, down_idx, cn_mask, slots, dv, B, s)
  ROUTE_DISPATCH(DOWN)
#undef DOWN
}

// up_idx [N, dv_max, q] int32, vn_mask [N, dv_max] bool
extern "C" int route_up(const float* chat, const float* llr, float* cv, float* post,
                        const int* up_idx, const uint8_t* vn_mask, int N, int dv, int q,
                        int B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UP(Q) launch_up<Q>(chat, llr, cv, post, up_idx, vn_mask, N, dv, B, s)
  ROUTE_DISPATCH(UP)
#undef UP
}
