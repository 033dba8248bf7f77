// One T-EMS check-node phase, batch-last: U [M, dc, q, B] f32 -> same.
//
// Replaces: nbldpc_tpu/kernels/cn_tems.py, _cn_kernel /
// tems_cn_update_bl_pallas (the Pallas K5 kernel).
//
// Math, per check m and frame b: exactly the plain version,
// nbldpc_tpu_torch/decoders/tems.py (tems_cn_update_bl):
//   x_j = U_j - max_q U_j;  z_j = argmax_q x_j (ties: lowest symbol);
//   dU_j[a] = x_j[a ^ z_j];  beta = XOR_j z_j
//   per row a, the top-3 (value, column) of dU_j[a] over j in column order
//   with strict >, so ties keep the earlier column: (m1, c1, m2, c2, m3)
//   per column j: m1x = c1 == j ? m2 : m1,  c1x = c1 == j ? c2 : c1,
//                 m2x = (c1 == j || c2 == j) ? m3 : m2
//   cand(e1, e2) = c1x[e1] == c1x[e2] ? max(m1x[e1] + m2x[e2],
//                  m2x[e1] + m1x[e2]) : m1x[e1] + m1x[e2]
//   n_r = 0: dW[eta] = max(m1x[eta], cand(e1, eta ^ e1) for e1 != 0, eta)
//   n_r > 0: e1 runs over n_r rounds of (max of m1x, lowest row reaching
//            it, set it to 2 NEG), row 0 starting at 2 NEG; e2 != 0 free
//   dW[0] = 0;  C_j[a] = dW[a ^ beta ^ z_j];  out = min((C - max C) + offset, 0)
// Every candidate is one add; the rest is max and select, exact in any
// order, so the kernel agrees with the plain version bit for bit.
//
// What bounds it on the H100: on-chip work. Each element is read once and
// written once (8 bytes), 0.180 ms at BASELINE config 4's [96,12,64,1024].
// The exact scan is q (q - 1) candidates per column and (check, frame), 48 k
// at GF(64) with dc = 12, each three shared-memory reads and about a dozen
// instructions; the n_r scan is n_r argmax rounds and n_r q candidates per
// column.
//
// The first design lost its time to issue and barriers: every argmax
// round was 10 dependent shuffles (value and index, 5 steps), 960 shuffles
// of the 96 rounds per (check, frame) at config 4 among ~2,230 shared-memory
// and shuffle instructions; and every column was staged alone through
// shared memory by the whole block, 4 __syncthreads per column, one
// column's loads in flight at a time, rows read in 32-byte runs (8 frames).
//
// Design: threads across symbols. A group of W = min(q, 32) lanes of one
// warp owns one (check, frame), lane l owning rows l, l + 32, ... (q / 32
// rows each for q >= 32). A group max is one warp reduction (q >= 32:
// __reduce_max_sync of order-preserving 32-bit keys) and an argmax two: the
// max key, then __reduce_min_sync of the lowest row reaching it, which is
// the plain version's tie rule; narrower groups reduce by W-lane shuffles.
// The per-row top-3 table stays in registers; the current column's (m1x,
// m2x, c1x) rows sit in shared memory, one block of 3 q words per group so
// that one address serves the three reads of a row, and the reads of row
// eta ^ e1 are a permutation inside an aligned block of 32 (no bank
// conflicts); row 0 holds -inf there, so a zero second deviation needs no
// test (its candidate loses every max, as the plain version's NEG). A block
// of up to 16 warps (fewer where three such blocks would not fit an SM)
// takes consecutive frames of one check (16 frames for q >= 32 at BASELINE
// config 4's shape, so every row is a 64-byte run) and stages its whole [dc, q,
// frames] tile once with cp.async, frame-major (a frame's dc q entries at a
// stride padded so the copies meet no bank conflict); the outputs overwrite
// the tile in place and leave in one pass. One barrier in, one barrier out,
// none per column. Frames past B compute on zeros and store nothing.
//
// Frame list: given `active` (n_active ascending frame indices, int32),
// block i takes the list's entries i * frames ... i * frames + frames - 1
// in place of frames i * frames ...: the same copies from and to those
// columns, the same arithmetic in between, so each listed (check, frame)
// comes out bit for bit as at full width, and every other column of `out`
// is left as it was. decoders/common.decode_bl lists the frames whose
// syndrome does not hold yet. A dense list keeps neighbouring frames in one
// block, so the rows stay in runs. Entries past n_active compute on zeros
// and store nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDc = 32;
constexpr int kMaxWarps = 16;
constexpr size_t kMaxSmem = 232448;  // per-block dynamic shared memory, sm_90

template <int Q>
struct Shape {
  static constexpr int kWidth = Q < 32 ? Q : 32;      // lanes of one group
  static constexpr int kSyms = Q / kWidth;            // rows per lane
  static constexpr int kPerWarp = 32 / kWidth;        // frames per warp
};

// Order-preserving 32-bit key of a float (-0 keyed as +0, as max and >
// treat them), and back.
__device__ __forceinline__ unsigned okey(float f) {
  unsigned u = __float_as_uint(f);
  u = u == 0x80000000u ? 0u : u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float ofloat(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// max / min of v over the W lanes of the group
template <int W>
__device__ __forceinline__ unsigned group_max(unsigned v) {
  if constexpr (W == 32) {
    return __reduce_max_sync(kFull, v);
  } else {
#pragma unroll
    for (int h = 1; h < W; h <<= 1) v = max(v, __shfl_xor_sync(kFull, v, h, W));
    return v;
  }
}

template <int W>
__device__ __forceinline__ unsigned group_min(unsigned v) {
  if constexpr (W == 32) {
    return __reduce_min_sync(kFull, v);
  } else {
#pragma unroll
    for (int h = 1; h < W; h <<= 1) v = min(v, __shfl_xor_sync(kFull, v, h, W));
    return v;
  }
}

// max over the group of the lane's NS values
template <int Q>
__device__ __forceinline__ float lanes_fmax(const float (&x)[Shape<Q>::kSyms]) {
  unsigned k = okey(x[0]);
#pragma unroll
  for (int s = 1; s < Shape<Q>::kSyms; ++s) k = max(k, okey(x[s]));
  return ofloat(group_max<Shape<Q>::kWidth>(k));
}

// (max key, lowest row reaching it) over the group of the lane's keys k;
// lane l holds rows l + W s
template <int Q>
__device__ __forceinline__ int lanes_argmax(const unsigned (&k)[Shape<Q>::kSyms], int l,
                                            unsigned& mx) {
  constexpr int W = Shape<Q>::kWidth;
  unsigned best = k[0];
  int idx = l;
#pragma unroll
  for (int s = 1; s < Shape<Q>::kSyms; ++s) {
    if (k[s] > best) {                  // strict: the lane's lowest row
      best = k[s];
      idx = l + W * s;
    }
  }
  mx = group_max<W>(best);
  return (int)group_min<W>(best == mx ? (unsigned)idx : 0xffffffffu);
}

__device__ __forceinline__ void copy4_async(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// Floats of the frame-major tile of one frame: its dc q entries padded so
// that frame f starts at bank (f * pad_unit) mod 32, pad_unit = 32 / G for
// G < 32 frames per block (the copy of one row spans 32 / G rows of a warp)
// and 1 from 32 frames up.
__host__ __device__ __forceinline__ int frame_stride(int dc, int q, int frames) {
  const int unit = frames >= 32 ? 1 : 32 / frames;
  return dc * q + ((unit - dc * q) % 32 + 32) % 32;
}

template <int Q>
size_t smem_bytes(int dc, int warps) {
  const int frames = warps * Shape<Q>::kPerWarp;
  return (size_t)frames * (frame_stride(dc, Q, frames) + 3 * Q + kMaxDc) * sizeof(float);
}

template <int Q>
__global__ void __launch_bounds__(32 * kMaxWarps)
cn_tems_kernel(const float* __restrict__ U, float* __restrict__ out, int dc, int B,
               int n_r, float offset, int lg_frames, const int* __restrict__ active,
               int n_active) {
  constexpr int W = Shape<Q>::kWidth;
  constexpr int NS = Shape<Q>::kSyms;
  extern __shared__ float smem[];
  const int frames = 1 << lg_frames;
  const int S = frame_stride(dc, Q, frames);
  float* tile = smem;                              // [frames, S]: in, scratch, out
  float* sX = tile + (size_t)frames * S;           // [frames, 3 Q] the column's
                                                   // m1x, m2x, c1x rows
  int* sZ = reinterpret_cast<int*>(sX + frames * 3 * Q);   // [frames, kMaxDc] z_j

  const int g = threadIdx.x / W;
  const int l = threadIdx.x % W;
  const int b0 = blockIdx.x * frames;
  const size_t js = (size_t)Q * B;
  const float* Um = U + (size_t)blockIdx.y * dc * js;
  float* Om = out + (size_t)blockIdx.y * dc * js;
  const int entries = dc * Q * frames;
  // the block's frames x W threads: each copies the rows of one frame, its
  // column `col` of U and of out
  const int fc = threadIdx.x & (frames - 1);
  const int i = b0 + fc;
  const bool valid = i < (active ? n_active : B);
  const int col = !valid ? 0 : (active ? active[i] : i);
  float* Tc = tile + (size_t)fc * S;

  // ---- the block's whole tile, once: row-major in U, frame-major here ----
  for (int e = threadIdx.x; e < entries; e += blockDim.x)
    copy4_async(Tc + (e >> lg_frames), Um + (size_t)(e >> lg_frames) * B + col, valid);
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  float* T = tile + (size_t)g * S;
  float* X1 = sX + g * 3 * Q;
  float* X2 = X1 + Q;
  int* XC = reinterpret_cast<int*>(X1 + 2 * Q);
  int* Z = sZ + g * kMaxDc;

  float m1[NS], m2[NS], m3[NS];
  int c1[NS], c2[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    m1[s] = m2[s] = m3[s] = kNeg;
    c1[s] = c2[s] = 0;
  }
  int beta = 0;

  // ---- delta transform and the per-row top-3 over the columns ----
  for (int j = 0; j < dc; ++j) {
    float* Tj = T + j * Q;
    float x[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) x[s] = Tj[l + W * s];
    const float mx = lanes_fmax<Q>(x);
#pragma unroll
    unsigned key[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      x[s] = x[s] - mx;
      key[s] = okey(x[s]);
    }
    unsigned zk;
    const int z = lanes_argmax<Q>(key, l, zk);
#pragma unroll
    for (int s = 0; s < NS; ++s) Tj[l + W * s] = x[s];
    __syncwarp();
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float v = Tj[(l + W * s) ^ z];
      if (v > m1[s]) {
        m3[s] = m2[s];
        m2[s] = m1[s];
        c2[s] = c1[s];
        m1[s] = v;
        c1[s] = j;
      } else if (v > m2[s]) {
        m3[s] = m2[s];
        m2[s] = v;
        c2[s] = j;
      } else if (v > m3[s]) {
        m3[s] = v;
      }
    }
    beta ^= z;
    if (l == 0) Z[j] = z;
  }

  // ---- per column: exclusion, two-deviation scan, rotation, offset ----
  for (int j = 0; j < dc; ++j) {
    float* Tj = T + j * Q;
    float dw[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int a = l + W * s;
      const bool is0 = c1[s] == j, is1 = c2[s] == j;
      dw[s] = is0 ? m2[s] : m1[s];                 // m1x: one deviation
      X1[a] = a == 0 ? -INFINITY : dw[s];
      X2[a] = a == 0 ? -INFINITY : ((is0 || is1) ? m3[s] : m2[s]);
      XC[a] = is0 ? c2[s] : c1[s];
    }
    __syncwarp();
    if (n_r == 0) {
      for (int e1 = 1; e1 < Q; ++e1) {
        const float v1 = X1[e1], v2 = X2[e1];
        const int ce = XC[e1];
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int e2 = (l + W * s) ^ e1;         // e2 = 0: -inf, no candidate
          const float mp = X1[e2], sp = X2[e2];
          const float cand = XC[e2] == ce ? fmaxf(v1 + sp, v2 + mp) : v1 + mp;
          dw[s] = fmaxf(dw[s], cand);
        }
      }
    } else {
      // the rows' keys; a picked row (and row 0) is set to 2 NEG's key
      const unsigned removed = okey(2.f * kNeg);
      unsigned run[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) run[s] = (l + W * s) == 0 ? removed : okey(dw[s]);
      for (int t = 0; t < n_r; ++t) {
        unsigned mk;
        const int e1 = lanes_argmax<Q>(run, l, mk);
        const float v1 = ofloat(mk);
#pragma unroll
        for (int s = 0; s < NS; ++s)
          if (l + W * s == e1) run[s] = removed;
        const float v2 = X2[e1];
        const int ce = XC[e1];
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int e2 = (l + W * s) ^ e1;
          const float mp = X1[e2], sp = X2[e2];
          const float cand = XC[e2] == ce ? fmaxf(v1 + sp, v2 + mp) : v1 + mp;
          dw[s] = fmaxf(dw[s], cand);
        }
      }
    }
    if (l == 0) dw[0] = 0.f;                       // zero deviations
#pragma unroll
    for (int s = 0; s < NS; ++s) Tj[l + W * s] = dw[s];
    __syncwarp();
    const int r = beta ^ Z[j];
    float o[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) o[s] = Tj[(l + W * s) ^ r];
    const float mx = lanes_fmax<Q>(o);
    __syncwarp();                                  // every lane has read Tj
#pragma unroll
    for (int s = 0; s < NS; ++s) Tj[l + W * s] = fminf((o[s] - mx) + offset, 0.f);
    __syncwarp();                                  // the X rows are rewritten next
  }

  // ---- the outputs, in one pass ----
  __syncthreads();
  if (valid)
    for (int e = threadIdx.x; e < entries; e += blockDim.x)
      Om[(size_t)(e >> lg_frames) * B + col] = Tc[e >> lg_frames];
}

template <int Q>
cudaError_t launch(const float* U, float* out, int M, int dc, int B, int n_r,
                   float offset, const int* active, int n_active, cudaStream_t stream) {
  if (M > 65535 || dc < 3 || dc > kMaxDc || n_r < 0 || n_r >= Q ||
      (active && (n_active < 1 || n_active > B)))
    return cudaErrorInvalidValue;
  // 16 warps a block unless that leaves fewer than three blocks an SM
  // (faster at GF(256); benchmarks/kernel_ab.py --builds k5_warps16)
  int warps = kMaxWarps;
  while (warps > 1 && smem_bytes<Q>(dc, warps) > kMaxSmem / 3) warps /= 2;
  const size_t bytes = smem_bytes<Q>(dc, warps);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cn_tems_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int frames = warps * Shape<Q>::kPerWarp;
  const int n = active ? n_active : B;
  const dim3 grid((n + frames - 1) / frames, M);
  cn_tems_kernel<Q><<<grid, 32 * warps, bytes, stream>>>(U, out, dc, B, n_r, offset,
                                                         __builtin_ctz(frames), active,
                                                         n_active);
  return cudaGetLastError();
}

}  // namespace

// active: n_active ascending frame indices in [0, B) to compute, or null for
// all B frames
extern "C" int cn_tems_update(const float* U, float* out, int M, int dc, int q, int B,
                              int n_r, float offset, const int* active, int n_active,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q) {
    case 2: return launch<2>(U, out, M, dc, B, n_r, offset, active, n_active, s);
    case 4: return launch<4>(U, out, M, dc, B, n_r, offset, active, n_active, s);
    case 8: return launch<8>(U, out, M, dc, B, n_r, offset, active, n_active, s);
    case 16: return launch<16>(U, out, M, dc, B, n_r, offset, active, n_active, s);
    case 32: return launch<32>(U, out, M, dc, B, n_r, offset, active, n_active, s);
    case 64: return launch<64>(U, out, M, dc, B, n_r, offset, active, n_active, s);
    case 128: return launch<128>(U, out, M, dc, B, n_r, offset, active, n_active, s);
    case 256: return launch<256>(U, out, M, dc, B, n_r, offset, active, n_active, s);
    default: return cudaErrorInvalidValue;
  }
}
