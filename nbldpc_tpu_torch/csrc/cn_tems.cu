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
// written once (8 bytes). The exact scan is q (q - 1) candidates per column
// and (check, frame), 48 k at GF(64) with dc = 12, each three shared-memory
// reads and about a dozen instructions; the n_r scan is n_r group argmax
// rounds and n_r q candidates per column.
//
// Design: threads across symbols. A group of min(q, 32) lanes of one warp
// owns one (check, frame), lane l owning rows l, l + 32, ... (q / 32 rows
// each for q >= 32), so every reduction is a warp shuffle and every group
// barrier a __syncwarp. The per-row top-3 table stays in registers; the
// current column's (m1x, m2x, c1x) rows sit in shared memory, where the
// reads of row eta ^ e1 are a permutation inside an aligned block of 32
// (no bank conflicts). A block of 256 threads holds 256 / min(q, 32)
// consecutive frames of one check; each column is loaded and stored through
// shared memory by the whole block, frames fastest, so a warp reads and
// writes runs of consecutive frames (U is contiguous in B). Groups past the
// last frame compute on frame B-1 and store nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDc = 32;
constexpr int kThreads = 256;

template <int Q>
struct Shape {
  static constexpr int kWidth = Q < 32 ? Q : 32;      // lanes of one group
  static constexpr int kSyms = Q / kWidth;            // rows per lane
  static constexpr int kGroups = kThreads / kWidth;   // frames per block
};

__device__ __forceinline__ bool better(float ov, int oi, float v, int i) {
  return ov > v || (ov == v && oi < i);
}

// (max value, lowest index reaching it) over the W lanes of the group.
template <int W>
__device__ __forceinline__ void group_argmax(float& v, int& i) {
#pragma unroll
  for (int h = 1; h < W; h <<= 1) {
    const float ov = __shfl_xor_sync(kFull, v, h, W);
    const int oi = __shfl_xor_sync(kFull, i, h, W);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

template <int W>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int h = 1; h < W; h <<= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, h, W));
  return v;
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
cn_tems_kernel(const float* __restrict__ U, float* __restrict__ out, int dc, int B,
               int n_r, float offset) {
  constexpr int W = Shape<Q>::kWidth;
  constexpr int NS = Shape<Q>::kSyms;
  constexpr int G = Shape<Q>::kGroups;
  __shared__ float sT[G * Q];      // a column of every group: in, dW, out
  __shared__ float sM1[G * Q];     // the current column's m1x rows
  __shared__ float sM2[G * Q];     // m2x
  __shared__ int sC1[G * Q];       // c1x
  __shared__ int sZ[G * kMaxDc];   // z_j of every column

  const int g = threadIdx.x / W;
  const int l = threadIdx.x % W;
  const int m = blockIdx.y;
  const int b0 = blockIdx.x * G;
  float* T = sT + g * Q;
  float* X1 = sM1 + g * Q;
  float* X2 = sM2 + g * Q;
  int* XC = sC1 + g * Q;
  int* Z = sZ + g * kMaxDc;
  const size_t js = (size_t)Q * B;
  const float* Um = U + (size_t)m * dc * js;
  float* Om = out + (size_t)m * dc * js;

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
    __syncthreads();                 // the last column's T reads are done
    for (int k = threadIdx.x; k < G * Q; k += kThreads) {
      const int gb = k % G, a = k / G;
      const int b = b0 + gb < B ? b0 + gb : B - 1;
      sT[gb * Q + a] = Um[j * js + (size_t)a * B + b];
    }
    __syncthreads();
    float x[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) x[s] = T[l + W * s];
    float mx = x[0];
#pragma unroll
    for (int s = 1; s < NS; ++s) mx = fmaxf(mx, x[s]);
    mx = group_max<W>(mx);
#pragma unroll
    for (int s = 0; s < NS; ++s) x[s] = x[s] - mx;
    float zv = x[0];
    int z = l;
#pragma unroll
    for (int s = 1; s < NS; ++s) {
      if (x[s] > zv) {
        zv = x[s];
        z = l + W * s;
      }
    }
    group_argmax<W>(zv, z);
#pragma unroll
    for (int s = 0; s < NS; ++s) T[l + W * s] = x[s];
    __syncwarp();
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float v = T[(l + W * s) ^ z];
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
    float dw[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int a = l + W * s;
      const bool is0 = c1[s] == j, is1 = c2[s] == j;
      dw[s] = is0 ? m2[s] : m1[s];                 // m1x: one deviation
      X1[a] = dw[s];
      X2[a] = (is0 || is1) ? m3[s] : m2[s];
      XC[a] = is0 ? c2[s] : c1[s];
    }
    __syncwarp();
    if (n_r == 0) {
      for (int e1 = 1; e1 < Q; ++e1) {
        const float v1 = X1[e1], v2 = X2[e1];
        const int ce = XC[e1];
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int e2 = (l + W * s) ^ e1;
          if (e2 == 0) continue;                   // a zero second deviation
          const float mp = X1[e2], sp = X2[e2];
          const float cand = XC[e2] == ce ? fmaxf(v1 + sp, v2 + mp) : v1 + mp;
          dw[s] = fmaxf(dw[s], cand);
        }
      }
    } else {
      float run[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) run[s] = (l + W * s) == 0 ? 2.f * kNeg : dw[s];
      for (int t = 0; t < n_r; ++t) {
        float v1 = run[0];
        int e1 = l;
#pragma unroll
        for (int s = 1; s < NS; ++s) {
          if (run[s] > v1) {
            v1 = run[s];
            e1 = l + W * s;
          }
        }
        group_argmax<W>(v1, e1);
#pragma unroll
        for (int s = 0; s < NS; ++s)
          if (l + W * s == e1) run[s] = 2.f * kNeg;
        const float v2 = X2[e1];
        const int ce = XC[e1];
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int e2 = (l + W * s) ^ e1;
          if (e2 == 0) continue;
          const float mp = X1[e2], sp = X2[e2];
          const float cand = XC[e2] == ce ? fmaxf(v1 + sp, v2 + mp) : v1 + mp;
          dw[s] = fmaxf(dw[s], cand);
        }
      }
    }
    if (l == 0) dw[0] = 0.f;                       // zero deviations
#pragma unroll
    for (int s = 0; s < NS; ++s) T[l + W * s] = dw[s];
    __syncwarp();
    const int r = beta ^ Z[j];
    float o[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) o[s] = T[(l + W * s) ^ r];
    float mx = o[0];
#pragma unroll
    for (int s = 1; s < NS; ++s) mx = fmaxf(mx, o[s]);
    mx = group_max<W>(mx);
    __syncwarp();                                  // every lane has read T
#pragma unroll
    for (int s = 0; s < NS; ++s) T[l + W * s] = fminf((o[s] - mx) + offset, 0.f);
    __syncthreads();
    for (int k = threadIdx.x; k < G * Q; k += kThreads) {
      const int gb = k % G, a = k / G;
      if (b0 + gb < B) Om[j * js + (size_t)a * B + b0 + gb] = sT[gb * Q + a];
    }
    __syncthreads();                 // T and the X rows are rewritten next
  }
}

template <int Q>
cudaError_t launch(const float* U, float* out, int M, int dc, int B, int n_r,
                   float offset, cudaStream_t stream) {
  constexpr int G = Shape<Q>::kGroups;
  if (M > 65535 || dc < 3 || dc > kMaxDc || n_r < 0 || n_r >= Q)
    return cudaErrorInvalidValue;
  const dim3 grid((B + G - 1) / G, M);
  cn_tems_kernel<Q><<<grid, kThreads, 0, stream>>>(U, out, dc, B, n_r, offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cn_tems_update(const float* U, float* out, int M, int dc, int q, int B,
                              int n_r, float offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q) {
    case 2: return launch<2>(U, out, M, dc, B, n_r, offset, s);
    case 4: return launch<4>(U, out, M, dc, B, n_r, offset, s);
    case 8: return launch<8>(U, out, M, dc, B, n_r, offset, s);
    case 16: return launch<16>(U, out, M, dc, B, n_r, offset, s);
    case 32: return launch<32>(U, out, M, dc, B, n_r, offset, s);
    case 64: return launch<64>(U, out, M, dc, B, n_r, offset, s);
    case 128: return launch<128>(U, out, M, dc, B, n_r, offset, s);
    case 256: return launch<256>(U, out, M, dc, B, n_r, offset, s);
    default: return cudaErrorInvalidValue;
  }
}
