// One EMS check-node phase, batch-last: U [M, dc, q, B] f32 -> same.
//
// Replaces: nbldpc_tpu/kernels/cn_ems.py, _cn_kernel / ems_cn_update_bl_pallas
// (the Pallas K2 kernel, classic merge) and _cn_kernel_bubble /
// ems_cn_update_bl_bubble_pallas (K2b, bubble merge).
//
// Math, per check m and frame b: exactly the plain version,
// nbldpc_tpu_torch/decoders/ems.py (ems_cn_update_bl):
//   U  = U - max_q U
//   classic: stable top-nm extraction of every operand (nm rounds of
//     (max, lowest index reaching it, set to NEG)); F/B recursion with
//     merge(acc, op)[a] = max_b op.list[b] + acc.dense[a ^ b] (all q
//     symbols, q <= 64 or nm >= q) or max_t op.val[t] + acc.dense[a ^
//     op.idx[t]] (the nm list entries, q > 64), re-extracted after every
//     merge; edge outputs dense.
//   bubble: operands are sorted nm-lists; merge = top-nm of the staircase
//     pairs (t+1)(s+1) <= 2 nm above the floor f = op.val[0] + acc.comp,
//     plus min(2 nm, q) fills of value f at indices 0, 1, ..., retiring
//     every candidate on a picked index; final merges dense, edge outputs
//     scattered lists.
//   O = (O - max_q O) + offset, min 0, max NEG.
// Only adds and max: each sum is the plain version's single add, and max
// is exact in any order, so the kernel agrees with it bit for bit.
//
// What bounds it on the H100: on-chip work. Each element is read once and
// written once (8 bytes); the merges are q (classic dense), nm (classic
// scan) or |staircase| (bubble) shared-memory reads per output symbol, and
// every extraction is nm group-wide argmax reductions, each with two block
// barriers for q > 32.
//
// Design: threads across symbols. A group of q threads owns one (check,
// frame) pair, thread a owning symbol a; a block of max(128, q) threads
// holds max(128, q) / q frames of one check. Operands, partials and lists
// live in the group's shared memory (nothing per thread grows with q, so
// nothing spills at q = 256). Reductions are warp shuffles inside a warp
// and a shared-memory exchange across the group's warps for q > 32. Groups
// past the last frame compute on frame B-1 and store nothing.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDenseMergeMaxQ = 64;
constexpr int kRed = 16;                  // block reduction scratch (8 v + 8 i)
constexpr size_t kMaxSmem = 232448;       // per-block dynamic shared memory, sm_90

template <int Q>
struct Shape {
  static constexpr int kThreads = Q < 128 ? 128 : Q;
  static constexpr int kGroups = kThreads / Q;
  static constexpr int kWidth = Q < 32 ? Q : 32;   // shuffle width
};

struct Red {
  float* v;
  int* i;
};

__device__ __forceinline__ bool better(float ov, int oi, float v, int i) {
  return ov > v || (ov == v && oi < i);
}

template <int Q>
__device__ __forceinline__ void group_sync() {
  if constexpr (Q <= 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// (max value, lowest index reaching it) over the q threads of the group,
// returned to every thread of the group.
template <int Q>
__device__ __forceinline__ void group_argmax(float& v, int& i, Red red) {
  constexpr int W = Shape<Q>::kWidth;
#pragma unroll
  for (int h = 1; h < W; h <<= 1) {
    const float ov = __shfl_xor_sync(kFull, v, h, W);
    const int oi = __shfl_xor_sync(kFull, i, h, W);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  if constexpr (Q > 32) {
    const int warp = threadIdx.x >> 5;
    __syncthreads();
    if ((threadIdx.x & 31) == 0) {
      red.v[warp] = v;
      red.i[warp] = i;
    }
    __syncthreads();
    const int w0 = (threadIdx.x / Q) * (Q / 32);
    v = red.v[w0];
    i = red.i[w0];
#pragma unroll
    for (int w = 1; w < Q / 32; ++w) {
      if (better(red.v[w0 + w], red.i[w0 + w], v, i)) {
        v = red.v[w0 + w];
        i = red.i[w0 + w];
      }
    }
  }
}

template <int Q>
__device__ __forceinline__ float group_max(float v, Red red) {
  constexpr int W = Shape<Q>::kWidth;
#pragma unroll
  for (int h = 1; h < W; h <<= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, h, W));
  if constexpr (Q > 32) {
    const int warp = threadIdx.x >> 5;
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red.v[warp] = v;
    __syncthreads();
    const int w0 = (threadIdx.x / Q) * (Q / 32);
    v = red.v[w0];
#pragma unroll
    for (int w = 1; w < Q / 32; ++w) v = fmaxf(v, red.v[w0 + w]);
  }
  return v;
}

// Offset correction and clip of one output slot, stored when valid.
template <int Q>
__device__ __forceinline__ void emit(float o, float offset, float* dst, bool valid,
                                     Red red) {
  const float mx = group_max<Q>(o, red);
  float r = (o - mx) + offset;
  r = fmaxf(fminf(r, 0.f), kNeg);
  if (valid) *dst = r;
}

// ---- classic -----------------------------------------------------------------

// One operand or partial: dense form D[q], list form L[q] (NEG outside the
// top-nm) and the extraction's (value, index) list V[nm], I[nm].
struct Rec {
  float* D;
  float* L;
  float* V;
  int* I;
};

template <int Q>
__device__ __forceinline__ Rec rec_at(float* area, int k, int nm) {
  float* r = area + (size_t)k * (2 * Q + 2 * nm);
  return {r, r + Q, r + 2 * Q, reinterpret_cast<int*>(r + 2 * Q + nm)};
}

// Writes x (this thread's symbol) into r: identity without truncation,
// else the stable top-nm extraction.
template <int Q>
__device__ __forceinline__ void put(float x, int a, int nm, bool trunc, Rec r, Red red) {
  if (!trunc) {
    r.D[a] = x;
    r.L[a] = x;
    return;
  }
  float run = x, comp = 0.f;
  bool kept = false;
  for (int t = 0; t < nm; ++t) {
    float v = run;
    int i = a;
    group_argmax<Q>(v, i, red);
    if (i == a) {
      run = kNeg;
      kept = true;
    }
    if (a == 0) {
      r.V[t] = v;
      r.I[t] = i;
    }
    comp = v;
  }
  r.D[a] = kept ? x : comp;
  r.L[a] = kept ? x : kNeg;
}

template <int Q>
__device__ __forceinline__ float merge(int a, int nm, bool scan, Rec acc, Rec op) {
  float o;
  if (scan) {
    o = op.V[0] + acc.D[a ^ op.I[0]];
    for (int t = 1; t < nm; ++t) o = fmaxf(o, op.V[t] + acc.D[a ^ op.I[t]]);
  } else {
    o = op.L[0] + acc.D[a];
#pragma unroll 8
    for (int b = 1; b < Q; ++b) o = fmaxf(o, op.L[b] + acc.D[a ^ b]);
  }
  return o;
}

template <int Q>
__global__ void __launch_bounds__(Shape<Q>::kThreads)
cn_ems_classic_kernel(const float* __restrict__ U, float* __restrict__ out,
                      int dc, int B, int nm, float offset) {
  extern __shared__ float smem[];
  constexpr int G = Shape<Q>::kGroups;
  const int g = threadIdx.x / Q;
  const int a = threadIdx.x % Q;
  const int m = blockIdx.y;
  const int b_raw = blockIdx.x * G + g;
  const bool valid = b_raw < B;
  const int b = valid ? b_raw : B - 1;
  const bool trunc = nm < Q;
  const bool scan = trunc && Q > kDenseMergeMaxQ;
  const Red red{smem, reinterpret_cast<int*>(smem + kRed / 2)};
  // records 0..dc-1: U_j (record 0 then carries F); dc..2dc-1: B_j
  float* area = smem + kRed + (size_t)g * 2 * dc * (2 * Q + 2 * nm);
  auto bj = [&](int j) {
    return rec_at<Q>(area, j == dc - 2 ? dc - 1 : dc + j, nm);
  };

  const size_t js = (size_t)Q * B;
  const size_t off = (size_t)m * dc * js + (size_t)a * B + b;
  for (int j = 0; j < dc; ++j) {
    float x = U[off + j * js];
    x = x - group_max<Q>(x, red);
    put<Q>(x, a, nm, trunc, rec_at<Q>(area, j, nm), red);
  }
  group_sync<Q>();
  // B_j = merge of U_{j+1..dc-1}; B_{dc-2} is U_{dc-1} itself
  for (int j = dc - 3; j >= 0; --j) {
    const float mrg = merge<Q>(a, nm, scan, bj(j + 1), rec_at<Q>(area, j + 1, nm));
    put<Q>(mrg, a, nm, trunc, rec_at<Q>(area, dc + j, nm), red);
    group_sync<Q>();
  }
  emit<Q>(bj(0).D[a], offset, out + off, valid, red);
  // F_j = merge of U_{0..j-1}, kept in record 0 (F_1 is U_0 itself)
  const Rec f = rec_at<Q>(area, 0, nm);
  for (int j = 1; j < dc; ++j) {
    if (j >= 2) {
      const float mrg = merge<Q>(a, nm, scan, f, rec_at<Q>(area, j - 1, nm));
      group_sync<Q>();                       // F is read before it is replaced
      put<Q>(mrg, a, nm, trunc, f, red);
      group_sync<Q>();
    }
    const float o = (j < dc - 1) ? merge<Q>(a, nm, scan, f, bj(j)) : f.D[a];
    emit<Q>(o, offset, out + off + j * js, valid, red);
  }
}

// ---- bubble ------------------------------------------------------------------

// A sorted nm-list: values V[nm] (descending), GF indices I[nm], comp C.
struct List {
  float* V;
  int* I;
  float* C;
};

__device__ __forceinline__ List list_at(float* area, int k, int nm) {
  float* r = area + (size_t)k * (2 * nm + 1);
  return {r, reinterpret_cast<int*>(r + nm), r + 2 * nm};
}

__host__ __device__ __forceinline__ int stair_row(int t, int nm) {
  const int c = (2 * nm) / (t + 1);
  return c < nm ? c : nm;
}

template <int Q>
__device__ __forceinline__ void top_list(float x, int a, int nm, List l, Red red) {
  float run = x, last = 0.f;
  for (int t = 0; t < nm; ++t) {
    float v = run;
    int i = a;
    group_argmax<Q>(v, i, red);
    if (i == a) run = kNeg;
    if (a == 0) {
      l.V[t] = v;
      l.I[t] = i;
    }
    last = v;
  }
  if (a == 0) *l.C = last;
}

// dst = top-nm of the staircase candidates and the fills (dst may be acc).
template <int Q>
__device__ void merge_bubble(int a, int nm, int npairs, int P, const int* pT,
                             const int* pS, List acc, List op, List dst,
                             float* cv, int* ci, Red red) {
  group_sync<Q>();          // lists written, the last merge's candidates read
  const float f = op.V[0] + *acc.C;
  for (int p = a; p < P; p += Q) {
    float v;
    int i;
    if (p < npairs) {
      const int t = pT[p], s = pS[p];
      v = acc.V[t] + op.V[s];
      i = acc.I[t] ^ op.I[s];
      v = v > f ? v : kNeg;
    } else {
      v = f;
      i = p - npairs;
    }
    cv[p] = v;
    ci[p] = i;
  }
  group_sync<Q>();          // candidates visible; acc and op no longer read
  float last = 0.f;
  for (int t = 0; t < nm; ++t) {
    float v = -INFINITY;
    int pos = INT_MAX;
    for (int p = a; p < P; p += Q) {
      if (cv[p] > v) {
        v = cv[p];
        pos = p;
      }
    }
    group_argmax<Q>(v, pos, red);
    const int pick = ci[pos];
    for (int p = a; p < P; p += Q)
      if (ci[p] == pick) cv[p] = kNeg;
    last = fmaxf(v, f);
    if (a == 0) {
      dst.V[t] = last;
      dst.I[t] = pick;
    }
  }
  if (a == 0) *dst.C = last;
  group_sync<Q>();
}

__device__ __forceinline__ float merge_bubble_dense(int a, int npairs, const int* pT,
                                                    const int* pS, List acc, List op) {
  float o = op.V[0] + *acc.C;
  for (int p = 0; p < npairs; ++p) {
    const int t = pT[p], s = pS[p];
    const float v = acc.V[t] + op.V[s];
    o = fmaxf(o, (acc.I[t] ^ op.I[s]) == a ? v : kNeg);
  }
  return o;
}

__device__ __forceinline__ float scatter(int a, int nm, List l) {
  float o = *l.C;
  for (int t = nm - 1; t >= 0; --t)
    if (l.I[t] == a) o = l.V[t];
  return o;
}

template <int Q>
__global__ void __launch_bounds__(Shape<Q>::kThreads)
cn_ems_bubble_kernel(const float* __restrict__ U, float* __restrict__ out,
                     int dc, int B, int nm, float offset, int npairs) {
  extern __shared__ float smem[];
  constexpr int G = Shape<Q>::kGroups;
  const int g = threadIdx.x / Q;
  const int a = threadIdx.x % Q;
  const int m = blockIdx.y;
  const int b_raw = blockIdx.x * G + g;
  const bool valid = b_raw < B;
  const int b = valid ? b_raw : B - 1;
  const int nf = 2 * nm < Q ? 2 * nm : Q;
  const int P = npairs + nf;
  const Red red{smem, reinterpret_cast<int*>(smem + kRed / 2)};
  int* pT = reinterpret_cast<int*>(smem + kRed);
  int* pS = pT + npairs;
  // per group: lists 0..dc-1 (U_j; list 0 then carries F), dc..2dc-1
  // (B_j), then the candidate values and indices
  float* area = smem + kRed + 2 * npairs +
                (size_t)g * (2 * dc * (2 * nm + 1) + 2 * P);
  float* cv = area + 2 * dc * (2 * nm + 1);
  int* ci = reinterpret_cast<int*>(cv + P);
  auto bj = [&](int j) { return list_at(area, j == dc - 2 ? dc - 1 : dc + j, nm); };

  // staircase pairs in lex (t, s) order
  for (int t = threadIdx.x; t < nm; t += blockDim.x) {
    int p = 0;
    for (int u = 0; u < t; ++u) p += stair_row(u, nm);
    for (int s = 0; s < stair_row(t, nm); ++s, ++p) {
      pT[p] = t;
      pS[p] = s;
    }
  }
  __syncthreads();

  const size_t js = (size_t)Q * B;
  const size_t off = (size_t)m * dc * js + (size_t)a * B + b;
  for (int j = 0; j < dc; ++j) {
    float x = U[off + j * js];
    x = x - group_max<Q>(x, red);
    top_list<Q>(x, a, nm, list_at(area, j, nm), red);
  }
  for (int j = dc - 3; j >= 0; --j)
    merge_bubble<Q>(a, nm, npairs, P, pT, pS, bj(j + 1), list_at(area, j + 1, nm),
                    list_at(area, dc + j, nm), cv, ci, red);
  group_sync<Q>();
  emit<Q>(scatter(a, nm, bj(0)), offset, out + off, valid, red);
  const List f = list_at(area, 0, nm);
  for (int j = 1; j < dc; ++j) {
    if (j >= 2)
      merge_bubble<Q>(a, nm, npairs, P, pT, pS, f, list_at(area, j - 1, nm), f, cv,
                      ci, red);
    const float o = (j < dc - 1) ? merge_bubble_dense(a, npairs, pT, pS, f, bj(j))
                                 : scatter(a, nm, f);
    emit<Q>(o, offset, out + off + j * js, valid, red);
  }
}

// ---- launch ------------------------------------------------------------------

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
  return cudaSuccess;
}

template <int Q>
cudaError_t launch(bool bubble, const float* U, float* out, int M, int dc, int B,
                   int nm, float offset, cudaStream_t stream) {
  constexpr int G = Shape<Q>::kGroups;
  const dim3 grid((B + G - 1) / G, M);
  if (M > 65535 || dc < 2 || nm < 1 || nm > Q) return cudaErrorInvalidValue;
  cudaError_t err;
  if (!bubble) {
    const size_t bytes =
        (kRed + (size_t)G * 2 * dc * (2 * Q + 2 * nm)) * sizeof(float);
    err = prepare(cn_ems_classic_kernel<Q>, bytes);
    if (err != cudaSuccess) return err;
    cn_ems_classic_kernel<Q><<<grid, Shape<Q>::kThreads, bytes, stream>>>(
        U, out, dc, B, nm, offset);
  } else {
    int npairs = 0;
    for (int t = 0; t < nm; ++t) npairs += stair_row(t, nm);
    const int P = npairs + (2 * nm < Q ? 2 * nm : Q);
    const size_t bytes =
        (kRed + 2 * (size_t)npairs + (size_t)G * (2 * dc * (2 * nm + 1) + 2 * P)) *
        sizeof(float);
    err = prepare(cn_ems_bubble_kernel<Q>, bytes);
    if (err != cudaSuccess) return err;
    cn_ems_bubble_kernel<Q><<<grid, Shape<Q>::kThreads, bytes, stream>>>(
        U, out, dc, B, nm, offset, npairs);
  }
  return cudaGetLastError();
}

int dispatch(bool bubble, const float* U, float* out, int M, int dc, int q, int B,
             int nm, float offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q) {
    case 2: return launch<2>(bubble, U, out, M, dc, B, nm, offset, s);
    case 4: return launch<4>(bubble, U, out, M, dc, B, nm, offset, s);
    case 8: return launch<8>(bubble, U, out, M, dc, B, nm, offset, s);
    case 16: return launch<16>(bubble, U, out, M, dc, B, nm, offset, s);
    case 32: return launch<32>(bubble, U, out, M, dc, B, nm, offset, s);
    case 64: return launch<64>(bubble, U, out, M, dc, B, nm, offset, s);
    case 128: return launch<128>(bubble, U, out, M, dc, B, nm, offset, s);
    case 256: return launch<256>(bubble, U, out, M, dc, B, nm, offset, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int cn_ems_update(const float* U, float* out, int M, int dc, int q, int B,
                             int nm, float offset, void* stream) {
  return dispatch(false, U, out, M, dc, q, B, nm, offset, stream);
}

extern "C" int cn_ems_update_bubble(const float* U, float* out, int M, int dc, int q,
                                    int B, int nm, float offset, void* stream) {
  return dispatch(true, U, out, M, dc, q, B, nm, offset, stream);
}
