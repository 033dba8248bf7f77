// Whole EMS decode of one frame per block, all iterations in shared memory.
//
// Replaces: nbldpc_tpu/kernels/ems_resident.py, ResidentEMS._kernel (the
// Pallas K3 kernel; its entry is ResidentQSPAFL.__call__), for q <= 32 and
// the classic merge.
//
// Math, exactly the plain version's association
// (nbldpc_tpu_torch/kernels/ems_resident.py:decode_plain):
//   prior = llr - max_q llr;  post = prior;  lc = 0        (lc in c-domain)
//   per iteration, per edge e = (m, j) with variable v and weight h:
//     U(x) = Ve(h^-1 x), Ve = post[v] - lc[e] minus its max over q;
//            delta0 = (0, NEG, ...) on pad slots
//     classic EMS over the check's dc operands: stable top-nm extraction
//     (nm < q), F/B merges out[a] = max_b op.list[b] + acc.dense[a ^ b],
//     re-extracted after every merge; edge outputs dense
//     O = (O - max_q O) + offset, min 0, max NEG;  lc[e](h^-1 x) = O(x)
//   post[v] = prior[v] + sum of lc over v's edges, in vn_edge slot order
//   hard = argmax (ties to the lowest symbol), syndrome by syn_k bits.
// Only adds and max: the kernel agrees with the plain version exactly.
//
// What bounds it on the H100: on-chip work, not HBM. A frame reads its
// LLRs once and writes N hard decisions once; prior, posterior and every
// edge message stay in shared memory for all iterations, (2 N q + M dc q)
// 4 bytes, 52 KB at GF(16) (204,102), plus the backward partials of the
// checks in flight. The cost is the merges: q shuffle pairs and q add/max
// pairs per lane per merge, 3 (dc - 2) merges per check and iteration.
//
// Design: one block per frame (any batch size). A check runs on a group of
// q lanes inside a warp, lane a owning symbol a: __shfl_xor_sync(acc, b)
// hands lane a the value acc[a ^ b], so a merge needs no shared-memory
// traffic; top-nm extraction is nm rounds of a group argmax on (value,
// lower index). The x-domain operands overwrite the check's own lc rows,
// the dense backward partials B_0..B_{dc-3} go to a per-group scratch, and
// the kept flags are bits of a register. The variable update runs one
// thread per (variable, symbol). Frames stop as soon as their outputs are
// final.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // per-block dynamic shared memory, sm_90

struct Tables {
  const int* cn_vn;      // [M*dc] variable of each edge slot (pads -> 0)
  const int* cn_real;    // [M*dc] 1 on real slots, 0 on pads
  const int* perm_down;  // [M*dc*q] h^-1 x
  const int* vn_edge;    // [N*dv] edge slot of each variable slot (pads -> M*dc)
  const int* syn_k;      // [M*dc*p] h * 2^t (0 on pads)
};

template <int Q>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int h = 1; h < Q; h <<= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, h, Q));
  return v;
}

// Stable top-nm of x over the group: returns the dense form (x where kept,
// else the compensation value, the last extracted maximum) and sets kept.
template <int Q>
__device__ __forceinline__ float extract(float x, int lane, int nm, bool& kept) {
  float run = x, comp = 0.f;
  kept = false;
  for (int t = 0; t < nm; ++t) {
    float v = run;
    int i = lane;
#pragma unroll
    for (int h = 1; h < Q; h <<= 1) {
      const float ov = __shfl_xor_sync(kFull, v, h, Q);
      const int oi = __shfl_xor_sync(kFull, i, h, Q);
      if (ov > v || (ov == v && oi < i)) {
        v = ov;
        i = oi;
      }
    }
    if (i == lane) {
      run = kNeg;
      kept = true;
    }
    comp = v;
  }
  return kept ? x : comp;
}

// out[a] = max_b op[b] + acc[a ^ b] over the group's lanes.
template <int Q>
__device__ __forceinline__ float merge(float acc, float op) {
  float o = __shfl_sync(kFull, op, 0, Q) + acc;
#pragma unroll
  for (int b = 1; b < Q; ++b)
    o = fmaxf(o, __shfl_sync(kFull, op, b, Q) + __shfl_xor_sync(kFull, acc, b, Q));
  return o;
}

template <int Q>
__device__ __forceinline__ float postprocess(float o, float offset) {
  const float r = (o - group_max<Q>(o)) + offset;
  return fmaxf(fminf(r, 0.f), kNeg);
}

// Hard decisions of the whole frame into hard[N]: argmax over q, strict
// ascending scan, so ties go to the lowest symbol.
template <int Q>
__device__ void hard_of(const float* post, int* hard, int N) {
  for (int v = threadIdx.x; v < N; v += blockDim.x) {
    const float* pv = post + v * Q;
    float best = pv[0];
    int idx = 0;
#pragma unroll
    for (int a = 1; a < Q; ++a) {
      if (pv[a] > best) {
        best = pv[a];
        idx = a;
      }
    }
    hard[v] = idx;
  }
}

// 1 when every check is satisfied. Reads hard[] (caller syncs before);
// returns the same value in every thread of the block.
__device__ int syndrome_ok(const int* hard, const Tables& t, int M, int dc, int P) {
  int bad = 0;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    int x = 0;
    for (int j = 0; j < dc; ++j) {
      const int e = m * dc + j;
      const int sym = hard[__ldg(&t.cn_vn[e])];
      for (int b = 0; b < P; ++b)
        if ((sym >> b) & 1) x ^= __ldg(&t.syn_k[e * P + b]);
    }
    bad |= (x != 0);
  }
  return !__syncthreads_or(bad);
}

// Check-node phase: every check's dc edge messages lc[e] are replaced in
// place. Groups of Q lanes own one check each; groups past the last check
// mirror check M-1 (they must join the shuffles) and store nothing.
template <int Q>
__device__ void cn_phase(const float* post, float* lc, float* scratch, const Tables& t,
                         int M, int dc, int nm, float offset) {
  const int lane = threadIdx.x % Q;
  const int grp = threadIdx.x / Q;
  const int groups = blockDim.x / Q;
  const bool trunc = nm < Q;
  float* bpart = scratch + grp * (dc - 2) * Q;   // dense B_0..B_{dc-3}, own lane
  for (int c0 = 0; c0 < M; c0 += groups) {
    const bool valid = c0 + grp < M;
    const int m = valid ? c0 + grp : M - 1;
    float* row = lc + (size_t)m * dc * Q;          // the check's dc rows
    // pass 1: x-domain operands, extracted, into the check's own rows
    unsigned ukept = 0;
    for (int j = 0; j < dc; ++j) {
      const int e = m * dc + j;
      const int pd = __ldg(&t.perm_down[e * Q + lane]);
      const int v = __ldg(&t.cn_vn[e]);
      const float ve = post[v * Q + pd] - row[j * Q + pd];
      float u = ve - group_max<Q>(ve);
      if (!__ldg(&t.cn_real[e])) u = (lane == 0) ? 0.f : kNeg;
      bool k = true;
      const float d = trunc ? extract<Q>(u, lane, nm, k) : u;
      ukept |= (unsigned)k << j;
      __syncwarp();
      if (valid) row[j * Q + lane] = d;
      __syncwarp();
    }
    auto ulist = [&](int j) {
      return ((ukept >> j) & 1u) ? row[j * Q + lane] : kNeg;
    };
    // backward: B_j = merge of U_{j+1..dc-1}; B_{dc-2} is U_{dc-1}
    unsigned bkept = 0;
    float bd = row[(dc - 1) * Q + lane];
    for (int j = dc - 3; j >= 0; --j) {
      const float mrg = merge<Q>(bd, ulist(j + 1));
      bool k = true;
      bd = trunc ? extract<Q>(mrg, lane, nm, k) : mrg;
      bkept |= (unsigned)k << j;
      bpart[j * Q + lane] = bd;
    }
    // forward: F_j = merge of U_{0..j-1}; the output of slot j-1 is held
    // until F_j has read row j-1, then written there in c-domain
    float fd = row[lane];
    float pending = postprocess<Q>(bd, offset);            // slot 0: B_0
    for (int j = 1; j < dc; ++j) {
      if (j >= 2) {
        const float mrg = merge<Q>(fd, ulist(j - 1));
        bool k = true;
        fd = trunc ? extract<Q>(mrg, lane, nm, k) : mrg;
      }
      const int pd = __ldg(&t.perm_down[(m * dc + j - 1) * Q + lane]);
      __syncwarp();
      if (valid) row[(j - 1) * Q + pd] = pending;
      __syncwarp();
      float o = fd;
      if (j < dc - 1) {
        const float bl = (j == dc - 2) ? ulist(dc - 1)
                         : (((bkept >> j) & 1u) ? bpart[j * Q + lane] : kNeg);
        o = merge<Q>(fd, bl);
      }
      pending = postprocess<Q>(o, offset);
    }
    const int pd = __ldg(&t.perm_down[(m * dc + dc - 1) * Q + lane]);
    __syncwarp();
    if (valid) row[(dc - 1) * Q + pd] = pending;
    __syncwarp();
  }
}

// Variable-node phase: post = prior + sum of the variable's edge messages.
template <int Q>
__device__ void vn_phase(const float* prior, const float* lc, float* post,
                         const Tables& t, int N, int dv, int E) {
  for (int i = threadIdx.x; i < N * Q; i += blockDim.x) {
    const int v = i / Q;
    const int a = i % Q;
    float acc = 0.f;
    for (int s = 0; s < dv; ++s) {
      const int e = __ldg(&t.vn_edge[v * dv + s]);
      if (e < E) acc += lc[e * Q + a];
    }
    post[i] = prior[i] + acc;
  }
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
ems_resident_kernel(const float* __restrict__ llr, int* __restrict__ hard_out,
                    uint8_t* __restrict__ done_out, int* __restrict__ iters_out,
                    int N, int M, int dc, int dv, int P, int nm, float offset, Tables t,
                    int max_iters, int early_term, int stats_each_iter) {
  extern __shared__ float smem[];
  const int E = M * dc;
  float* prior = smem;                 // [N, Q]
  float* post = prior + N * Q;         // [N, Q]
  float* lc = post + N * Q;            // [E, Q] check->variable, c-domain
  int* hard = reinterpret_cast<int*>(lc + E * Q);  // [N]
  float* scratch = reinterpret_cast<float*>(hard + N);
  const int b = blockIdx.x;

  const float* L = llr + (size_t)b * N * Q;
  for (int i = threadIdx.x; i < N * Q; i += blockDim.x) prior[i] = L[i];
  for (int i = threadIdx.x; i < E * Q; i += blockDim.x) lc[i] = 0.f;
  __syncthreads();
  for (int v = threadIdx.x; v < N; v += blockDim.x) {
    float mx = prior[v * Q];
#pragma unroll
    for (int a = 1; a < Q; ++a) mx = fmaxf(mx, prior[v * Q + a]);
#pragma unroll
    for (int a = 0; a < Q; ++a) {
      prior[v * Q + a] -= mx;
      post[v * Q + a] = prior[v * Q + a];
    }
  }
  __syncthreads();
  hard_of<Q>(post, hard, N);
  __syncthreads();
  const int done0 = syndrome_ok(hard, t, M, dc, P);
  int done = done0;
  int iters = 0;
  // Outputs are final once a frame is done, except in throughput mode,
  // where the decision is taken after the whole budget.
  const bool may_stop = early_term || stats_each_iter;
  for (int it = 0; it < max_iters; ++it) {
    if (may_stop && done) break;
    cn_phase<Q>(post, lc, scratch, t, M, dc, nm, offset);
    __syncthreads();
    vn_phase<Q>(prior, lc, post, t, N, dv, E);
    __syncthreads();
    if (!stats_each_iter) {
      iters += 1 - done0;
      continue;
    }
    hard_of<Q>(post, hard, N);
    __syncthreads();
    done = syndrome_ok(hard, t, M, dc, P);
    iters += 1;
  }
  if (!stats_each_iter) {
    hard_of<Q>(post, hard, N);
    __syncthreads();
    done = syndrome_ok(hard, t, M, dc, P);
  }
  for (int v = threadIdx.x; v < N; v += blockDim.x)
    hard_out[(size_t)b * N + v] = hard[v];
  if (threadIdx.x == 0) {
    done_out[b] = (uint8_t)done;
    iters_out[b] = iters;
  }
}

template <int Q>
cudaError_t launch(const float* llr, int* hard, uint8_t* done, int* iters, int B,
                   int N, int M, int dc, int dv, int P, int nm, float offset,
                   const Tables& t, int max_iters, int early_term,
                   int stats_each_iter, cudaStream_t stream) {
  if (dc < 2 || dc > 32 || nm < 1) return cudaErrorInvalidValue;
  const int groups = kThreads / Q;
  const size_t smem = ((size_t)(2 * N + M * dc) * Q + N +
                       (size_t)groups * (dc - 2) * Q) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ems_resident_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ems_resident_kernel<Q><<<B, kThreads, smem, stream>>>(
      llr, hard, done, iters, N, M, dc, dv, P, nm, offset, t, max_iters, early_term,
      stats_each_iter);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ems_resident_decode(
    const float* llr, int* hard, uint8_t* done, int* iters,
    int B, int N, int M, int dc, int dv, int q, int nm, float offset,
    const int* cn_vn, const int* cn_real, const int* perm_down,
    const int* vn_edge, const int* syn_k,
    int max_iters, int early_term, int stats_each_iter, void* stream) {
  const Tables t{cn_vn, cn_real, perm_down, vn_edge, syn_k};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return cudaSuccess;
  switch (q) {
#define NBLDPC_CASE(QQ, PP)                                                   \
    case QQ:                                                                  \
      return launch<QQ>(llr, hard, done, iters, B, N, M, dc, dv, PP, nm,      \
                        offset, t, max_iters, early_term, stats_each_iter, s);
    NBLDPC_CASE(2, 1)
    NBLDPC_CASE(4, 2)
    NBLDPC_CASE(8, 3)
    NBLDPC_CASE(16, 4)
    NBLDPC_CASE(32, 5)
#undef NBLDPC_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
