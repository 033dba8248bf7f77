// Whole QSPA decode for large fields (q = 64, 128, 256): one frame per
// block at a time, all iterations in one launch, state in a global scratch.
//
// Replaces: nbldpc_tpu/kernels/qspa_resident.py, ResidentQSPA._kernel /
// __call__ (the Pallas K0-cl kernel, the JAX package's QSPA default for
// q > 32).
//
// Probability-domain BP, the plain version's association order
// (nbldpc_tpu_torch/kernels/qspa_resident.py:decode_plain), the same as
// csrc/qspa_resident.cu (K0):
//   prior = llr - max_q llr;  post = prior;  lc = 0
//   per iteration, per edge e = (m, j) with variable v and weight h:
//     U(x)  = post[v](h^-1 x) - lc[e](h^-1 x)
//     P     = exp(U) / S, S summed serially in exp order (0, 1, a, a^2,
//             ...), the plain version's order; delta0 on pad slots. No
//             max-subtraction: lc lies in [log(1e-12), 0].
//     F     = WHT(P)
//     G_j   = (F_0 ... F_{j-1}) * (F_{dc-1} ... F_{j+1})  (prefix x suffix)
//     lc[e](h^-1 x) = log(max(WHT(G_j)(x) / q, 1e-12))
//   post[v] = prior[v] + sum of lc over v's edges, in vn_edge slot order
//   hard = argmax (ties to the lowest symbol), syndrome by syn_k bits.
//
// What bounds it on the H100. A frame's state does not fit one block's
// shared memory: (N + M dc) q 4 bytes of posterior and edge messages,
// 834 KB at GF(256) (255,175) and 442 KB at GF(64) (576,480). The work
// is about 10 q + 2 q log2 q operations per edge and iteration (exp,
// softmax, two WHTs, the leave-one-out products, floor and log): 3.6e6
// per frame and iteration at GF(256), so 3.0e11 for 4096 frames x 20
// iterations, 4.4 ms at the card's 67 TFLOP/s f32; the LLRs read once
// and the decisions written once are 1.07 GB, 0.32 ms. So the bound is
// operations. This design moves each frame's state through a global
// scratch every iteration (about 2.8 MB per frame and iteration at
// GF(256): the CN phase reads posterior and messages and writes messages,
// the VN phase reads messages and LLRs and writes the posterior), which
// far exceeds both: it is simple and right, not fast. Keeping a frame on
// chip (a thread-block cluster with distributed shared memory) is the
// redesign for speed.
//
// Design: a persistent grid (as many blocks as fit on the card, at most
// B) walks the frames; each block owns one slice of the scratch. A check
// runs on one warp, lane l holding symbols l, l + 32, ..., so WHT stages
// h < 32 are shuffles and stages h >= 32 are register butterflies, in the
// plain version's stage order. The check's dc rows of exp(U), later its
// spectra, sit in the warp's shared-memory buffer (rows Q + 1 apart, so
// the serial softmax sums, lane j summing row j, hit distinct banks). GF
// permutations are perm_down gathers. The variable update and the hard
// decision run one warp per variable (argmax by shuffles, ties to the
// lower symbol). Block barriers separate the CN, VN and syndrome phases;
// a frame stops iterating as soon as its outputs are final.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kProbFloor = 1e-12f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDc = 32;                // one serial softmax sum per lane
constexpr size_t kMaxSmem = 232448;       // per-block dynamic shared memory, sm_90

struct Tables {
  const int* cn_vn;      // [M*dc] variable of each edge slot (pads -> 0)
  const int* cn_real;    // [M*dc] 1 on real slots, 0 on pads
  const int* perm_down;  // [M*dc*q] h^-1 x
  const int* vn_edge;    // [N*dv] edge slot of each variable slot (pads -> M*dc)
  const int* syn_k;      // [M*dc*p] h * 2^t (0 on pads)
  const int* n2e;        // [q] exp-order basis: 0, 1, a, a^2, ...
};

size_t smem_bytes(int N, int dc, int Q) {
  // per warp dc rows of Q + 1 floats and dc sums; per variable mx and hard
  return ((size_t)kWarps * dc * (Q + 2) + 2 * (size_t)N) * sizeof(float);
}

// Unnormalized WHT of the warp's Q-vector, r[k] holding symbol k * 32 +
// lane: stages h = 1, 2, ..., Q / 2 writing (lo + hi, lo - hi).
template <int Q>
__device__ __forceinline__ void wht_warp(float (&r)[Q / 32], int lane) {
  constexpr int K = Q / 32;
#pragma unroll
  for (int h = 1; h < 32; h <<= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float o = __shfl_xor_sync(kFull, r[k], h);
      r[k] = (lane & h) ? (o - r[k]) : (r[k] + o);
    }
  }
#pragma unroll
  for (int h = 1; h < K; h <<= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!(k & h)) {
        const float lo = r[k];
        const float hi = r[k + h];
        r[k] = lo + hi;
        r[k + h] = lo - hi;
      }
    }
  }
}

// (max, lowest symbol reaching it) over the warp; every lane gets it.
__device__ __forceinline__ int warp_argmax(float best, int idx) {
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, h);
    const int oi = __shfl_xor_sync(kFull, idx, h);
    if (ob > best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
  return idx;
}

// 1 when every check is satisfied. Reads hard[] (caller syncs before);
// returns the same value in every thread of the block.
__device__ int syndrome_ok(const int* hard, const Tables& t, int M, int dc,
                           int P) {
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

// Start of a frame: mx[v] = max_q llr, post = prior = llr - mx, lc = 0,
// hard = argmax of the prior.
template <int Q>
__device__ void init_phase(const float* L, float* post, float* lc, float* mx,
                           int* hard, int N, int E) {
  constexpr int K = Q / 32;
  const int lane = threadIdx.x & 31;
  for (int v = threadIdx.x >> 5; v < N; v += kWarps) {
    float x[K];
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      x[k] = L[v * Q + k * 32 + lane];
      m = fmaxf(m, x[k]);
    }
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, h));
    float best = -INFINITY;
    int idx = Q;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float p = x[k] - m;
      post[v * Q + k * 32 + lane] = p;
      if (p > best) {
        best = p;
        idx = k * 32 + lane;
      }
    }
    idx = warp_argmax(best, idx);
    if (lane == 0) {
      mx[v] = m;
      hard[v] = idx;
    }
  }
  for (int i = threadIdx.x; i < E * Q; i += blockDim.x) lc[i] = 0.f;
}

// Check-node phase: every check's dc edge messages lc[e] are replaced.
// Warp w owns checks w, w + kWarps, ...; buf is its dc x (Q + 1) rows,
// sums its dc softmax sums.
template <int Q>
__device__ void cn_phase(const float* post, float* lc, float* buf, float* sums,
                         const int* s_n2e, const Tables& t, int M, int dc) {
  constexpr int K = Q / 32;
  constexpr int R = Q + 1;
  const int lane = threadIdx.x & 31;
  for (int m = threadIdx.x >> 5; m < M; m += kWarps) {
    // exp(U) of every edge of the check
    for (int j = 0; j < dc; ++j) {
      const int e = m * dc + j;
      const int v = __ldg(&t.cn_vn[e]);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int pd = __ldg(&t.perm_down[e * Q + k * 32 + lane]);
        buf[j * R + k * 32 + lane] = expf(post[v * Q + pd] - lc[e * Q + pd]);
      }
    }
    __syncwarp();
    // softmax sums, serially in exp order: lane j sums row j
    if (lane < dc) {
      const float* row = buf + lane * R;
      float s = row[s_n2e[0]];
      for (int k = 1; k < Q; ++k) s += row[s_n2e[k]];
      sums[lane] = s;
    }
    __syncwarp();
    // spectra F_j = WHT(P_j), in place (a lane touches only its symbols)
    for (int j = 0; j < dc; ++j) {
      const bool real = __ldg(&t.cn_real[m * dc + j]) != 0;
      const float s = sums[j];
      float r[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int x = k * 32 + lane;
        r[k] = real ? buf[j * R + x] / s : (x == 0 ? 1.f : 0.f);
      }
      wht_warp<Q>(r, lane);
#pragma unroll
      for (int k = 0; k < K; ++k) buf[j * R + k * 32 + lane] = r[k];
    }
    // leave-one-out products, inverse WHT, floor, log, permute up
    float runp[K];
#pragma unroll
    for (int k = 0; k < K; ++k) runp[k] = 1.f;
    for (int j = 0; j < dc; ++j) {
      const int e = m * dc + j;
      float g[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int x = k * 32 + lane;
        float sj = 1.f;
        for (int i = dc - 1; i > j; --i) sj = sj * buf[i * R + x];
        g[k] = runp[k] * sj;
        runp[k] = runp[k] * buf[j * R + x];
      }
      wht_warp<Q>(g, lane);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int pd = __ldg(&t.perm_down[e * Q + k * 32 + lane]);
        lc[e * Q + pd] = logf(fmaxf(g[k] * (1.0f / Q), kProbFloor));
      }
    }
    __syncwarp();
  }
}

// Variable-node phase, one warp per variable: post = prior + the sum of
// the variable's edge messages in slot order; with `decide`, hard = argmax.
template <int Q>
__device__ void vn_phase(const float* L, const float* mx, const float* lc,
                         float* post, int* hard, const Tables& t, int N, int dv,
                         int E, bool decide) {
  constexpr int K = Q / 32;
  const int lane = threadIdx.x & 31;
  for (int v = threadIdx.x >> 5; v < N; v += kWarps) {
    float best = -INFINITY;
    int idx = Q;
    const float m = mx[v];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int a = k * 32 + lane;
      float acc = 0.f;
      for (int s = 0; s < dv; ++s) {
        const int e = __ldg(&t.vn_edge[v * dv + s]);
        if (e < E) acc += lc[e * Q + a];
      }
      const float p = (L[v * Q + a] - m) + acc;
      post[v * Q + a] = p;
      if (p > best) {
        best = p;
        idx = a;
      }
    }
    if (decide) {
      idx = warp_argmax(best, idx);
      if (lane == 0) hard[v] = idx;
    }
  }
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
qspa_resident_cl_kernel(const float* __restrict__ llr, int* __restrict__ hard_out,
                        uint8_t* __restrict__ done_out, int* __restrict__ iters_out,
                        float* scratch, int B, int N, int M, int dc,
                        int dv, int P, Tables t, int max_iters, int early_term,
                        int stats_each_iter) {
  extern __shared__ float smem[];
  __shared__ int s_n2e[Q];
  const int E = M * dc;
  const int warp = threadIdx.x >> 5;
  float* buf = smem + warp * dc * (Q + 1);              // [dc, Q + 1] per warp
  float* sums = smem + kWarps * dc * (Q + 1) + warp * dc;  // [dc] per warp
  float* mx = smem + kWarps * dc * (Q + 2);             // [N]
  int* hard = reinterpret_cast<int*>(mx + N);           // [N]
  float* post = scratch + (size_t)blockIdx.x * (N + E) * Q;   // [N, Q]
  float* lc = post + (size_t)N * Q;                     // [E, Q] c-domain
  for (int i = threadIdx.x; i < Q; i += blockDim.x) s_n2e[i] = __ldg(&t.n2e[i]);
  // Outputs are final once a frame is done, except in throughput mode,
  // where the decision is taken after the whole budget.
  const bool may_stop = early_term || stats_each_iter;

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const float* L = llr + (size_t)b * N * Q;
    init_phase<Q>(L, post, lc, mx, hard, N, E);
    __syncthreads();
    const int done0 = syndrome_ok(hard, t, M, dc, P);
    int done = done0;
    int iters = 0;
    for (int it = 0; it < max_iters; ++it) {
      if (may_stop && done) break;
      cn_phase<Q>(post, lc, buf, sums, s_n2e, t, M, dc);
      __syncthreads();
      vn_phase<Q>(L, mx, lc, post, hard, t, N, dv, E,
                  stats_each_iter || it == max_iters - 1);
      __syncthreads();
      if (!stats_each_iter) {
        iters += 1 - done0;
        continue;
      }
      done = syndrome_ok(hard, t, M, dc, P);
      iters += 1;
    }
    if (!stats_each_iter) done = syndrome_ok(hard, t, M, dc, P);
    for (int v = threadIdx.x; v < N; v += blockDim.x)
      hard_out[(size_t)b * N + v] = hard[v];
    if (threadIdx.x == 0) {
      done_out[b] = (uint8_t)done;
      iters_out[b] = iters;
    }
    __syncthreads();                     // hard and mx are the next frame's
  }
}

// Checks the layout against the card's limits, sets the kernel's dynamic
// shared memory (*smem bytes) and returns the blocks of the persistent
// grid (at most B).
template <int Q>
cudaError_t grid_size(int B, int N, int dc, int* grid, int* smem) {
  const size_t bytes = smem_bytes(N, dc, Q);
  // the static s_n2e[Q] shares the block's shared memory
  if (bytes + Q * sizeof(int) > kMaxSmem || dc > kMaxDc) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(qspa_resident_cl_kernel<Q>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, qspa_resident_cl_kernel<Q>, kThreads, bytes)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long resident = (long)per_sm * sms;
  *grid = (int)(B < resident ? B : resident);
  *smem = (int)bytes;
  return cudaSuccess;
}

template <int Q>
cudaError_t launch(const float* llr, int* hard, uint8_t* done, int* iters,
                   float* scratch, int grid, int smem, int B, int N, int M, int dc,
                   int dv, int P, const Tables& t, int max_iters, int early_term,
                   int stats_each_iter, cudaStream_t stream) {
  qspa_resident_cl_kernel<Q><<<grid, kThreads, smem, stream>>>(
      llr, hard, done, iters, scratch, B, N, M, dc, dv, P, t, max_iters,
      early_term, stats_each_iter);
  return cudaGetLastError();
}

}  // namespace

// Blocks of the persistent grid for a batch of B frames (at most B) and
// the dynamic shared memory of a block, both for qspa_resident_cl_decode:
// the caller sizes the scratch as grid * (N + M dc) * q floats. Returns
// cudaErrorInvalidValue for a q, dc or N the kernel does not take.
extern "C" int qspa_resident_cl_grid(int B, int N, int M, int dc, int q,
                                     int* grid, int* smem) {
  (void)M;
  switch (q) {
    case 64: return grid_size<64>(B, N, dc, grid, smem);
    case 128: return grid_size<128>(B, N, dc, grid, smem);
    case 256: return grid_size<256>(B, N, dc, grid, smem);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int qspa_resident_cl_decode(
    const float* llr, int* hard, uint8_t* done, int* iters, float* scratch,
    int grid, int smem, int B, int N, int M, int dc, int dv, int q,
    const int* cn_vn, const int* cn_real, const int* perm_down,
    const int* vn_edge, const int* syn_k, const int* n2e,
    int max_iters, int early_term, int stats_each_iter, void* stream) {
  const Tables t{cn_vn, cn_real, perm_down, vn_edge, syn_k, n2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return cudaSuccess;
  if (grid < 1) return cudaErrorInvalidValue;
  switch (q) {
    case 64:
      return launch<64>(llr, hard, done, iters, scratch, grid, smem, B, N, M, dc,
                        dv, 6, t, max_iters, early_term, stats_each_iter, s);
    case 128:
      return launch<128>(llr, hard, done, iters, scratch, grid, smem, B, N, M, dc,
                         dv, 7, t, max_iters, early_term, stats_each_iter, s);
    case 256:
      return launch<256>(llr, hard, done, iters, scratch, grid, smem, B, N, M, dc,
                         dv, 8, t, max_iters, early_term, stats_each_iter, s);
    default:
      return cudaErrorInvalidValue;
  }
}
