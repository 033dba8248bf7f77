// Whole QSPA decode for large fields (q = 64, 128, 256) with each frame's
// whole state on chip, spread over the shared memory of one thread-block
// cluster: K0-cl, the redesign of csrc/qspa_resident_cl.cu, which stays
// for codes whose state does not fit a cluster of 8.
//
// Replaces: nbldpc_tpu/kernels/qspa_resident.py, ResidentQSPA._kernel /
// __call__ (the Pallas K0-cl kernel, the JAX package's QSPA default for
// q > 32).
//
// Probability-domain BP in the plain version's association order
// (nbldpc_tpu_torch/kernels/qspa_resident.py:_iteration, run_plain):
//   prior = llr - max_q llr;  post = prior;  lc = 0
//   per iteration, per edge e = (m, j) with variable v and weight h:
//     U(x)  = post[v](h^-1 x) - lc[e](h^-1 x)
//     P     = exp(U) / S, S summed serially in exp order (0, 1, a, a^2,
//             ...); delta0 on pad slots
//     F     = WHT(P), stages h = 1, 2, ..., q / 2
//     G_j   = (F_0 ... F_{j-1}) * suf(j), suf(dc - 1) = 1,
//             suf(j) = suf(j + 1) * F_{j+1}  (the plain version's
//             ((F_{dc-1} F_{dc-2}) ...) F_{j+1}, built once per check)
//     lc[e](h^-1 x) = log(max(WHT(G_j)(x) / q, 1e-12))
//   post[v] = prior[v] + sum of lc over v's edges, in vn_edge slot order
//   hard = argmax (ties to the lowest symbol); syndrome: XOR of h * hard.
//
// What bounds it on the H100: operations. About 10 q + 2 q log2 q per
// edge and iteration, 3.0e11 for 4096 frames x 20 iterations of GF(256)
// (255,175), 4.5 ms at 67 TFLOP/s f32; the LLRs and decisions, read and
// written once, take 0.3 ms. The scratch kernel streamed ~2.8 MB of state
// per frame and iteration through HBM; here none of it leaves the chip.
//
// Design. The host plans the partition (kernels/qspa_resident.py,
// plan_cluster): the cluster has C = 1, 2, 4 or 8 blocks ("ranks"), the
// smallest C whose share of a frame fits a block's 227 KB. Rank r owns
// the checks [r cpr, (r + 1) cpr) and their dc message rows each, and a
// set of variables, each placed with one of its checks, with its prior
// and posterior rows and its hard decision. The prior stays in shared
// memory (the plan counts it in each rank's share), so the LLRs are read
// from HBM once per frame. A persistent grid of as many clusters as
// cudaOccupancyMaxActiveClusters allows walks the frames.
// The kernel is bound by latency and instruction throughput (one block
// per SM), so the whole block works on one phase at a time over many
// independent rows and columns, every table a phase reads sits in the
// rank's shared memory (copied there once per launch: per edge slot its
// variable's (rank, row) and shift, per posterior row its variable and
// message sources), and loads from other ranks are started a few rows at
// a time.
//   CN phase, for the rank's checks in rounds that fit the buffer (one
//   round at GF(256)), block barriers between its steps:
//   Posterior, prior and message rows are kept in exp order (position 0
//   symbol 0, position i > 0 symbol a^(i-1)), where multiplying by h^-1
//   rotates positions 1 .. Q - 1 by shift(h) = (Q - 1 - log h) mod (Q - 1).
//   A. per edge row, one warp, lane l holding positions l, l + 32, ...:
//      U read as a rotation of the variable's posterior row (local or in
//      another rank's shared memory: distributed shared memory, nearly
//      contiguous) and of the message row; exp(U) stored in exp order.
//   B. one thread per edge row sums it serially in exp order, contiguous
//      (16-byte loads; rows Q + 4 apart).
//   C. per row, one warp, lane l holding symbols l, l + 32, ...: P =
//      exp(U) / S read at position log x + 1 (the lane's logs in
//      registers), F = WHT(P), back in x order.
//   D. one thread per (check, symbol), two at a time: the suffix
//      products, then the leave-one-out products G_j, both in the check's
//      own message rows (free once read in A).
//   E. per row, one warp: WHT(G_j), floor, log, written in place at the
//      exp-order position of h^-1 x.
//   VN phase: one warp per owned variable, two at a time, sums its
//   message rows, local or remote (8- or 16-byte loads), in slot order;
//   the hard decision by warp shuffles, ties to the lowest symbol (not
//   position).
//   Syndrome: one warp per check, lane j forming h_j * hard (log/exp
//   tables) and the warp XOR-reducing; each rank publishes one flag, and
//   after a cluster barrier every rank ORs the C flags, so all agree on
//   `done` and stop together.
// cluster.sync() (barrier.cluster arrive.release / wait.acquire)
// separates the CN, VN and syndrome phases, and precedes the exit, so no
// rank's shared memory goes away while another reads it. What this kernel
// shares with the scratch kernel (the helpers, the syndrome, steps B and
// C, the frame loop) is in qspa_cluster.cuh.

#include "qspa_cluster.cuh"

namespace {

using namespace k0cl;

// Dynamic shared memory of a block, in the order the kernel lays it out:
// prior and posterior [nv, Q], messages [cpr dc, Q], the round's rc dc
// rows of Q + 4 floats and their sums, hard [nv], two syndrome flags, and
// the rank's tables (edge_info [cpr dc], row_src [nv dv], row_var [nv]).
// kernels/qspa_resident.py:cluster_smem_bytes mirrors it and adds the
// static tables (n2e [Q], log [Q] and exp [2Q] ints).
size_t dyn_bytes(int nv, int cpr, int rc, int dc, int dv, int Q) {
  return ((size_t)2 * nv * Q + (size_t)cpr * dc * Q + (size_t)rc * dc * (Q + 5) + nv + 2 +
          (size_t)cpr * dc + (size_t)nv * dv + nv) *
         sizeof(float);
}

// Whole-row moves with 8- or 16-byte accesses (vec_width).
__device__ __forceinline__ void ld_vec(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void ld_vec(const float* p, float (&o)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  o[0] = v.x; o[1] = v.y;
}
__device__ __forceinline__ void st_vec(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void st_vec(float* p, const float (&o)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
}

// The rank's shared-memory view: state, buffers and tables.
struct Rank {
  float* prior;      // [nv, Q]
  float* post;       // [nv, Q]
  float* lc;         // [cpr dc, Q] c-domain messages of the rank's checks
  float* buf;        // [rc dc, Q + 4] the round's edge rows
  float* sums;       // [rc dc]
  int* hard;         // [nv]
  int* flag;         // [2]
  int* edge_info;    // [cpr dc]
  int* row_src;      // [nv dv]
  int* row_var;      // [nv]
  const int* n2e;    // [Q]
  const int* log;    // [Q]
  const int* exp;    // [2Q]
  int nv, nchk, rc, dc, dv;
};

// Start of a frame: prior = post = llr - max_q llr for the rank's
// variables, hard = argmax of the prior, the rank's messages = 0.
template <int Q>
__device__ void init_phase(const float* L, const Rank& r) {
  constexpr int K = Q / 32;
  const int lane = threadIdx.x & 31;
  const int W = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < r.nv; i += W) {
    const int v = r.row_var[i];
    if (v < 0) continue;
    float x[K];
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      x[k] = L[(size_t)v * Q + r.n2e[k * 32 + lane]];
      m = fmaxf(m, x[k]);
    }
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, h));
    float best = -INFINITY;
    int idx = Q;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int a = k * 32 + lane;
      const float p = x[k] - m;
      r.prior[i * Q + a] = p;
      r.post[i * Q + a] = p;
      const int sym = r.n2e[a];
      if (p > best || (p == best && sym < idx)) {
        best = p;
        idx = sym;
      }
    }
    idx = warp_argmax(best, idx);
    if (lane == 0) r.hard[i] = idx;
  }
  for (int i = threadIdx.x; i < r.nchk * r.dc * Q; i += blockDim.x) r.lc[i] = 0.f;
}

// Check-node phase over the rank's checks, rc at a time, steps A-E of
// the header; logx[k] = log(k * 32 + lane).
template <int Q>
__device__ void cn_phase(const cg::cluster_group& cl, const Rank& r, const int (&logx)[Q / 32]) {
  constexpr int K = Q / 32;
  constexpr int RS = Q + 4;                   // buffer row stride: 16-byte rows
  constexpr int G = K >= 16 ? 1 : 16 / K;     // posterior rows in flight per warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int dc = r.dc;
  for (int c0 = 0; c0 < r.nchk; c0 += r.rc) {
    const int nrow = min(r.rc, r.nchk - c0) * dc;
    const int* info = r.edge_info + c0 * dc;   // the round's rows t = (c - c0) dc + j
    float* rows = r.lc + c0 * dc * Q;          // the round's messages
    // A: exp(U) of every real edge row, in exp order: a rotation of the
    // posterior and message rows, G rows in flight
    for (int t0 = warp * G; t0 < nrow; t0 += W * G) {
      float u[G][K];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int loc = t0 + g < nrow ? info[t0 + g] : -1;
        if (loc < 0) continue;
        const float* pv = cl.map_shared_rank(r.post, rank_of(loc)) + row_of(loc) * Q;
        const float* lr = rows + (t0 + g) * Q;
        const int sh = shift_of(loc);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int i = k * 32 + lane;
          const int src = rot<Q>(i, sh);
          u[g][k] = pv[src] - lr[src];
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (t0 + g >= nrow || info[t0 + g] < 0) continue;
        float* bt = r.buf + (t0 + g) * RS;
#pragma unroll
        for (int k = 0; k < K; ++k) bt[k * 32 + lane] = expf(u[g][k]);
      }
    }
    __syncthreads();
    // B: softmax sums, serially in exp order, one thread per row
    softmax_sums<Q>(r.buf, r.sums, info, nrow);
    __syncthreads();
    // C: spectra F = WHT(P), P read in x order, written back in x order
    spectra<Q>(r.buf, r.sums, info, nrow, logx);
    __syncthreads();
    // D: per (check, symbol) the suffix products suf(j) into message row
    // j, then G_j = prefix * suf(j) over them; two columns per thread at
    // a time
    const int ncol = nrow / dc * Q;
    for (int i0 = threadIdx.x; i0 < ncol; i0 += 2 * blockDim.x) {
      float* mr[2];
      const float* fr[2];
      float acc[2] = {1.f, 1.f};
      const int i1 = i0 + (int)blockDim.x < ncol ? i0 + (int)blockDim.x : i0;  // i0 twice
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int i = n ? i1 : i0;
        mr[n] = rows + (i / Q) * dc * Q + i % Q;
        fr[n] = r.buf + (i / Q) * dc * RS + i % Q;
      }
      for (int j = dc - 1; j >= 0; --j) {
        const float f0 = fr[0][j * RS], f1 = fr[1][j * RS];
        mr[0][j * Q] = acc[0];
        mr[1][j * Q] = acc[1];
        acc[0] = acc[0] * f0;
        acc[1] = acc[1] * f1;
      }
      acc[0] = acc[1] = 1.f;
      for (int j = 0; j < dc; ++j) {
        const float f0 = fr[0][j * RS], f1 = fr[1][j * RS];
        const float s0 = mr[0][j * Q], s1 = mr[1][j * Q];
        mr[0][j * Q] = acc[0] * s0;
        mr[1][j * Q] = acc[1] * s1;
        acc[0] = acc[0] * f0;
        acc[1] = acc[1] * f1;
      }
    }
    __syncthreads();
    // E: inverse WHT, floor, log, permuted up in place, one warp per row
    for (int t = warp; t < nrow; t += W) {
      float* mt = rows + t * Q;
      float g[K];
#pragma unroll
      for (int k = 0; k < K; ++k) g[k] = mt[k * 32 + lane];
      wht_warp<Q>(g, lane);
      __syncwarp();                       // the row is read before it is overwritten
      const int loc = info[t];
      const int sh = loc < 0 ? 0 : shift_of(loc);   // pads: weight 1
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int x = k * 32 + lane;            // to h^-1 x, in exp order
        mt[x ? rot<Q>(logx[k] + 1, sh) : 0] = logf(fmaxf(g[k] * (1.0f / Q), kProbFloor));
      }
    }
    __syncthreads();                      // the buffer is the next round's
  }
}

// Variable-node phase over the rank's variables, one warp per variable,
// two at a time: post = prior + the sum of the variable's message rows in
// slot order, wherever they live, a lane moving V consecutive floats;
// with `decide`, hard = argmax.
template <int Q>
__device__ void vn_phase(const cg::cluster_group& cl, const Rank& r, bool decide) {
  constexpr int V = vec_width<Q>();
  constexpr int NV = Q / 32 / V;
  constexpr int NR = 2;
  const int lane = threadIdx.x & 31;
  const int W = blockDim.x >> 5;
  for (int i0 = threadIdx.x >> 5; i0 < r.nv; i0 += NR * W) {
    float acc[NR][NV][V];
#pragma unroll
    for (int n = 0; n < NR; ++n)
#pragma unroll
      for (int kk = 0; kk < NV; ++kk)
#pragma unroll
        for (int c = 0; c < V; ++c) acc[n][kk][c] = 0.f;
    for (int s = 0; s < r.dv; ++s) {
#pragma unroll
      for (int n = 0; n < NR; ++n) {
        const int i = i0 + n * W;
        const int src = i < r.nv ? r.row_src[i * r.dv + s] : -1;
        if (src < 0) continue;
        const float* row = cl.map_shared_rank(r.lc, rank_of(src)) + row_of(src) * Q;
#pragma unroll
        for (int kk = 0; kk < NV; ++kk) {
          float v[V];
          ld_vec(row + (kk * 32 + lane) * V, v);
#pragma unroll
          for (int c = 0; c < V; ++c) acc[n][kk][c] += v[c];
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NR; ++n) {
      const int i = i0 + n * W;
      if (i >= r.nv || r.row_var[i] < 0) continue;
      float best = -INFINITY;
      int idx = Q;
#pragma unroll
      for (int kk = 0; kk < NV; ++kk) {
        const int a0 = (kk * 32 + lane) * V;
        float p[V];
        ld_vec(r.prior + i * Q + a0, p);
#pragma unroll
        for (int c = 0; c < V; ++c) {
          p[c] = p[c] + acc[n][kk][c];
          const int sym = r.n2e[a0 + c];
          if (p[c] > best || (p[c] == best && sym < idx)) {
            best = p[c];
            idx = sym;
          }
        }
        st_vec(r.post + i * Q + a0, p);
      }
      if (decide) {
        idx = warp_argmax(best, idx);
        if (lane == 0) r.hard[i] = idx;
      }
    }
  }
}

template <int Q>
__global__ void __launch_bounds__(max_warps<Q>() * 32, 1)
qspa_cluster_kernel(const float* __restrict__ llr, int* __restrict__ hard_out,
                    uint8_t* __restrict__ done_out, int* __restrict__ iters_out, int B,
                    int N, int M, int dc, int dv, int nv, int cpr, int rc, Tables t,
                    int max_iters,
                    int early_term, int stats_each_iter) {
  constexpr int K = Q / 32;
  extern __shared__ float smem[];
  __shared__ int s_n2e[Q], s_log[Q], s_exp[2 * Q];
  const cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  Rank r;
  r.prior = smem;
  r.post = r.prior + nv * Q;
  r.lc = r.post + nv * Q;
  r.buf = r.lc + cpr * dc * Q;
  r.sums = r.buf + rc * dc * (Q + 4);
  r.hard = reinterpret_cast<int*>(r.sums + rc * dc);
  r.flag = r.hard + nv;
  r.edge_info = r.flag + 2;
  r.row_src = r.edge_info + cpr * dc;
  r.row_var = r.row_src + nv * dv;
  r.n2e = s_n2e;
  r.log = s_log;
  r.exp = s_exp;
  r.nv = nv;
  r.nchk = max(0, min(cpr, M - rank * cpr));
  r.rc = rc;
  r.dc = dc;
  r.dv = dv;
  int logx[K];
  load_tables<Q>(t, rank, cpr, r, s_n2e, s_log, s_exp, logx);
  __syncthreads();
  run_frames<Q>(
      cl, r, blockIdx.x / C, gridDim.x / C, B, N, max_iters, early_term, stats_each_iter,
      hard_out, done_out, iters_out,
      [&](int b) { init_phase<Q>(llr + (size_t)b * N * Q, r); },
      [&](int, int) { cn_phase<Q>(cl, r, logx); },
      [&](int, bool decide) { vn_phase<Q>(cl, r, decide); });
}

// The launch configuration of a cluster of C blocks of W warps, each
// with `smem` bytes of shared memory in all (the static tables included;
// grid: one cluster), after checking it against the layout and the
// kernel's limits and setting the attribute.
template <int Q>
cudaError_t configure(int dc, int dv, int C, int nv, int cpr, int rc, int W, int smem,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const size_t dyn = dyn_bytes(nv, cpr, rc, dc, dv, Q);
  if (!plan_ok<Q>(C, W, dc, dv, nv, cpr, rc) || dyn + 4 * Q * sizeof(int) != (size_t)smem ||
      (size_t)smem > kMaxSmem)
    return cudaErrorInvalidValue;
  return cluster_config(qspa_cluster_kernel<Q>, C, W, dyn, cfg, attr);
}

template <int Q>
cudaError_t max_clusters(int dc, int dv, int C, int nv, int cpr, int rc, int W, int smem,
                         int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<Q>(dc, dv, C, nv, cpr, rc, W, smem, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters, qspa_cluster_kernel<Q>, &cfg);
}

template <int Q>
cudaError_t launch(const float* llr, int* hard, uint8_t* done, int* iters, int B, int N,
                   int M, int dc, int dv, int C, int nv, int cpr, int rc, int W, int smem,
                   const Tables& t, int max_iters, int early_term, int stats_each_iter,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<Q>(dc, dv, C, nv, cpr, rc, W, smem, &cfg, &attr);
  if (err != cudaSuccess) return err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, qspa_cluster_kernel<Q>, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3((B < clusters ? B : clusters) * C);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, qspa_cluster_kernel<Q>, llr, hard, done, iters, B, N, M,
                           dc, dv, nv, cpr, rc, t, max_iters, early_term, stats_each_iter);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// cudaOccupancyMaxActiveClusters of the kernel at this plan: how many
// clusters run at once, the persistent grid of qspa_cluster_decode.
extern "C" int qspa_cluster_occupancy(int q, int dc, int dv, int C, int nv, int cpr, int rc,
                                      int W, int smem, int* clusters) {
  switch (q) {
    case 64: return max_clusters<64>(dc, dv, C, nv, cpr, rc, W, smem, clusters);
    case 128: return max_clusters<128>(dc, dv, C, nv, cpr, rc, W, smem, clusters);
    case 256: return max_clusters<256>(dc, dv, C, nv, cpr, rc, W, smem, clusters);
    default: return cudaErrorInvalidValue;
  }
}

// The decode of B frames under a plan from kernels/qspa_resident.py:
// clusters of C blocks of W warps, nv posterior rows and cpr checks per
// rank (rc checks per round of the CN phase), `smem` bytes of shared memory per block in all (checked against
// the layout above). Returns cudaErrorInvalidValue for a plan or q the
// kernel does not take.
extern "C" int qspa_cluster_decode(
    const float* llr, int* hard, uint8_t* done, int* iters, int B, int N, int M, int dc,
    int dv, int q, int C, int nv, int cpr, int rc, int W, int smem, const int* edge_info,
    const int* row_src, const int* row_var, const int* n2e, const int* gf_log,
    const int* gf_exp, int max_iters, int early_term, int stats_each_iter, void* stream) {
  const Tables t{edge_info, row_src, row_var, n2e, gf_log, gf_exp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return cudaSuccess;
  switch (q) {
    case 64:
      return launch<64>(llr, hard, done, iters, B, N, M, dc, dv, C, nv, cpr, rc, W, smem, t,
                        max_iters, early_term, stats_each_iter, s);
    case 128:
      return launch<128>(llr, hard, done, iters, B, N, M, dc, dv, C, nv, cpr, rc, W, smem, t,
                         max_iters, early_term, stats_each_iter, s);
    case 256:
      return launch<256>(llr, hard, done, iters, B, N, M, dc, dv, C, nv, cpr, rc, W, smem, t,
                         max_iters, early_term, stats_each_iter, s);
    default:
      return cudaErrorInvalidValue;
  }
}
