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
// plan_cluster): the cluster has C = 1, 2, 4 or 8 blocks ("ranks"). Rank r
// owns the checks [r cpr, (r + 1) cpr) and their dc message rows each, and
// a set of variables, each placed with one of its checks, with its
// posterior row and its hard decision. A persistent grid of as many
// clusters as cudaOccupancyMaxActiveClusters allows walks the frames, one
// frame a cluster at a time. Each block lays its share out in one of two
// ways, by the code's shape:
//   buffered (f32 and bf16): the frame's prior, posterior and message rows
//   and a buffer of rc checks' edge rows (Q + 4 floats apart) that the
//   check phase runs through in rounds; the smallest C that holds that.
//   in place (f32): the posterior rows and the message rows, Q + 4 floats
//   apart, which are themselves the check phase's buffer (every check at
//   once); the priors in the wrapper's global scratch (a slice per
//   cluster and rank, written at the frame's start; the L2 holds it); the
//   smallest C that holds that. The plan takes it where that C is smaller
//   than buffered's, which puts more frames on the card (config 5's
//   GF(256) code: 4 blocks in place against 8 buffered).
// The kernel is bound by latency and instruction throughput (one block
// per SM), so the whole block works on one phase at a time over many
// independent rows and columns, every table a phase reads sits in the
// rank's shared memory (copied there once per launch: per edge slot its
// variable's (rank, row) and shift, per posterior row its variable and
// message sources), and loads from other ranks are started a few rows at
// a time.
//   CN phase, for the rank's checks in rounds that fit the buffer (in
//   place and at GF(256), one round), block barriers between its steps:
//   Posterior, prior and message rows are kept in exp order (position 0
//   symbol 0, position i > 0 symbol a^(i-1)), where multiplying by h^-1
//   rotates positions 1 .. Q - 1 by shift(h) = (Q - 1 - log h) mod (Q - 1).
//   A. per edge row, one warp, lane l holding positions l, l + 32, ...,
//      G rows in flight: U read as a rotation of the variable's posterior
//      row (local or in another rank's shared memory: distributed shared
//      memory, nearly contiguous) and of the message row into registers;
//      exp(U) written in exp order to the buffer (in place: over the
//      message row).
//   B. one thread per edge row sums it serially in exp order, contiguous
//      (16-byte loads).
//   C. per row, one warp, lane l holding symbols l, l + 32, ...: P =
//      exp(U) / S read at position log x + 1, F = WHT(P), back in x order.
//   D. one thread per (check, symbol): the leave-one-out products G_j,
//      prefix * suf(j). In place: the suffix products in registers, G_j
//      written over F_j. Buffered, f32: the suffix products in the check's
//      own message rows (free once read in A), two columns a thread. bf16:
//      as in place, over the spectra in the buffer.
//   E. per row, one warp: WHT(G_j), floor, log, written to the message row
//      at the exp-order position of h^-1 x.
//   VN phase: one warp per owned variable, two at a time, sums its
//   message rows, local or remote (8- or 16-byte loads), in slot order,
//   and adds the prior; the hard decision by warp shuffles, ties to the
//   lowest symbol (not position).
//   Syndrome: one warp per check, lane j forming h_j * hard (log/exp
//   tables) and the warp XOR-reducing; each rank publishes one flag, and
//   after a cluster barrier every rank ORs the C flags, so all agree on
//   `done` and stop together.
// cluster.sync() (barrier.cluster arrive.release / wait.acquire)
// separates the CN, VN and syndrome phases, and precedes the exit, so no
// rank's shared memory goes away while another reads it. What this kernel
// shares with the scratch kernel (the helpers, the syndrome, steps B and
// C, step D over spectra in place, the frame loop) is in qspa_cluster.cuh.
//
// bf16 (mm_precision="bf16", T = __nv_bfloat16; buffered): prior,
// posterior and message rows are stored in bf16, rounded where the plain
// version rounds them (U before the exp, each log as it is stored, the
// posterior sum and the posterior); the buffer and all arithmetic stay
// f32. Half the state bytes take half the ranks (config 5's GF(256) code:
// a cluster of 4 in place of 8). The message rows then leave no room for
// step D's f32 products: it runs over the spectra in the buffer, in place
// (the scratch kernel's step D), and step E reads G_j there.

#include <type_traits>

#include "qspa_cluster.cuh"

namespace {

using namespace k0cl;

// Dynamic shared memory of a block, in the order the kernel lays it out.
// Buffered: prior and posterior [nv, Q] and messages [cpr dc, Q] (es-byte
// elements), the round's rc dc rows of Q + 4 floats and their sums, hard
// [nv], two syndrome flags, the tables (edge_info [cpr dc], row_src [nv
// dv], row_var [nv]). In place: posterior [nv, Q], message rows [cpr dc,
// Q + 4] and their sums [cpr dc], hard, flags and tables as buffered.
// kernels/qspa_resident.py: cluster_smem_bytes mirrors it and adds the
// static tables (n2e [Q], log [Q] and exp [2Q] ints).
size_t dyn_bytes(int nv, int cpr, int rc, int dc, int dv, int Q, int es, bool in_place) {
  const size_t ints = (size_t)nv + (size_t)cpr * dc + (size_t)nv * dv + nv + 2;
  if (in_place) return ((size_t)nv * Q + (size_t)cpr * dc * (Q + 5) + ints) * sizeof(float);
  return ((size_t)2 * nv * Q + (size_t)cpr * dc * Q) * es +
         ((size_t)rc * dc * (Q + 5) + ints) * sizeof(float);
}

// The rank's shared-memory view: state (elements T), buffers and tables.
template <class T>
struct Rank {
  T* prior;          // [nv, Q] in shared memory (buffered), or the rank's
                     // slice of the priors in global memory (in place)
  T* post;           // [nv, Q]
  T* lc;             // [cpr dc, LS] c-domain messages of the rank's checks
  float* buf;        // buffered: [rc dc, Q + 4] the round's edge rows; in place: null
  float* sums;       // [rc dc] (in place rc = cpr: every check's)
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

// The row stride of the message rows: Q + 4 floats in place (IP), where
// they are the check phase's buffer; else Q elements.
template <int Q, bool IP>
__host__ __device__ constexpr int lc_stride() { return IP ? Q + 4 : Q; }

// Start of a frame: prior = post = llr - max_q llr for the rank's
// variables, hard = argmax of the prior, the rank's messages = 0.
template <int Q, class T, bool IP>
__device__ void init_phase(const float* L, const Rank<T>& r) {
  constexpr int K = Q / 32;
  constexpr int LS = lc_stride<Q, IP>();
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
      const float p = state::rnd<T>(x[k] - m);
      r.prior[i * Q + a] = state::put<T>(p);
      r.post[i * Q + a] = state::put<T>(p);
      const int sym = r.n2e[a];
      if (p > best || (p == best && sym < idx)) {
        best = p;
        idx = sym;
      }
    }
    idx = warp_argmax(best, idx);
    if (lane == 0) r.hard[i] = idx;
  }
  for (int i = threadIdx.x; i < r.nchk * r.dc * Q; i += blockDim.x)
    r.lc[(i / Q) * LS + i % Q] = state::put<T>(0.f);
}

// logx[k] = log(k * 32 + lane), from the field's table (shared memory),
// for the phase steps that read it (C and E)
template <int Q>
__device__ __forceinline__ void lane_logs(const int* log, int (&logx)[Q / 32]) {
#pragma unroll
  for (int k = 0; k < Q / 32; ++k) logx[k] = log[k * 32 + (threadIdx.x & 31)];
}

// A round's spectra in rows Q + 4 floats apart, as qspa_cluster.cuh's
// loo_products reads them (buf and dc)
struct Spectra {
  float* buf;
  int dc;
};

// Step D of the buffered f32 build: per (check, symbol) the suffix
// products suf(j) into message row j (rows Q floats apart, free once step
// A read them), then G_j = prefix * suf(j) over them, F_j read from the
// buffer (rows Q + 4 floats apart), two columns per thread at a time.
template <int Q>
__device__ __forceinline__ void suffix_in_rows(float* rows, const float* buf, int dc, int nrow) {
  constexpr int RS = Q + 4;
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
      fr[n] = buf + (i / Q) * dc * RS + i % Q;
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
}

// Step E, per row, one warp: WHT(G_j) read from `src` (rows SS floats
// apart), floor, log, written as T to the row of `dst` (rows DS elements
// apart; in f32 the same rows) at the exp-order position of h^-1 x.
template <int Q, int SS, int DS, class T>
__device__ __forceinline__ void log_rows(const float* src, T* dst, const int* info, int nrow,
                                         const int* log) {
  constexpr int K = Q / 32;
  const int lane = threadIdx.x & 31;
  const int W = blockDim.x >> 5;
  int logx[K];
  lane_logs<Q>(log, logx);
  for (int t = threadIdx.x >> 5; t < nrow; t += W) {
    float g[K];
#pragma unroll
    for (int k = 0; k < K; ++k) g[k] = src[t * SS + k * 32 + lane];
    wht_warp<Q>(g, lane);
    __syncwarp();                       // the row is read before it is overwritten
    const int loc = info[t];
    const int sh = loc < 0 ? 0 : shift_of(loc);   // pads: weight 1
    T* mt = dst + t * DS;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int x = k * 32 + lane;            // to h^-1 x, in exp order
      mt[x ? rot<Q>(logx[k] + 1, sh) : 0] =
          state::put<T>(logf(fmaxf(g[k] * (1.0f / Q), kProbFloor)));
    }
  }
}

// Check-node phase over the rank's checks, steps A-E of the header: in
// place all at once in the message rows, else rc at a time through the
// buffer.
template <int Q, class T, bool IP>
__device__ void cn_phase(const cg::cluster_group& cl, const Rank<T>& r) {
  constexpr int K = Q / 32;
  constexpr int RS = Q + 4;                   // buffer row stride: 16-byte rows
  constexpr int LS = lc_stride<Q, IP>();
  constexpr int G = K >= 16 ? 1 : 16 / K;     // posterior rows in flight per warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int dc = r.dc;
  const int rc = IP ? r.nchk : r.rc;          // in place: one round, which the compiler sees
  for (int c0 = 0; c0 < r.nchk; c0 += rc) {
    const int nrow = min(rc, r.nchk - c0) * dc;
    const int* info = r.edge_info + c0 * dc;   // the round's rows t = (c - c0) dc + j
    T* rows = r.lc + (size_t)c0 * dc * LS;     // the round's messages
    float* buf = IP ? reinterpret_cast<float*>(rows) : r.buf;
    float* sums = r.sums;
    // A: exp(U) of every real edge row, in exp order: a rotation of the
    // posterior and message rows, G rows in flight
    for (int t0 = warp; t0 < nrow; t0 += W * G) {
      float u[G][K];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int loc = t0 + g * W < nrow ? info[t0 + g * W] : -1;
        if (loc < 0) continue;
        const T* pv = cl.map_shared_rank(r.post, rank_of(loc)) + row_of(loc) * Q;
        const T* lr = rows + (t0 + g * W) * LS;
        const int sh = shift_of(loc);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int i = k * 32 + lane;
          const int src = rot<Q>(i, sh);
          u[g][k] = state::rnd<T>(state::get(pv[src]) - state::get(lr[src]));
        }
      }
      if constexpr (IP) __syncwarp();          // the rows are read before they are overwritten
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (t0 + g * W >= nrow || info[t0 + g * W] < 0) continue;
        float* bt = buf + (t0 + g * W) * RS;
#pragma unroll
        for (int k = 0; k < K; ++k) bt[k * 32 + lane] = expf(u[g][k]);
      }
    }
    __syncthreads();
    // B: softmax sums, serially in exp order, one thread per row
    softmax_sums<Q>(buf, sums, info, nrow);
    __syncthreads();
    // C: spectra F = WHT(P), P read in x order, written back in x order
    {
      int logx[K];
      lane_logs<Q>(r.log, logx);
      spectra<Q>(buf, sums, info, nrow, logx);
    }
    __syncthreads();
    // D: the leave-one-out products; E: inverse WHT, floor, log, into the
    // message rows
    if constexpr (IP) {                    // in place
      loo_products_round<Q>(Spectra{buf, dc}, nrow);
      __syncthreads();
      log_rows<Q, RS, RS>(buf, rows, info, nrow, r.log);
    } else if constexpr (sizeof(T) == 4) { // the suffix products in the message rows
      suffix_in_rows<Q>(rows, buf, dc, nrow);
      __syncthreads();
      log_rows<Q, Q, Q>(rows, rows, info, nrow, r.log);
    } else {                               // bf16: over the spectra in the buffer
      loo_products_round<Q>(r, nrow);
      __syncthreads();
      log_rows<Q, RS, Q>(buf, rows, info, nrow, r.log);
    }
    __syncthreads();                      // the buffer is the next round's
  }
}

// Variable-node phase over the rank's variables, one warp per variable,
// two at a time: post = prior + the sum of the variable's message rows in
// slot order (rounded to T before the prior is added, and after),
// wherever they live, a lane moving V consecutive elements; with
// `decide`, hard = argmax.
template <int Q, class T, bool IP>
__device__ void vn_phase(const cg::cluster_group& cl, const Rank<T>& r, bool decide) {
  constexpr int V = vec_width<Q>();
  constexpr int NV = Q / 32 / V;
  constexpr int NR = 2;
  constexpr int LS = lc_stride<Q, IP>();
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
        const T* row = cl.map_shared_rank(r.lc, rank_of(src)) + row_of(src) * LS;
#pragma unroll
        for (int kk = 0; kk < NV; ++kk) {
          float v[V];
          state::load<V>(row + (kk * 32 + lane) * V, v);
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
        state::load<V>(r.prior + i * Q + a0, p);   // shared memory, or the L2
#pragma unroll
        for (int c = 0; c < V; ++c) {
          p[c] = state::rnd<T>(p[c] + state::rnd<T>(acc[n][kk][c]));
          const int sym = r.n2e[a0 + c];
          if (p[c] > best || (p[c] == best && sym < idx)) {
            best = p[c];
            idx = sym;
          }
        }
        state::store<V>(r.post + i * Q + a0, p);
      }
      if (decide) {
        idx = warp_argmax(best, idx);
        if (lane == 0) r.hard[i] = idx;
      }
    }
  }
}

template <int Q, class T, bool IP>
__global__ void __launch_bounds__(max_warps<Q>() * 32, 1)
qspa_cluster_kernel(const float* __restrict__ llr, int* __restrict__ hard_out,
                    uint8_t* __restrict__ done_out, int* __restrict__ iters_out,
                    float* __restrict__ prior, int B, int N, int M, int dc, int dv, int nv,
                    int cpr, int rc, Tables t, int max_iters, int early_term,
                    int stats_each_iter) {
  constexpr int K = Q / 32;
  constexpr int LS = lc_stride<Q, IP>();
  extern __shared__ float smem[];
  __shared__ int s_n2e[Q], s_log[Q], s_exp[2 * Q];
  const cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int cid = blockIdx.x / C;
  Rank<T> r;
  if constexpr (IP) {
    r.post = reinterpret_cast<T*>(smem);
    r.prior = reinterpret_cast<T*>(prior) + ((size_t)cid * C + rank) * nv * Q;
    r.lc = r.post + (size_t)nv * Q;
    r.buf = nullptr;
    r.sums = reinterpret_cast<float*>(r.lc + (size_t)cpr * dc * LS);
  } else {
    r.prior = reinterpret_cast<T*>(smem);
    r.post = r.prior + nv * Q;
    r.lc = r.post + nv * Q;
    r.buf = reinterpret_cast<float*>(r.lc + cpr * dc * Q);
    r.sums = r.buf + rc * dc * (Q + 4);
  }
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
  int logx[K];                        // (read again where a phase needs it)
  load_tables<Q>(t, rank, cpr, r, s_n2e, s_log, s_exp, logx);
  __syncthreads();
  run_frames<Q>(
      cl, r, cid, gridDim.x / C, B, N, max_iters, early_term, stats_each_iter, hard_out,
      done_out, iters_out,
      [&](int b) { init_phase<Q, T, IP>(llr + (size_t)b * N * Q, r); },
      [&](int, int) { cn_phase<Q, T, IP>(cl, r); },
      [&](int, bool decide) { vn_phase<Q, T, IP>(cl, r, decide); });
}

// The launch configuration of a cluster of C blocks of W warps in the
// layout (in place, or buffered), each block with `smem` bytes of shared
// memory in all (the static tables included; grid: one cluster), after
// checking it against the layout and the kernel's limits and setting the
// attribute.
template <int Q, class T, bool IP>
cudaError_t configure(int dc, int dv, int C, int nv, int cpr, int rc, int W, bool in_place,
                      int smem, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const size_t dyn = dyn_bytes(nv, cpr, rc, dc, dv, Q, sizeof(T), in_place);
  if (!plan_ok<Q>(C, W, dc, dv, nv, cpr, rc) || in_place != IP || (IP && rc != cpr) ||
      dyn + 4 * Q * sizeof(int) != (size_t)smem || (size_t)smem > kMaxSmem)
    return cudaErrorInvalidValue;
  return cluster_config(qspa_cluster_kernel<Q, T, IP>, C, W, dyn, cfg, attr);
}

template <int Q, class T, bool IP>
cudaError_t max_clusters(int dc, int dv, int C, int nv, int cpr, int rc, int W, bool in_place,
                         int smem, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<Q, T, IP>(dc, dv, C, nv, cpr, rc, W, in_place, smem, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters, qspa_cluster_kernel<Q, T, IP>, &cfg);
}

template <int Q, class T, bool IP>
cudaError_t launch(const float* llr, int* hard, uint8_t* done, int* iters, float* prior,
                   int prior_clusters, int B, int N, int M, int dc, int dv, int C, int nv,
                   int cpr, int rc, int W, bool in_place, int smem, const Tables& t,
                   int max_iters, int early_term, int stats_each_iter, int* grid_blocks,
                   int* frame_slots, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<Q, T, IP>(dc, dv, C, nv, cpr, rc, W, in_place, smem, &cfg, &attr);
  if (err != cudaSuccess) return err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, qspa_cluster_kernel<Q, T, IP>, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  const int grid = B < clusters ? B : clusters;
  // in place, the priors in global memory: the caller's scratch, [grid, C, nv, Q] floats
  if (IP && (prior == nullptr || prior_clusters < grid)) return cudaErrorInvalidValue;
  cfg.gridDim = dim3(grid * C);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, qspa_cluster_kernel<Q, T, IP>, llr, hard, done, iters, prior, B,
                           N, M, dc, dv, nv, cpr, rc, t, max_iters, early_term, stats_each_iter);
  if (err != cudaSuccess) return err;
  if (grid_blocks) *grid_blocks = grid * C;
  if (frame_slots) *frame_slots = grid;
  return cudaGetLastError();
}

// The kernel's instantiations: q, and the layout (in place in f32 alone;
// configure refuses in place in bf16).
template <class T, class Fn>
int dispatch(int q, bool in_place, Fn fn) {
  auto at = [&](auto q_tag) -> int {
    if constexpr (sizeof(T) == 4) {
      if (in_place) return fn(q_tag, std::true_type{});
    }
    return fn(q_tag, std::false_type{});
  };
  switch (q) {
    case 64: return at(std::integral_constant<int, 64>{});
    case 128: return at(std::integral_constant<int, 128>{});
    case 256: return at(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

template <class T>
int occupancy(int q, int dc, int dv, int C, int nv, int cpr, int rc, int W, int in_place,
              int smem, int* clusters) {
  return dispatch<T>(q, in_place != 0, [&](auto q_tag, auto ip) -> int {
    return max_clusters<decltype(q_tag)::value, T, decltype(ip)::value>(
        dc, dv, C, nv, cpr, rc, W, in_place != 0, smem, clusters);
  });
}

template <class T>
int decode(const float* llr, int* hard, uint8_t* done, int* iters, float* prior,
           int prior_clusters, int B, int N, int M, int dc, int dv, int q, int C, int nv,
           int cpr, int rc, int W, int in_place, int smem, const Tables& t, int max_iters,
           int early_term, int stats_each_iter, int* grid_blocks, int* frame_slots,
           cudaStream_t s) {
  if (grid_blocks) *grid_blocks = 0;
  if (frame_slots) *frame_slots = 0;
  if (B == 0) return cudaSuccess;
  return dispatch<T>(q, in_place != 0, [&](auto q_tag, auto ip) -> int {
    return launch<decltype(q_tag)::value, T, decltype(ip)::value>(
        llr, hard, done, iters, prior, prior_clusters, B, N, M, dc, dv, C, nv, cpr, rc, W,
        in_place != 0, smem, t, max_iters, early_term, stats_each_iter, grid_blocks,
        frame_slots, s);
  });
}

}  // namespace

// cudaOccupancyMaxActiveClusters of the kernel at this plan: how many
// clusters run at once, the persistent grid of qspa_cluster_decode.
extern "C" int qspa_cluster_occupancy(int q, int dc, int dv, int C, int nv, int cpr, int rc,
                                      int W, int in_place, int smem, int* clusters) {
  return occupancy<float>(q, dc, dv, C, nv, cpr, rc, W, in_place, smem, clusters);
}

// The same for the bf16 build (the plan's smem laid out with 2-byte state).
extern "C" int qspa_cluster_occupancy_bf16(int q, int dc, int dv, int C, int nv, int cpr,
                                           int rc, int W, int in_place, int smem,
                                           int* clusters) {
  return occupancy<state::bf16>(q, dc, dv, C, nv, cpr, rc, W, in_place, smem, clusters);
}

// The decode of B frames under a plan from kernels/qspa_resident.py:
// clusters of C blocks of W warps, a frame a cluster, nv posterior rows
// and cpr checks per rank, rc checks per round of the CN phase, buffered
// (in_place 0) or in place (1, f32 alone, rc = cpr), `smem` bytes of
// shared memory per block in all (checked against the layout above). In
// place `prior` is a scratch of prior_clusters x C x nv x q floats, at
// least one cluster's per cluster of the grid (min(B, occupancy));
// buffered it is unused (NULL, 0). Writes the blocks of the grid it
// launched to *grid_blocks and its clusters, the frames it holds at once,
// to *frame_slots (0 when B is 0; NULL skips either). Returns
// cudaErrorInvalidValue for a plan, q or scratch the kernel does not take.
extern "C" int qspa_cluster_decode(
    const float* llr, int* hard, uint8_t* done, int* iters, float* prior, int prior_clusters,
    int B, int N, int M, int dc, int dv, int q, int C, int nv, int cpr, int rc, int W,
    int in_place, int smem, const int* edge_info, const int* row_src, const int* row_var,
    const int* n2e, const int* gf_log, const int* gf_exp, int max_iters, int early_term,
    int stats_each_iter, int* grid_blocks, int* frame_slots, void* stream) {
  const Tables t{edge_info, row_src, row_var, n2e, gf_log, gf_exp};
  return decode<float>(llr, hard, done, iters, prior, prior_clusters, B, N, M, dc, dv, q, C, nv,
                       cpr, rc, W, in_place, smem, t, max_iters, early_term, stats_each_iter,
                       grid_blocks, frame_slots, static_cast<cudaStream_t>(stream));
}

// The same with the prior, posterior and messages stored in bf16
// (mm_precision="bf16"), under a buffered plan made for 2-byte state.
extern "C" int qspa_cluster_decode_bf16(
    const float* llr, int* hard, uint8_t* done, int* iters, float* prior, int prior_clusters,
    int B, int N, int M, int dc, int dv, int q, int C, int nv, int cpr, int rc, int W,
    int in_place, int smem, const int* edge_info, const int* row_src, const int* row_var,
    const int* n2e, const int* gf_log, const int* gf_exp, int max_iters, int early_term,
    int stats_each_iter, int* grid_blocks, int* frame_slots, void* stream) {
  const Tables t{edge_info, row_src, row_var, n2e, gf_log, gf_exp};
  return decode<state::bf16>(llr, hard, done, iters, prior, prior_clusters, B, N, M, dc, dv, q,
                             C, nv, cpr, rc, W, in_place, smem, t, max_iters, early_term,
                             stats_each_iter, grid_blocks, frame_slots,
                             static_cast<cudaStream_t>(stream));
}
