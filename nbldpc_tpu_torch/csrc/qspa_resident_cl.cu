// Whole QSPA decode for large fields (q = 64, 128, 256) for the codes whose
// state no thread-block cluster holds: K0-cl's scratch kernel. One frame a
// cluster, as in csrc/qspa_cluster.cu; what does not fit the cluster's
// shared memory goes to a global slice of the cluster's own.
//
// Replaces: nbldpc_tpu/kernels/qspa_resident.py, ResidentQSPA._kernel /
// __call__ (the Pallas K0-cl kernel, the JAX package's QSPA default for
// q > 32), for the codes csrc/qspa_cluster.cu does not take.
//
// Probability-domain BP in the plain version's association order
// (nbldpc_tpu_torch/kernels/qspa_resident.py:_iteration, run_plain), the
// cluster kernel's:
//   prior = llr - max_q llr;  post = prior;  lc = 0
//   per iteration, per edge e = (m, j) with variable v and weight h:
//     U(x)  = post[v](h^-1 x) - lc[e](h^-1 x)
//     P     = exp(U) / S, S summed serially in exp order (0, 1, a, a^2,
//             ...); delta0 on pad slots
//     F     = WHT(P), stages h = 1, 2, ..., q / 2
//     G_j   = (F_0 ... F_{j-1}) * suf(j), suf(dc - 1) = 1,
//             suf(j) = suf(j + 1) * F_{j+1}
//     lc[e](h^-1 x) = log(max(WHT(G_j)(x) / q, 1e-12))
//   post[v] = prior[v] + sum of lc over v's edges, in vn_edge slot order
//   hard = argmax (ties to the lowest symbol); syndrome: XOR of h * hard.
//
// What bounds it on the H100: operations, as the cluster kernel (about
// 10 q + 2 q log2 q per edge and iteration; 512 frames x 20 iterations of
// a GF(256) code with N = 1200 and 2400 edges: 2.6 ms at 67 TFLOP/s f32).
// The design before this one ran a frame on one block of 8 warps, its
// posterior and messages in a scratch of 3.7 MB a frame, ~396 frames at
// once: ~12 MB of device-memory traffic a frame and iteration, which no
// cache held, and a second round of frames under a third full (139.5 ms
// there on the H100). This one takes 79.9 ms (PERF.md): its check phase
// ~63, its variable phase ~19, message traffic past the L2 ~10.
//
// Design. The host plans the partition (kernels/qspa_resident.py,
// plan_scratch): a cluster of C = 1, 2, 4 or 8 blocks ("ranks"), rank r
// owning the checks [r cpr, (r + 1) cpr) and the variables placed with
// them, as the cluster kernel's plan. What stays on chip, in each rank's
// shared memory: the posterior rows of its variables (of the sizes whose
// ranks hold them, the one with the fewest check rounds; where even 8 do
// not, the posterior too goes to the slice, PS = false), each variable's
// max_q llr and hard decision, the tables, and the buffer of a round of
// checks. The prior is not kept: the variable phase forms it again from
// the LLRs, llr - max, the same float.
// The edge messages live in the cluster's slice of the global scratch
// (`torch.empty` in the wrapper; [C cpr dc, Q] floats, then the posterior
// [C nv, Q] where PS is false). A persistent grid of as many clusters as
// cudaOccupancyMaxActiveClusters allows walks the frames; where their
// slices fit the L2 (GF(256), N = 1200: 2.4 MB a slice, 15 clusters 37
// MB of the 50 MB, their LLR rows 18 MB more), the messages move mostly
// through it. The grid is not cut to fit the L2: each cluster cut adds
// rounds of frames, which cost more than the overflow (PERF.md).
//   CN phase, the rank's checks in rounds that fit the buffer, block
//   barriers between the steps (as the cluster kernel):
//   A. per edge row, one warp, lane l holding exp positions l, l + 32,
//      ...: U from the variable's posterior row (distributed shared
//      memory) and the edge's message row (the slice; not read in the
//      first iteration, where it is 0 and x - 0 is x), both rotated by
//      the edge's shift; exp(U) into the buffer in exp order. One row in
//      flight a warp at q = 256 (two, the cluster kernel's, spill).
//   B. one thread per row sums it serially in exp order.
//   C. per row, one warp: P read at position log x + 1, F = WHT(P) in x
//      order, in place.
//   D. one thread per (check, symbol): the suffix products in registers
//      (at most DC of them), then G_j = prefix * suf(j) written over F_j,
//      which the prefix has already taken.
//   E. per row, one warp: WHT(G_j), floor, log, written in the buffer at
//      the exp-order position of h^-1 x, then the whole row to the slice
//      with 16-byte stores (pad rows are never read and are not stored).
//   VN phase: one warp per owned variable, two at a time: its message rows
//   from the slice (16-byte loads), in slot order, plus the prior from the
//   LLR row (asked into the L2 when the phase starts, then copied
//   asynchronously into the round buffer, free in this phase, and read
//   there in exp order); the posterior stored, the hard decision by warp
//   shuffles.
//   Syndrome: the cluster kernel's (one warp per check, one flag a rank).
// cluster.sync() (barrier.cluster arrive.release / wait.acquire)
// separates the CN, VN and syndrome phases. Data the kernel writes to the
// slice is read and written with .cg accesses (L2, not the SM's L1), so
// what one rank wrote before a cluster barrier, another reads after it.
// What this kernel shares with the cluster kernel (the helpers, the
// syndrome, steps B, C and D, the frame loop) is in qspa_cluster.cuh.
//
// bf16 (mm_precision="bf16", T = __nv_bfloat16): the posterior (shared
// memory or slice) and the slice's messages are bf16, and so is the prior
// as the variable phase forms it from the staged LLR row, each rounded
// where the plain version rounds it (U before the exp, each log as step E
// stores the row, the posterior sum and the posterior); the buffer and
// the arithmetic stay f32. A slice is half the bytes.

#include <cuda_pipeline.h>

#include "qspa_cluster.cuh"

namespace {

using namespace k0cl;

constexpr int kVnRows = 2;                // variables a warp takes at once in the VN phase

// Rows of Q + 4 floats in the round buffer: the round's rc dc edge rows,
// and at least kVnRows a warp (the variable phase's LLR rows).
__host__ __device__ int buf_rows(int rc, int dc, int W) { return max(rc * dc, kVnRows * W); }

// Dynamic shared memory of a block, in the order the kernel lays it out:
// the posterior [nv, Q] (when PS; elements of es bytes), the round buffer
// and the rc dc sums, max_q llr [nv], hard [nv], two syndrome flags, and
// the rank's tables (edge_info [cpr dc], row_src [nv dv], row_var [nv]).
// kernels/qspa_resident.py:scratch_smem_bytes mirrors it and adds the
// static tables (n2e [Q], log [Q] and exp [2Q] ints).
size_t dyn_bytes(int nv, int cpr, int rc, int dc, int dv, int W, int Q, bool ps, int es) {
  return (ps ? (size_t)nv * Q * es : 0) +
         ((size_t)buf_rows(rc, dc, W) * (Q + 4) + (size_t)rc * dc + 2 * (size_t)nv + 2 +
          (size_t)cpr * dc + (size_t)nv * dv + nv) *
             sizeof(float);
}

// Elements of one cluster's slice: the messages, then the posterior if !ps.
__host__ __device__ size_t slice_floats(int C, int nv, int cpr, int dc, int Q, bool ps) {
  return (size_t)C * cpr * dc * Q + (ps ? 0 : (size_t)C * nv * Q);
}

// Slice accesses (.cg: through the L2, whichever SM wrote the data).
__device__ __forceinline__ void ld_cg(const float* p, float (&o)[4]) {
  const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void ld_cg(const float* p, float (&o)[2]) {
  const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
  o[0] = v.x; o[1] = v.y;
}
__device__ __forceinline__ void ld_cg(const state::bf16* p, float (&o)[4]) {
  const uint2 v = __ldcg(reinterpret_cast<const uint2*>(p));
  state::unpack2(v.x, o[0], o[1]);
  state::unpack2(v.y, o[2], o[3]);
}
__device__ __forceinline__ void ld_cg(const state::bf16* p, float (&o)[2]) {
  state::unpack2(__ldcg(reinterpret_cast<const unsigned*>(p)), o[0], o[1]);
}
__device__ __forceinline__ float ld_cg1(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg1(const state::bf16* p) {
  return __uint_as_float((unsigned)__ldcg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ void st_cg1(float* p, float v) { __stcg(p, v); }
__device__ __forceinline__ void st_cg1(state::bf16* p, float v) {
  __stcg(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}
// A posterior element: shared memory (any rank's) when PS, else the slice.
template <bool PS, class T>
__device__ __forceinline__ float ld_post(const T* p) { return PS ? state::get(*p) : ld_cg1(p); }
template <bool PS, class T>
__device__ __forceinline__ void st_post(T* p, float v) {
  if (PS)
    *p = state::put<T>(v);
  else
    st_cg1(p, v);
}

// The rank's view: shared-memory state, buffers and tables, and its
// cluster's slice (elements T).
template <class T>
struct Rank {
  T* post;           // [nv, Q] shared (PS) or the rank's rows of the slice
  float* buf;        // [rc dc, Q + 4] the round's edge rows
  float* sums;       // [rc dc]
  float* mx;         // [nv] max_q llr of each posterior row's variable
  int* hard;         // [nv]
  int* flag;         // [2]
  int* edge_info;    // [cpr dc]
  int* row_src;      // [nv dv]
  int* row_var;      // [nv]
  const int* n2e;    // [Q]
  const int* log;    // [Q]
  const int* exp;    // [2Q]
  T* msg;            // the slice's messages [C cpr dc, Q]
  T* gpost;          // the slice's posterior [C nv, Q] (unused when PS)
  int rank, nv, cpr, nchk, rc, dc, dv;
};

// Posterior row `row` of rank `rank`.
template <int Q, bool PS, class T>
__device__ __forceinline__ const T* post_row(const cg::cluster_group& cl, const Rank<T>& r,
                                             int rank, int row) {
  if (PS) return cl.map_shared_rank(r.post, rank) + row * Q;
  return r.gpost + ((size_t)rank * r.nv + row) * Q;
}

// Start of a frame: post = llr - max_q llr for the rank's variables, in
// exp order (rounded to T), mx = that max, hard = argmax.
template <int Q, bool PS, class T>
__device__ void init_phase(const float* L, const Rank<T>& r) {
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
      x[k] = __ldg(&L[(size_t)v * Q + r.n2e[k * 32 + lane]]);
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
      st_post<PS>(r.post + i * Q + a, p);
      const int sym = r.n2e[a];
      if (p > best || (p == best && sym < idx)) {
        best = p;
        idx = sym;
      }
    }
    idx = warp_argmax(best, idx);
    if (lane == 0) {
      r.hard[i] = idx;
      r.mx[i] = m;
    }
  }
}

// Check-node phase over the rank's checks, rc at a time, steps A-E of the
// header; logx[k] = log(k * 32 + lane); `first`: the messages are 0.
template <int Q, bool PS, class T>
__device__ void cn_phase(const cg::cluster_group& cl, const Rank<T>& r,
                         const int (&logx)[Q / 32], bool first) {
  constexpr int K = Q / 32;
  constexpr int RS = Q + 4;                   // buffer row stride: 16-byte rows
  constexpr int G = K >= 8 ? 1 : 8 / K;       // rows in flight per warp (more spill)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int dc = r.dc;
  for (int c0 = 0; c0 < r.nchk; c0 += r.rc) {
    const int nrow = min(r.rc, r.nchk - c0) * dc;
    const int* info = r.edge_info + c0 * dc;   // the round's rows t = (c - c0) dc + j
    T* rows = r.msg + ((size_t)r.rank * r.cpr + c0) * dc * Q;       // their messages
    // A: exp(U) of every real edge row, in exp order, G rows in flight
    for (int t0 = warp * G; t0 < nrow; t0 += W * G) {
      float u[G][K];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int loc = t0 + g < nrow ? info[t0 + g] : -1;
        if (loc < 0) continue;
        const T* pv = post_row<Q, PS>(cl, r, rank_of(loc), row_of(loc));
        const T* lr = rows + (size_t)(t0 + g) * Q;
        const int sh = shift_of(loc);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int src = rot<Q>(k * 32 + lane, sh);
          u[g][k] = first ? ld_post<PS>(pv + src)
                          : state::rnd<T>(ld_post<PS>(pv + src) - ld_cg1(lr + src));
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
    // D: the leave-one-out products, over the spectra
    loo_products_round<Q>(r, nrow);
    __syncthreads();
    // E: inverse WHT, floor, log, permuted up in the buffer, then the row
    // to the slice
    for (int t = warp; t < nrow; t += W) {
      float* bt = r.buf + t * RS;
      float g[K];
#pragma unroll
      for (int k = 0; k < K; ++k) g[k] = bt[k * 32 + lane];
      wht_warp<Q>(g, lane);
      __syncwarp();                       // the row is read before it is overwritten
      const int loc = info[t];
      if (loc < 0) continue;              // a pad row's messages are never read
      const int sh = shift_of(loc);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int x = k * 32 + lane;            // to h^-1 x, in exp order
        bt[x ? rot<Q>(logx[k] + 1, sh) : 0] = logf(fmaxf(g[k] * (1.0f / Q), kProbFloor));
      }
      __syncwarp();
      if constexpr (sizeof(T) == 4) {
        float4* dst = reinterpret_cast<float4*>(rows + (size_t)t * Q);
        const float4* srcv = reinterpret_cast<const float4*>(bt);
        for (int k = lane; k < Q / 4; k += 32) __stcg(dst + k, srcv[k]);
      } else {                            // 8 floats to 8 bf16 a store
        uint4* dst = reinterpret_cast<uint4*>(rows + (size_t)t * Q);
        const float4* srcv = reinterpret_cast<const float4*>(bt);
        for (int k = lane; k < Q / 8; k += 32) {
          const float4 a = srcv[2 * k], b = srcv[2 * k + 1];
          __stcg(dst + k, make_uint4(state::pack2(a.x, a.y), state::pack2(a.z, a.w),
                                     state::pack2(b.x, b.y), state::pack2(b.z, b.w)));
        }
      }
    }
    __syncthreads();                      // the buffer is the next round's
  }
}

// Variable-node phase over the rank's variables, one warp per variable,
// two at a time: post = prior + the sum of the variable's message rows in
// slot order (in bf16: the prior, the sum and the posterior each rounded),
// a lane moving V consecutive elements; the prior llr - max formed again
// from the LLR row, copied asynchronously into the warp's rows of the
// round buffer (free in this phase) and gathered there in exp order; with
// `decide`, hard = argmax.
template <int Q, bool PS, class T>
__device__ void vn_phase(const float* L, const Rank<T>& r, bool decide) {
  constexpr int V = vec_width<Q>();
  constexpr int NV = Q / 32 / V;
  constexpr int NR = kVnRows;
  constexpr int LQ = (Q / 4 + 31) / 32;      // 16-byte pieces of an LLR row a lane
  const int lane = threadIdx.x & 31;
  const int W = blockDim.x >> 5;
  const int cdq = r.cpr * r.dc;
  float* stage = r.buf + (size_t)(threadIdx.x >> 5) * NR * Q;   // the warp's LLR rows
  // the LLR rows of every variable the warp will take, asked into the L2
  // now, so that only the first pass waits on device memory
  for (int i = (threadIdx.x >> 5) + lane * W; i < r.nv; i += 32 * W) {
    const int var = r.row_var[i];
    if (var >= 0)
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(L + (size_t)var * Q),
                   "r"(Q * 4) : "memory");
  }
  for (int i0 = threadIdx.x >> 5; i0 < r.nv; i0 += NR * W) {
    float acc[NR][NV][V];
#pragma unroll
    for (int n = 0; n < NR; ++n)
#pragma unroll
      for (int kk = 0; kk < NV; ++kk)
#pragma unroll
        for (int c = 0; c < V; ++c) acc[n][kk][c] = 0.f;
    // the variables' LLR rows, in x order, copied to the stage while the
    // messages load (16-byte asynchronous copies: no registers held)
#pragma unroll
    for (int n = 0; n < NR; ++n) {
      const int i = i0 + n * W;
      const int var = i < r.nv ? r.row_var[i] : -1;
#pragma unroll
      for (int k = 0; k < LQ; ++k)
        if (var >= 0 && k * 32 + lane < Q / 4)
          __pipeline_memcpy_async(stage + n * Q + (k * 32 + lane) * 4,
                                  L + (size_t)var * Q + (k * 32 + lane) * 4, 16);
    }
    __pipeline_commit();
    for (int s = 0; s < r.dv; ++s) {
#pragma unroll
      for (int n = 0; n < NR; ++n) {
        const int i = i0 + n * W;
        const int src = i < r.nv ? r.row_src[i * r.dv + s] : -1;
        if (src < 0) continue;
        const T* row = r.msg + ((size_t)rank_of(src) * cdq + row_of(src)) * Q;
#pragma unroll
        for (int kk = 0; kk < NV; ++kk) {
          float v[V];
          ld_cg(row + (kk * 32 + lane) * V, v);
#pragma unroll
          for (int c = 0; c < V; ++c) acc[n][kk][c] += v[c];
        }
      }
    }
    __pipeline_wait_prior(0);
    __syncwarp();
#pragma unroll
    for (int n = 0; n < NR; ++n) {
      const int i = i0 + n * W;
      if (i >= r.nv) continue;
      const int var = r.row_var[i];
      if (var < 0) continue;
      const float* lv = stage + n * Q;
      const float m = r.mx[i];
      float best = -INFINITY;
      int idx = Q;
#pragma unroll
      for (int kk = 0; kk < NV; ++kk) {
        const int a0 = (kk * 32 + lane) * V;
#pragma unroll
        for (int c = 0; c < V; ++c) {
          const int sym = r.n2e[a0 + c];
          const float p =
              state::rnd<T>(state::rnd<T>(lv[sym] - m) + state::rnd<T>(acc[n][kk][c]));
          st_post<PS>(r.post + i * Q + a0 + c, p);
          if (p > best || (p == best && sym < idx)) {
            best = p;
            idx = sym;
          }
        }
      }
      if (decide) {
        idx = warp_argmax(best, idx);
        if (lane == 0) r.hard[i] = idx;
      }
    }
    __syncwarp();                         // the stage is read before the next rows
  }
}

template <int Q, bool PS, class T>
__global__ void __launch_bounds__(max_warps<Q>() * 32, 1)
qspa_scratch_kernel(const float* __restrict__ llr, int* __restrict__ hard_out,
                    uint8_t* __restrict__ done_out, int* __restrict__ iters_out,
                    T* scratch, int B, int N, int M, int dc, int dv, int nv, int cpr,
                    int rc, Tables t, int max_iters, int early_term, int stats_each_iter) {
  constexpr int K = Q / 32;
  extern __shared__ float smem[];
  __shared__ int s_n2e[Q], s_log[Q], s_exp[2 * Q];
  const cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int cid = blockIdx.x / C, ncl = gridDim.x / C;
  T* slice = scratch + (size_t)cid * slice_floats(C, nv, cpr, dc, Q, PS);
  Rank<T> r;
  r.msg = slice;
  r.gpost = slice + (size_t)C * cpr * dc * Q;
  r.post = PS ? reinterpret_cast<T*>(smem) : r.gpost + (size_t)rank * nv * Q;
  r.buf = reinterpret_cast<float*>(reinterpret_cast<T*>(smem) + (PS ? nv * Q : 0));
  r.sums = r.buf + buf_rows(rc, dc, (int)(blockDim.x >> 5)) * (Q + 4);
  r.mx = r.sums + rc * dc;
  r.hard = reinterpret_cast<int*>(r.mx + nv);
  r.flag = r.hard + nv;
  r.edge_info = r.flag + 2;
  r.row_src = r.edge_info + cpr * dc;
  r.row_var = r.row_src + nv * dv;
  r.n2e = s_n2e;
  r.log = s_log;
  r.exp = s_exp;
  r.rank = rank;
  r.nv = nv;
  r.cpr = cpr;
  r.nchk = max(0, min(cpr, M - rank * cpr));
  r.rc = rc;
  r.dc = dc;
  r.dv = dv;
  int logx[K];
  load_tables<Q>(t, rank, cpr, r, s_n2e, s_log, s_exp, logx);
  __syncthreads();
  run_frames<Q>(
      cl, r, cid, ncl, B, N, max_iters, early_term, stats_each_iter, hard_out, done_out,
      iters_out, [&](int b) { init_phase<Q, PS, T>(llr + (size_t)b * N * Q, r); },
      [&](int, int it) { cn_phase<Q, PS, T>(cl, r, logx, it == 0); },
      [&](int b, bool decide) { vn_phase<Q, PS, T>(llr + (size_t)b * N * Q, r, decide); });
}

// The launch configuration of one cluster of C blocks of W warps with
// `smem` bytes of shared memory each in all (the static tables included),
// after checking it against the layout and the kernel's limits; then the
// clusters that run at once (*clusters), and, with `launch`, the decode on
// a grid of `grid` clusters.
template <int Q, bool PS, class T>
cudaError_t run(int C, int nv, int cpr, int rc, int W, int smem, int dc, int dv, int* clusters,
                bool launch, const float* llr, int* hard, uint8_t* done, int* iters,
                void* scratch, int grid, int B, int N, int M, const Tables& t, int max_iters,
                int early_term, int stats_each_iter, cudaStream_t stream) {
  const size_t dyn = dyn_bytes(nv, cpr, rc, dc, dv, W, Q, PS, sizeof(T));
  if (!plan_ok<Q>(C, W, dc, dv, nv, cpr, rc) || dyn + 4 * Q * sizeof(int) != (size_t)smem ||
      (size_t)smem > kMaxSmem)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(qspa_scratch_kernel<Q, PS, T>, C, W, dyn, &cfg, &attr);
  if (err != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveClusters(clusters, qspa_scratch_kernel<Q, PS, T>, &cfg)) !=
      cudaSuccess)
    return err;
  if (*clusters < 1) return cudaErrorInvalidConfiguration;
  if (!launch) return cudaSuccess;
  if (grid < 1 || (long long)M > (long long)C * cpr || (long long)N > (long long)C * nv)
    return cudaErrorInvalidValue;
  cfg.gridDim = dim3(grid * C);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, qspa_scratch_kernel<Q, PS, T>, llr, hard, done, iters,
                           static_cast<T*>(scratch), B, N, M, dc, dv, nv, cpr, rc, t,
                           max_iters, early_term, stats_each_iter);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <class T>
cudaError_t dispatch(int q, int ps, int C, int nv, int cpr, int rc, int W, int smem, int dc,
                     int dv, int* clusters, bool launch, const float* llr, int* hard,
                     uint8_t* done, int* iters, void* scratch, int grid, int B, int N, int M,
                     const Tables& t, int max_iters, int early_term, int stats_each_iter,
                     cudaStream_t s) {
#define NBLDPC_SCRATCH_RUN(QQ, PP)                                                           \
  run<QQ, PP, T>(C, nv, cpr, rc, W, smem, dc, dv, clusters, launch, llr, hard, done, iters, \
                 scratch, grid, B, N, M, t, max_iters, early_term, stats_each_iter, s)
  switch (q) {
    case 64: return ps ? NBLDPC_SCRATCH_RUN(64, true) : NBLDPC_SCRATCH_RUN(64, false);
    case 128: return ps ? NBLDPC_SCRATCH_RUN(128, true) : NBLDPC_SCRATCH_RUN(128, false);
    case 256: return ps ? NBLDPC_SCRATCH_RUN(256, true) : NBLDPC_SCRATCH_RUN(256, false);
    default: return cudaErrorInvalidValue;
  }
#undef NBLDPC_SCRATCH_RUN
}

}  // namespace

// cudaOccupancyMaxActiveClusters of the kernel at a plan from
// kernels/qspa_resident.py:plan_scratch: how many clusters run at once.
extern "C" int qspa_scratch_occupancy(int q, int dc, int dv, int C, int nv, int cpr, int rc,
                                      int W, int smem, int post_shared, int* clusters) {
  const Tables t{};
  return dispatch<float>(q, post_shared, C, nv, cpr, rc, W, smem, dc, dv, clusters, false,
                         nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0, t, 0, 0, 0,
                         nullptr);
}

// The same for the bf16 build, at a plan made for 2-byte state.
extern "C" int qspa_scratch_occupancy_bf16(int q, int dc, int dv, int C, int nv, int cpr,
                                           int rc, int W, int smem, int post_shared,
                                           int* clusters) {
  const Tables t{};
  return dispatch<state::bf16>(q, post_shared, C, nv, cpr, rc, W, smem, dc, dv, clusters, false,
                               nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0, t, 0, 0,
                               0, nullptr);
}

// The decode of B frames under a plan: clusters of C blocks of W warps,
// nv posterior rows and cpr checks per rank (rc checks per round), `smem`
// bytes of shared memory per block in all, the posterior in shared memory
// when post_shared; `grid` clusters, each with its slice of `scratch`
// (grid x (C cpr dc + (post_shared ? 0 : C nv)) x q floats, allocated by
// the caller). Returns cudaErrorInvalidValue for a plan or q the kernel
// does not take.
extern "C" int qspa_resident_cl_decode(
    const float* llr, int* hard, uint8_t* done, int* iters, float* scratch, int grid, int B,
    int N, int M, int dc, int dv, int q, int C, int nv, int cpr, int rc, int W, int smem,
    int post_shared, const int* edge_info, const int* row_src, const int* row_var,
    const int* n2e, const int* gf_log, const int* gf_exp, int max_iters, int early_term,
    int stats_each_iter, void* stream) {
  const Tables t{edge_info, row_src, row_var, n2e, gf_log, gf_exp};
  if (B == 0) return cudaSuccess;
  int clusters = 0;
  return dispatch<float>(q, post_shared, C, nv, cpr, rc, W, smem, dc, dv, &clusters, true, llr,
                         hard, done, iters, scratch, grid, B, N, M, t, max_iters, early_term,
                         stats_each_iter, static_cast<cudaStream_t>(stream));
}

// The same with the posterior, the prior and the messages stored in bf16
// (mm_precision="bf16"): scratch holds grid x (C cpr dc + (post_shared ? 0
// : C nv)) x q bf16, at a plan made for 2-byte state.
extern "C" int qspa_resident_cl_decode_bf16(
    const float* llr, int* hard, uint8_t* done, int* iters, void* scratch, int grid, int B,
    int N, int M, int dc, int dv, int q, int C, int nv, int cpr, int rc, int W, int smem,
    int post_shared, const int* edge_info, const int* row_src, const int* row_var,
    const int* n2e, const int* gf_log, const int* gf_exp, int max_iters, int early_term,
    int stats_each_iter, void* stream) {
  const Tables t{edge_info, row_src, row_var, n2e, gf_log, gf_exp};
  if (B == 0) return cudaSuccess;
  int clusters = 0;
  return dispatch<state::bf16>(q, post_shared, C, nv, cpr, rc, W, smem, dc, dv, &clusters, true,
                               llr, hard, done, iters, scratch, grid, B, N, M, t, max_iters,
                               early_term, stats_each_iter, static_cast<cudaStream_t>(stream));
}
