// The device code that K0-cl's two kernels share: qspa_cluster.cu (a
// frame's whole state in the shared memory of a thread-block cluster) and
// qspa_resident_cl.cu (the same partition, the edge messages in a global
// slice a cluster). Both run a frame on a cluster of C blocks ("ranks"),
// laid out by a host plan (kernels/qspa_resident.py: plan_cluster,
// plan_scratch), in the plain version's association order. Here: the
// plan's limits and tables, the exp-order rotation, the warp's WHT and
// argmax, the syndrome check, the check phase's steps B (softmax sums) and
// C (spectra), the scratch kernel's step D (the leave-one-out products
// over the spectra in the buffer, which the cluster kernel's bf16 build
// and its in-place layout run too), the tables' copy into shared memory
// and the frame loop with its outputs. What differs (where the posterior
// and the messages live: the frame's init, steps A, D and E, the variable
// phase) stays in each kernel's source. Both are built with the state's element T = float and
// T = bf16 (state.cuh).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "state.cuh"

namespace cg = cooperative_groups;

namespace k0cl {

constexpr float kProbFloor = 1e-12f;
constexpr unsigned kFull = 0xffffffffu;
// Warps per block: 24 below q = 256; 16 at q = 256, where the 128
// registers a thread then has hold step A's rows without spilling (with
// 24 warps the cluster kernel spills there and ran slower on the H100;
// below q = 256, 24 warps ran faster than 16).
template <int Q>
constexpr int max_warps() { return Q >= 256 ? 16 : 24; }
constexpr int kMaxDc = 32;
constexpr int kMaxCluster = 8;
constexpr size_t kMaxSmem = 232448;       // per-block shared memory, sm_90

struct Tables {
  const int* edge_info;  // [C, cpr*dc] shift << 20 | rank << 16 | posterior row
                         // of each of the rank's edge slots; -1 on pads
  const int* row_src;    // [C, nv*dv] rank << 16 | message row of each slot of
                         // each of the rank's variables; -1 on pads
  const int* row_var;    // [C, nv] variable of each posterior row; -1 if unused
  const int* n2e;        // [q] exp-order basis: 0, 1, a, a^2, ...
  const int* gf_log;     // [q] (log 0 unused)
  const int* gf_exp;     // [2(q - 1)] a^i, doubled
};

// A plan's limits, which both kernels check before they launch.
template <int Q>
bool plan_ok(int C, int W, int dc, int dv, int nv, int cpr, int rc) {
  return C >= 1 && C <= kMaxCluster && !(C & (C - 1)) && W >= 1 && W <= max_warps<Q>() &&
         dc >= 1 && dc <= kMaxDc && dv >= 1 && nv >= 1 && cpr >= 1 && rc >= 1 && rc <= cpr &&
         nv <= 0xffff && cpr * dc <= 0xffff;
}

__device__ __forceinline__ int rank_of(int loc) { return (loc >> 16) & 0xf; }
__device__ __forceinline__ int row_of(int loc) { return loc & 0xffff; }
__device__ __forceinline__ int shift_of(int info) { return info >> 20; }

// Rows are kept in exp order: position 0 holds symbol 0, position i > 0
// symbol a^(i-1). The position of h^-1 y, for y at position i, with sh =
// (Q - 1 - log h) mod (Q - 1): multiplying by h^-1 rotates positions
// 1 .. Q - 1.
template <int Q>
__device__ __forceinline__ int rot(int i, int sh) {
  if (i == 0) return 0;
  const int j = i - 1 + sh;
  return (j >= Q - 1 ? j - (Q - 1) : j) + 1;
}

// Unnormalized WHT of the warp's Q-vector, r[k] holding symbol k * 32 +
// lane: stages h = 1, 2, ..., Q / 2 writing (lo + hi, lo - hi). Across
// lanes the upper lane forms lo - hi as (-hi) + lo, the same float.
template <int Q>
__device__ __forceinline__ void wht_warp(float (&r)[Q / 32], int lane) {
  constexpr int K = Q / 32;
#pragma unroll
  for (int h = 1; h < 32; h <<= 1) {
    const unsigned neg = (lane & h) ? 0x80000000u : 0u;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float o = __shfl_xor_sync(kFull, r[k], h);
      r[k] = __uint_as_float(__float_as_uint(r[k]) ^ neg) + o;
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

// Whole-row moves with 8- or 16-byte accesses: a lane moves V = 2 or 4
// consecutive floats, positions (kk * 32 + lane) V + c, kk < Q / (32 V).
template <int Q>
__host__ __device__ constexpr int vec_width() { return Q / 32 >= 4 ? 4 : 2; }

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

// The fields of a rank's shared-memory view (each kernel's Rank) that the
// code below reads: hard [nv], flag [2], edge_info [cpr dc], row_src [nv
// dv], row_var [nv], the field's n2e [Q], log [Q] and exp [2Q], and nv,
// nchk (the rank's checks), dc, dv.

// The rank's tables into its shared memory and the lane's logs, logx[k] =
// log(k * 32 + lane); the caller syncs the block.
template <int Q, class R>
__device__ void load_tables(const Tables& t, int rank, int cpr, const R& r, int* n2e, int* log,
                            int* exp, int (&logx)[Q / 32]) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < Q; i += blockDim.x) {
    n2e[i] = __ldg(&t.n2e[i]);
    log[i] = __ldg(&t.gf_log[i]);
  }
  for (int i = threadIdx.x; i < 2 * (Q - 1); i += blockDim.x) exp[i] = __ldg(&t.gf_exp[i]);
  for (int i = threadIdx.x; i < cpr * r.dc; i += blockDim.x)
    r.edge_info[i] = __ldg(&t.edge_info[rank * cpr * r.dc + i]);
  for (int i = threadIdx.x; i < r.nv * r.dv; i += blockDim.x)
    r.row_src[i] = __ldg(&t.row_src[rank * r.nv * r.dv + i]);
  for (int i = threadIdx.x; i < r.nv; i += blockDim.x)
    r.row_var[i] = __ldg(&t.row_var[rank * r.nv + i]);
#pragma unroll
  for (int k = 0; k < Q / 32; ++k) logx[k] = __ldg(&t.gf_log[k * 32 + lane]);
}

// 1 when every check of the code is satisfied, the same in every thread of
// the cluster. One warp per check of the rank: lane j forms h_j * hard of
// its variable, read in the rank that owns it (final: the caller synced
// the cluster), and the warp XORs them; each rank writes one flag to
// flag[slot], and after the barrier every rank ORs the cluster's flags.
// Consecutive calls alternate `slot`, so a rank never overwrites a flag
// that another rank may still read.
template <int Q, class R>
__device__ int syndrome_ok(const cg::cluster_group& cl, const R& r, int slot) {
  const int lane = threadIdx.x & 31;
  const int W = blockDim.x >> 5;
  int bad = 0;
  for (int lm = threadIdx.x >> 5; lm < r.nchk; lm += W) {
    const int info = lane < r.dc ? r.edge_info[lm * r.dc + lane] : -1;
    unsigned prod = 0;
    if (info >= 0) {
      const int sym = cl.map_shared_rank(r.hard, rank_of(info))[row_of(info)];
      const int sh = shift_of(info);            // log h = (Q - 1 - sh) mod (Q - 1)
      if (sym) prod = r.exp[r.log[sym] + (sh ? Q - 1 - sh : 0)];
    }
    bad |= __reduce_xor_sync(kFull, prod) != 0;
  }
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) r.flag[slot] = bad;
  cl.sync();
  const int C = (int)cl.num_blocks();
  const int any = (int)threadIdx.x < C ? *cl.map_shared_rank(r.flag + slot, threadIdx.x) : 0;
  return !__syncthreads_or(any);
}

// Step B of the check phase: the softmax sums of the round's nrow edge
// rows of exp(U) in `buf` (rows Q + 4 floats apart), serially in exp
// order, one thread per real row (16-byte loads).
template <int Q>
__device__ __forceinline__ void softmax_sums(const float* buf, float* sums, const int* info,
                                             int nrow) {
  constexpr int RS = Q + 4;
  for (int t = threadIdx.x; t < nrow; t += blockDim.x) {
    if (info[t] < 0) continue;
    const float4* row = reinterpret_cast<const float4*>(buf + t * RS);
    float s = 0.f;                     // 0 + first entry: the first entry
#pragma unroll 4
    for (int k = 0; k < Q / 4; ++k) {
      const float4 v = row[k];
      s = s + v.x;
      s = s + v.y;
      s = s + v.z;
      s = s + v.w;
    }
    sums[t] = s;
  }
}

// Step C: per row, one warp, lane l holding symbols l, l + 32, ...: P =
// exp(U) / S read at position log x + 1, F = WHT(P), written back in x
// order; a pad row's P is delta0.
template <int Q>
__device__ __forceinline__ void spectra(float* buf, const float* sums, const int* info, int nrow,
                                        const int (&logx)[Q / 32]) {
  constexpr int K = Q / 32;
  constexpr int RS = Q + 4;
  const int lane = threadIdx.x & 31;
  const int W = blockDim.x >> 5;
  for (int t = threadIdx.x >> 5; t < nrow; t += W) {
    const bool real = info[t] >= 0;
    float* bt = buf + t * RS;
    const float s = real ? sums[t] : 1.f;
    float f[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int x = k * 32 + lane;
      f[k] = real ? bt[x ? logx[k] + 1 : 0] / s : (x == 0 ? 1.f : 0.f);
    }
    wht_warp<Q>(f, lane);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < K; ++k) bt[k * 32 + lane] = f[k];
  }
}

// Step D over the round's spectra in `buf` (rows Q + 4 floats apart), one
// thread per column (check, symbol): the suffix products in registers (at
// most DC of them, DC >= dc), then G_j = prefix * suf(j) written over F_j,
// which the prefix has already taken: the plain version's products.
template <int Q, int DC, class R>
__device__ void loo_products(const R& r, int ncol) {
  constexpr int RS = Q + 4;
  const int dc = r.dc;
  for (int i = threadIdx.x; i < ncol; i += blockDim.x) {
    float* col = r.buf + (i / Q) * dc * RS + i % Q;
    float suf[DC];
    float acc = 1.f;
#pragma unroll
    for (int j = DC - 1; j >= 0; --j) {
      if (j < dc) {
        suf[j] = acc;
        acc = acc * col[j * RS];
      }
    }
    acc = 1.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      if (j < dc) {
        const float f = col[j * RS];
        col[j * RS] = acc * suf[j];
        acc = acc * f;
      }
    }
  }
}

// loo_products for the round's nrow rows with the smallest DC that holds dc
template <int Q, class R>
__device__ __forceinline__ void loo_products_round(const R& r, int nrow) {
  const int ncol = nrow / r.dc * Q;
  if (r.dc <= 8)
    loo_products<Q, 8>(r, ncol);
  else if (r.dc <= 16)
    loo_products<Q, 16>(r, ncol);
  else
    loo_products<Q, kMaxDc>(r, ncol);
}

// The frames b = first, first + step, ... < B of one cluster of a
// persistent grid: init(b) (the frame's start: posterior, hard
// decisions), the syndrome, then up to max_iters iterations of the check
// phase cn(b, it) and the variable phase vn(b, decide), the cluster
// synced after each, in the plain version's modes (the syndrome checked
// after every iteration only with stats_each_iter, a frame stopping once
// it holds with early_term or stats_each_iter; without stats_each_iter the
// decision is taken and checked once, after the budget). Then the rank's
// hard decisions, done and iters, and a block barrier: hard[] is read out
// before the next frame's init writes it. Every rank leaves through a
// cluster barrier, so no shared memory goes away while another rank reads
// it.
template <int Q, class R, class Init, class Cn, class Vn>
__device__ __forceinline__ void run_frames(const cg::cluster_group& cl, const R& r, int first,
                                           int step, int B, int N, int max_iters, int early_term,
                                           int stats_each_iter, int* hard_out, uint8_t* done_out,
                                           int* iters_out, Init init, Cn cn, Vn vn) {
  // Outputs are final once a frame is done, except in throughput mode,
  // where the decision is taken after the whole budget.
  const bool may_stop = early_term || stats_each_iter;
  const int rank = (int)cl.block_rank();
  int slot = 0;
  for (int b = first; b < B; b += step) {
    init(b);
    cl.sync();
    const int done0 = syndrome_ok<Q>(cl, r, slot);
    slot ^= 1;
    int done = done0;
    int iters = 0;
    for (int it = 0; it < max_iters; ++it) {
      if (may_stop && done) break;
      cn(b, it);
      cl.sync();
      vn(b, stats_each_iter || it == max_iters - 1);
      cl.sync();
      if (!stats_each_iter) {
        iters += 1 - done0;
        continue;
      }
      done = syndrome_ok<Q>(cl, r, slot);
      slot ^= 1;
      iters += 1;
    }
    if (!stats_each_iter) {
      done = syndrome_ok<Q>(cl, r, slot);
      slot ^= 1;
    }
    for (int i = threadIdx.x; i < r.nv; i += blockDim.x) {
      const int v = r.row_var[i];
      if (v >= 0) hard_out[(size_t)b * N + v] = r.hard[i];
    }
    if (rank == 0 && threadIdx.x == 0) {
      done_out[b] = (uint8_t)done;
      iters_out[b] = iters;
    }
    __syncthreads();          // hard[] is read out before the next frame's init writes it
  }
  cl.sync();                  // no rank leaves while another reads its shared memory
}

// The launch attributes of a cluster of C blocks of W warps with `dyn`
// bytes of dynamic shared memory each (grid: one cluster), after setting
// the kernel's shared-memory attribute.
template <class Kernel>
cudaError_t cluster_config(Kernel kernel, int C, int W, size_t dyn, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(C);
  cfg->blockDim = dim3(W * 32);
  cfg->dynamicSmemBytes = dyn;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace k0cl
