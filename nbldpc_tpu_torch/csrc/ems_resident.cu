// Whole EMS decode, all iterations in shared memory, a few frames per block.
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
// edge message stay in shared memory for all iterations. The cost is the
// merges: 3 (dc - 2) per check and iteration, each q^2 adds and as many
// max, 2.24 ms of f32 work (ops bound) for the bench step of
// ems_gf16_n204_k102 (8192 frames x 50 iterations, nm = q = 16).
//
// The first design ran a check on a group of q lanes, lane a owning
// symbol a, and paid in shuffles: a merge was 2 q - 1 shuffles, each group
// max log2 q more, ~218 per check of dc = 4 at q = 16, ~3.45e7 shuffle
// issues per SM over the bench step, about 20 of its ~31.7 ms at one
// shuffle per clock; the rest went to per-edge __ldg table reads and two
// block barriers per iteration.
//
// Design: one thread owns one check. Templated on q and fully unrolled, a
// merge keeps acc and out in registers with both indices of acc[a ^ b]
// compile-time constants: q^2 adds and max on the FP32 pipe, no shuffle.
// Normalize, postprocess and extraction (nm rounds over the thread's
// registers, (value, lower index), a kept bitmask) are in-register too.
// The x-domain operands overwrite the check's own lc rows (dense form;
// the backward partials B_0..B_{dc-3} go to the check's shared scratch,
// the kept masks to words beside); rows of consecutive checks start 4
// banks apart, so the
// 16-byte row loads meet no bank conflict. The routing tables (perm_down
// as bytes, the edge variables with a pad bit, the variables' lc row
// offsets, syn_k as bytes) are staged into shared memory once per block.
// Up to kMaxFrames frames share a block (and its tables), as many as 227
// KB hold, so the check phase keeps ~10 warps of an SM busy at GF(16)
// (204,102); every frame keeps its own stop, iteration count and outputs.
// The variable update runs one thread per (variable, 4 symbols).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxFrames = 3;
constexpr size_t kMaxSmem = 232448;  // per-block dynamic shared memory, sm_90
constexpr unsigned kPadBit = 0x8000u;
constexpr unsigned kNoEdge = 0xffffu;

template <int Q>
struct Cfg {
  static constexpr int kThreads = Q >= 32 ? 256 : 512;   // most threads a block
  static constexpr int kVec = Q < 4 ? Q : 4;             // floats per row access
  static constexpr unsigned kAll = Q == 32 ? 0xffffffffu : (1u << Q) - 1u;
};

struct Tables {
  const int* cn_vn;      // [M*dc] variable of each edge slot (pads -> 0)
  const int* cn_real;    // [M*dc] 1 on real slots, 0 on pads
  const int* perm_down;  // [M*dc*q] h^-1 x
  const int* vn_edge;    // [N*dv] edge slot of each variable slot (pads -> M*dc)
  const int* syn_k;      // [M*dc*p] h * 2^t (0 on pads)
};

// Shared-memory layout, the same on the host and in the kernel (and in
// kernels/ems_resident.py:ems_smem_layout). Tables first (bytes): perm_down
// u8 [E q], edge variable u16 [E] (kPadBit on pads), lc row offset of each
// variable slot u16 [N dv] (kNoEdge on pads), syn_k u8 [E p]; then per
// frame (floats): prior [N q], post [N q], lc (M rows of cs: the check's dc
// rows), scratch (M rows of bs: the dc - 2 backward partials), kept masks
// (M x (2 dc - 2) words), hard u8 [N].
struct Layout {
  int cs, bs;                                 // floats per check: lc, scratch
  int off_post, off_lc, off_scr, off_kept, off_hard;   // floats into a frame
  int frame;                                  // floats per frame
  int tables;                                 // bytes of the tables
};

__host__ __device__ inline int round_up(int x, int k) { return (x + k - 1) / k * k; }

// n rounded up to a stride of 4 (mod 32) floats: consecutive rows 4 banks apart
__host__ __device__ inline int bank_stride(int n) { return n + ((4 - n) % 32 + 32) % 32; }

__host__ __device__ inline Layout layout(int N, int M, int dc, int dv, int q, int P) {
  Layout L;
  const int E = M * dc;
  L.cs = bank_stride(dc * q);
  L.bs = bank_stride((dc - 2) * q);
  L.off_post = round_up(N * q, 4);
  L.off_lc = 2 * L.off_post;
  L.off_scr = L.off_lc + M * L.cs;
  L.off_kept = L.off_scr + M * L.bs;
  L.off_hard = L.off_kept + round_up(M * (2 * dc - 2), 4);
  L.frame = L.off_hard + round_up((N + 3) / 4, 4);
  L.tables = round_up(E * q + 2 * E + 2 * N * dv + E * P, 16);
  return L;
}

__host__ __device__ inline size_t block_bytes(const Layout& L, int frames) {
  return (size_t)L.tables + (size_t)frames * L.frame * sizeof(float);
}

// ---- one row of q floats, in registers ----------------------------------------

template <int Q>
__device__ __forceinline__ void load_row(const float* p, float (&x)[Q]) {
  if constexpr (Q >= 4) {
#pragma unroll
    for (int c = 0; c < Q; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + c);
      x[c] = v.x; x[c + 1] = v.y; x[c + 2] = v.z; x[c + 3] = v.w;
    }
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  }
}

template <int Q>
__device__ __forceinline__ void store_row(float* p, const float (&x)[Q]) {
  if constexpr (Q >= 4) {
#pragma unroll
    for (int c = 0; c < Q; c += 4)
      *reinterpret_cast<float4*>(p + c) = make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

// perm_down bytes of one edge: symbol a's source is byte a of w
template <int Q>
__device__ __forceinline__ void load_perm(const uint8_t* p, unsigned (&w)[(Q + 3) / 4]) {
  if constexpr (Q >= 16) {
#pragma unroll
    for (int c = 0; c < Q / 16; ++c) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[c];
      w[4 * c] = v.x; w[4 * c + 1] = v.y; w[4 * c + 2] = v.z; w[4 * c + 3] = v.w;
    }
  } else if constexpr (Q == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else if constexpr (Q == 4) {
    w[0] = *reinterpret_cast<const unsigned*>(p);
  } else {
    w[0] = *reinterpret_cast<const unsigned short*>(p);
  }
}

__device__ __forceinline__ int perm_at(const unsigned* w, int a) {
  return (w[a >> 2] >> (8 * (a & 3))) & 0xff;
}

template <int Q>
__device__ __forceinline__ float row_max(const float (&x)[Q]) {
  float m = x[0];
#pragma unroll
  for (int a = 1; a < Q; ++a) m = fmaxf(m, x[a]);
  return m;
}

// Stable top-nm of x: nm rounds of (max, lowest index reaching it, set it
// to NEG). x becomes the dense form (kept entries, the rest at the last
// extracted value); returns the kept mask.
template <int Q>
__device__ __forceinline__ unsigned extract(float (&x)[Q], int nm) {
  float run[Q];
#pragma unroll
  for (int a = 0; a < Q; ++a) run[a] = x[a];
  unsigned kept = 0;
  float comp = 0.f;
  for (int t = 0; t < nm; ++t) {
    float v = run[0];
    int i = 0;
#pragma unroll
    for (int a = 1; a < Q; ++a) {
      if (run[a] > v) {
        v = run[a];
        i = a;
      }
    }
    kept |= 1u << i;
#pragma unroll
    for (int a = 0; a < Q; ++a)
      if (a == i) run[a] = kNeg;
    comp = v;
  }
#pragma unroll
  for (int a = 0; a < Q; ++a) x[a] = ((kept >> a) & 1u) ? x[a] : comp;
  return kept;
}

// o[a] = max_b op.list[b] + acc[a ^ b]; op's dense row at `op`, its list
// form kept ? op : NEG
template <int Q>
__device__ __forceinline__ void merge(const float (&acc)[Q], const float* op, unsigned kept,
                                      float (&o)[Q]) {
  constexpr int V = Cfg<Q>::kVec;
#pragma unroll
  for (int b0 = 0; b0 < Q; b0 += V) {
    float v[V];
    if constexpr (V == 4) {
      const float4 t = *reinterpret_cast<const float4*>(op + b0);
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      const float2 t = *reinterpret_cast<const float2*>(op + b0);
      v[0] = t.x; v[1] = t.y;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int b = b0 + k;
      const float l = ((kept >> b) & 1u) ? v[k] : kNeg;
#pragma unroll
      for (int a = 0; a < Q; ++a) {
        const float c = l + acc[a ^ b];
        o[a] = b == 0 ? c : fmaxf(o[a], c);
      }
    }
  }
}

template <int Q>
__device__ __forceinline__ void postprocess(float (&o)[Q], float offset) {
  const float mx = row_max<Q>(o);
#pragma unroll
  for (int a = 0; a < Q; ++a) o[a] = fmaxf(fminf((o[a] - mx) + offset, 0.f), kNeg);
}

// lc[e](h^-1 x) = o(x): the check's row of edge e in c-domain
template <int Q>
__device__ __forceinline__ void scatter_row(float* row, const uint8_t* pd, const float (&o)[Q]) {
  unsigned w[(Q + 3) / 4];
  load_perm<Q>(pd, w);
#pragma unroll
  for (int a = 0; a < Q; ++a) row[perm_at(w, a)] = o[a];
}

// post = prior + the sum of the variable's messages in slot order, on the
// V symbols of chunk i = (variable, chunk) of one frame
template <int Q>
__device__ __forceinline__ void vn_chunk(const float* __restrict__ prior,
                                         const float* __restrict__ lc,
                                         float* __restrict__ post,
                                         const uint16_t* __restrict__ vno, int i, int dv) {
  constexpr int V = Cfg<Q>::kVec, C = Q / V;
  const int v = i / C, c0 = (i % C) * V;
  float acc[V] = {}, x[V];
  for (int s = 0; s < dv; ++s) {
    const unsigned o = vno[v * dv + s];
    if (o == kNoEdge) continue;
    load_row<V>(lc + o + c0, x);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] += x[k];
  }
  load_row<V>(prior + v * Q + c0, x);
#pragma unroll
  for (int k = 0; k < V; ++k) x[k] = x[k] + acc[k];
  store_row<V>(post + v * Q + c0, x);
}

// The classic EMS update of one check: its dc c-domain lc rows are replaced
// in place. `scr` holds the dense partials B_0..B_{dc-3}, `kmask` the
// kept masks of U_0..U_{dc-1} and of B_0..B_{dc-3} (written only when nm < q).
template <int Q>
__device__ void check_update(const float* post, float* rows, float* scr, unsigned* kmask,
                             const uint8_t* pd, const uint16_t* cv, int dc, int nm,
                             float offset) {
  constexpr unsigned kAll = Cfg<Q>::kAll;
  const bool trunc = nm < Q;
  // pass 1: the x-domain operands, normalized (and extracted), over the rows
  for (int j = 0; j < dc; ++j) {
    float* row = rows + j * Q;
    const unsigned c = cv[j];
    const float* pv = post + (c & ~kPadBit) * Q;
    unsigned w[(Q + 3) / 4];
    load_perm<Q>(pd + j * Q, w);
    float u[Q];
#pragma unroll
    for (int a = 0; a < Q; ++a) {
      const int s = perm_at(w, a);
      u[a] = pv[s] - row[s];
    }
    const float mx = row_max<Q>(u);
#pragma unroll
    for (int a = 0; a < Q; ++a) u[a] = u[a] - mx;
    if (c & kPadBit) {
#pragma unroll
      for (int a = 0; a < Q; ++a) u[a] = a == 0 ? 0.f : kNeg;
    }
    if (trunc) kmask[j] = extract<Q>(u, nm);
    store_row<Q>(row, u);
  }
  auto kept = [&](int k) { return trunc ? kmask[k] : kAll; };
  // backward: B_j = merge of U_{j+1..dc-1}; B_{dc-2} is U_{dc-1}
  float acc[Q], o[Q];
  load_row<Q>(rows + (dc - 1) * Q, acc);
  for (int j = dc - 3; j >= 0; --j) {
    merge<Q>(acc, rows + (j + 1) * Q, kept(j + 1), o);
    if (trunc) kmask[dc + j] = extract<Q>(o, nm);
#pragma unroll
    for (int a = 0; a < Q; ++a) acc[a] = o[a];
    store_row<Q>(scr + j * Q, acc);
  }
  // forward: F_j = merge of U_{0..j-1} in fd; the output of slot j - 1
  // waits in pend until F_j has read row j - 1
  float fd[Q];
  load_row<Q>(rows, fd);                    // F_1 = U_0
  postprocess<Q>(acc, offset);              // slot 0: B_0
  for (int j = 1; j < dc; ++j) {
    if (j >= 2) {
      merge<Q>(fd, rows + (j - 1) * Q, kept(j - 1), o);
      if (trunc) extract<Q>(o, nm);
#pragma unroll
      for (int a = 0; a < Q; ++a) fd[a] = o[a];
    }
    scatter_row<Q>(rows + (j - 1) * Q, pd + (j - 1) * Q, acc);
    if (j < dc - 1) {
      if (j == dc - 2)
        merge<Q>(fd, rows + (dc - 1) * Q, kept(dc - 1), acc);
      else
        merge<Q>(fd, scr + j * Q, kept(dc + j), acc);
    } else {
#pragma unroll
      for (int a = 0; a < Q; ++a) acc[a] = fd[a];
    }
    postprocess<Q>(acc, offset);
  }
  scatter_row<Q>(rows + (dc - 1) * Q, pd + (dc - 1) * Q, acc);
}

template <int Q, int P>
__global__ void __launch_bounds__(Cfg<Q>::kThreads)
ems_resident_kernel(const float* __restrict__ llr, int* __restrict__ hard_out,
                    uint8_t* __restrict__ done_out, int* __restrict__ iters_out,
                    int B, int N, int M, int dc, int dv, int nm, float offset, Tables t,
                    int max_iters, int early_term, int stats_each_iter, int frames) {
  constexpr int C = Q / Cfg<Q>::kVec;      // row chunks
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_bad[kMaxFrames];
  const Layout L = layout(N, M, dc, dv, Q, P);
  const int E = M * dc;
  uint8_t* pdn = smem;
  uint16_t* cnv = reinterpret_cast<uint16_t*>(smem + E * Q);
  uint16_t* vno = cnv + E;
  uint8_t* synk = reinterpret_cast<uint8_t*>(vno + N * dv);
  float* fbase = reinterpret_cast<float*>(smem + L.tables);
  const int fb0 = blockIdx.x * frames;
  const int nf = min(frames, B - fb0);    // frames of this block
  const int tid = threadIdx.x, nt = blockDim.x;
  auto frame = [&](int f) { return fbase + (size_t)f * L.frame; };

  // ---- tables and frames in ----
  for (int i = tid; i < E * Q; i += nt) pdn[i] = (uint8_t)t.perm_down[i];
  for (int e = tid; e < E; e += nt)
    cnv[e] = (uint16_t)(t.cn_vn[e] | (t.cn_real[e] ? 0u : kPadBit));
  for (int i = tid; i < N * dv; i += nt) {
    const int e = t.vn_edge[i];
    vno[i] = (uint16_t)(e < E ? (e / dc) * L.cs + (e % dc) * Q : kNoEdge);
  }
  for (int i = tid; i < E * P; i += nt) synk[i] = (uint8_t)t.syn_k[i];
  const float* Lf = llr + (size_t)fb0 * N * Q;
  for (int f = 0; f < nf; ++f) {
    float* fr = frame(f);
    for (int i = tid; i < N * Q; i += nt) fr[i] = Lf[(size_t)f * N * Q + i];
    for (int i = tid; i < M * L.cs; i += nt) fr[L.off_lc + i] = 0.f;
  }
  __syncthreads();
  for (int k = tid; k < nf * N; k += nt) {
    const int f = k / N, v = k - f * N;
    float* pr = frame(f) + v * Q;
    float x[Q];
    load_row<Q>(pr, x);
    const float mx = row_max<Q>(x);
#pragma unroll
    for (int a = 0; a < Q; ++a) x[a] -= mx;
    store_row<Q>(pr, x);
    store_row<Q>(pr + L.off_post, x);
  }
  __syncthreads();

  // hard decisions of the frames in `mask`: argmax over q, strict
  // ascending scan, so ties go to the lowest symbol
  auto hard_of = [&](unsigned mask) {
    for (int k = tid; k < nf * N; k += nt) {
      const int f = k / N, v = k - f * N;
      if (!((mask >> f) & 1u)) continue;
      float x[Q];
      load_row<Q>(frame(f) + L.off_post + v * Q, x);
      float best = x[0];
      int idx = 0;
#pragma unroll
      for (int a = 1; a < Q; ++a) {
        if (x[a] > best) {
          best = x[a];
          idx = a;
        }
      }
      reinterpret_cast<uint8_t*>(frame(f) + L.off_hard)[v] = (uint8_t)idx;
    }
  };
  // bit f set when every check of frame f is satisfied; reads hard (the
  // caller syncs before), the same value in every thread
  auto satisfied = [&](unsigned mask) {
    if (tid < kMaxFrames) s_bad[tid] = 0;
    __syncthreads();
    for (int k = tid; k < nf * M; k += nt) {
      const int f = k / M, m = k - f * M;
      if (!((mask >> f) & 1u)) continue;
      const uint8_t* hard = reinterpret_cast<const uint8_t*>(frame(f) + L.off_hard);
      int x = 0;
      for (int j = 0; j < dc; ++j) {
        const int e = m * dc + j;
        const int sym = hard[cnv[e] & ~kPadBit];
#pragma unroll
        for (int b = 0; b < P; ++b)
          if ((sym >> b) & 1) x ^= synk[e * P + b];
      }
      if (x) s_bad[f] = 1;
    }
    __syncthreads();
    unsigned ok = 0;
    for (int f = 0; f < nf; ++f) ok |= (unsigned)(s_bad[f] == 0) << f;
    return ok;
  };

  const unsigned all = (1u << nf) - 1u;
  hard_of(all);
  __syncthreads();
  const unsigned done0 = satisfied(all);
  unsigned done = done0;
  int iters[kMaxFrames] = {};
  // Outputs are final once a frame is done, except in throughput mode,
  // where the decision is taken after the whole budget.
  const bool may_stop = early_term || stats_each_iter;
  for (int it = 0; it < max_iters; ++it) {
    const unsigned run = may_stop ? all & ~done : all;
    if (!run) break;
    // check-node phase: a thread per (frame, check)
    for (int k = tid; k < nf * M; k += nt) {
      const int f = k / M, m = k - f * M;
      if (!((run >> f) & 1u)) continue;
      float* fr = frame(f);
      check_update<Q>(fr + L.off_post, fr + L.off_lc + m * L.cs, fr + L.off_scr + m * L.bs,
                      reinterpret_cast<unsigned*>(fr + L.off_kept) + m * (2 * dc - 2), pdn + m * dc * Q, cnv + m * dc, dc, nm, offset);
    }
    __syncthreads();
    // variable-node phase: post = prior + sum of the variable's messages,
    // a thread per (variable, V symbols), frame by frame
    for (int f = 0; f < nf; ++f) {
      if (!((run >> f) & 1u)) continue;
      float* fr = frame(f);
      for (int i = tid; i < N * C; i += nt)
        vn_chunk<Q>(fr, fr + L.off_lc, fr + L.off_post, vno, i, dv);
    }
    __syncthreads();
#pragma unroll
    for (int f = 0; f < kMaxFrames; ++f)
      iters[f] += stats_each_iter ? (int)((run >> f) & 1u) : (int)(1u - ((done0 >> f) & 1u));
    if (!stats_each_iter) continue;
    hard_of(run);
    __syncthreads();
    done |= satisfied(run) & run;
  }
  if (!stats_each_iter) {
    hard_of(all);
    __syncthreads();
    done = satisfied(all);
  }
  for (int k = tid; k < nf * N; k += nt) {
    const int f = k / N, v = k - f * N;
    hard_out[(size_t)(fb0 + f) * N + v] =
        reinterpret_cast<const uint8_t*>(frame(f) + L.off_hard)[v];
  }
  if (tid == 0) {
#pragma unroll
    for (int f = 0; f < kMaxFrames; ++f) {
      if (f < nf) {
        done_out[fb0 + f] = (uint8_t)((done >> f) & 1u);
        iters_out[fb0 + f] = iters[f];
      }
    }
  }
}

template <int Q, int P>
cudaError_t launch(const float* llr, int* hard, uint8_t* done, int* iters, int B,
                   int N, int M, int dc, int dv, int nm, float offset,
                   const Tables& t, int max_iters, int early_term,
                   int stats_each_iter, cudaStream_t stream) {
  if (dc < 2 || dc > 32 || nm < 1 || N >= (int)kPadBit) return cudaErrorInvalidValue;
  const Layout L = layout(N, M, dc, dv, Q, P);
  if (M * L.cs >= (int)kNoEdge) return cudaErrorInvalidValue;
  // as many frames a block as shared memory holds, up to kMaxFrames
  int frames = kMaxFrames;
  while (frames > 1 && block_bytes(L, frames) > kMaxSmem) --frames;
  const size_t smem = block_bytes(L, frames);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int threads = min(Cfg<Q>::kThreads, round_up(frames * M, 32));
  cudaError_t err = cudaFuncSetAttribute(
      ems_resident_kernel<Q, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ems_resident_kernel<Q, P><<<(B + frames - 1) / frames, threads, smem, stream>>>(
      llr, hard, done, iters, B, N, M, dc, dv, nm, offset, t, max_iters, early_term,
      stats_each_iter, frames);
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
      return launch<QQ, PP>(llr, hard, done, iters, B, N, M, dc, dv, nm,      \
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
