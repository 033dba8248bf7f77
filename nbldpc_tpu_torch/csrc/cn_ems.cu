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
// every extraction is nm argmax reductions over the q symbols.
//
// Classic design (cn_ems_classic_kernel): one warp per (check, frame) for
// q >= 32, lane l holding symbols l, l + 32, ..., l + q - 32 in registers;
// for q < 32 a warp holds 32 / q frames, one symbol per lane. Every
// reduction stays inside the warp: an extraction round is one warp max
// (__reduce_max_sync) of the lanes' best order-preserving 32-bit keys, one
// warp min of the symbol indices reaching it, and a rescan of its S keys
// by the one lane that owns the pick, so no round has a block barrier.
// Three blocks fit an SM at q = 256 (at most 85 registers). A block of NW
// warps (8 unless
// shared memory forces fewer) takes consecutive frames of one check and
// stages each [q, frames] slab through shared memory, so global loads and
// stores run along the frame axis (each 32-byte sector used whole; the
// next operand's loads are in flight while one is extracted); block
// barriers come only at the 2 dc slab exchanges. A frame keeps only what
// the recursion reads: the dense form of operand 0 (then F) and of the
// running B partial (the merge's acc), and the op form of operands 1..dc-1
// and partials B_1..B_{dc-3} (the nm (value, index) pairs for q > 64, else
// the q-entry list). Frames past B compute on zeros and store nothing.
//
// Bubble design (cn_ems_bubble_kernel): threads across symbols. A group of
// q threads owns one (check, frame) pair, thread a owning symbol a; a block
// of max(128, q) threads holds max(128, q) / q frames of one check; lists
// live in the group's shared memory; reductions are warp shuffles and a
// shared-memory exchange across the group's warps for q > 32. Groups past
// the last frame compute on frame B-1 and store nothing.

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

// A warp's lanes across the q symbols: S symbols per lane (lane l holds
// l, l + 32, ...) for q >= 32; for q < 32, G = 32 / q frames per warp, one
// symbol per lane. The group of a frame is its q lanes (the whole warp for
// q >= 32).
template <int Q>
struct Lanes {
  static constexpr int S = Q < 32 ? 1 : Q / 32;
  static constexpr int G = Q < 32 ? 32 / Q : 1;
};

// Order-preserving 32-bit key of a float (-0 keyed as +0, as max and >=
// treat them), and back.
__device__ __forceinline__ unsigned okey(float f) {
  unsigned u = __float_as_uint(f);
  u = u == 0x80000000u ? 0u : u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float ofloat(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// max / min of v over the frame's group of lanes
template <int Q>
__device__ __forceinline__ unsigned lanes_max(unsigned v) {
  if constexpr (Q >= 32) {
    return __reduce_max_sync(kFull, v);
  } else {
#pragma unroll
    for (int h = 1; h < Q; h <<= 1) v = max(v, __shfl_xor_sync(kFull, v, h, Q));
    return v;
  }
}

template <int Q>
__device__ __forceinline__ unsigned lanes_min(unsigned v) {
  if constexpr (Q >= 32) {
    return __reduce_min_sync(kFull, v);
  } else {
#pragma unroll
    for (int h = 1; h < Q; h <<= 1) v = min(v, __shfl_xor_sync(kFull, v, h, Q));
    return v;
  }
}

// max over the group of this lane's S values
template <int Q>
__device__ __forceinline__ float lanes_fmax(const float (&x)[Lanes<Q>::S]) {
  unsigned k = okey(x[0]);
#pragma unroll
  for (int s = 1; s < Lanes<Q>::S; ++s) k = max(k, okey(x[s]));
  return ofloat(lanes_max<Q>(k));
}

// The record of one operand or partial x (this lane's S symbols, symbol
// sym + 32 s): without truncation the identity, else the stable top-nm
// (nm rounds of: max, lowest symbol reaching it, set it to NEG). d gets the
// dense form (kept entries, the rest at the last extracted value); `dense`,
// if given, gets d too; `op`, if given, gets the op form: the nm (value,
// index) pairs when `scan`, else the list form (the rest at NEG).
template <int Q>
__device__ __forceinline__ void record(const float (&x)[Lanes<Q>::S], float (&d)[Lanes<Q>::S],
                                       int sym, int nm, bool trunc, bool scan,
                                       float* dense, float* op) {
  constexpr int S = Lanes<Q>::S;
  unsigned kept = (1u << S) - 1;
  float comp = 0.f;
  if (trunc) {
    unsigned key[S];
#pragma unroll
    for (int s = 0; s < S; ++s) key[s] = okey(x[s]);
    kept = 0;
    const unsigned neg = okey(kNeg);
    // the lane's best key and the lowest of its slots reaching it; only the
    // lane that owns a round's pick changes, so only it rescans
    unsigned best;
    int bs;
    auto rescan = [&] {
      best = key[0];
      bs = 0;
#pragma unroll
      for (int s = 1; s < S; ++s) {
        if (key[s] > best) {
          best = key[s];
          bs = s;
        }
      }
    };
    rescan();
    for (int t = 0; t < nm; ++t) {
      const unsigned mx = lanes_max<Q>(best);
      const unsigned cand = best == mx ? sym + 32 * bs : 0xffffffffu;
      const unsigned idx = lanes_min<Q>(cand);
      if (cand == idx) {                     // this lane owns the pick
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (s == bs) key[s] = neg;
        kept |= 1u << bs;
        rescan();
      }
      comp = ofloat(mx);
      if (scan && op && sym == 0)
        reinterpret_cast<float2*>(op)[t] = make_float2(comp, __uint_as_float(idx));
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool k = (kept >> s) & 1u;
    d[s] = k ? x[s] : comp;
    if (dense) dense[sym + 32 * s] = d[s];
    if (op && !scan) op[sym + 32 * s] = k ? x[s] : kNeg;
  }
}

// o[a] = max over the op's entries of op value + acc.dense[a ^ op index]:
// the nm (value, index) pairs when `scan`, else all q list entries.
template <int Q>
__device__ __forceinline__ void merge(const float* acc, const float* op, int sym, int nm,
                                      bool scan, float (&o)[Lanes<Q>::S]) {
  constexpr int S = Lanes<Q>::S;
  if (scan) {
    const float2* pairs = reinterpret_cast<const float2*>(op);
    for (int t = 0; t < nm; ++t) {
      const float2 e = pairs[t];
      const int c = sym ^ (int)__float_as_uint(e.y);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float v = e.x + acc[c ^ (s << 5)];
        o[s] = t == 0 ? v : fmaxf(o[s], v);
      }
    }
  } else {
#pragma unroll 4
    for (int b = 0; b < Q; ++b) {
      const float l = op[b];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float v = l + acc[(sym + 32 * s) ^ b];
        o[s] = b == 0 ? v : fmaxf(o[s], v);
      }
    }
  }
}

// The block's [Q, fb] slab of frames b0.. b0 + fb - 1 of one (check, slot)
// row block [Q, B], fb = 2^lg_fb frames, moved along b: with 32 fb / G
// threads each thread moves exactly S entries, e = thread + s * threads.
// slab_fetch reads it into registers (zeros past B), slab_put writes them
// to the slab (row stride fb + 1) between two barriers, slab_store writes
// the slab out between two barriers.
template <int Q>
__device__ __forceinline__ void slab_fetch(float (&v)[Lanes<Q>::S], const float* src, int B,
                                           int b0, int lg_fb) {
#pragma unroll
  for (int s = 0; s < Lanes<Q>::S; ++s) {
    const int e = threadIdx.x + s * blockDim.x;
    const int a = e >> lg_fb, b = b0 + (e & ((1 << lg_fb) - 1));
    v[s] = b < B ? src[(size_t)a * B + b] : 0.f;
  }
}

template <int Q>
__device__ __forceinline__ void slab_put(float* slab, const float (&v)[Lanes<Q>::S],
                                         int lg_fb) {
  __syncthreads();
#pragma unroll
  for (int s = 0; s < Lanes<Q>::S; ++s) {
    const int e = threadIdx.x + s * blockDim.x;
    slab[(e >> lg_fb) * ((1 << lg_fb) + 1) + (e & ((1 << lg_fb) - 1))] = v[s];
  }
  __syncthreads();
}

template <int Q>
__device__ __forceinline__ void slab_store(const float* slab, float* dst, int B, int b0,
                                           int lg_fb) {
  __syncthreads();
#pragma unroll
  for (int s = 0; s < Lanes<Q>::S; ++s) {
    const int e = threadIdx.x + s * blockDim.x;
    const int a = e >> lg_fb, f = e & ((1 << lg_fb) - 1);
    if (b0 + f < B) dst[(size_t)a * B + b0 + f] = slab[a * ((1 << lg_fb) + 1) + f];
  }
  __syncthreads();
}

// Floats of shared memory the classic kernel needs for frames of fb per block.
template <int Q>
size_t classic_floats(int fb, int dc, int nm) {
  const bool scan = nm < Q && Q > kDenseMergeMaxQ;
  const int slots = (dc - 1) + (dc > 3 ? dc - 3 : 0);
  return (size_t)Q * (fb + 1) + (size_t)fb * (2 * Q + slots * (scan ? 2 * nm : Q));
}

template <int Q>
__global__ void __launch_bounds__(256, 3)
cn_ems_classic_kernel(const float* __restrict__ U, float* __restrict__ out,
                      int dc, int B, int nm, float offset, int lg_fb) {
  extern __shared__ float smem[];
  constexpr int S = Lanes<Q>::S, G = Lanes<Q>::G;
  const int lane = threadIdx.x & 31;
  const int sym = lane % Q;                                 // lane l holds sym + 32 s
  const int w = (threadIdx.x >> 5) * G + lane / Q;          // its frame in the block
  const int fb = 1 << lg_fb, ld = fb + 1;
  const int b0 = blockIdx.x * fb;
  const bool trunc = nm < Q;
  const bool scan = trunc && Q > kDenseMergeMaxQ;
  const int rec = scan ? 2 * nm : Q;
  const int slots = (dc - 1) + (dc > 3 ? dc - 3 : 0);
  float* slab = smem;
  // per frame: dense operand 0 (then F), dense B partial, then the op
  // records: slots 0..dc-2 operands 1..dc-1, slots dc-1.. partials B_1..
  float* fdense = smem + (size_t)Q * ld + (size_t)w * (2 * Q + slots * rec);
  float* bdense = fdense + Q;
  auto slot = [&](int k) { return bdense + Q + (size_t)k * rec; };
  auto bop = [&](int j) { return slot(j == dc - 2 ? dc - 2 : dc - 2 + j); };
  const size_t js = (size_t)Q * B;
  const float* Um = U + (size_t)blockIdx.y * dc * js;
  float* Om = out + (size_t)blockIdx.y * dc * js;

  // postprocess o and store it as output slot j
  auto emit_out = [&](int j, const float (&o)[S]) {
    const float mx = lanes_fmax<Q>(o);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float r = (o[s] - mx) + offset;
      slab[(sym + 32 * s) * ld + w] = fmaxf(fminf(r, 0.f), kNeg);
    }
    slab_store<Q>(slab, Om + j * js, B, b0, lg_fb);
  };

  float d[S], o[S], next[S];
  slab_fetch<Q>(next, Um, B, b0, lg_fb);
  for (int j = 0; j < dc; ++j) {
    slab_put<Q>(slab, next, lg_fb);
    float x[S];
#pragma unroll
    for (int s = 0; s < S; ++s) x[s] = slab[(sym + 32 * s) * ld + w];
    if (j + 1 < dc) slab_fetch<Q>(next, Um + (j + 1) * js, B, b0, lg_fb);   // in flight
    const float mx = lanes_fmax<Q>(x);
#pragma unroll
    for (int s = 0; s < S; ++s) x[s] = x[s] - mx;
    record<Q>(x, d, sym, nm, trunc, scan,
              j == 0 ? fdense : (j == dc - 1 ? bdense : nullptr),
              j >= 1 ? slot(j - 1) : nullptr);
  }
  __syncwarp();
  // B_j = merge of U_{j+1..dc-1}; B_{dc-2} is U_{dc-1}, whose dense form d holds
  for (int j = dc - 3; j >= 0; --j) {
    merge<Q>(bdense, slot(j), sym, nm, scan, o);
    __syncwarp();                            // the acc is read before it is replaced
    record<Q>(o, d, sym, nm, trunc, scan, bdense, j >= 1 ? bop(j) : nullptr);
    __syncwarp();
  }
  emit_out(0, d);
  // F_j = merge of U_{0..j-1}, kept in fdense (F_1 is U_0 itself)
#pragma unroll
  for (int s = 0; s < S; ++s) d[s] = fdense[sym + 32 * s];
  for (int j = 1; j < dc; ++j) {
    if (j >= 2) {
      merge<Q>(fdense, slot(j - 2), sym, nm, scan, o);
      __syncwarp();
      record<Q>(o, d, sym, nm, trunc, scan, fdense, nullptr);
      __syncwarp();
    }
    if (j < dc - 1) {
      merge<Q>(fdense, bop(j), sym, nm, scan, o);
      emit_out(j, o);
    } else {
      emit_out(j, d);
    }
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
    // 8 warps a block unless shared memory forces fewer
    int warps = 8;
    while (warps > 1 &&
           classic_floats<Q>(warps * Lanes<Q>::G, dc, nm) * sizeof(float) > kMaxSmem)
      warps /= 2;
    const int fb = warps * Lanes<Q>::G;
    const size_t bytes = classic_floats<Q>(fb, dc, nm) * sizeof(float);
    err = prepare(cn_ems_classic_kernel<Q>, bytes);
    if (err != cudaSuccess) return err;
    cn_ems_classic_kernel<Q><<<dim3((B + fb - 1) / fb, M), 32 * warps, bytes, stream>>>(
        U, out, dc, B, nm, offset, __builtin_ctz(fb));
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
