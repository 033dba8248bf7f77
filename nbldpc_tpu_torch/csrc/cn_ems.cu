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
// Bubble design (cn_ems_bubble_kernel), the classic kernel's layout: one
// warp per (check, frame) for q >= 32 (lane l holding symbols l, l + 32,
// ...), 32 / q frames a warp for q < 32; blocks of up to 8 warps take
// consecutive frames of one check and stage their slabs through shared
// memory. A frame's sorted nm-lists (operands, then the B partials; F
// overwrites operand 0) sit in its shared memory, written by one lane a
// round and read by all. Extraction rounds are the classic kernel's. A
// merge's P = npairs + min(2 nm, q) candidates sit in registers, 2 or
// kSlots = 4 a lane (the fewest that hold them: P <= 64 at q >= 32 is nm
// <= 8, P <= 128 is nm <= 16), lane l holding the consecutive positions l
// n .. l n + n - 1; more candidates go to the frame's shared memory. A
// round is one warp max of keys, a ballot of the lanes reaching it (the
// lowest such lane holds the lowest such position), a shuffle of the
// pick's index from that lane, and a register compare that retires every
// candidate of that index, so no merge has a block barrier. Dense outputs
// go through a per-frame row of q keys in shared memory, each pair (or
// list entry) taken by an atomicMax of its order-preserving key. At most
// 64 registers a thread leave four 8-warp blocks an SM. Frames past B
// compute on zeros and store nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "slab.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDenseMergeMaxQ = 64;
constexpr size_t kMaxSmem = 232448;       // per-block dynamic shared memory, sm_90

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
    slab_store<S>(slab, Om + j * js, B, b0, lg_fb);
  };

  float d[S], o[S], next[S];
  slab_fetch<S>(next, Um, B, b0, lg_fb);
  for (int j = 0; j < dc; ++j) {
    slab_put<S>(slab, next, lg_fb);
    float x[S];
#pragma unroll
    for (int s = 0; s < S; ++s) x[s] = slab[(sym + 32 * s) * ld + w];
    if (j + 1 < dc) slab_fetch<S>(next, Um + (j + 1) * js, B, b0, lg_fb);   // in flight
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

// Most candidate slots a lane keeps in registers; a merge with more
// candidates than kSlots per lane keeps them in the frame's shared memory.
constexpr int kSlots = 4;

// A sorted nm-list of one frame in its shared memory: values V[nm]
// (non-increasing), GF indices I[nm], comp C (= V[nm - 1]).
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

// Floats of a frame's shared memory: the 2 dc - 2 lists (operands 0..dc-1,
// operand 0 then carrying F, and partials B_0..B_{dc-3}), the dense row
// of q keys and, without register slots, the candidate slots (keys and
// indices, cp each).
__host__ __device__ __forceinline__ int bubble_frame_floats(int q, int dc, int nm,
                                                            int cp) {
  return (2 * dc - 2) * (2 * nm + 1) + q + 2 * cp;
}

// The candidate slots of one lane: slot k is staircase position p =
// gl n + k (pairs first, in lex (t, s) order, then the fills), so a lane's
// positions are consecutive and the lowest position reaching a maximum
// lies in the lowest lane reaching it. KP > 0: n = KP slots in registers;
// KP = 0: n slots in the frame's shared memory (sk, si at gl + L k, no
// bank conflicts). `ts` caches the lane's pairs (t | s << 16) for register
// slots.
template <int Q, int KP>
struct Slots {
  static constexpr int L = Q < 32 ? Q : 32;
  static constexpr int R = KP > 0 ? KP : 1;
  unsigned key[R];
  int idx[R];
  int ts[R];
  unsigned* sk;
  int* si;
  int n;
  int gl;
  const int* tab;

  __device__ __forceinline__ int count() const { return KP > 0 ? KP : n; }
  __device__ __forceinline__ int pos(int k) const { return gl * count() + k; }
  __device__ __forceinline__ int pair(int k) const {
    if constexpr (KP > 0) return ts[k];
    else return tab[pos(k)];
  }
  __device__ __forceinline__ unsigned& K(int k) {
    if constexpr (KP > 0) return key[k];
    else return sk[gl + L * k];
  }
  __device__ __forceinline__ int& I(int k) {
    if constexpr (KP > 0) return idx[k];
    else return si[gl + L * k];
  }
};

// The stable top-nm list of x (this lane's S symbols sym + 32 s): nm rounds
// of (max, lowest symbol reaching it, set it to NEG); only the lane that
// owns a round's pick rescans.
template <int Q>
__device__ __forceinline__ void top_list(const float (&x)[Lanes<Q>::S], int sym, int nm,
                                         List l) {
  constexpr int S = Lanes<Q>::S, L = Q < 32 ? Q : 32;
  unsigned key[S];
#pragma unroll
  for (int s = 0; s < S; ++s) key[s] = okey(x[s]);
  const unsigned neg = okey(kNeg);
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
  unsigned mx = 0;
  for (int t = 0; t < nm; ++t) {
    mx = lanes_max<Q>(best);
    const unsigned cand = best == mx ? sym + 32 * bs : 0xffffffffu;
    const unsigned idx = lanes_min<Q>(cand);
    if (cand == idx) {
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (s == bs) key[s] = neg;
      rescan();
    }
    if (sym == (t & (L - 1))) {
      l.V[t] = ofloat(mx);
      l.I[t] = (int)idx;
    }
  }
  if (sym == 0) *l.C = ofloat(mx);
}

// dst = top-nm of the staircase pairs above the floor f = op.V[0] + acc.C
// and min(2 nm, q) fills of value f at indices 0, 1, ...; a pick retires
// every candidate of its index, ties go to the lowest position, and
// retired candidates (NEG) can be picked again. dst may be acc.
template <int Q, int KP>
__device__ __forceinline__ void merge_bubble(Slots<Q, KP>& c, int nm, int npairs, int P,
                                             List acc, List op, List dst) {
  constexpr int L = Slots<Q, KP>::L;
  const int gl = c.gl;
  const int lane0 = (threadIdx.x & 31) - gl;  // the group's first lane
  __syncwarp();                              // the lists are written
  const float f = op.V[0] + *acc.C;
  const unsigned kf = okey(f), neg = okey(kNeg);
#pragma unroll
  for (int k = 0; k < c.count(); ++k) {
    const int p = c.pos(k);
    unsigned key = 0;                        // no candidate: below every key
    int idx = -1;
    if (p < npairs) {
      const int ts = c.pair(k), t = ts & 0xffff, s = ts >> 16;
      const float v = acc.V[t] + op.V[s];
      key = v > f ? okey(v) : neg;
      idx = acc.I[t] ^ op.I[s];
    } else if (p < P) {
      key = kf;
      idx = p - npairs;
    }
    c.K(k) = key;
    c.I(k) = idx;
  }
  __syncwarp();                              // acc and op read before dst is written
  unsigned best;
  int bi;
  auto rescan = [&] {
    best = 0;
    bi = -1;
#pragma unroll
    for (int k = 0; k < c.count(); ++k) {
      if (c.K(k) > best) {
        best = c.K(k);
        bi = c.I(k);
      }
    }
  };
  rescan();
  float last = 0.f;
  for (int t = 0; t < nm; ++t) {
    const unsigned mx = lanes_max<Q>(best);
    // the lowest lane of the frame's group reaching mx owns the pick, at
    // the lowest of its slots reaching it (the one rescan kept)
    const unsigned reach = __ballot_sync(kFull, best == mx) >> (lane0 & 31);
    const int owner = __ffs(L == 32 ? reach : reach & ((1u << (L & 31)) - 1)) - 1;
    const int pick = __shfl_sync(kFull, bi, owner, L);
#pragma unroll
    for (int k = 0; k < c.count(); ++k)
      if (c.I(k) == pick) c.K(k) = neg;
    rescan();
    last = fmaxf(ofloat(mx), f);
    if (gl == (t & (L - 1))) {
      dst.V[t] = last;
      dst.I[t] = pick;
    }
  }
  if (gl == 0) *dst.C = last;
}

// o = the dense form of a final output into the frame's row of q keys:
// with `pairs`, the merge of acc and op (the floor f = op.V[0] + acc.C,
// raised to NEG as the plain version's masked max does, then every
// staircase pair's value at its index); else the scatter of list acc
// (comp everywhere, each entry at its index). max is exact in any order,
// so the row takes them by atomicMax of order-preserving keys.
template <int Q, int KP>
__device__ __forceinline__ void dense_out(Slots<Q, KP>& c, int sym, int nm, int npairs,
                                          bool pairs, List acc, List op, unsigned* row,
                                          float (&o)[Lanes<Q>::S]) {
  constexpr int S = Lanes<Q>::S, L = Slots<Q, KP>::L;
  __syncwarp();                              // lists written, the last row read
  const float base = pairs ? fmaxf(op.V[0] + *acc.C, kNeg) : *acc.C;
#pragma unroll
  for (int s = 0; s < S; ++s) row[sym + 32 * s] = okey(base);
  __syncwarp();
  if (pairs) {
#pragma unroll
    for (int k = 0; k < c.count(); ++k) {
      if (c.pos(k) < npairs) {
        const int ts = c.pair(k), t = ts & 0xffff, s = ts >> 16;
        atomicMax(row + (acc.I[t] ^ op.I[s]), okey(acc.V[t] + op.V[s]));
      }
    }
  } else {
    for (int t = c.gl; t < nm; t += L) atomicMax(row + acc.I[t], okey(acc.V[t]));
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < S; ++s) o[s] = ofloat(row[sym + 32 * s]);
}

template <int Q, int KP>
__global__ void __launch_bounds__(256, 4)
cn_ems_bubble_kernel(const float* __restrict__ U, float* __restrict__ out, int dc, int B,
                     int nm, float offset, int npairs, int lg_fb) {
  extern __shared__ float smem[];
  constexpr int S = Lanes<Q>::S, G = Lanes<Q>::G, L = Slots<Q, KP>::L;
  const int lane = threadIdx.x & 31;
  const int sym = lane % Q;                                 // lane l holds sym + 32 s
  const int w = (threadIdx.x >> 5) * G + lane / Q;          // its frame in the block
  const int fb = 1 << lg_fb, ld = fb + 1;
  const int b0 = blockIdx.x * fb;
  const int P = npairs + (2 * nm < Q ? 2 * nm : Q);
  const int cp = KP > 0 ? 0 : (P + L - 1) / L * L;
  float* slab = smem;
  int* tab = reinterpret_cast<int*>(smem + (size_t)Q * ld);  // pairs, t | s << 16
  float* area = smem + (size_t)Q * ld + npairs +
                (size_t)w * bubble_frame_floats(Q, dc, nm, cp);
  unsigned* row = reinterpret_cast<unsigned*>(area + (2 * dc - 2) * (2 * nm + 1));
  auto bj = [&](int j) { return list_at(area, j == dc - 2 ? dc - 1 : dc + j, nm); };
  const size_t js = (size_t)Q * B;
  const float* Um = U + (size_t)blockIdx.y * dc * js;
  float* Om = out + (size_t)blockIdx.y * dc * js;

  for (int t = threadIdx.x; t < nm; t += blockDim.x) {
    int p = 0;
    for (int u = 0; u < t; ++u) p += stair_row(u, nm);
    for (int s = 0; s < stair_row(t, nm); ++s) tab[p++] = t | s << 16;
  }
  __syncthreads();
  Slots<Q, KP> c;
  c.gl = sym;
  c.tab = tab;
  c.n = cp / L;
  c.sk = reinterpret_cast<unsigned*>(row + Q);
  c.si = reinterpret_cast<int*>(c.sk + cp);
  if constexpr (KP > 0) {
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const int p = c.pos(k);
      c.ts[k] = p < npairs ? tab[p] : 0;
    }
  }

  // postprocess o and store it as output slot j
  auto emit_out = [&](int j, const float (&o)[S]) {
    const float mx = lanes_fmax<Q>(o);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float r = (o[s] - mx) + offset;
      slab[(sym + 32 * s) * ld + w] = fmaxf(fminf(r, 0.f), kNeg);
    }
    slab_store<S>(slab, Om + j * js, B, b0, lg_fb);
  };

  float next[S], o[S];
  slab_fetch<S>(next, Um, B, b0, lg_fb);
  for (int j = 0; j < dc; ++j) {
    slab_put<S>(slab, next, lg_fb);
    float x[S];
#pragma unroll
    for (int s = 0; s < S; ++s) x[s] = slab[(sym + 32 * s) * ld + w];
    if (j + 1 < dc) slab_fetch<S>(next, Um + (j + 1) * js, B, b0, lg_fb);   // in flight
    const float mx = lanes_fmax<Q>(x);
#pragma unroll
    for (int s = 0; s < S; ++s) x[s] = x[s] - mx;
    top_list<Q>(x, sym, nm, list_at(area, j, nm));
  }
  // B_j = merge of U_{j+1..dc-1}; B_{dc-2} is U_{dc-1}
  for (int j = dc - 3; j >= 0; --j)
    merge_bubble<Q, KP>(c, nm, npairs, P, bj(j + 1), list_at(area, j + 1, nm),
                        list_at(area, dc + j, nm));
  dense_out<Q, KP>(c, sym, nm, npairs, false, bj(0), bj(0), row, o);
  emit_out(0, o);
  // F_j = merge of U_{0..j-1}, kept in list 0 (F_1 is U_0 itself)
  const List f = list_at(area, 0, nm);
  for (int j = 1; j < dc; ++j) {
    if (j >= 2) merge_bubble<Q, KP>(c, nm, npairs, P, f, list_at(area, j - 1, nm), f);
    dense_out<Q, KP>(c, sym, nm, npairs, j < dc - 1, f, bj(j), row, o);
    emit_out(j, o);
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
  if (M > 65535 || dc < 2 || nm < 1 || nm > Q) return cudaErrorInvalidValue;
  constexpr int G = Lanes<Q>::G;
  // 8 warps a block unless shared memory forces fewer
  auto blocks = [&](int warps, size_t bytes, auto kernel, auto... args) {
    cudaError_t err = prepare(kernel, bytes);
    if (err != cudaSuccess) return err;
    const int fb = warps * G;
    kernel<<<dim3((B + fb - 1) / fb, M), 32 * warps, bytes, stream>>>(
        U, out, dc, B, nm, offset, args..., __builtin_ctz(fb));
    return cudaGetLastError();
  };
  int warps = 8;
  if (!bubble) {
    while (warps > 1 && classic_floats<Q>(warps * G, dc, nm) * sizeof(float) > kMaxSmem)
      warps /= 2;
    return blocks(warps, classic_floats<Q>(warps * G, dc, nm) * sizeof(float),
                  cn_ems_classic_kernel<Q>);
  }
  constexpr int L = Q < 32 ? Q : 32;
  int npairs = 0;
  for (int t = 0; t < nm; ++t) npairs += stair_row(t, nm);
  const int P = npairs + (2 * nm < Q ? 2 * nm : Q);
  // the fewest register slots that hold the merge's candidates, if any do
  const int slots = P <= 2 * L ? 2 : (P <= kSlots * L ? kSlots : 0);
  const int cp = slots ? 0 : (P + L - 1) / L * L;
  auto floats = [&](int w) {
    return (size_t)Q * (w * G + 1) + npairs +
           (size_t)w * G * bubble_frame_floats(Q, dc, nm, cp);
  };
  while (warps > 1 && floats(warps) * sizeof(float) > kMaxSmem) warps /= 2;
  const size_t bytes = floats(warps) * sizeof(float);
  if (slots == 2) return blocks(warps, bytes, cn_ems_bubble_kernel<Q, 2>, npairs);
  if (slots) return blocks(warps, bytes, cn_ems_bubble_kernel<Q, kSlots>, npairs);
  return blocks(warps, bytes, cn_ems_bubble_kernel<Q, 0>, npairs);
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
